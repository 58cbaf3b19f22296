"""ECDSA over secp256k1 (host tier).

(The port's own copy of zk_toolkit_tpu/signatures/ecdsa.py;
the port imports nothing of the JAX package.)

Parity: reference curves/secp256k1/ecdsa.rs — `gen_pub_key` (:33-35), `sign`
loop with fresh k, r = (kG).x mod n, s = k^-1 (z + r*d) (:37-85), `verify`
with pubkey infinity / on-curve / subgroup checks and r,s range checks before
u1*G + u2*Q (:88-135).

Randomness (the nonce k) is injectable for reproducible tests; production
use draws from OS entropy (SURVEY.md §7 randomness plumbing).

The device tier provides batched keygen/sign/verify
(zk_toolkit_tpu_torch.ops.signature_ops); this host class is its oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.curves import secp256k1 as curve
from zk_toolkit_tpu_torch.fields.prime_field import PrimeFieldElem
from zk_toolkit_tpu_torch.hashers.sha256 import Sha256
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint


@dataclass
class Signature:
    r: PrimeFieldElem  # mod n
    s: PrimeFieldElem  # mod n


class Ecdsa:
    def __init__(self, hasher=Sha256):
        self.hasher = hasher

    def gen_pub_key(self, priv_key: PrimeFieldElem) -> AffinePoint:
        if priv_key.f.order != curve.N:
            raise ValueError("Private key needs to be an element of curve group")
        return curve.g() * priv_key

    def sign(self, priv_key: PrimeFieldElem, message: bytes, rng: Rng | None = None) -> Signature:
        if priv_key.f.order != curve.N:
            raise ValueError("Private key needs to be an element of curve group")
        f_n = curve.curve_group()
        g = curve.g()
        rng = rng or GLOBAL_RNG
        while True:
            k = f_n.rand_elem(exclude_zero=True, rng=rng)
            z = int.from_bytes(self.hasher.get_digest(message), "big")
            p = g * k
            if p.is_zero():
                continue
            r = p.x.e % curve.N
            if r == 0:
                continue
            k_inv = k.inv()
            r_fe = f_n.elem(r)
            z_fe = f_n.elem(z)
            s = k_inv * (priv_key * r_fe + z_fe)
            if s.e == 0:
                continue
            return Signature(r_fe, s)

    def verify(self, sig: Signature, pub_key: AffinePoint, message: bytes) -> bool:
        n = curve.N
        # pubkey must be a finite, on-curve point of order dividing n
        # (ecdsa.rs:94-106)
        if pub_key.is_zero():
            return False
        if not pub_key.is_rational_point():
            return False
        if not (pub_key * n).is_zero():
            return False
        # r, s in [1, n-1] (ecdsa.rs:108-113)
        if sig.r.e == 0 or sig.s.e == 0 or sig.r.e >= n or sig.s.e >= n:
            return False
        f_n = curve.curve_group()
        z = int.from_bytes(self.hasher.get_digest(message), "big")
        z_fe = f_n.elem(z)
        w = sig.s.inv()
        u1 = z_fe * w
        u2 = sig.r * w
        p3 = curve.g() * u1 + pub_key * u2
        if p3.is_zero():
            return False
        return sig.r.e == p3.x.e % n
