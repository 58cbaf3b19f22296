"""BLS signatures over BLS12-381 (host tier).

Parity: reference curves/bls12_381/signature.rs:8-45 — pk = g1 * sk,
sig = H(m) * sk in G2, verify e(g1, sig) == e(pk, H(m)) with the Tate
pairing; private key uniform in [1, r-1] (private_key.rs:10-27).

(The port's own copy of zk_toolkit_tpu/signatures/bls.py;
the port imports nothing of the JAX package.)

`hash_to_g2` defaults to the reference's placeholder (scalar-mul hash,
g2_point.rs:83-88) for bit-exact parity; pass
`hash_fn=g2.hash_to_g2point_swu` for the proper hash-and-check map (the
mcl `hash_and_map` equivalent).

The device tier batches verification: ops/signature_ops.bls_verify_batch.
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2, params
from zk_toolkit_tpu_torch.curves.bls12_381.pairing import Pairing
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG


class PrivateKey:
    """Uniform scalar in [1, r-1] (private_key.rs:10-27)."""

    __slots__ = ("value",)

    def __init__(self, value: int | None = None, rng: Rng | None = None):
        if value is None:
            rng = rng or GLOBAL_RNG
            value = rng.randint(1, params.R - 1)
        self.value = int(value)

    def __int__(self):
        return self.value


class Signer:
    def __init__(self, hash_fn=g2.hash_to_g2point):
        self.g1 = g1.g()
        self.pairing = Pairing()
        self.hash_fn = hash_fn

    def gen_public_key(self, sk: PrivateKey) -> AffinePoint:
        return self.g1 * sk.value

    def sign(self, m: bytes, sk: PrivateKey) -> AffinePoint:
        return self.hash_fn(m) * sk.value

    def verify(self, m: bytes, sig: AffinePoint, pk: AffinePoint) -> bool:
        hash_m = self.hash_fn(m)
        lhs = self.pairing.tate(self.g1, sig)
        rhs = self.pairing.tate(pk, hash_m)
        return lhs == rhs
