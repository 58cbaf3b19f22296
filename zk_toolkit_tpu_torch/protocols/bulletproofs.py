"""Bulletproofs range proof + inner-product argument over secp256k1.

(The port's own copy of zk_toolkit_tpu/protocols/bulletproofs.py;
the port imports nothing of the JAX package.)

Parity: reference zk/wo_trusted_setup/bulletproofs.rs (after
eprint 2017/1066) — `inner_product_argument` with recursive halving, cL/cR
cross inner products, L/R commitments, and x-challenge folding of g, h, a,
b, P (:19-55); `range_proof` with aL bit vector, aR = aL - 1^n, A/S
commitments, y/z challenges, l(x)/r(x), t0/t1/t2, T1/T2, t_hat/tau_x/mu, the
eq. (65) check, then either the direct (66)-(68) checks or delegation to the
IPA (:58-147).

The reference model is interactive: challenges are sampled locally. All
sampling goes through the injectable `rng` so transcripts replay exactly;
`fiat_shamir=True` derives challenges from a SHA-256 transcript instead (a
non-interactive extension the reference lacks).

The device tier (protocols/bulletproofs_device.py) replays the same
interactive transcript with every vector fold and MSM batched on a device;
this host class is its oracle.
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.fields.prime_field import PrimeFieldElem, PrimeFieldElems
from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.curves.secp256k1 import AffinePoints
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint
from zk_toolkit_tpu_torch.hashers.sha256 import Sha256
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG


class _Transcript:
    """Fiat-Shamir challenge derivation (SHA-256 chain)."""

    def __init__(self):
        self.state = b"zk_toolkit_tpu/bulletproofs/v1"

    def absorb_point(self, p: AffinePoint) -> None:
        if p.is_zero():
            self.state = Sha256.get_digest(self.state + b"\x00")
        else:
            self.state = Sha256.get_digest(
                self.state + p.x.e.to_bytes(32, "big") + p.y.e.to_bytes(32, "big")
            )

    def challenge(self) -> PrimeFieldElem:
        f_n = secp256k1.curve_group()
        while True:
            self.state = Sha256.get_digest(self.state + b"\x01")
            v = int.from_bytes(self.state, "big")
            if 0 < v < secp256k1.N:
                return f_n.elem(v)


class Bulletproofs:
    def __init__(self, rng: Rng | None = None, fiat_shamir: bool = False):
        self.rng = rng or GLOBAL_RNG
        self.fiat_shamir = fiat_shamir
        self.transcript = _Transcript() if fiat_shamir else None

    def _challenge(self, *points: AffinePoint) -> PrimeFieldElem:
        if self.fiat_shamir:
            for p in points:
                self.transcript.absorb_point(p)
            return self.transcript.challenge()
        return secp256k1.curve_group().rand_elem(True, self.rng)

    def inner_product_argument(
        self,
        n: int,
        gg: AffinePoints,
        hh: AffinePoints,
        u: AffinePoint,
        P: AffinePoint,
        a: PrimeFieldElems,
        b: PrimeFieldElems,
    ) -> bool:
        """P = g^a h^b u^<a,b> (bulletproofs.rs:19-55)."""
        if n == 1:
            c = (a * b).sum()
            rhs = (gg * a).sum() + (hh * b).sum() + u * c
            return P == rhs
        np = n // 2
        cL = (a.to(np) * b.from_(np)).sum()
        cR = (a.from_(np) * b.to(np)).sum()
        L = (gg.from_(np) * a.to(np)).sum() + (hh.to(np) * b.from_(np)).sum() + u * cL
        R = (gg.to(np) * a.from_(np)).sum() + (hh.from_(np) * b.to(np)).sum() + u * cR
        x = self._challenge(L, R)
        ggp = (gg.to(np) * x.inv()) + (gg.from_(np) * x)
        hhp = (hh.to(np) * x) + (hh.from_(np) * x.inv())
        Pp = (L * x.sq()) + P + (R * x.sq().inv())
        ap = a.to(np) * x + a.from_(np) * x.inv()
        bp = b.to(np) * x.inv() + b.from_(np) * x
        return self.inner_product_argument(np, ggp, hhp, u, Pp, ap, bp)

    def range_proof(
        self,
        n: int,
        V: AffinePoint,
        aL: PrimeFieldElems,
        gamma: PrimeFieldElem,
        g: AffinePoint,
        h: AffinePoint,
        gg: AffinePoints,
        hh: AffinePoints,
        use_inner_product_argument: bool,
    ) -> bool:
        """(bulletproofs.rs:58-147)."""
        f_n = secp256k1.curve_group()
        one = f_n.one()
        two = f_n.elem(2)
        one_n = one.pow_seq(n)
        two_n = two.pow_seq(n)

        aR = aL - one_n
        alpha = f_n.rand_elem(True, self.rng)
        A = h * alpha + (gg * aL).sum() + (hh * aR).sum()

        sL = f_n.rand_elems(n, True, self.rng)
        sR = f_n.rand_elems(n, True, self.rng)
        rho = f_n.rand_elem(True, self.rng)
        S = h * rho + (gg * sL).sum() + (hh * sR).sum()

        y = self._challenge(A, S)
        z = self._challenge()

        y_n = y.pow_seq(n)
        l0 = aL - (one_n * z)
        l1 = sL
        r0 = (y_n * (aR + (one_n * z))) + (two_n * z.sq())
        r1 = y_n * sR

        t0 = (l0 * r0).sum()
        t1 = (l1 * r0).sum() + (l0 * r1).sum()
        t2 = (l1 * r1).sum()

        tau1 = f_n.rand_elem(True, self.rng)
        tau2 = f_n.rand_elem(True, self.rng)
        T1 = g * t1 + h * tau1
        T2 = g * t2 + h * tau2

        x = self._challenge(T1, T2)

        t_hat = t0 + (t1 * x) + (t2 * x.sq())
        tau_x = tau2 * x.sq() + (tau1 * x) + (z.sq() * gamma)
        mu = alpha + (rho * x)

        # (64)
        hhp = hh * y.inv().pow_seq(n)

        # (65)
        delta_yz = ((z - z.sq()) * (one_n * y_n).sum()) - (z.cube() * (one_n * two_n).sum())
        lhs_65 = (g * t_hat) + (h * tau_x)
        rhs_65 = V * z.sq() + g * delta_yz + T1 * x + T2 * x.sq()
        if lhs_65 != rhs_65:
            return False

        # (66), (67)
        l = (aL - (one_n * z)) + (sL * x)
        r = (y_n * ((aR + (one_n * z)) + (sR * x))) + (two_n * z.sq())

        P = (
            A
            + S * x
            + (gg * (one_n * z.negate())).sum()
            + (hhp * ((y_n * z) + (two_n * z.sq()))).sum()
        )

        if use_inner_product_argument:
            u = secp256k1.rand_point(True, self.rng)
            Pp = P + h * mu.negate() + u * (l * r).sum()
            return self.inner_product_argument(n, gg, hhp, u, Pp, l, r)
        rhs_66_67 = ((h * mu) + (gg * l).sum()) + (hhp * r).sum()
        if P != rhs_66_67:
            return False
        # (68)
        return t_hat == (l * r).sum()
