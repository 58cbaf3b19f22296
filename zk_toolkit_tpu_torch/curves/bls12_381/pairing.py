"""Weil and Tate pairings via the Miller loop (host tier).

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/pairing.py;
the port imports nothing of the JAX package.)

Parity: reference curves/bls12_381/pairing.rs — Miller loop over the bits of
r - 1 with the MSB dropped (:57-73); per bit f <- f^2 * g_{V,V}(q) /
g_{2V,-2V}(q) plus a conditional add step (:20-55); `weil` =
Miller(p1,p2) / Miller(p2,p1) (:75-84); `tate` = Miller(p1,p2)^((q^12-1)/r)
(:86-100). GTPoint wrapper parity: gt_point.rs:5-39.

The reference narrates progress with println!; here the equivalent hook is
the standard `logging` module at DEBUG level.

The device tier provides the throughput path: a batched optimal-ate pairing
(the mcl-equivalent, reference mcl/pairing.rs:9-18) in
zk_toolkit_tpu_torch.ops.pairing_ops.
"""

from __future__ import annotations

import logging

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq12
from zk_toolkit_tpu_torch.curves.bls12_381.g12 import G12Point
from zk_toolkit_tpu_torch.curves.bls12_381.rational_function import RationalFunction
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint

log = logging.getLogger(__name__)


class GTPoint:
    """Fq12 wrapper with Mul + Eq only (gt_point.rs:5-39)."""

    __slots__ = ("e",)

    def __init__(self, e: Fq12):
        self.e = e

    def __mul__(self, other: "GTPoint") -> "GTPoint":
        return GTPoint(self.e * other.e)

    def __eq__(self, other) -> bool:
        if not isinstance(other, GTPoint):
            return NotImplemented
        return self.e == other.e

    def __repr__(self):
        return f"GTPoint({self.e!r})"


def _miller_bits() -> list[bool]:
    """Bits of r - 1, MSB-first with the leading 1 dropped
    (pairing.rs:57-73)."""
    l = params.R - 1
    bits = []
    while l:
        bits.append(bool(l & 1))
        l >>= 1
    bits.reverse()
    return bits[1:]


class Pairing:
    def __init__(self):
        self.l_bits = _miller_bits()

    def _miller(self, p: AffinePoint, q: AffinePoint, embed_p, embed_q) -> Fq12:
        """Generic Miller loop (pairing.rs:24-50 macro body). `embed_p` /
        `embed_q` are G12Point.from_g1/from_g2 matching each side's group."""
        f = Fq12.one()
        v = p
        for bit in self.l_bits:
            v2 = v + v
            g_num = RationalFunction.new(v, v, embed_p)
            g_deno = RationalFunction.new(v2, -v2, embed_p)
            f = (f * f) * g_num.eval_at(q, embed_q) * g_deno.eval_at(q, embed_q).inv()
            v = v2
            if bit:
                v_plus_p = v + p
                g_num = RationalFunction.new(v, p, embed_p)
                g_deno = RationalFunction.new(v_plus_p, -v_plus_p, embed_p)
                f = f * g_num.eval_at(q, embed_q) * g_deno.eval_at(q, embed_q).inv()
                v = v_plus_p
        return f

    def calc_g1_g2(self, p: AffinePoint, q: AffinePoint) -> Fq12:
        return self._miller(p, q, G12Point.from_g1, G12Point.from_g2)

    def calc_g2_g1(self, p: AffinePoint, q: AffinePoint) -> Fq12:
        return self._miller(p, q, G12Point.from_g2, G12Point.from_g1)

    def weil(self, p1: AffinePoint, p2: AffinePoint) -> GTPoint:
        """Weil pairing = Miller(p1,p2) / Miller(p2,p1) (pairing.rs:75-84)."""
        log.debug("Started Weil pairing: Miller loop G1-G2")
        num = self.calc_g1_g2(p1, p2)
        log.debug("Running Miller loop G2-G1")
        deno = self.calc_g2_g1(p2, p1)
        return GTPoint(num * deno.inv())

    def tate(self, p1: AffinePoint, p2: AffinePoint) -> GTPoint:
        """Tate pairing = Miller(p1,p2)^((q^12-1)/r) (pairing.rs:86-100)."""
        log.debug("Started Tate pairing: Miller loop G1-G2")
        intmed = self.calc_g1_g2(p1, p2)
        log.debug("Applying final exponentiation")
        exp = (params.Q**12 - 1) // params.R
        return GTPoint(intmed.pow(exp))

    # The mcl backend's `Pairing::e` is an optimal ate pairing
    # (reference mcl/pairing.rs:9-18); `e` here aliases tate for the host
    # tier — any fixed bilinear non-degenerate pairing works for the
    # protocols, and tate matches the reference's vectors.
    def e(self, p1: AffinePoint, p2: AffinePoint) -> GTPoint:
        return self.tate(p1, p2)
