"""G12: points embedded in E(Fq12) — the common home where G1 and untwisted

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/g12.py;
the port imports nothing of the JAX package.)
G2 points meet for line-function evaluation.

Parity: reference curves/bls12_381/g12_point.rs — `From<&G1Point>` embed
(:29-44) and `From<&G2Point>` untwist via the root w: x * (1/w as Fq12),
y * (1/(w*z)) (:46-67).
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq2, Fq6, Fq12
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint


class G12Point:
    __slots__ = ("x", "y", "inf")

    def __init__(self, x: Fq12 | None, y: Fq12 | None, inf: bool = False):
        self.x, self.y = x, y
        self.inf = inf

    @staticmethod
    def from_g1(p: AffinePoint) -> "G12Point":
        """Embed Fq coordinates into Fq12 (g12_point.rs:29-44)."""
        if p.is_zero():
            return G12Point(None, None, inf=True)
        return G12Point(Fq12.from_int(p.x.e), Fq12.from_int(p.y.e))

    @staticmethod
    def from_g2(p: AffinePoint) -> "G12Point":
        """Untwist (g12_point.rs:46-67): with root = w embedded in Fq6,
        x12 = x_embedded * (w-as-Fq12)^-1, y12 = y_embedded * (w*z)^-1."""
        if p.is_zero():
            return G12Point(None, None, inf=True)
        root = Fq6(Fq2.zero(), Fq2.one(), Fq2.zero())  # = w
        x6 = Fq6(Fq2.zero(), Fq2.zero(), p.x)
        y6 = Fq6(Fq2.zero(), Fq2.zero(), p.y)
        x12 = Fq12(Fq6.zero(), x6) * Fq12(Fq6.zero(), root).inv()
        y12 = Fq12(Fq6.zero(), y6) * Fq12(root, Fq6.zero()).inv()
        return G12Point(x12, y12)
