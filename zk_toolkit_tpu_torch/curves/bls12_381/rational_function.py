"""Line functions through pairs of G12 points, for Miller-loop divisor

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/rational_function.py;
the port imports nothing of the JAX package.)
evaluation.

Parity: reference curves/bls12_381/rational_function.rs — Vertical /
NonVertical line dispatch for tangent/vertical/chord (:21-43), evaluation of
the divisor line at a point in Fq12 (:46-66), slopes computed in Fq12
(:70-103).
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq12
from zk_toolkit_tpu_torch.curves.bls12_381.g12 import G12Point
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint


class RationalFunction:
    def __init__(self, vertical: bool, x: Fq12, y: Fq12 | None = None, slope: Fq12 | None = None):
        self.vertical = vertical
        self.x, self.y, self.slope = x, y, slope

    @staticmethod
    def new(p: AffinePoint, q: AffinePoint, embed) -> "RationalFunction":
        """Dispatch tangent / vertical / chord (rational_function.rs:21-43).
        `embed` maps the typed point into G12 (G12Point.from_g1 / from_g2)."""
        p12, q12 = embed(p), embed(q)
        if p12.inf or q12.inf:
            raise ValueError("Both points need to be rational")
        if p == q:
            return RationalFunction._tangent(p12.x, p12.y)
        if q == -p:
            return RationalFunction._vertical(p12.x)
        return RationalFunction._chord(p12.x, p12.y, q12.x, q12.y)

    @staticmethod
    def _tangent(x: Fq12, y: Fq12) -> "RationalFunction":
        slope = Fq12.from_int(3) * x * x * (Fq12.from_int(2) * y).inv()
        return RationalFunction(False, x, y, slope)

    @staticmethod
    def _vertical(x: Fq12) -> "RationalFunction":
        return RationalFunction(True, x)

    @staticmethod
    def _chord(x1: Fq12, y1: Fq12, x2: Fq12, y2: Fq12) -> "RationalFunction":
        slope = (y2 - y1) * (x2 - x1).inv()
        return RationalFunction(False, x1, y1, slope)

    def eval_at(self, q: AffinePoint, embed) -> Fq12:
        """Evaluate the line at q (rational_function.rs:46-66)."""
        q12 = embed(q)
        if q12.inf:
            raise ValueError("cannot evaluate with point at infinity")
        if self.vertical:
            return q12.x + (-self.x)
        return -self.slope * q12.x + q12.y + (-self.y) + self.slope * self.x
