"""Generic short-Weierstrass affine group law, duck-typed over the coordinate

(The port's own copy of zk_toolkit_tpu/curves/weierstrass.py;
the port imports nothing of the JAX package.)
field so the same implementation serves secp256k1 (over Fp), BLS12-381 G1
(over Fq), G2 (over Fq2), and G12 (over Fq12).

Behavioral parity with the reference's macro-generated group law
(reference: curves/macros.rs — `impl_affine_add!` :35-215 covering
infinity/vertical/tangent/y=0 cases, `impl_scalar_mul_point!` :1-33
double-and-add) and the general-coefficient curve-membership check
(curves/weierstrass_eq.rs:4-45).

Coordinate elements must support +, -, *, /, unary -, ==, and `is_zero()` —
satisfied by `PrimeFieldElem` and the Fq2/Fq6/Fq12 tower classes.

The device tier re-implements this law branch-free in Jacobian coordinates
(zk_toolkit_tpu_torch.ops.curve_ops); this host version is its oracle.
"""

from __future__ import annotations


class WeierstrassEq:
    """General y^2 + a1·xy + a3·y = x^3 + a2·x^2 + a4·x + a6 membership check
    (reference: weierstrass_eq.rs:4-45)."""

    def __init__(self, a1, a2, a3, a4, a6):
        self.a1, self.a2, self.a3, self.a4, self.a6 = a1, a2, a3, a4, a6

    def is_rational_point(self, x, y) -> bool:
        lhs = y * y + self.a1 * x * y + self.a3 * y
        rhs = x * x * x + self.a2 * x * x + self.a4 * x + self.a6
        return lhs == rhs


class WeierstrassCurve:
    """Curve y^2 = x^3 + a·x + b over a duck-typed coordinate field.

    `zero`/`one` are the additive/multiplicative identities of the coordinate
    field; `order` is the scalar-group order (subgroup order n or r).
    """

    def __init__(self, a, b, zero, one, order: int, name: str = "weierstrass"):
        self.a, self.b = a, b
        self.zero, self.one = zero, one
        self.order = order
        self.name = name

    def point(self, x, y) -> "AffinePoint":
        return AffinePoint(self, x, y)

    def infinity(self) -> "AffinePoint":
        return AffinePoint(self, None, None, inf=True)

    def is_on_curve(self, x, y) -> bool:
        return y * y == x * x * x + self.a * x + self.b


class AffinePoint:
    """Affine point with the full chord-tangent case analysis of
    reference macros.rs:35-215."""

    __slots__ = ("curve", "x", "y", "inf")

    def __init__(self, curve: WeierstrassCurve, x, y, inf: bool = False):
        self.curve = curve
        self.x, self.y = x, y
        self.inf = inf

    def is_zero(self) -> bool:
        return self.inf

    def is_rational_point(self) -> bool:
        if self.inf:
            return False  # reference returns false for infinity (macros parity)
        return self.curve.is_on_curve(self.x, self.y)

    def __add__(self, other: "AffinePoint") -> "AffinePoint":
        c = self.curve
        if self.inf:
            return other
        if other.inf:
            return self
        if self.x == other.x:
            # vertical: y1 == -y2 (covers y1 == y2 == 0 tangent-vertical)
            if self.y == -other.y:
                return c.infinity()
            # tangent: lambda = (3x^2 + a) / 2y
            xx = self.x * self.x
            lam = (xx + xx + xx + c.a) / (self.y + self.y)
        else:
            lam = (other.y - self.y) / (other.x - self.x)
        x3 = lam * lam - self.x - other.x
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(c, x3, y3)

    def double(self) -> "AffinePoint":
        return self + self

    def __neg__(self) -> "AffinePoint":
        if self.inf:
            return self
        return AffinePoint(self.curve, self.x, -self.y)

    def __sub__(self, other: "AffinePoint") -> "AffinePoint":
        return self + (-other)

    def __mul__(self, scalar) -> "AffinePoint":
        """Double-and-add over the scalar's bits
        (reference impl_scalar_mul_point!, macros.rs:1-33)."""
        k = int(scalar) if not hasattr(scalar, "e") else scalar.e
        if k < 0:
            return (-self) * (-k)
        acc = self.curve.infinity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base + base
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __eq__(self, other) -> bool:
        if not isinstance(other, AffinePoint):
            return NotImplemented
        if self.inf or other.inf:
            return self.inf and other.inf
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        if self.inf:
            return hash((self.curve.name, "inf"))
        return hash((self.curve.name, repr(self.x), repr(self.y)))

    def __repr__(self) -> str:
        if self.inf:
            return f"{self.curve.name}(infinity)"
        return f"{self.curve.name}({self.x!r}, {self.y!r})"
