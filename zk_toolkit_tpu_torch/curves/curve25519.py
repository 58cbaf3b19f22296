"""curve25519 in twisted-Edwards form (the Ed25519 curve):
-x^2 + y^2 = 1 + d·x^2·y^2 over F_q, q = 2^255 - 19.

(The port's own copy of zk_toolkit_tpu/curves/curve25519.py;
the port imports nothing of the JAX package.)

Parity: reference curves/curve25519/affine_point.rs — q and l constants
(:41-53), base point B = (recover_x(4/5, even), 4/5) (:70-75), `recover_x`
square root via a^((q+3)/8) with sqrt(-1) fixup and parity select (:83-104),
d = -121665/121666 (:106-112), Edwards addition law (:117-149), and
double-and-add scalar mul (:115).
"""

from __future__ import annotations

from enum import Enum

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem

#: Base field order q = 2^255 - 19
Q = 2**255 - 19
#: Base-point (subgroup) order l = 2^252 + delta
L = 2**252 + 27742317777372353535851937790883648493

BASE_FIELD = PrimeField(Q)
CURVE_GROUP = PrimeField(L)


class Parity(Enum):
    EVEN = 0
    ODD = 1


def base_field() -> PrimeField:
    return BASE_FIELD


def curve_group() -> PrimeField:
    return CURVE_GROUP


def d() -> PrimeFieldElem:
    """d = -121665 / 121666 (affine_point.rs:106-112)."""
    return -BASE_FIELD.elem(121665) / BASE_FIELD.elem(121666)


def get_parity(e: PrimeFieldElem) -> Parity:
    return Parity.EVEN if e.e % 2 == 0 else Parity.ODD


def recover_x(d_elem: PrimeFieldElem, y: PrimeFieldElem, x_parity: Parity) -> PrimeFieldElem:
    """Recover x from y: x^2 = (y^2-1)/(d·y^2+1); square root via
    candidate a^((q+3)/8), multiplied by sqrt(-1) = 2^((q-1)/4) if needed,
    then parity-adjusted (affine_point.rs:83-104)."""
    f = BASE_FIELD
    xx = (y.sq() - 1) / (d_elem * y.sq() + 1)
    x = xx ** ((Q + 3) // 8)
    if x.sq() != xx:
        i = f.elem(2) ** ((Q - 1) // 4)  # sqrt(-1)
        x = x * i
    if get_parity(x) != x_parity:
        x = -x
    return x


class EdwardsPoint:
    """Twisted-Edwards affine point with the unified addition law — no
    exceptional cases for doubling (complete for a=-1, d non-square)."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x: PrimeFieldElem | None, y: PrimeFieldElem | None, inf: bool = False):
        self.x, self.y = x, y
        self.inf = inf

    @staticmethod
    def infinity() -> "EdwardsPoint":
        # The reference models the identity as AtInfinity rather than (0, 1)
        # (affine_point.rs:26-29); we mirror that for behavioral parity.
        return EdwardsPoint(None, None, inf=True)

    def is_zero(self) -> bool:
        return self.inf

    def __add__(self, other: "EdwardsPoint") -> "EdwardsPoint":
        if self.inf:
            return other
        if other.inf:
            return self
        one = BASE_FIELD.one()
        dd = d()
        x1y2 = self.x * other.y
        x2y1 = other.x * self.y
        x1x2y1y2 = x1y2 * x2y1
        y1y2 = self.y * other.y
        x1x2 = self.x * other.x
        x = (x1y2 + x2y1) / (one + dd * x1x2y1y2)
        y = (y1y2 + x1x2) / (one - dd * x1x2y1y2)
        return EdwardsPoint(x, y)

    def __neg__(self) -> "EdwardsPoint":
        if self.inf:
            return self
        return EdwardsPoint(-self.x, self.y)

    def __mul__(self, scalar) -> "EdwardsPoint":
        k = int(scalar) if not hasattr(scalar, "e") else scalar.e
        acc = EdwardsPoint.infinity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base + base
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __eq__(self, other) -> bool:
        if not isinstance(other, EdwardsPoint):
            return NotImplemented
        if self.inf or other.inf:
            return self.inf and other.inf
        return self.x == other.x and self.y == other.y

    def is_on_curve(self) -> bool:
        if self.inf:
            return True
        lhs = -self.x.sq() + self.y.sq()
        rhs = BASE_FIELD.one() + d() * self.x.sq() * self.y.sq()
        return lhs == rhs

    def __repr__(self):
        return "ed25519(infinity)" if self.inf else f"ed25519({self.x!r}, {self.y!r})"


def B() -> EdwardsPoint:
    """Base point (+x, 4/5) (affine_point.rs:70-75)."""
    b_y = BASE_FIELD.elem(4) / BASE_FIELD.elem(5)
    b_x = recover_x(d(), b_y, Parity.EVEN)
    return EdwardsPoint(b_x, b_y)
