"""secp256k1: y^2 = x^3 + 7 over F_p.

(The port's own copy of zk_toolkit_tpu/curves/secp256k1.py;
the port imports nothing of the JAX package.)

Parity: reference curves/secp256k1/affine_point.rs (p, n, G constants
:30-47, `rand_point` :69-77, b=7 membership check :90-106) and
affine_points.rs:14-169 (point-vector ops used by Bulletproofs).

The reference's `AffinePoint::inv` returns (x, y) un-negated — a documented
unused bug (affine_point.rs:79-87, SURVEY.md §7); we provide correct negation
via `-point`.
"""

from __future__ import annotations

from typing import Iterable

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem, PrimeFieldElems
from zk_toolkit_tpu_torch.curves.weierstrass import WeierstrassCurve, AffinePoint
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG

#: Base field modulus p = 2^256 - 2^32 - 977
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
#: Curve group order n
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

BASE_FIELD = PrimeField(P)
CURVE_GROUP = PrimeField(N)

CURVE = WeierstrassCurve(
    a=BASE_FIELD.zero(),
    b=BASE_FIELD.elem(7),
    zero=BASE_FIELD.zero(),
    one=BASE_FIELD.one(),
    order=N,
    name="secp256k1",
)


def base_field() -> PrimeField:
    return BASE_FIELD


def curve_group() -> PrimeField:
    return CURVE_GROUP


def g() -> AffinePoint:
    return CURVE.point(BASE_FIELD.elem(GX), BASE_FIELD.elem(GY))


def point(x: int | PrimeFieldElem, y: int | PrimeFieldElem) -> AffinePoint:
    return CURVE.point(BASE_FIELD.elem(x), BASE_FIELD.elem(y))


def infinity() -> AffinePoint:
    return CURVE.infinity()


def rand_point(exclude_zero: bool = False, rng: Rng | None = None) -> AffinePoint:
    """g * random scalar (reference affine_point.rs:69-77)."""
    rng = rng or GLOBAL_RNG
    while True:
        k = CURVE_GROUP.rand_elem(exclude_zero, rng)
        p = g() * k
        if not exclude_zero or not p.is_zero():
            return p


class AffinePoints:
    """Vector of secp256k1 points with elementwise ops — `sum`, slicing,
    elementwise add / scalar-mul / Hadamard vector-mul
    (reference: affine_points.rs:14-169). Bulletproofs' commitment vectors."""

    def __init__(self, points: Iterable[AffinePoint]):
        self.points = list(points)
        if not self.points:
            raise ValueError("empty AffinePoints")

    @staticmethod
    def rand_points(n: int, exclude_zero: bool = False, rng: Rng | None = None) -> "AffinePoints":
        return AffinePoints([rand_point(exclude_zero, rng) for _ in range(n)])

    def __len__(self):
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return AffinePoints(self.points[i])
        return self.points[i]

    def sum(self) -> AffinePoint:
        acc = infinity()
        for p in self.points:
            acc = acc + p
        return acc

    def from_(self, idx: int) -> "AffinePoints":
        return AffinePoints(self.points[idx:])

    def to(self, idx: int) -> "AffinePoints":
        return AffinePoints(self.points[:idx])

    def __add__(self, other: "AffinePoints") -> "AffinePoints":
        if len(other) != len(self):
            raise ValueError("length mismatch")
        return AffinePoints([a + b for a, b in zip(self.points, other.points)])

    def __mul__(self, other) -> "AffinePoints":
        """Elementwise scalar mul by a PrimeFieldElems vector or single scalar."""
        if isinstance(other, PrimeFieldElems):
            if len(other) != len(self):
                raise ValueError("length mismatch")
            return AffinePoints([p * e for p, e in zip(self.points, other)])
        return AffinePoints([p * other for p in self.points])

    __rmul__ = __mul__

    def inner_prod(self, scalars: PrimeFieldElems) -> AffinePoint:
        """MSM: sum_i scalars[i] * self[i]."""
        return (self * scalars).sum()

    def __eq__(self, other) -> bool:
        if not isinstance(other, AffinePoints):
            return NotImplemented
        return len(self) == len(other) and all(a == b for a, b in zip(self.points, other.points))
