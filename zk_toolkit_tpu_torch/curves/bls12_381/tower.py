"""BLS12-381 extension-field tower Fq1 -> Fq2 -> Fq6 -> Fq12 (host tier).

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/tower.py;
the port imports nothing of the JAX package.)

Tower construction and arithmetic match the reference exactly so that pairing
outputs are bit-identical:

- Fq2 = Fq[u]/(u^2 + 1), element u0 + u1*u
  (reference: fq2.rs — mul :134-152, inv via (u1^2+u0^2)^-1 :26-32,
  `reduce` = multiply by xi = 1 + u :52-59)
- Fq6 = Fq2[w]/(w^3 - xi), element v0 + v1*w + v2*w^2
  (reference: fq6.rs — mul with reduce-folding :148-171, inv :23-38,
  `reduce` = multiply by w :54-62)
- Fq12 = Fq6[z]/(z^2 - w), element w0 + w1*z
  (reference: fq12.rs — mul :135-152, inv :31-40, square-and-multiply pow
  :42-57)

The reference's `Fq6::is_zero`/`Fq12::is_zero` are hardcoded `true` and
`Fq12::reduce` panics (fq6.rs:49-52, fq12.rs:77-86) — documented dead quirks
(SURVEY.md §7); we implement them correctly since no test vector depends on
the broken behavior.

The device tier mirrors this file with batched limb kernels
(zk_toolkit_tpu_torch.ops.tower); this implementation is its oracle.
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.fields.prime_field import PrimeFieldElem
from zk_toolkit_tpu_torch.curves.bls12_381 import params

# Fq1 is just a PrimeFieldElem over q (reference fq1.rs:13-49).
Fq1 = PrimeFieldElem


def fq1(v: int) -> Fq1:
    return params.BASE_PRIME_FIELD.elem(v)


def fq1_from_u8_slice(s: bytes | str) -> Fq1:
    """Hex-string constructor (reference fq1.rs `from_u8_slice`)."""
    if isinstance(s, bytes):
        s = s.decode()
    return fq1(int(s, 16))


class Fq2:
    """u0 + u1*u with u^2 = -1."""

    __slots__ = ("u1", "u0")

    def __init__(self, u1: Fq1, u0: Fq1):
        # Constructor takes (u1, u0) in that order — reference Fq2::new parity.
        self.u1, self.u0 = u1, u0

    @staticmethod
    def from_int(n: int) -> "Fq2":
        return Fq2(fq1(0), fq1(n))

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(fq1(0), fq1(0))

    @staticmethod
    def one() -> "Fq2":
        return Fq2(fq1(0), fq1(1))

    def is_zero(self) -> bool:
        return self.u0.is_zero() and self.u1.is_zero()

    def _coerce(self, other):
        if isinstance(other, Fq2):
            return other
        if isinstance(other, int):
            return Fq2.from_int(other)
        return None

    def __add__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return Fq2(self.u1 + o.u1, self.u0 + o.u0)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return Fq2(self.u1 - o.u1, self.u0 - o.u0)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return Fq2(
            self.u1 * o.u0 + self.u0 * o.u1,
            self.u0 * o.u0 - self.u1 * o.u1,
        )

    __rmul__ = __mul__

    def __neg__(self):
        return Fq2.zero() - self

    def inv(self) -> "Fq2":
        factor = (self.u1 * self.u1 + self.u0 * self.u0).inv()
        return Fq2(self.u1.negate() * factor, self.u0 * factor)

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        return self * o.inv()

    def sq(self) -> "Fq2":
        return self * self

    def reduce(self) -> "Fq2":
        """Multiply by xi = 1 + u (fq2.rs:52-59)."""
        return Fq2(self.u1 + self.u0, self.u0 - self.u1)

    def conjugate(self) -> "Fq2":
        return Fq2(-self.u1, self.u0)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Fq2):
            return NotImplemented
        return self.u1 == other.u1 and self.u0 == other.u0

    def __hash__(self):
        return hash((self.u1.e, self.u0.e))

    def __repr__(self):
        return f"Fq2(u1={self.u1.e}, u0={self.u0.e})"


class Fq6:
    """v0 + v1*w + v2*w^2 with w^3 = xi = 1 + u."""

    __slots__ = ("v2", "v1", "v0")

    def __init__(self, v2: Fq2, v1: Fq2, v0: Fq2):
        self.v2, self.v1, self.v0 = v2, v1, v0

    @staticmethod
    def from_int(n: int) -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.from_int(n))

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.one())

    def is_zero(self) -> bool:
        return self.v2.is_zero() and self.v1.is_zero() and self.v0.is_zero()

    def __add__(self, other: "Fq6"):
        return Fq6(self.v2 + other.v2, self.v1 + other.v1, self.v0 + other.v0)

    def __sub__(self, other: "Fq6"):
        return Fq6(self.v2 - other.v2, self.v1 - other.v1, self.v0 - other.v0)

    def __neg__(self):
        return Fq6.zero() - self

    def __mul__(self, other: "Fq6"):
        """Schoolbook with xi-folding of the w^3/w^4 terms (fq6.rs:148-171)."""
        t0 = self.v0 * other.v0
        t1 = self.v0 * other.v1 + self.v1 * other.v0
        t2 = self.v0 * other.v2 + self.v1 * other.v1 + self.v2 * other.v0
        t3 = (self.v1 * other.v2 + self.v2 * other.v1).reduce()
        t4 = (self.v2 * other.v2).reduce()
        return Fq6(t2, t1 + t4, t0 + t3)

    def inv(self) -> "Fq6":
        """(fq6.rs:23-38)."""
        t0 = self.v0 * self.v0 - (self.v1 * self.v2).reduce()
        t1 = (self.v2 * self.v2).reduce() - self.v0 * self.v1
        t2 = self.v1 * self.v1 - self.v0 * self.v2
        factor = (
            self.v0 * t0 + (self.v2 * t1).reduce() + (self.v1 * t2).reduce()
        ).inv()
        return Fq6(t2 * factor, t1 * factor, t0 * factor)

    def sq(self) -> "Fq6":
        return self * self

    def reduce(self) -> "Fq6":
        """Multiply by w: rotate with xi (fq6.rs:54-62)."""
        return Fq6(self.v1, self.v0, self.v2.reduce())

    def __eq__(self, other) -> bool:
        if not isinstance(other, Fq6):
            return NotImplemented
        return self.v2 == other.v2 and self.v1 == other.v1 and self.v0 == other.v0

    def __hash__(self):
        return hash((hash(self.v2), hash(self.v1), hash(self.v0)))

    def __repr__(self):
        return f"Fq6(v2={self.v2!r}, v1={self.v1!r}, v0={self.v0!r})"


class Fq12:
    """w0 + w1*z with z^2 = w."""

    __slots__ = ("w1", "w0")

    def __init__(self, w1: Fq6, w0: Fq6):
        self.w1, self.w0 = w1, w0

    @staticmethod
    def from_int(n: int) -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.from_int(n))

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.one())

    def is_zero(self) -> bool:
        return self.w1.is_zero() and self.w0.is_zero()

    def __add__(self, other: "Fq12"):
        return Fq12(self.w1 + other.w1, self.w0 + other.w0)

    def __sub__(self, other: "Fq12"):
        return Fq12(self.w1 - other.w1, self.w0 - other.w0)

    def __neg__(self):
        return Fq12.zero() - self

    def __mul__(self, other):
        if isinstance(other, int):
            other = Fq12.from_int(other)
        return Fq12(
            self.w1 * other.w0 + self.w0 * other.w1,
            self.w0 * other.w0 + (self.w1 * other.w1).reduce(),
        )

    __rmul__ = __mul__

    def inv(self) -> "Fq12":
        """(fq12.rs:31-40)."""
        factor = (self.w0 * self.w0 - (self.w1 * self.w1).reduce()).inv()
        return Fq12(-self.w1 * factor, self.w0 * factor)

    def __truediv__(self, other: "Fq12"):
        return self * other.inv()

    def sq(self) -> "Fq12":
        return self * self

    def pow(self, exp: int) -> "Fq12":
        """Square-and-multiply, LSB-first (fq12.rs:42-57)."""
        exp = int(exp)
        base = self
        acc = Fq12.one()
        while exp:
            if exp & 1:
                acc = acc * base
            base = base * base
            exp >>= 1
        return acc

    __pow__ = pow

    def conjugate(self) -> "Fq12":
        """z -> -z; equals the q^6 Frobenius, used by the fast final exp."""
        return Fq12(-self.w1, self.w0)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Fq12):
            return NotImplemented
        return self.w1 == other.w1 and self.w0 == other.w0

    def __hash__(self):
        return hash((hash(self.w1), hash(self.w0)))

    def __repr__(self):
        return f"Fq12(w1={self.w1!r}, w0={self.w0!r})"
