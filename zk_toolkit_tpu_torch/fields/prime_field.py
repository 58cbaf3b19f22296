"""Host-tier prime field: exact Python-int arithmetic.

(The port's own copy of zk_toolkit_tpu/fields/prime_field.py;
the port imports nothing of the JAX package.)

Behavioral parity with the reference's field layer
(reference: building_block/field/prime_field.rs:15-105,
prime_field_elem.rs:33-457, prime_field_elems.rs:9-174): a `PrimeField` is
just the order; `PrimeFieldElem` carries (field, value) with full operator
overloading; `PrimeFieldElems` adds elementwise vector ops used by
Bulletproofs.

This tier is the control-flow / oracle layer. Throughput-critical batched
field arithmetic lives in the device tier (`zk_toolkit_tpu_torch.ops.field_ops`),
which is differentially tested against this implementation.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG


class PrimeField:
    """A prime field, represented by its order.

    Reference parity: `PrimeField` (prime_field.rs:15-18) plus its factories
    `elem` / `elem_from_signed` (:40-54), `rand_elem` (:73-85),
    `first_n_powers_of_x` (:62-70), `seq` (:92-104).
    """

    __slots__ = ("order",)

    def __init__(self, order: int):
        if order < 2:
            raise ValueError("field order must be >= 2")
        self.order = int(order)

    # -- factories ----------------------------------------------------------
    def elem(self, v: int | "PrimeFieldElem") -> "PrimeFieldElem":
        if isinstance(v, PrimeFieldElem):
            v = v.e
        return PrimeFieldElem(self, int(v) % self.order)

    def elem_from_signed(self, v: int) -> "PrimeFieldElem":
        return PrimeFieldElem(self, int(v) % self.order)

    def zero(self) -> "PrimeFieldElem":
        return PrimeFieldElem(self, 0)

    def one(self) -> "PrimeFieldElem":
        return PrimeFieldElem(self, 1 % self.order)

    def rand_elem(self, exclude_zero: bool = False, rng: Rng | None = None) -> "PrimeFieldElem":
        rng = rng or GLOBAL_RNG
        lo = 1 if exclude_zero else 0
        return PrimeFieldElem(self, rng.randint(lo, self.order - 1))

    def rand_elems(self, n: int, exclude_zero: bool = False, rng: Rng | None = None) -> "PrimeFieldElems":
        return PrimeFieldElems([self.rand_elem(exclude_zero, rng) for _ in range(n)])

    def first_n_powers_of_x(self, x: int | "PrimeFieldElem", n: int) -> "PrimeFieldElems":
        """[x^0, x^1, ..., x^(n-1)] (prime_field.rs:62-70)."""
        x = self.elem(x)
        out, acc = [], self.one()
        for _ in range(n):
            out.append(acc)
            acc = acc * x
        return PrimeFieldElems(out)

    def seq(self, start: int, n: int) -> "PrimeFieldElems":
        """[start, start+1, ..., start+n-1] (prime_field.rs:92-104)."""
        return PrimeFieldElems([self.elem_from_signed(start + i) for i in range(n)])

    # -- dunder -------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return isinstance(other, PrimeField) and self.order == other.order

    def __hash__(self) -> int:
        return hash(("PrimeField", self.order))

    def __repr__(self) -> str:
        return f"PrimeField({self.order})"


class PrimeFieldElem:
    """A scalar mod p. Reference parity: `PrimeFieldElem`
    (prime_field_elem.rs:33-37) with `plus/minus/times` (:278-308), `pow`
    (:311-328), `sq`/`cube` (:330-344), `safe_inv` via inverse (:379-432),
    `negate` (:448-457), `pow_seq`/`repeat` (:346-376).

    The reference's `Rem` operator is miswired to addition and unused
    (prime_field_elem.rs:190-209, SURVEY.md §7 quirk list); we implement `%`
    correctly and do not reproduce the bug.
    """

    __slots__ = ("f", "e")

    def __init__(self, f: PrimeField, e: int):
        self.f = f
        self.e = int(e) % f.order

    # -- arithmetic ---------------------------------------------------------
    def _coerce(self, other) -> "PrimeFieldElem":
        if isinstance(other, PrimeFieldElem):
            if other.f.order != self.f.order:
                raise ValueError("mismatched fields")
            return other
        if isinstance(other, int):
            return self.f.elem_from_signed(other)
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return PrimeFieldElem(self.f, self.e + o.e)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return PrimeFieldElem(self.f, self.e - o.e)

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return PrimeFieldElem(self.f, o.e - self.e)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return PrimeFieldElem(self.f, self.e * o.e)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return self * o.inv()

    def __rtruediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return o
        return o * self.inv()

    def __neg__(self):
        return PrimeFieldElem(self.f, -self.e)

    def negate(self):
        return -self

    def __pow__(self, exp):
        e = exp.e if isinstance(exp, PrimeFieldElem) else int(exp)
        return PrimeFieldElem(self.f, pow(self.e, e, self.f.order))

    def pow(self, exp):
        return self ** exp

    def sq(self):
        return self * self

    def cube(self):
        return self * self * self

    def inv(self) -> "PrimeFieldElem":
        """Modular inverse; raises ZeroDivisionError on zero
        (reference `safe_inv` returns Err, prime_field_elem.rs:379-382)."""
        if self.e == 0:
            raise ZeroDivisionError("inverse of zero field element")
        return PrimeFieldElem(self.f, pow(self.e, -1, self.f.order))

    def safe_inv(self) -> "PrimeFieldElem":
        return self.inv()

    def pow_seq(self, n: int) -> "PrimeFieldElems":
        """[self^0, ..., self^(n-1)] (prime_field_elem.rs:346-360)."""
        return self.f.first_n_powers_of_x(self, n)

    def repeat(self, n: int) -> "PrimeFieldElems":
        """[self] * n (prime_field_elem.rs:362-376)."""
        return PrimeFieldElems([self] * n)

    # -- predicates / misc --------------------------------------------------
    def is_zero(self) -> bool:
        return self.e == 0

    def __eq__(self, other) -> bool:
        if isinstance(other, PrimeFieldElem):
            return self.f.order == other.f.order and self.e == other.e
        if isinstance(other, int):
            return self.e == other % self.f.order
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.f.order, self.e))

    def __lt__(self, other):
        return self.e < self._coerce(other).e

    def __le__(self, other):
        return self.e <= self._coerce(other).e

    def __gt__(self, other):
        return self.e > self._coerce(other).e

    def __ge__(self, other):
        return self.e >= self._coerce(other).e

    def __int__(self) -> int:
        return self.e

    def __repr__(self) -> str:
        return f"{self.e}"

    def to_bytes_be(self, length: int | None = None) -> bytes:
        length = length or (self.f.order.bit_length() + 7) // 8
        return self.e.to_bytes(length, "big")


class PrimeFieldElems:
    """Vector of field elements with elementwise ops
    (reference: prime_field_elems.rs:30-174). Used heavily by Bulletproofs."""

    __slots__ = ("elems",)

    def __init__(self, elems: Iterable[PrimeFieldElem]):
        self.elems = list(elems)
        if not self.elems:
            raise ValueError("empty PrimeFieldElems")

    @property
    def f(self) -> PrimeField:
        return self.elems[0].f

    def __len__(self) -> int:
        return len(self.elems)

    def __iter__(self):
        return iter(self.elems)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PrimeFieldElems(self.elems[i])
        return self.elems[i]

    def sum(self) -> PrimeFieldElem:
        acc = self.f.zero()
        for e in self.elems:
            acc = acc + e
        return acc

    def from_(self, idx: int) -> "PrimeFieldElems":
        """Suffix starting at idx (prime_field_elems.rs `from`)."""
        return PrimeFieldElems(self.elems[idx:])

    def to(self, idx: int) -> "PrimeFieldElems":
        """Prefix of length idx (prime_field_elems.rs `to`)."""
        return PrimeFieldElems(self.elems[:idx])

    def _zip(self, other) -> Sequence[tuple[PrimeFieldElem, PrimeFieldElem]]:
        if isinstance(other, PrimeFieldElems):
            if len(other) != len(self):
                raise ValueError("length mismatch")
            return list(zip(self.elems, other.elems))
        o = self.elems[0]._coerce(other)
        return [(e, o) for e in self.elems]

    def __add__(self, other):
        return PrimeFieldElems([a + b for a, b in self._zip(other)])

    def __sub__(self, other):
        return PrimeFieldElems([a - b for a, b in self._zip(other)])

    def __mul__(self, other):
        """Hadamard product (vector) or scalar product."""
        return PrimeFieldElems([a * b for a, b in self._zip(other)])

    __rmul__ = __mul__

    def inner_prod(self, other: "PrimeFieldElems") -> PrimeFieldElem:
        return (self * other).sum()

    def __eq__(self, other) -> bool:
        if not isinstance(other, PrimeFieldElems):
            return NotImplemented
        return len(self) == len(other) and all(a == b for a, b in zip(self.elems, other.elems))

    def __repr__(self) -> str:
        return f"PrimeFieldElems({self.elems})"
