"""Dense univariate polynomial over a prime field, little-endian coefficient
order (coeffs[i] is the coefficient of x^i).

(The port's own copy of zk_toolkit_tpu/fields/polynomial.py;
the port imports nothing of the JAX package.)

Parity: reference field/polynomial.rs — `normalize` trims trailing zeros
(:139-152), add/sub/mul (:154-202), long division returning
Quotient / QuotientRemainder (:204-238), `eval_at` (:240-249),
`eval_from_1_to_n` (:251-262), MSM-shaped `eval_with_g1_hidings` /
`eval_with_g2_hidings` = sum_i c_i * P_i (:271-293), `to_sparse_vec`
(:295-303).

The device protocols run the MSM evaluations on ops/msm.py and the
interpolation and division through ops/ntt.py; this class is the exact
host model.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem


class DivResult:
    """Quotient or QuotientRemainder (polynomial.rs:204-238)."""

    def __init__(self, quotient: "Polynomial", remainder: "Polynomial | None"):
        self.quotient = quotient
        self.remainder = remainder  # None when division is exact

    @property
    def is_exact(self) -> bool:
        return self.remainder is None


class Polynomial:
    __slots__ = ("f", "coeffs")

    def __init__(self, f: PrimeField, coeffs: Iterable[PrimeFieldElem | int]):
        self.f = f
        cs = [f.elem(c) if isinstance(c, int) else c for c in coeffs]
        if not cs:
            cs = [f.zero()]
        self.coeffs = cs
        self._normalize()

    def _normalize(self) -> None:
        while len(self.coeffs) > 1 and self.coeffs[-1].is_zero():
            self.coeffs.pop()

    @staticmethod
    def zero(f: PrimeField) -> "Polynomial":
        return Polynomial(f, [f.zero()])

    def is_zero(self) -> bool:
        return len(self.coeffs) == 1 and self.coeffs[0].is_zero()

    def degree(self) -> int:
        return len(self.coeffs) - 1

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        z = self.f.zero()
        out = [
            (self.coeffs[i] if i < len(self.coeffs) else z)
            + (other.coeffs[i] if i < len(other.coeffs) else z)
            for i in range(n)
        ]
        return Polynomial(self.f, out)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        z = self.f.zero()
        out = [
            (self.coeffs[i] if i < len(self.coeffs) else z)
            - (other.coeffs[i] if i < len(other.coeffs) else z)
            for i in range(n)
        ]
        return Polynomial(self.f, out)

    def __mul__(self, other):
        if isinstance(other, PrimeFieldElem):
            return Polynomial(self.f, [c * other for c in self.coeffs])
        out = [self.f.zero()] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            if a.is_zero():
                continue
            for j, b in enumerate(other.coeffs):
                out[i + j] = out[i + j] + a * b
        return Polynomial(self.f, out)

    __rmul__ = __mul__

    def __neg__(self):
        return Polynomial(self.f, [-c for c in self.coeffs])

    def divide_by(self, divisor: "Polynomial") -> DivResult:
        """Long division (polynomial.rs:204-238)."""
        if divisor.is_zero():
            raise ZeroDivisionError("division by zero polynomial")
        rem = list(self.coeffs)
        dcs = divisor.coeffs
        dlead_inv = dcs[-1].inv()
        qlen = len(rem) - len(dcs) + 1
        if qlen <= 0:
            q = Polynomial.zero(self.f)
            r = Polynomial(self.f, rem)
            return DivResult(q, None if r.is_zero() else r)
        q = [self.f.zero()] * qlen
        for i in range(qlen - 1, -1, -1):
            c = rem[i + len(dcs) - 1] * dlead_inv
            q[i] = c
            if c.is_zero():
                continue
            for j, d in enumerate(dcs):
                rem[i + j] = rem[i + j] - c * d
        r = Polynomial(self.f, rem)
        return DivResult(Polynomial(self.f, q), None if r.is_zero() else r)

    # -- evaluation ---------------------------------------------------------
    def eval_at(self, x: PrimeFieldElem | int) -> PrimeFieldElem:
        x = self.f.elem(x) if isinstance(x, int) else x
        acc = self.f.zero()
        for c in reversed(self.coeffs):
            acc = acc * x + c
        return acc

    def eval_from_1_to_n(self, n: int) -> list[PrimeFieldElem]:
        """[p(1), ..., p(n)] (polynomial.rs:251-262)."""
        return [self.eval_at(self.f.elem(i)) for i in range(1, n + 1)]

    def eval_with_g1_hidings(self, powers):
        """MSM: sum_i coeffs[i] * powers[i] over G1 points
        (polynomial.rs:271-283). `powers` are hidings of x^i."""
        return self._eval_with_hidings(powers)

    def eval_with_g2_hidings(self, powers):
        """Same over G2 (polynomial.rs:284-293)."""
        return self._eval_with_hidings(powers)

    def _eval_with_hidings(self, powers: Sequence):
        if len(powers) < len(self.coeffs):
            raise ValueError("not enough powers for polynomial degree")
        acc = None
        for c, p in zip(self.coeffs, powers):
            term = p * c
            acc = term if acc is None else acc + term
        return acc

    def to_sparse_vec(self, size: int):
        """(polynomial.rs:295-303)."""
        from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec

        v = SparseVec(self.f, size)
        for i, c in enumerate(self.coeffs):
            v.set(i, c)
        return v

    def __eq__(self, other) -> bool:
        if not isinstance(other, Polynomial):
            return NotImplemented
        return self.coeffs == other.coeffs

    def __repr__(self):
        return f"Polynomial({[c.e for c in self.coeffs]})"
