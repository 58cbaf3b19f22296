"""Sparse vector of field elements.

(The port's own copy of zk_toolkit_tpu/fields/sparse_vec.py;
the port imports nothing of the JAX package.)

Parity: reference field/sparse_vec.rs — `set` drops zero values (:70-79),
`get` returns zero for unset indices (:81-91), `sum`, `slice`, `concat`,
Hadamard `Mul` (:261-279), and iteration (:33-50). The reference indexes by
field elements; we accept ints or `PrimeFieldElem`s and key by int.
"""

from __future__ import annotations

from typing import Iterable

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem


def _idx(i) -> int:
    return i.e if isinstance(i, PrimeFieldElem) else int(i)


class SparseVec:
    __slots__ = ("f", "size", "entries")

    def __init__(self, f: PrimeField, size: int):
        self.f = f
        self.size = _idx(size)
        self.entries: dict[int, PrimeFieldElem] = {}

    def set(self, i, v) -> None:
        i = _idx(i)
        if i >= self.size:
            raise IndexError(f"index {i} out of range for size {self.size}")
        v = self.f.elem(v) if isinstance(v, int) else v
        if v.is_zero():
            self.entries.pop(i, None)
        else:
            self.entries[i] = v

    def get(self, i) -> PrimeFieldElem:
        i = _idx(i)
        if i >= self.size:
            raise IndexError(f"index {i} out of range for size {self.size}")
        return self.entries.get(i, self.f.zero())

    __setitem__ = set
    __getitem__ = get

    def indices(self) -> list[int]:
        return sorted(self.entries)

    def __iter__(self):
        """Yields (index, value) for non-zero entries, ascending index."""
        for i in self.indices():
            yield i, self.entries[i]

    def sum(self) -> PrimeFieldElem:
        acc = self.f.zero()
        for v in self.entries.values():
            acc = acc + v
        return acc

    def slice(self, start, end) -> "SparseVec":
        """Elements [start, end) re-indexed from 0."""
        start, end = _idx(start), _idx(end)
        out = SparseVec(self.f, end - start)
        for i, v in self.entries.items():
            if start <= i < end:
                out.set(i - start, v)
        return out

    def concat(self, other: "SparseVec") -> "SparseVec":
        out = SparseVec(self.f, self.size + other.size)
        for i, v in self.entries.items():
            out.set(i, v)
        for i, v in other.entries.items():
            out.set(self.size + i, v)
        return out

    def __mul__(self, other):
        """Hadamard product (sparse_vec.rs:261-279) or scalar mul."""
        if isinstance(other, SparseVec):
            if other.size != self.size:
                raise ValueError("size mismatch")
            out = SparseVec(self.f, self.size)
            for i, v in self.entries.items():
                if i in other.entries:
                    out.set(i, v * other.entries[i])
            return out
        s = self.f.elem(other) if isinstance(other, int) else other
        out = SparseVec(self.f, self.size)
        for i, v in self.entries.items():
            out.set(i, v * s)
        return out

    __rmul__ = __mul__

    def __add__(self, other: "SparseVec") -> "SparseVec":
        if other.size != self.size:
            raise ValueError("size mismatch")
        out = SparseVec(self.f, self.size)
        for i in set(self.entries) | set(other.entries):
            out.set(i, self.get(i) + other.get(i))
        return out

    def __sub__(self, other: "SparseVec") -> "SparseVec":
        if other.size != self.size:
            raise ValueError("size mismatch")
        out = SparseVec(self.f, self.size)
        for i in set(self.entries) | set(other.entries):
            out.set(i, self.get(i) - other.get(i))
        return out

    def inner_prod(self, other: "SparseVec") -> PrimeFieldElem:
        return (self * other).sum()

    def to_dense(self) -> list[PrimeFieldElem]:
        return [self.get(i) for i in range(self.size)]

    @staticmethod
    def from_dense(f: PrimeField, values: Iterable) -> "SparseVec":
        values = list(values)
        out = SparseVec(f, len(values))
        for i, v in enumerate(values):
            out.set(i, f.elem(v) if isinstance(v, int) else v)
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, SparseVec):
            return NotImplemented
        return self.size == other.size and self.entries == other.entries

    def __repr__(self):
        return f"SparseVec(size={self.size}, {{{', '.join(f'{i}: {v.e}' for i, v in self)}}})"
