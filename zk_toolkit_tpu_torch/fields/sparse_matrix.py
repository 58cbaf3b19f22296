"""Sparse matrix of field elements (row-major dict of SparseVec rows).

(The port's own copy of zk_toolkit_tpu/fields/sparse_matrix.py;
the port imports nothing of the JAX package.)

Parity: reference field/sparse_matrix.rs — `set`/`get` (:98-129),
`get_row`/`get_column` (:131-162), `transpose` (:164-177), `normalize` (drop
empty rows, :180-189), `row_transform` (:191-208), matrix multiply
(:283-309), per-row polynomial conversion (:242-253), construction from a
row list (:256-281), `multiply_column`, `flatten_rows` (:61-96).
"""

from __future__ import annotations

from typing import Callable, Sequence

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem
from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec, _idx


class SparseMatrix:
    __slots__ = ("f", "width", "height", "rows")

    def __init__(self, f: PrimeField, width, height):
        self.f = f
        self.width = _idx(width)
        self.height = _idx(height)
        self.rows: dict[int, SparseVec] = {}

    @staticmethod
    def from_rows(rows: Sequence[SparseVec]) -> "SparseMatrix":
        """(sparse_matrix.rs:256-281)."""
        if not rows:
            raise ValueError("empty row list")
        f = rows[0].f
        width = rows[0].size
        m = SparseMatrix(f, width, len(rows))
        for y, row in enumerate(rows):
            if row.size != width:
                raise ValueError("ragged rows")
            for x, v in row:
                m.set(x, y, v)
        return m

    def set(self, x, y, v) -> None:
        x, y = _idx(x), _idx(y)
        if x >= self.width or y >= self.height:
            raise IndexError(f"({x},{y}) out of range {self.width}x{self.height}")
        v = self.f.elem(v) if isinstance(v, int) else v
        if v.is_zero():
            if y in self.rows:
                self.rows[y].set(x, v)
            return
        if y not in self.rows:
            self.rows[y] = SparseVec(self.f, self.width)
        self.rows[y].set(x, v)

    def get(self, x, y) -> PrimeFieldElem:
        x, y = _idx(x), _idx(y)
        if x >= self.width or y >= self.height:
            raise IndexError(f"({x},{y}) out of range {self.width}x{self.height}")
        if y not in self.rows:
            return self.f.zero()
        return self.rows[y].get(x)

    def get_row(self, y) -> SparseVec:
        y = _idx(y)
        if y in self.rows:
            out = SparseVec(self.f, self.width)
            for x, v in self.rows[y]:
                out.set(x, v)
            return out
        return SparseVec(self.f, self.width)

    def get_column(self, x) -> SparseVec:
        x = _idx(x)
        out = SparseVec(self.f, self.height)
        for y, row in self.rows.items():
            v = row.get(x)
            if not v.is_zero():
                out.set(y, v)
        return out

    def transpose(self) -> "SparseMatrix":
        out = SparseMatrix(self.f, self.height, self.width)
        for y, row in self.rows.items():
            for x, v in row:
                out.set(y, x, v)
        return out

    def normalize(self) -> "SparseMatrix":
        """Drop empty rows (sparse_matrix.rs:180-189); width preserved,
        height shrinks to the number of non-empty rows."""
        live = [self.rows[y] for y in sorted(self.rows) if self.rows[y].entries]
        if not live:
            return SparseMatrix(self.f, self.width, 0)
        return SparseMatrix.from_rows(live)

    def row_transform(self, fn: Callable[[SparseVec], SparseVec]) -> "SparseMatrix":
        """Apply fn to every row (sparse_matrix.rs:191-208)."""
        out = SparseMatrix(self.f, self.width, self.height)
        for y in range(self.height):
            new_row = fn(self.get_row(y))
            for x, v in new_row:
                out.set(x, y, v)
        return out

    def multiply_column(self, col: SparseVec) -> "SparseMatrix":
        """Scale row y by col[y]."""
        if col.size != self.height:
            raise ValueError("size mismatch")
        out = SparseMatrix(self.f, self.width, self.height)
        for y, row in self.rows.items():
            s = col.get(y)
            for x, v in row:
                out.set(x, y, v * s)
        return out

    def flatten_rows(self) -> SparseVec:
        """Concatenate all rows into one vector (sparse_matrix.rs:61-96)."""
        out = SparseVec(self.f, self.width * self.height)
        for y, row in self.rows.items():
            for x, v in row:
                out.set(y * self.width + x, v)
        return out

    def __mul__(self, other):
        if isinstance(other, SparseMatrix):
            if self.width != other.height:
                raise ValueError("dimension mismatch")
            out = SparseMatrix(self.f, other.width, self.height)
            ot = other.transpose()
            for y, row in self.rows.items():
                for x in range(other.width):
                    v = row.inner_prod(ot.get_row(x))
                    if not v.is_zero():
                        out.set(x, y, v)
            return out
        if isinstance(other, SparseVec):
            # matrix-vector product -> SparseVec of length height
            if self.width != other.size:
                raise ValueError("dimension mismatch")
            out = SparseVec(self.f, self.height)
            for y, row in self.rows.items():
                v = row.inner_prod(other)
                if not v.is_zero():
                    out.set(y, v)
            return out
        return NotImplemented

    def __eq__(self, other) -> bool:
        if not isinstance(other, SparseMatrix):
            return NotImplemented
        if (self.width, self.height) != (other.width, other.height):
            return False
        ys = set(self.rows) | set(other.rows)
        return all(self.get_row(y) == other.get_row(y) for y in ys)

    def __repr__(self):
        lines = [f"SparseMatrix {self.width}x{self.height}"]
        for y in sorted(self.rows):
            lines.append(f"  row {y}: {self.rows[y]!r}")
        return "\n".join(lines)

    def to_polynomials(self) -> list:
        """Each row interpreted as little-endian polynomial coefficients
        (sparse_matrix.rs:242-253)."""
        from zk_toolkit_tpu_torch.fields.polynomial import Polynomial

        return [Polynomial(self.f, self.get_row(y).to_dense()) for y in range(self.height)]
