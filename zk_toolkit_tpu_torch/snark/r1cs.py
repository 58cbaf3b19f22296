"""R1CS template (wire layout + symbolic constraints) and witness-bound R1CS.

(The port's own copy of zk_toolkit_tpu/snark/r1cs.py;
the port imports nothing of the JAX package.)

Parity:
- R1CSTmpl (reference zk/w_trusted_setup/qap/r1cs_tmpl.rs:13-137): witness
  layout [1, inputs..., Out, mid...] (:22-51), term classification (:53-69;
  inputs in first-appearance order, TmpVars to mid), per-gate sparse a/b/c
  rows with Num mapping to a coefficient on index 0 (:71-127).
- Constraint {a,b,c} triple (qap/constraint.rs:4-17).
- R1CS (qap/r1cs.rs:15-125): bind witness values (:38-58), `validate`
  checking <a,w> * <b,w> = <c,w> per constraint (:61-74), and constraint
  matrix export (:108-124).
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem
from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec
from zk_toolkit_tpu_torch.fields.sparse_matrix import SparseMatrix
from zk_toolkit_tpu_torch.snark import term as T
from zk_toolkit_tpu_torch.snark.gate import Gate


@dataclass
class Constraint:
    a: SparseVec
    b: SparseVec
    c: SparseVec


class R1CSValidationError(ValueError):
    pass


class R1CSTmpl:
    def __init__(self, f: PrimeField, gates: list[Gate]):
        self.f = f
        self.witness: list[T.Term] = [T.One()]
        self.indices: dict[T.Term, int] = {T.One(): 0}

        inputs: list[T.Term] = []
        mid: list[T.Term] = []
        for gate in gates:
            for t in (gate.a, gate.b, gate.c):
                self._categorize(t, inputs, mid)

        # witness layout: [1, inputs..., Out, mid...] (r1cs_tmpl.rs:22-51)
        i = 1
        for x in inputs:
            self.witness.append(x)
            self.indices[x] = i
            i += 1
        self.witness.append(T.Out())
        self.indices[T.Out()] = i
        i += 1
        self.mid_beg = i
        for x in mid:
            self.witness.append(x)
            self.indices[x] = i
            i += 1

        n = len(self.witness)
        self.constraints: list[Constraint] = []
        for gate in gates:
            a = SparseVec(f, n)
            self._build_constraint_vec(a, gate.a)
            b = SparseVec(f, n)
            self._build_constraint_vec(b, gate.b)
            c = SparseVec(f, n)
            self._build_constraint_vec(c, gate.c)
            self.constraints.append(Constraint(a, b, c))

    @staticmethod
    def _categorize(t: T.Term, inputs: list[T.Term], mid: list[T.Term]) -> None:
        """(r1cs_tmpl.rs:53-69)."""
        if isinstance(t, (T.One, T.Num, T.Out)):
            return
        if isinstance(t, T.Var):
            if t not in inputs:
                inputs.append(t)
        elif isinstance(t, T.TmpVar):
            if t not in mid:
                mid.append(t)
        elif isinstance(t, T.Sum):
            R1CSTmpl._categorize(t.a, inputs, mid)
            R1CSTmpl._categorize(t.b, inputs, mid)

    def _build_constraint_vec(self, vec: SparseVec, term: T.Term) -> None:
        """(r1cs_tmpl.rs:71-127)."""
        if isinstance(term, T.Sum):
            self._build_constraint_vec(vec, term.a)
            self._build_constraint_vec(vec, term.b)
        elif isinstance(term, T.Num):
            vec.set(0, term.n)  # Num = n * One at index 0
        else:
            vec.set(self.indices[term], 1)


class R1CS:
    def __init__(self, constraints: list[Constraint], witness: SparseVec, mid_beg: int):
        self.constraints = constraints
        self.witness = witness
        self.mid_beg = mid_beg

    @staticmethod
    def from_tmpl(
        f: PrimeField, tmpl: R1CSTmpl, witness_instance: dict[T.Term, PrimeFieldElem]
    ) -> "R1CS":
        witness = SparseVec(f, len(tmpl.witness))
        for i, term in enumerate(tmpl.witness):
            if term not in witness_instance:
                raise R1CSValidationError(f"'{term!r}' is missing in witness_instance")
            witness.set(i, witness_instance[term])
        return R1CS(list(tmpl.constraints), witness, tmpl.mid_beg)

    def validate(self) -> None:
        """Check <a,w> * <b,w> = <c,w> per constraint (r1cs.rs:61-74)."""
        for constraint in self.constraints:
            a = (constraint.a * self.witness).sum()
            b = (constraint.b * self.witness).sum()
            c = (constraint.c * self.witness).sum()
            if a * b != c:
                raise R1CSValidationError(
                    f"Constraint a ({a!r}) * b ({b!r}) = c ({c!r}) doesn't hold"
                )

    def to_constraint_matrices(self) -> tuple[SparseMatrix, SparseMatrix, SparseMatrix]:
        """(r1cs.rs:108-124)."""
        a = SparseMatrix.from_rows([c.a for c in self.constraints])
        b = SparseMatrix.from_rows([c.b for c in self.constraints])
        c = SparseMatrix.from_rows([c_.c for c_ in self.constraints])
        return a, b, c
