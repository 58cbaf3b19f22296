"""R1CS -> QAP: per-witness-column Lagrange interpolation polynomials.

(The port's own copy of zk_toolkit_tpu/snark/qap.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/qap/qap.rs — `build_polynomial` O(n^2)
Lagrange interpolation through points (x = 1..n_constraints, value)
(:33-97), `build_t` = prod_i (x - i) (:115-135), `build_p` =
(sum w_i v_i)(sum w_i w_i) - (sum w_i y_i) (:99-112), `build` transposing
the constraint matrices (:137-203), `is_valid` checking t | p (:205-217).

For large circuits the device tier replaces the O(n^2) interpolation with a
radix-2 NTT over BLS12-381 Fr (zk_toolkit_tpu_torch.ops.ntt — the reference's
2-adicity-32 subgroup makes the power-of-two evaluation domain available);
this host implementation keeps the reference's x = 1..n evaluation domain
for bit-exact small-circuit tests.
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField
from zk_toolkit_tpu_torch.fields.polynomial import Polynomial
from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec
from zk_toolkit_tpu_torch.snark.r1cs import R1CS


def build_polynomial(f: PrimeField, target_vals: SparseVec) -> Polynomial:
    """Lagrange interpolation through (x=i+1, target_vals[i]) for
    i in 0..size (qap.rs:33-97)."""
    n = target_vals.size
    parts = []
    for target_x in range(1, n + 1):
        target_val = target_vals.get(target_x - 1)
        if target_val.is_zero():
            parts.append(Polynomial.zero(f))
            continue
        acc = Polynomial(f, [target_val])
        denominator = f.one()
        for i in range(1, n + 1):
            if i == target_x:
                continue
            acc = acc * Polynomial(f, [f.elem_from_signed(-i), f.one()])
            denominator = denominator * f.elem_from_signed(target_x - i)
        acc = acc * Polynomial(f, [denominator.inv()])
        parts.append(acc)
    res = parts[0]
    for p in parts[1:]:
        res = res + p
    return res


def build_t(f: PrimeField, num_constraints: int) -> Polynomial:
    """Vanishing polynomial (x-1)(x-2)...(x-n) (qap.rs:115-135)."""
    acc = Polynomial(f, [f.one()])
    for i in range(1, num_constraints + 1):
        acc = acc * Polynomial(f, [f.elem_from_signed(-i), f.one()])
    return acc


class QAP:
    def __init__(self, f: PrimeField, vi, wi, yi, num_constraints: int):
        self.f = f
        self.vi, self.wi, self.yi = vi, wi, yi
        self.num_constraints = num_constraints

    @staticmethod
    def build(f: PrimeField, r1cs: R1CS) -> "QAP":
        """(qap.rs:137-203)."""
        a, b, c = r1cs.to_constraint_matrices()
        at, bt, ct = a.transpose(), b.transpose(), c.transpose()
        vi, wi, yi = [], [], []
        for i in range(r1cs.witness.size):
            vi.append(build_polynomial(f, at.get_row(i)))
            wi.append(build_polynomial(f, bt.get_row(i)))
            yi.append(build_polynomial(f, ct.get_row(i)))
        return QAP(f, vi, wi, yi, a.height)

    def build_p(self, witness: SparseVec) -> Polynomial:
        """(v.w)(w.w) - y.w as polynomials (qap.rs:99-112)."""
        v = Polynomial.zero(self.f)
        w = Polynomial.zero(self.f)
        y = Polynomial.zero(self.f)
        for i in range(witness.size):
            wit = witness.get(i)
            v = v + self.vi[i] * wit
            w = w + self.wi[i] * wit
            y = y + self.yi[i] * wit
        return (v * w) - y

    def is_valid(self, witness: SparseVec, num_constraints: int) -> bool:
        t = build_t(self.f, num_constraints)
        p = self.build_p(witness)
        return p.divide_by(t).is_exact
