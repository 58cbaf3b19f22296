"""Groth16 over BLS12-381.

(The port's own copy of zk_toolkit_tpu/protocols/groth16.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/groth16/zktoolkit_based/ —
- Prover (prover.rs:35-148): frontend pipeline parse -> gates -> R1CSTmpl ->
  R1CS(validate) -> QAP; t, h = p/t; indices n, l, m (:36-46); `prove` with
  random r, s: A = alpha + sum a_i u_i(x)_1 + r*delta,
  B = beta + sum a_i v_i(x)_2 + s*delta (plus B in G1),
  C = sum_wit a_i uvw_i/delta + h(x)t(x)/delta + sA + rB_1 - rs*delta
  (:96-147).
- CRS (crs.rs:17-147): sigma = (alpha, beta, gamma, delta, x);
  uvw_stmt = (beta u_i + alpha v_i + w_i)/gamma for 0..l, uvw_wit = /delta
  for l+1..m; x^i powers in G1/G2; x^i t(x)/delta in G1; e(alpha_1, beta_2)
  precomputed in GT.
- Verifier (verifier.rs:31-56): e(A,B) == e(alpha,beta) *
  e(sum stmt_i uvw_stmt_i, gamma) * e(C, delta).
- Wires statement/witness split at l (wires.rs:13-49); Proof {A, B, C}
  (proof.rs:6-11).

All trapdoor/prover randomness is injectable (`rng=`) for reproducible tests.

Implementation note (identical outputs, better complexity): where the
reference runs one n-point MSM per wire (m+1 MSMs of the x-power hidings,
prover.rs:106-118), we first combine the QAP polynomials with the wire values
in the scalar field — u(X) = sum_i a_i u_i(X) — and then run a single MSM per
proof element. The resulting group elements are the same linear combinations.
The device Groth16 (protocols/groth16_device.py) runs those MSMs on the
card's Pippenger (ops/msm.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem
from zk_toolkit_tpu_torch.fields.polynomial import Polynomial
from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec
from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
from zk_toolkit_tpu_torch.curves.bls12_381.pairing import Pairing, GTPoint
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint
from zk_toolkit_tpu_torch.snark.equation_parser import EquationParser
from zk_toolkit_tpu_torch.snark import gate as gate_mod
from zk_toolkit_tpu_torch.snark.r1cs import R1CSTmpl, R1CS
from zk_toolkit_tpu_torch.snark.qap import QAP, build_t
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG


class Wires:
    """Statement/witness split at index l (wires.rs:13-49)."""

    def __init__(self, sv: SparseVec, l: int):
        self.sv = sv
        self.witness_beg = l + 1

    def statement(self) -> SparseVec:
        return self.sv.slice(0, self.witness_beg)

    def witness(self) -> SparseVec:
        return self.sv.slice(self.witness_beg, self.sv.size)

    def __getitem__(self, i: int) -> PrimeFieldElem:
        return self.sv.get(i)


@dataclass
class Proof:
    A: AffinePoint  # G1
    B: AffinePoint  # G2
    C: AffinePoint  # G1


class Prover:
    def __init__(self, f: PrimeField, expr: str, witness_map: dict):
        eq = EquationParser.parse(f, expr)
        gates = gate_mod.build(f, eq)
        tmpl = R1CSTmpl(f, gates)
        r1cs = R1CS.from_tmpl(f, tmpl, witness_map)
        r1cs.validate()
        qap = QAP.build(f, r1cs)

        self.f = f
        self.n = len(tmpl.constraints)
        self.l = tmpl.mid_beg - 1  # last statement index
        self.m = len(tmpl.witness) - 1  # last wire index
        self.t = build_t(f, self.n)
        p = qap.build_p(r1cs.witness)
        res = p.divide_by(self.t)
        if not res.is_exact:
            raise ValueError("p should be divisible by t")
        self.h = res.quotient
        self.wires = Wires(r1cs.witness, self.l)
        # reference naming: ui = qap.vi, vi = qap.wi, wi = qap.yi
        self.ui, self.vi, self.wi = qap.vi, qap.wi, qap.yi

    def _combined(self, polys) -> Polynomial:
        """sum_i wires[i] * polys[i] in the scalar field."""
        acc = Polynomial.zero(self.f)
        for i in range(self.m + 1):
            acc = acc + polys[i] * self.wires[i]
        return acc

    def prove(self, crs: "CRS", rng: Rng | None = None) -> Proof:
        rng = rng or GLOBAL_RNG
        f = self.f
        r = f.rand_elem(True, rng)
        s = f.rand_elem(True, rng)

        u_comb = self._combined(self.ui)
        v_comb = self._combined(self.vi)

        sum_a = u_comb.eval_with_g1_hidings(crs.g1_xi) if not u_comb.is_zero() else g1.infinity()
        sum_b = v_comb.eval_with_g2_hidings(crs.g2_xi) if not v_comb.is_zero() else g2.infinity()
        sum_b_g1 = v_comb.eval_with_g1_hidings(crs.g1_xi) if not v_comb.is_zero() else g1.infinity()

        A = crs.g1_alpha + sum_a + crs.g1_delta * r
        B = crs.g2_beta + sum_b + crs.g2_delta * s
        B_g1 = crs.g1_beta + sum_b_g1 + crs.g1_delta * s

        # C = sum_wit a_i uvw_wit_i + h(x)t(x)/delta + sA + rB_1 - rs*delta
        wit_beg = self.l + 1
        c_sum = g1.infinity()
        for i in range(wit_beg, self.m + 1):
            c_sum = c_sum + crs.g1_uvw_wit[i - wit_beg] * self.wires[i]
        ht_by_delta = self.h.eval_with_g1_hidings(crs.g1_xt_by_delta)
        C = c_sum + ht_by_delta + A * s + B_g1 * r + (-(crs.g1_delta * (r.e * s.e % f.order)))
        return Proof(A, B, C)


class CRS:
    """Trusted setup (crs.rs:49-146). Trapdoor randomness injectable."""

    def __init__(self, f: PrimeField, prover: Prover, pairing: Pairing, rng: Rng | None = None):
        rng = rng or GLOBAL_RNG
        g = g1.g()
        h = g2.g()
        alpha = f.rand_elem(True, rng)
        beta = f.rand_elem(True, rng)
        gamma = f.rand_elem(True, rng)
        delta = f.rand_elem(True, rng)
        x = f.rand_elem(True, rng)

        def uvw_div(from_i: int, to_i: int, div_factor: PrimeFieldElem):
            ys = []
            for i in range(from_i, to_i + 1):
                ui = beta * prover.ui[i].eval_at(x)
                vi = alpha * prover.vi[i].eval_at(x)
                wi = prover.wi[i].eval_at(x)
                ys.append(g * ((ui + vi + wi) * div_factor))
            return ys

        self.g1_uvw_stmt = uvw_div(0, prover.l, gamma.inv())
        self.g1_uvw_wit = uvw_div(prover.l + 1, prover.m, delta.inv())

        def n_pows(gen):
            ys, x_pow = [], f.one()
            for _ in range(prover.n):
                ys.append(gen * x_pow)
                x_pow = x_pow * x
            return ys

        self.g1_xi = n_pows(g)
        self.g2_xi = n_pows(h)

        t_at_x = build_t(f, prover.n).eval_at(x)
        delta_inv = delta.inv()
        self.g1_xt_by_delta = []
        x_pow = f.one()
        for _ in range(prover.n):
            self.g1_xt_by_delta.append(g * (x_pow * t_at_x * delta_inv))
            x_pow = x_pow * x

        self.g1_alpha = g * alpha
        self.g1_beta = g * beta
        self.g1_delta = g * delta
        self.g2_beta = h * beta
        self.g2_gamma = h * gamma
        self.g2_delta = h * delta
        self.gt_alpha_beta = pairing.tate(self.g1_alpha, self.g2_beta)


class Verifier:
    def __init__(self, pairing: Pairing):
        self.pairing = pairing

    def verify(self, proof: Proof, crs: CRS, stmt_wires: SparseVec) -> bool:
        """e(A,B) == e(alpha,beta) * e(sum stmt, gamma) * e(C, delta)
        (verifier.rs:31-56)."""
        e = self.pairing.tate
        lhs = e(proof.A, proof.B)
        sum_term = g1.infinity()
        for i in range(stmt_wires.size):
            sum_term = sum_term + crs.g1_uvw_stmt[i] * stmt_wires.get(i)
        rhs = crs.gt_alpha_beta * e(sum_term, crs.g2_gamma) * e(proof.C, crs.g2_delta)
        return lhs == rhs
