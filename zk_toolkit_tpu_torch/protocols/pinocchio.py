"""Pinocchio ("protocol 2", GGPR'13 page 5) over BLS12-381.

(The port's own copy of zk_toolkit_tpu/protocols/pinocchio.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/pinocchio/ —
- Prover (prover.rs:37-171): frontend pipeline, max_degree = max poly degree
  + 1 (:65-79), `prove` randomizing v and y with delta_v*t, delta_y*t,
  accumulating the 9 proof group elements over the mid witness, and h(s) via
  G2 MSM with the adjustment h + delta_v*w - delta_y (:96-170).
- CRS (crs.rs:46-159): trapdoor (r_v, r_w, alpha_v, alpha_w, alpha_y, beta,
  gamma, s) with r_y = r_v*r_w; evaluation keys over mid indices and
  verification keys over io indices.
- Verifier (verifier.rs:31-86): three pairing-equation groups — KC of
  beta(v+w+y) vs gamma, alpha-consistency of v/w/y, QAP divisibility
  e(v_s, w_s) = e(t, h) * e(y_s, 1) with io re-aggregation.
- Proof 9-element struct (proof.rs:8-19); Witness io/mid split at mid_beg
  (witness.rs:6-31).
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem
from zk_toolkit_tpu_torch.fields.polynomial import Polynomial
from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec
from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
from zk_toolkit_tpu_torch.curves.bls12_381.pairing import Pairing
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint
from zk_toolkit_tpu_torch.snark.equation_parser import EquationParser
from zk_toolkit_tpu_torch.snark import gate as gate_mod
from zk_toolkit_tpu_torch.snark.r1cs import R1CSTmpl, R1CS
from zk_toolkit_tpu_torch.snark.qap import QAP, build_t
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG


class Witness:
    """io/mid split at mid_beg (witness.rs:6-31)."""

    def __init__(self, sv: SparseVec, mid_beg: int):
        self.sv = sv
        self.mid_beg = mid_beg

    def io(self) -> SparseVec:
        return self.sv.slice(0, self.mid_beg)

    def mid(self) -> SparseVec:
        return self.sv.slice(self.mid_beg, self.sv.size)


@dataclass
class Proof:
    v_mid_s: AffinePoint       # G1
    g1_w_mid_s: AffinePoint    # G1
    g2_w_mid_s: AffinePoint    # G2
    y_mid_s: AffinePoint       # G1
    h_s: AffinePoint           # G2
    alpha_v_mid_s: AffinePoint # G1
    alpha_w_mid_s: AffinePoint # G1
    alpha_y_mid_s: AffinePoint # G1
    beta_vwy_mid_s: AffinePoint  # G1


class Prover:
    def __init__(self, f: PrimeField, expr: str, witness_map: dict):
        eq = EquationParser.parse(f, expr)
        gates = gate_mod.build(f, eq)
        tmpl = R1CSTmpl(f, gates)
        r1cs = R1CS.from_tmpl(f, tmpl, witness_map)
        r1cs.validate()
        qap = QAP.build(f, r1cs)

        self.f = f
        self.num_constraints = len(tmpl.constraints)
        self.t = build_t(f, self.num_constraints)
        self.p = qap.build_p(r1cs.witness)
        degrees = [poly.degree() for poly in qap.vi + qap.wi + qap.yi] + [
            self.p.degree(), self.t.degree()
        ]
        self.max_degree = max(degrees) + 1
        self.witness = Witness(r1cs.witness, tmpl.mid_beg)
        self.vi, self.wi, self.yi = qap.vi, qap.wi, qap.yi

    def prove(self, crs: "CRS", rng: Rng | None = None) -> Proof:
        rng = rng or GLOBAL_RNG
        f = self.f
        witness_mid = self.witness.mid()
        ek, vk = crs.ek, crs.vk
        delta_v = f.rand_elem(True, rng)
        delta_y = f.rand_elem(True, rng)

        # randomize v and y with multiples of t(s); h adjusted to
        # h + delta_v*w - delta_y (prover.rs:100-123)
        v_mid_s = vk["t"] * delta_v
        g1_w_mid_s = g1.infinity()
        g2_w_mid_s = g2.infinity()
        y_mid_s = vk["t"] * delta_y
        alpha_v_mid_s = vk["alpha_v_t"] * delta_v
        alpha_w_mid_s = g1.infinity()
        alpha_y_mid_s = vk["alpha_y_t"] * delta_y
        beta_vwy_mid_s = vk["beta_t"] * delta_v + vk["beta_t"] * delta_y

        for i in range(witness_mid.size):
            w = witness_mid.get(i)
            v_mid_s = v_mid_s + ek["vk_mid"][i] * w
            g1_w_mid_s = g1_w_mid_s + ek["g1_wk_mid"][i] * w
            g2_w_mid_s = g2_w_mid_s + ek["g2_wk_mid"][i] * w
            y_mid_s = y_mid_s + ek["yk_mid"][i] * w
            alpha_v_mid_s = alpha_v_mid_s + ek["alpha_vk_mid"][i] * w
            alpha_w_mid_s = alpha_w_mid_s + ek["alpha_wk_mid"][i] * w
            alpha_y_mid_s = alpha_y_mid_s + ek["alpha_yk_mid"][i] * w
            beta_vwy_mid_s = beta_vwy_mid_s + ek["beta_vwy_k_mid"][i] * w

        res = self.p.divide_by(self.t)
        if not res.is_exact:
            raise ValueError("p should be divisible by t")
        h_s = res.quotient.eval_with_g2_hidings(ek["si"])
        witness_io = self.witness.io()
        w_s = g2_w_mid_s
        for i in range(len(vk["wk_io"])):
            w_s = w_s + vk["wk_io"][i] * witness_io.get(i)
        adj_h_s = h_s + w_s * delta_v + (-(vk["one_g2"] * delta_y))

        return Proof(
            v_mid_s, g1_w_mid_s, g2_w_mid_s, y_mid_s, adj_h_s,
            alpha_v_mid_s, alpha_w_mid_s, alpha_y_mid_s, beta_vwy_mid_s,
        )


class CRS:
    def __init__(self, f: PrimeField, p: Prover, rng: Rng | None = None):
        rng = rng or GLOBAL_RNG
        g1g, g2g = g1.g(), g2.g()
        r_v = f.rand_elem(True, rng)
        r_w = f.rand_elem(True, rng)
        alpha_v = f.rand_elem(True, rng)
        alpha_w = f.rand_elem(True, rng)
        alpha_y = f.rand_elem(True, rng)
        beta = f.rand_elem(True, rng)
        gamma = f.rand_elem(True, rng)
        r_y = r_v * r_w
        g1_v = g1g * r_v
        g1_w = g1g * r_w
        g2_w = g2g * r_w
        g1_y = g1g * r_y

        mid_beg = p.witness.mid_beg
        end = p.witness.sv.size - 1
        mid = list(range(mid_beg, end + 1))
        io = list(range(mid_beg))
        s = f.rand_elem(True, rng)

        vs = {i: p.vi[i].eval_at(s) for i in range(end + 1)}
        ws = {i: p.wi[i].eval_at(s) for i in range(end + 1)}
        ys = {i: p.yi[i].eval_at(s) for i in range(end + 1)}

        self.ek = {
            "vk_mid": [g1_v * vs[i] for i in mid],
            "g1_wk_mid": [g1_w * ws[i] for i in mid],
            "g2_wk_mid": [g2_w * ws[i] for i in mid],
            "yk_mid": [g1_y * ys[i] for i in mid],
            "alpha_vk_mid": [g1_v * (alpha_v * vs[i]) for i in mid],
            "alpha_wk_mid": [g1_w * (alpha_w * ws[i]) for i in mid],
            "alpha_yk_mid": [g1_y * (alpha_y * ys[i]) for i in mid],
            "si": [g2g * (s ** i) for i in range(p.max_degree)],
            "beta_vwy_k_mid": [
                g1_v * (beta * vs[i]) + g1_w * (beta * ws[i]) + g1_y * (beta * ys[i])
                for i in mid
            ],
        }

        t_pt = g1_y * p.t.eval_at(s)
        self.vk = {
            "one_g1": g1g,
            "one_g2": g2g,
            "alpha_v": g2g * alpha_v,
            "alpha_w": g1g * alpha_w,
            "alpha_y": g2g * alpha_y,
            "gamma": g2g * gamma,
            "beta_gamma": g2g * (gamma * beta),
            "t": t_pt,
            "vk_io": [g1_v * vs[i] for i in io],
            "wk_io": [g2_w * ws[i] for i in io],
            "yk_io": [g1_y * ys[i] for i in io],
            "alpha_v_t": t_pt * alpha_v,
            "alpha_y_t": t_pt * alpha_y,
            "beta_t": t_pt * beta,
        }


class Verifier:
    def __init__(self, pairing: Pairing | None = None):
        self.pairing = pairing or Pairing()

    def verify(self, proof: Proof, crs: CRS, witness_io: SparseVec) -> bool:
        """(verifier.rs:31-86)."""
        e = self.pairing.tate
        p, vk = proof, crs.vk

        # KC of beta(v + w + y) vs gamma
        vwy_mid_s = p.v_mid_s + p.g1_w_mid_s + p.y_mid_s
        if e(p.beta_vwy_mid_s, vk["gamma"]) != e(vwy_mid_s, vk["beta_gamma"]):
            return False
        # alpha-consistency of v, w, y
        if e(p.alpha_v_mid_s, vk["one_g2"]) != e(p.v_mid_s, vk["alpha_v"]):
            return False
        if e(p.alpha_w_mid_s, vk["one_g2"]) != e(vk["alpha_w"], p.g2_w_mid_s):
            return False
        if e(p.alpha_y_mid_s, vk["one_g2"]) != e(p.y_mid_s, vk["alpha_y"]):
            return False
        # QAP divisibility
        v_s = p.v_mid_s
        w_s = p.g2_w_mid_s
        y_s = p.y_mid_s
        for i in range(witness_io.size):
            w = witness_io.get(i)
            v_s = v_s + vk["vk_io"][i] * w
            w_s = w_s + vk["wk_io"][i] * w
            y_s = y_s + vk["yk_io"][i] * w
        lhs = e(v_s, w_s)
        rhs = e(vk["t"], p.h_s) * e(y_s, vk["one_g2"])
        return lhs == rhs
