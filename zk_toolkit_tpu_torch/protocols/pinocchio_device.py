"""Pinocchio on the device (GGPR'13 protocol 2; the port of
zk_toolkit_tpu/protocols/pinocchio_device.py): the nine-element proof, eight
MSMs over the mid witness, the NTT quotient h(s), and all verifier pairings
folded into ONE batched Miller product with one shared final
exponentiation.

The same structure as protocols/groth16_device.py: the QAP lives on the
power-of-two root-of-unity domain, trapdoor and prover randomness are
injectable, every group sum is a Pippenger MSM (G1 on kernels B2/B3, G2 on
the formulas over Fq2Ops, every product on B1). Entry points take
`device="cuda"` and raise without a card; pass device="cpu" to run the plain
versions. The Lagrange values of the CRS run on the port's native host
engine where the JAX package runs its own (groth16_device.qap_at), in
Python without g++.
"""

from __future__ import annotations

import dataclasses

import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as MSM
from zk_toolkit_tpu_torch.ops import ntt as NTT
from zk_toolkit_tpu_torch.ops import pairing_ops as PO
from zk_toolkit_tpu_torch.protocols.groth16_device import (
    FR_BITS, CircuitMatrices, _fq_ops, _fr_spec, _g2_to_affine, _pack_fr_plain, _tile_point,
    fixed_base_g1, fixed_base_g2, qap_at, spmv,
)
from zk_toolkit_tpu_torch.snark.r1cs import R1CS
from zk_toolkit_tpu_torch.utils.rng import Rng

R = params.R

TRAPDOOR_NAMES = ("r_v", "r_w", "alpha_v", "alpha_w", "alpha_y", "beta", "gamma", "s")


@dataclasses.dataclass(eq=False)
class DevicePinocchioCRS:
    """Evaluation key `ek` and verification key `vk` over the NTT domain,
    on the device: dicts of Jacobian point tuples."""

    mat: CircuitMatrices
    ek: dict
    vk: dict

    @staticmethod
    def generate(mat: CircuitMatrices, rng: Rng | None = None, device="cuda"):
        rng = rng or Rng()
        f = params.SUBGROUP
        td = {k: f.rand_elem(True, rng).e for k in TRAPDOOR_NAMES}
        return DevicePinocchioCRS.from_trapdoor(mat, **td, device=device)

    @staticmethod
    def from_trapdoor(mat, r_v, r_w, alpha_v, alpha_w, alpha_y, beta, gamma, s,
                      device="cuda"):
        dev = resolve_device(device)
        m, mid_beg = mat.m, mat.l + 1
        r_y = r_v * r_w % R
        vs, ws, ys, t_s = qap_at(mat, s, NTT.fr_domain(mat.n_pad, dev).w)

        mid = range(mid_beg, m + 1)
        io = range(mid_beg)

        g1_scalars, layout = [], {}

        def add(name, vals):
            layout[name] = (len(g1_scalars), len(vals))
            g1_scalars.extend(vals)

        add("vk_mid", [r_v * vs[i] % R for i in mid])
        add("g1_wk_mid", [r_w * ws[i] % R for i in mid])
        add("yk_mid", [r_y * ys[i] % R for i in mid])
        add("alpha_vk_mid", [alpha_v * r_v % R * vs[i] % R for i in mid])
        add("alpha_wk_mid", [alpha_w * r_w % R * ws[i] % R for i in mid])
        add("alpha_yk_mid", [alpha_y * r_y % R * ys[i] % R for i in mid])
        add("beta_vwy_k_mid", [(r_v * vs[i] + r_w * ws[i] + r_y * ys[i]) * beta % R
                               for i in mid])
        add("vk_io", [r_v * vs[i] % R for i in io])
        add("yk_io", [r_y * ys[i] % R for i in io])
        t_sc = r_y * t_s % R
        add("singles", [1, alpha_w, t_sc, alpha_v * t_sc % R, alpha_y * t_sc % R,
                        beta * t_sc % R])
        g1_pts = fixed_base_g1(_pack_fr_plain(g1_scalars, dev))

        g2_scalars, g2_layout = [], {}

        def add2(name, vals):
            g2_layout[name] = (len(g2_scalars), len(vals))
            g2_scalars.extend(vals)

        add2("g2_wk_mid", [r_w * ws[i] % R for i in mid])
        add2("wk_io", [r_w * ws[i] % R for i in io])
        # s^0 .. s^(n_pad-1) covers h (degree <= n_pad - 2)
        si, cur = [], 1
        for _ in range(mat.n_pad):
            si.append(cur)
            cur = cur * s % R
        add2("si", si)
        add2("singles2", [1, alpha_v, alpha_y, gamma, gamma * beta % R])
        g2_pts = fixed_base_g2(_pack_fr_plain(g2_scalars, dev))

        def sl(pts, lay, name, i=None):
            off, ln = lay[name]
            if i is not None:
                off, ln = off + i, 1
            return tuple(x[off:off + ln] for x in pts)

        ek = {name: sl(g1_pts, layout, name)
              for name in ("vk_mid", "g1_wk_mid", "yk_mid", "alpha_vk_mid",
                           "alpha_wk_mid", "alpha_yk_mid", "beta_vwy_k_mid")}
        ek["g2_wk_mid"] = sl(g2_pts, g2_layout, "g2_wk_mid")
        ek["si"] = sl(g2_pts, g2_layout, "si")
        vk = {name: sl(g1_pts, layout, "singles", i)
              for i, name in enumerate(("one_g1", "alpha_w", "t", "alpha_v_t", "alpha_y_t",
                                        "beta_t"))}
        vk.update({name: sl(g2_pts, g2_layout, "singles2", i)
                   for i, name in enumerate(("one_g2", "alpha_v", "alpha_y", "gamma",
                                             "beta_gamma"))})
        vk["vk_io"] = sl(g1_pts, layout, "vk_io")
        vk["yk_io"] = sl(g1_pts, layout, "yk_io")
        vk["wk_io"] = sl(g2_pts, g2_layout, "wk_io")
        return DevicePinocchioCRS(mat=mat, ek=ek, vk=vk)


@dataclasses.dataclass
class DeviceProof:
    """The nine proof elements; each a Jacobian point tuple of batch 1 (G1
    [1, K], G2 [1, 2, K])."""

    v_mid_s: tuple
    g1_w_mid_s: tuple
    g2_w_mid_s: tuple
    y_mid_s: tuple
    h_s: tuple
    alpha_v_mid_s: tuple
    alpha_w_mid_s: tuple
    alpha_y_mid_s: tuple
    beta_vwy_mid_s: tuple


class DevicePinocchioProver:
    def __init__(self, mat: CircuitMatrices, witness_map: dict, device="cuda"):
        dev = resolve_device(device)
        f = params.SUBGROUP
        r1cs = R1CS.from_tmpl(f, mat.tmpl, witness_map)
        r1cs.validate()
        self.mat = mat
        self.device = dev
        self.wires = [r1cs.witness.get(i).e for i in range(mat.m + 1)]
        self.w_mont = L.pack(self.wires, _fr_spec(), mont=True, device=dev)

    def statement(self) -> list[int]:
        return self.wires[: self.mat.l + 1]

    def prove(self, crs: DevicePinocchioCRS, rng: Rng | None = None) -> DeviceProof:
        rng = rng or Rng()
        f = params.SUBGROUP
        dv = f.rand_elem(True, rng).e
        dy = f.rand_elem(True, rng).e
        return self.prove_with_deltas(crs, dv, dy)

    def prove_with_deltas(self, crs, delta_v: int, delta_y: int) -> DeviceProof:
        fq = _fq_ops()
        e2 = PO.bls_pairing_ops().e2
        fr = _fr_spec()
        mat, dev = self.mat, self.device
        mid_beg = mat.l + 1

        mid_plain = _pack_fr_plain(self.wires[mid_beg:], dev)
        io_plain = _pack_fr_plain(self.wires[:mid_beg], dev)

        def msm1(pts, sc=mid_plain):
            return tuple(x[None] for x in MSM.msm_pippenger(fq, pts, sc, FR_BITS))

        def msm2(pts, sc=mid_plain):
            return tuple(x[None] for x in MSM.msm_pippenger(e2, pts, sc, FR_BITS))

        def sm(pt, k):
            return C.scalar_mul(fq, pt, _pack_fr_plain([k], dev), FR_BITS)

        # randomizer multiples of t(s)
        t_m = C.scalar_mul(fq, _tile_point(crs.vk["t"], 4),
                           _pack_fr_plain([delta_v, delta_y, 0, 0], dev), FR_BITS)
        avt = sm(crs.vk["alpha_v_t"], delta_v)
        ayt = sm(crs.vk["alpha_y_t"], delta_y)
        bt = sm(crs.vk["beta_t"], (delta_v + delta_y) % R)

        v_mid = C.point_add(fq, tuple(x[0:1] for x in t_m), msm1(crs.ek["vk_mid"]))
        g1_w_mid = msm1(crs.ek["g1_wk_mid"])
        g2_w_mid = msm2(crs.ek["g2_wk_mid"])
        y_mid = C.point_add(fq, tuple(x[1:2] for x in t_m), msm1(crs.ek["yk_mid"]))
        a_v_mid = C.point_add(fq, avt, msm1(crs.ek["alpha_vk_mid"]))
        a_w_mid = msm1(crs.ek["alpha_wk_mid"])
        a_y_mid = C.point_add(fq, ayt, msm1(crs.ek["alpha_yk_mid"]))
        b_vwy_mid = C.point_add(fq, bt, msm1(crs.ek["beta_vwy_k_mid"]))

        # h = (V*W - Y)/t over the domain; h_s in G2 over s^i, adjusted by
        # + delta_v * w(s) - delta_y
        a_ev = spmv(mat.a_idx, mat.a_val, self.w_mont, fr)
        b_ev = spmv(mat.b_idx, mat.b_val, self.w_mont, fr)
        c_ev = spmv(mat.c_idx, mat.c_val, self.w_mont, fr)
        h = NTT.h_coset_then_coeffs(NTT.fr_domain(mat.n_pad, dev), a_ev, b_ev, c_ev)
        h_s = msm2(crs.ek["si"], L.from_mont(h, fr))

        w_s = C.point_add(e2, g2_w_mid, msm2(crs.vk["wk_io"], io_plain))
        w_dv = C.scalar_mul(e2, w_s, _pack_fr_plain([delta_v], dev), FR_BITS)
        one_dy = C.scalar_mul(e2, crs.vk["one_g2"], _pack_fr_plain([delta_y], dev), FR_BITS)
        adj_h = C.point_add(e2, C.point_add(e2, h_s, w_dv), C.point_neg(e2, one_dy))

        return DeviceProof(
            v_mid_s=v_mid, g1_w_mid_s=g1_w_mid, g2_w_mid_s=g2_w_mid,
            y_mid_s=y_mid, h_s=adj_h, alpha_v_mid_s=a_v_mid,
            alpha_w_mid_s=a_w_mid, alpha_y_mid_s=a_y_mid,
            beta_vwy_mid_s=b_vwy_mid,
        )


class DevicePinocchioVerifier:
    """The verifier's three equation groups as ONE batched pairing product:
    five rows of three (G1, G2) pairs, padded with infinity pairs
    (e(inf, .) = 1), one final exponentiation per row, one host read."""

    def verify(self, proof: DeviceProof, crs: DevicePinocchioCRS,
               statement: list[int]) -> bool:
        fq = _fq_ops()
        po = PO.bls_pairing_ops()
        e2 = po.e2
        vk = crs.vk
        dev = vk["one_g1"][0].device
        io_plain = _pack_fr_plain(statement, dev)

        def neg1(p):
            return C.point_neg(fq, p)

        def io_sum(ops, pts):
            return tuple(x[None] for x in MSM.msm_pippenger(ops, pts, io_plain, FR_BITS))

        vwy_mid = C.point_add(fq, C.point_add(fq, proof.v_mid_s, proof.g1_w_mid_s),
                              proof.y_mid_s)
        # io re-aggregation
        v_s = C.point_add(fq, proof.v_mid_s, io_sum(fq, vk["vk_io"]))
        y_s = C.point_add(fq, proof.y_mid_s, io_sum(fq, vk["yk_io"]))
        w_s = C.point_add(e2, proof.g2_w_mid_s, io_sum(e2, vk["wk_io"]))

        def aff1(p):
            return C.to_affine(fq, p)

        def aff2(p):
            return _g2_to_affine(p)

        one = torch.ones((1,), dtype=torch.bool, device=dev)
        inf1 = tuple(torch.zeros_like(x) for x in vk["one_g1"][:2]) + (one,)
        inf2 = tuple(torch.zeros_like(x) for x in vk["one_g2"][:2]) + (one,)

        rows = [
            # e(beta_vwy, gamma) == e(vwy, beta_gamma)
            ([aff1(neg1(proof.beta_vwy_mid_s)), aff1(vwy_mid), inf1],
             [aff2(vk["gamma"]), aff2(vk["beta_gamma"]), inf2]),
            # e(alpha_v_mid, 1) == e(v_mid, alpha_v)
            ([aff1(neg1(proof.alpha_v_mid_s)), aff1(proof.v_mid_s), inf1],
             [aff2(vk["one_g2"]), aff2(vk["alpha_v"]), inf2]),
            # e(alpha_w_mid, 1) == e(alpha_w, w_mid)
            ([aff1(neg1(proof.alpha_w_mid_s)), aff1(vk["alpha_w"]), inf1],
             [aff2(vk["one_g2"]), aff2(proof.g2_w_mid_s), inf2]),
            # e(alpha_y_mid, 1) == e(y_mid, alpha_y)
            ([aff1(neg1(proof.alpha_y_mid_s)), aff1(proof.y_mid_s), inf1],
             [aff2(vk["one_g2"]), aff2(vk["alpha_y"]), inf2]),
            # e(v_s, w_s) == e(t, h) e(y_s, 1)
            ([aff1(neg1(v_s)), aff1(vk["t"]), aff1(y_s)],
             [aff2(w_s), aff2(proof.h_s), aff2(vk["one_g2"])]),
        ]
        p_b = tuple(torch.stack([torch.cat([pair[i] for pair in row_p]) for row_p, _ in rows])
                    for i in range(3))
        q_b = tuple(torch.stack([torch.cat([pair[i] for pair in row_q]) for _, row_q in rows])
                    for i in range(3))
        ok = PO.pairing_product_is_one(po, p_b, q_b)
        return bool(ok.all())
