"""The Groth16 prove sharded over a Mesh (the port of
zk_toolkit_tpu/parallel/sharded_groth16.py).

Every rank is handed the whole circuit, CRS and witness (the same on every
rank) and keeps its blocks: a contiguous block of n_pad/D constraint rows
and of every CRS point stream and scalar stream. Five stages, on every
rank:

  0. host: the randomizer points and the scalar streams; the wit stream
     padded to a multiple of D (sharded_msm.pad_to_multiple, the JAX
     module's _pad_stream);
  1. SpMV (`_spmv_gather`): the rank's rows of A*w, B*w, C*w through
     groth16_device.spmv; the evaluations stay in blocks when the four-step
     NTT runs (n_pad >= D^2), else one all_gather makes them whole;
  2. the quotient: sharded_ntt.h_from_evs_local on the blocks (nine
     all_to_alls), or below n_pad = D^2 the single-device
     ntt.h_coset_then_coeffs on the gathered evaluations;
  3. the five G1 MSM segments [U | wit | xt | s*U | r*V] of the rank's
     blocks, padded to one length with infinity points, as one
     msm_pippenger_many: no collective;
  4. the rank's G2 MSM (msm_pippenger over Fq2Ops, the formulas): no
     collective;
  5. `_combine`: one all_gather of the rank's five G1 partials and one of
     its G2 partial, scan_fold over the ranks, then A, B and C assembled.

The randomizer terms are computed on the host (utils/host_curve.py): by
sA + rB1 - rs*delta = s*alpha + r*beta + rs*delta + s*U + r*V (U, V the
G1 sums of a_i u_i and a_i v_i), C needs the two MSM segments with
host-scaled scalars s*a_i and r*a_i and one host point K = s*alpha + r*beta
+ rs*delta; A takes r*delta and B takes s*delta_2, both host points. So
the G2 scalar_mul of the single-device prove_core never runs here. The
proof equals prove_core's for the same (r, s) after to_affine.

Each stage is a profiling.timed span ("sharded_prove/<stage>", host clock,
logged at debug level).
"""

from __future__ import annotations

import numpy as np
import torch

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as M
from zk_toolkit_tpu_torch.ops import ntt as NTT
from zk_toolkit_tpu_torch.parallel.mesh import Mesh, shard_leading
from zk_toolkit_tpu_torch.parallel.sharded_msm import pad_rows, pad_to_multiple
from zk_toolkit_tpu_torch.parallel.sharded_ntt import h_from_evs_local
from zk_toolkit_tpu_torch.protocols import groth16_device as GD
from zk_toolkit_tpu_torch.utils import host_curve as HC
from zk_toolkit_tpu_torch.utils.profiling import timed

FR_BITS = GD.FR_BITS
R = params.R


# -- host helpers ------------------------------------------------------------------

def _unpack_g1_host(pt, spec):
    """A G1 Jacobian point (batch 1) on a device -> host affine (x, y) ints
    or None."""
    x, y, z = (L.unpack(a, spec)[0] for a in pt)
    return HC.jac_to_affine(HC.FpHost(spec.p), (x, y, z))


def _unpack_g2_host(pt, spec):
    """A G2 Jacobian point (batch 1) -> host affine ((x0, x1), (y0, y1)) or
    None."""
    x, y, z = (L.unpack(a, spec) for a in pt)
    return HC.jac_to_affine(HC.Fp2Host(spec.p), ((x[0], x[1]), (y[0], y[1]), (z[0], z[1])))


def _host_points(crs, r: int, s: int, fqs, dev):
    """r*delta, K = s*alpha + r*beta + rs*delta (G1) and s*delta_2 (G2) as
    Jacobian tuples [1, ...] on dev, from raw-int host arithmetic."""
    F1, F2 = HC.FpHost(fqs.p), HC.Fp2Host(fqs.p)
    alpha = HC.from_affine(F1, _unpack_g1_host(crs.g1_alpha, fqs))
    beta = HC.from_affine(F1, _unpack_g1_host(crs.g1_beta, fqs))
    delta = HC.from_affine(F1, _unpack_g1_host(crs.g1_delta, fqs))
    delta2 = HC.from_affine(F2, _unpack_g2_host(crs.g2_delta, fqs))
    rd = HC.jac_to_affine(F1, HC.jac_mul(F1, delta, r))
    sd2 = HC.jac_to_affine(F2, HC.jac_mul(F2, delta2, s))
    k = HC.jac_add(F1, HC.jac_add(F1, HC.jac_mul(F1, alpha, s), HC.jac_mul(F1, beta, r)),
                   HC.jac_mul(F1, delta, r * s % R))

    def dev_pts(arrs):
        return tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in arrs)

    return (dev_pts(HC.pack_g1_jac([rd], fqs)), dev_pts(HC.pack_g1_jac([HC.jac_to_affine(F1, k)],
                                                                         fqs)),
            dev_pts(HC.pack_g2_jac([sd2], fqs)))


# -- stages --------------------------------------------------------------------------

def _spmv_gather(mesh: Mesh, mat, w_mont, gather: bool):
    """[3, n_pad/D, K] block of the A/B/C evaluations over H, or with
    gather the whole [3, n_pad, K] (one all_gather)."""
    fr = GD._fr_spec()
    rows = [(shard_leading(mesh, idx), shard_leading(mesh, val))
            for idx, val in ((mat.a_idx, mat.a_val), (mat.b_idx, mat.b_val),
                             (mat.c_idx, mat.c_val))]
    evs = torch.stack([GD.spmv(idx, val, w_mont, fr) for idx, val in rows])
    if not gather:
        return evs
    return mesh.all_gather(evs).transpose(0, 1).reshape(3, -1, fr.K)


def _local_msm_g1(fq, segs, seg_pts, seg_scal, c: int):
    """The five segments of this rank's blocks, each padded to the longest
    with infinity points and zero scalars, as one msm_pippenger_many:
    [5, K] partials each coordinate."""
    n_max = max(segs)
    pts5, scal5 = [], []
    for pts, scal in zip(seg_pts, seg_scal):
        pts, scal = pad_rows(fq, pts, scal, n_max)
        pts5.append(pts)
        scal5.append(scal)
    pts5 = tuple(torch.stack([p[i] for p in pts5]) for i in range(3))
    return M.msm_pippenger_many(fq, pts5, torch.stack(scal5), FR_BITS, c)


def _combine(mesh: Mesh, fq, e2, g1_parts, g2_part, crs, g1_rd, g1_k, g2_sd):
    """Two all_gathers (the G1 partials, the G2 partial, coordinates
    stacked), scan_fold over the ranks, then A = alpha + U + r*delta,
    B = beta_2 + V_2 + s*delta_2, C = wit + ht + s*U + r*V + K, each a
    scan_fold of its terms in that order. Jacobian [1, ...] tuples."""
    g1_all = mesh.all_gather(torch.stack(g1_parts))               # [D, 3, 5, K]
    g2_all = mesh.all_gather(torch.stack(g2_part))                # [D, 3, 2, K]
    g1_sums = C.scan_fold(fq, tuple(g1_all[:, i] for i in range(3)))   # [5, K]
    sum_b2 = C.scan_fold(e2, tuple(g2_all[:, i] for i in range(3)))    # [2, K]
    s_u, s_wit, s_xt, s_su, s_rv = (tuple(x[j] for x in g1_sums) for j in range(5))

    def fold(ops, rows):
        return tuple(x[None] for x in C.scan_fold(
            ops, tuple(torch.stack([r[i] for r in rows]) for i in range(3))))

    row = lambda pt: tuple(x[0].to(mesh.device) for x in pt)
    A = fold(fq, [row(crs.g1_alpha), s_u, row(g1_rd)])
    B2 = fold(e2, [row(crs.g2_beta), sum_b2, row(g2_sd)])
    Cp = fold(fq, [s_wit, s_xt, s_su, s_rv, row(g1_k)])
    return A, B2, Cp


# -- public entry ------------------------------------------------------------------

def sharded_prove(mesh: Mesh, mat, crs, wires, r: int, s: int):
    """Groth16 prove with the constraint rows and the point streams sharded
    over the mesh. mat: groth16_device.CircuitMatrices; crs: DeviceCRS;
    wires: the whole witness as host ints (DeviceGroth16Prover.wires). The
    constraint rows and the wire count (m + 1) must split evenly over the
    ranks (synthetic_r1cs(pad_wires_to=D)). Returns a DeviceProof in affine
    form on the mesh's device, the same on every rank."""
    d = mesh.world
    if mat.n_pad % d:
        raise ValueError(f"{mat.n_pad} constraint rows do not split over {d} ranks")
    if (mat.m + 1) % d:
        raise ValueError(f"{mat.m + 1} wires do not split over {d} ranks")
    fq, e2, fr = GD._fq_ops(), GD._e2(), GD._fr_spec()
    dev = mesh.device
    r, s = int(r) % R, int(s) % R

    with timed("sharded_prove/host_points"):
        g1_rd, g1_k, g2_sd = _host_points(crs, r, s, fq.spec, dev)
        wires_plain = GD._pack_fr_plain(wires, dev)
        su_scal = GD._pack_fr_plain([s * w % R for w in wires], dev)
        rv_scal = GD._pack_fr_plain([r * w % R for w in wires], dev)
        w_mont = L.pack(wires, fr, mont=True, device=dev)

    g1_wit, wit_scal = pad_to_multiple(fq, crs.g1_uvw_wit, wires_plain[mat.l + 1:], d)
    # the n_pad - 1 xt points padded to n_pad, so a rank's xt block pairs
    # with its block of the n_pad h coefficients (the last one with infinity)
    g1_xt, _ = pad_rows(fq, crs.g1_xt, None, mat.n_pad)
    segs = ((mat.m + 1) // d, g1_wit[0].shape[0] // d, mat.n_pad // d,
            (mat.m + 1) // d, (mat.m + 1) // d)

    use_sharded_ntt = mat.n_pad >= d * d
    with timed("sharded_prove/spmv"):
        evs = _spmv_gather(mesh, mat, w_mont, gather=not use_sharded_ntt)
    with timed("sharded_prove/quotient"):
        if use_sharded_ntt:
            h_mont = h_from_evs_local(evs, mat.n_pad, mesh)
        else:
            dom = NTT.fr_domain(mat.n_pad, dev)
            h_mont = shard_leading(mesh, NTT.h_coset_then_coeffs(dom, evs[0], evs[1], evs[2]))
        h_plain = L.from_mont(h_mont, fr)

    u_loc = shard_leading(mesh, wires_plain)
    with timed("sharded_prove/msm_g1"):
        g1_parts = _local_msm_g1(
            fq, segs,
            [shard_leading(mesh, p) for p in (crs.g1_u, g1_wit, g1_xt, crs.g1_u, crs.g1_v)],
            [u_loc, shard_leading(mesh, wit_scal), h_plain, shard_leading(mesh, su_scal),
             shard_leading(mesh, rv_scal)],
            M.default_window_bits(max(segs)))
    with timed("sharded_prove/msm_g2"):
        g2_part = M.msm_pippenger(e2, shard_leading(mesh, crs.g2_v), u_loc, FR_BITS,
                                  c=M.default_window_bits(segs[0]))
    with timed("sharded_prove/combine"):
        A, B2, Cp = _combine(mesh, fq, e2, g1_parts, g2_part, crs, g1_rd, g1_k, g2_sd)
        return GD.DeviceProof(a=C.to_affine(fq, A), b=C.to_affine(e2, B2),
                              c=C.to_affine(fq, Cp))
