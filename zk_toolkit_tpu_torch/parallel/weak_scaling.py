"""Weak scaling of the sharded layer: the explicit sharded MSM, the sharded
NTT and the sharded Groth16 prove at a fixed size per rank, on a world of
one rank against a world of N (the port of
zk_toolkit_tpu/parallel/weak_scaling.py).

    python -m zk_toolkit_tpu_torch.parallel.weak_scaling --device cpu --world 4
    python -m zk_toolkit_tpu_torch.parallel.weak_scaling --device cuda

Prints one JSON object. Every timed result is checked first: the MSM
against its known discrete log (P_i = k_i G with known k_i), the NTT
against the single-device ops/ntt.py transform, the prove by
host_oracle_verify; a failed check raises, and so does any error of a
rank. In place of the JAX module's collective inventory read from XLA
dumps, each path reports its process-group calls per run (`mesh.counts`):
the MSM's local phase makes none, its fold one all_gather per coordinate.

On the CPU (gloo) every rank shares the one host, so the ranks' compute
serializes and t(N) cannot show scaling: ideal on separate devices is
t(N) == t(1), here t(N) <= N t(1), and the times bound the communication
and partition overhead. On "cuda" each rank takes a card of its own: a
machine with one card runs the world of one only, which the output says.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: Sizes per rank: MSM points (64-bit scalars), NTT rows, and the prove's
#: constraint count (in all, not per rank, as the JAX module's).
DEFAULTS = {"cpu": {"msm_local": 64, "ntt_local": 256, "prove_n": 16},
            "cuda": {"msm_local": 1 << 14, "ntt_local": 1 << 14, "prove_n": 1 << 12}}
MSM_BITS = 64
REPS = 2
SEED = 17


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(mesh, fn, reps: int):
    """(fn()'s last result, seconds per call over `reps` calls), the ranks
    lined up by a barrier before and after."""
    _sync(mesh)
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(mesh)
    mesh.barrier()
    return out, (time.perf_counter() - t0) / reps


def _msm_rank(mesh, pts_np, scal_np, want, reps: int) -> dict:
    """The explicit sharded MSM of the given stream: checked against the
    known-dlog point `want`, then timed."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import curve_ops as C
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.parallel.sharded_msm import sharded_msm_explicit

    spec = L.field_spec(params.Q)
    ops = FqOps(spec)
    pts = tuple(torch.from_numpy(a.astype(np.int32)).to(mesh.device) for a in pts_np)
    scal = torch.from_numpy(scal_np.astype(np.int32)).to(mesh.device)
    run = lambda: sharded_msm_explicit(ops, pts, scal, MSM_BITS, mesh, c=4)
    t0 = time.perf_counter()
    res = run()
    _sync(mesh)
    first_s = time.perf_counter() - t0
    if C.unpack_points(tuple(a[None] for a in res), spec)[0] != want:
        raise RuntimeError(f"sharded MSM differs from its known dlog at d = {mesh.world}")
    mesh.counts.clear()
    _, seconds = _timed(mesh, run, reps)
    return {"seconds": seconds, "first_call_s": first_s, "n_points": pts[0].shape[0],
            "correct_vs_host_oracle": True, "collectives_per_run": _per_run(mesh, reps)}


def _per_run(mesh, reps: int) -> dict:
    return {k: v / reps for k, v in mesh.counts.items() if k != "barrier"}


def _ntt_rank(mesh, x_np, reps: int) -> dict:
    from zk_toolkit_tpu_torch.ops import ntt as NTT
    from zk_toolkit_tpu_torch.parallel.sharded_ntt import sharded_ntt

    x = torch.from_numpy(x_np.astype(np.int32)).to(mesh.device)
    n = x.shape[0]
    if not torch.equal(sharded_ntt(x, mesh), NTT.ntt(NTT.fr_domain(n, mesh.device), x)):
        raise RuntimeError(f"sharded NTT differs from the single-device NTT at d = {mesh.world}")
    mesh.counts.clear()
    _, seconds = _timed(mesh, lambda: sharded_ntt(x, mesh), reps)
    return {"seconds": seconds, "n_rows": n, "matches_unsharded": True,
            "transform": "four_step_all_to_all", "collectives_per_run": _per_run(mesh, reps)}


def _prove_rank(mesh, n_cons: int, pad_to: int) -> dict:
    """synthetic_r1cs(seed=5) with a CRS from the trapdoor (its points by the
    device tables on a card, by host multiplications on the CPU, where the
    plain tables would take longer), the sharded prove at
    (r, s) = (11, 13) checked by host_oracle_verify (rank 0), then timed at
    (13, 17)."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.parallel.sharded_groth16 import sharded_prove
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    tmpl, wit = synthetic_r1cs(params.SUBGROUP, n_cons, seed=5, pad_wires_to=pad_to)
    mat = GD.CircuitMatrices.from_tmpl(tmpl, mesh.device)
    crs = GD.DeviceCRS.from_trapdoor(
        mat, tau=5, alpha=6, beta=7, gamma=8, delta=9, device=mesh.device,
        point_mode="table" if mesh.device.type == "cuda" else "host")
    prover = GD.DeviceGroth16Prover(mat, wit, mesh.device)
    t0 = time.perf_counter()
    proof = sharded_prove(mesh, mat, crs, prover.wires, r=11, s=13)
    _sync(mesh)
    first_s = time.perf_counter() - t0
    if mesh.rank == 0 and not GD.host_oracle_verify(crs, proof, prover.statement()):
        raise RuntimeError(f"host_oracle_verify rejects the sharded proof at d = {mesh.world}")
    mesh.counts.clear()
    _, seconds = _timed(mesh, lambda: sharded_prove(mesh, mat, crs, prover.wires, r=13, s=17), 1)
    return {"seconds": seconds, "first_call_s": first_s, "n_constraints": n_cons,
            "verified_host_oracle": True, "collectives_per_run": _per_run(mesh, 1)}


def _known_dlog_stream(n: int, rng):
    """n points k_i G1 (host Jacobian math, 62-bit k_i) as uint32 Jacobian
    limbs, 64-bit scalars s_i as limbs, and the k_i and s_i."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import host_curve as HC
    from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

    dlogs = [int(x) for x in rng.integers(1, 1 << 62, size=n)]
    pts = HC.pack_g1_jac([HC.g1_mul_affine(k) for k in dlogs], L.field_spec(params.Q))
    scal = [int(a) | (int(b) << 32) for a, b in zip(
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64),
        rng.integers(0, 1 << (MSM_BITS - 32), size=n, dtype=np.uint64))]
    return pts, ints_to_array(scal, MSM_BITS // 16), dlogs, scal


def main(argv=None) -> int:
    from zk_toolkit_tpu_torch import resolve_device
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.parallel.mesh import World
    from zk_toolkit_tpu_torch.utils import host_curve as HC

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="N, the larger world (default: every card on cuda, 4 on the CPU)")
    ap.add_argument("--msm-local", type=int, default=None)
    ap.add_argument("--ntt-local", type=int, default=None)
    ap.add_argument("--prove-n", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = {k: getattr(args, k) or v for k, v in DEFAULTS[dev.type].items()}
    d_max = args.world or (torch.cuda.device_count() if dev.type == "cuda" else 4)
    worlds = sorted({1, d_max})
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "backend": "nccl" if dev.type == "cuda" else "gloo", "worlds": worlds,
           "scalar_bits": MSM_BITS, **cfg, "msm": {}, "ntt": {}, "groth16_prove": {}}
    rng = np.random.default_rng(SEED)
    n_total = cfg["msm_local"] * d_max
    pts_all, scal_all, dlogs, scal_ints = _known_dlog_stream(n_total, rng)
    x_all = rng.integers(0, 1 << 16, size=(cfg["ntt_local"] * d_max, 16), dtype=np.int64)
    x_all[:, -1] &= 0x3FFF                               # canonical: < 2^254 < r
    for d in worlds:
        n = cfg["msm_local"] * d
        pts, scal = tuple(a[:n] for a in pts_all), scal_all[:n]
        want = HC.g1_mul_affine(sum(k * s for k, s in zip(dlogs[:n], scal_ints[:n])) % params.R)
        with World(d, dev.type) as w:
            out["msm"][str(d)] = w.run(_msm_rank, pts, scal, want, REPS)
            out["ntt"][str(d)] = w.run(_ntt_rank, x_all[:cfg["ntt_local"] * d], REPS)
            out["groth16_prove"][str(d)] = w.run(_prove_rank, cfg["prove_n"], d_max)
    for key in ("msm", "ntt", "groth16_prove"):
        t1, td = out[key]["1"]["seconds"], out[key][str(d_max)]["seconds"]
        out[key]["t1_over_td"] = t1 / td
    out["note"] = (
        "one card: the world of one only (d = 1)" if d_max == 1 else
        "gloo on one CPU: every rank shares the host, so t(d) shows serialized compute "
        "and partition overhead, not scaling" if dev.type == "cpu" else
        f"NCCL, one card per rank, {d_max} ranks")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
