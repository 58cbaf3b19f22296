"""Benchmarks of the port (the twin of the repository's bench.py).

bench_msm: the 2^20-point BLS12-381 G1 MSM, the repository's headline
metric, over n DISTINCT points k_i * G made by the fixed-base path and
255-bit scalars. The result is asserted against the known-dlog oracle before
any timing: with P_i = k_i * G and known k_i the MSM must equal
(sum s_i k_i mod r) * G, an exact check that costs one uint64 matmul and one
host scalar multiplication. The benchmark refuses to report a wrong result.

Run on a card: python -m zk_toolkit_tpu_torch.bench [log2_n]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as M
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.protocols.groth16_device import fixed_base_g1
from zk_toolkit_tpu_torch.utils import host_curve as HC
from zk_toolkit_tpu_torch.utils.profiling import Spans


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def msm_inputs(n: int, device):
    """The benchmark's inputs, from default_rng(1) as in bench.py: base
    scalars k_i (256-bit), MSM scalars s_i masked to 255 bits (the 32 c=8
    windows span bits [0, 256); the known-dlog oracle reduces mod 2^255)."""
    rng = np.random.default_rng(1)
    base_np = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    scalars_np = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    scalars_np[:, 15] &= 0x7FFF
    dev = resolve_device(device)
    to_dev = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return base_np, scalars_np, to_dev(base_np), to_dev(scalars_np)


def bench_msm(n: int = 1 << 20, device="cuda", reps: int = 3, c: int | None = None) -> dict:
    """Seconds per n-point MSM and points/s, after the known-dlog check.
    Times on a card with CUDA events after torch.cuda.synchronize()."""
    dev = resolve_device(device)
    spec = L.field_spec(params.Q)
    ops = FqOps(spec)
    base_np, scalars_np, base, scalars = msm_inputs(n, dev)

    _sync(dev)
    t0 = time.perf_counter()
    pts = fixed_base_g1(base)
    _sync(dev)
    point_gen_first_s = time.perf_counter() - t0

    res = M.msm_pippenger(ops, pts, scalars, 255, c=c)
    got = C.unpack_points(tuple(a[None] for a in res), spec)[0]
    want = HC.g1_mul_affine(HC._limb_dot_mod_r(base_np, scalars_np, 255))
    if got != want:
        raise RuntimeError(
            f"MSM(n={n}) does not match the known-dlog host oracle — refusing to report"
        )

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans(dev)
    _sync(dev)
    with spans.span("point_gen"):
        fixed_base_g1(base)
    t0 = time.perf_counter()
    for _ in range(reps):
        with spans.span("msm"):
            M.msm_pippenger(ops, pts, scalars, 255, c=c, spans=spans)
    _sync(dev)
    wall = (time.perf_counter() - t0) / reps
    ms = spans.totals()
    dt = ms.pop("msm") / reps / 1e3
    split = {k: v / (1 if k == "point_gen" else reps) for k, v in ms.items()}
    out = {
        "n": n,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "known_dlog_ok": True,
        "seconds": dt,
        "wall_seconds": wall,
        "points_per_s": n / dt,
        "point_gen_first_s": point_gen_first_s,
        "split_ms": split,
    }
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


if __name__ == "__main__":
    log2_n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    print(json.dumps(bench_msm(1 << log2_n)))
