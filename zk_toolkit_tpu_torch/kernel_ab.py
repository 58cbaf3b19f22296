"""Times kernels B2 and B3 and the 2^20 G1 MSM of two checkouts of the port
on one card, in turns A, B, B, A, each turn a process of its own that
imports the package of its checkout (and builds that checkout's kernels).
Prints one JSON line per turn, then the card's name and power limit.

    python3 -m zk_toolkit_tpu_torch.kernel_ab OTHER_ROOT

A is OTHER_ROOT (say, the parent commit unpacked with `git archive`), B
this checkout. Per turn, on the inputs of chip_smoke.py's samples:

- B2 on 2^16 generic pairs, and on the even/odd views of a contiguous
  [2^23, 3K] tensor (2^22 pairs, an up-sweep level): ms per call (CUDA
  events over back-to-back calls) and device ms per launch;
- B3 on 32 points and on 1 point, one doubling: ms per call, device ms
  per launch and host us per call; and a Horner step's 8 doublings of one
  point, as one r = 8 launch where the checkout has point_double_n_fused,
  else as 8 launches;
- bench_msm(2^20): s per MSM and the stage split.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys


def _turn(root: str) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "_ab_profiling", os.path.join(here, "utils", "profiling.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from zk_toolkit_tpu_torch import _build
    from zk_toolkit_tpu_torch.bench import bench_msm
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import curve_kernels as CK
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import samples as S

    if not _build.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    _build.build()
    fq = L.field_spec(params.Q)
    k = fq.K
    rng = np.random.default_rng(2024)
    out = {"root": os.path.abspath(root)}

    def both(fn, reps):
        dev_ms, host_us = prof.device_ms(fn, reps)
        return {"ms": prof.cuda_ms(fn, reps), "device_ms": dev_ms, "host_us": host_us}

    n = 1 << 16
    pp, qq = S.point_pairs(rng, n, dev, generic_only=True)
    out["b2_65536"] = both(lambda: CK.point_add_fused(pp, qq, fq), 50)
    tiles = (1 << 22) // n
    buf = torch.empty((tiles, n, 2, 3 * k), dtype=torch.int32, device=dev)
    buf[:, :, 0] = torch.cat(pp, -1)
    buf[:, :, 1] = torch.cat(qq, -1)
    flat = buf.view(-1, 3 * k)
    ev, od = (tuple(flat[s::2, c * k:(c + 1) * k] for c in range(3)) for s in (0, 1))
    out["b2_upsweep_4194304"] = both(lambda: CK.point_add_fused(ev, od, fq), 5)
    del buf, flat, ev, od

    p32 = tuple(c[:32].contiguous() for c in pp)
    p1 = tuple(c[:1].contiguous() for c in pp)
    out["b3_32"] = both(lambda: CK.point_double_fused(p32, fq), 200)
    out["b3_1"] = both(lambda: CK.point_double_fused(p1, fq), 200)
    if hasattr(CK, "point_double_n_fused"):
        step = lambda: CK.point_double_n_fused(p1, fq, 8)
    else:
        def step():
            p = p1
            for _ in range(8):
                p = CK.point_double_fused(p, fq)
            return p
    out["b3_1_x8"] = both(step, 50)

    res = bench_msm(1 << 20, dev, reps=3)
    out["msm_s"] = res["seconds"]
    out["msm_split_ms"] = res["split_ms"]
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--turn":
        print(json.dumps(_turn(argv[2])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for label, root in (("A", argv[1]), ("B", this), ("B", this), ("A", argv[1])):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-2000:] + r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(f"{label} " + r.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
