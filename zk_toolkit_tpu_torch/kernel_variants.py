"""Builds variants of kernels B1, B2 and B3 from edited copies of csrc/ and
compares them on one card: ptxas registers, stack and spills at K = 24,
the instruction mix of B2's K = 24 SASS, parity against the plain versions
(tolerance 0: B2 and B3 on every case class at 2^16 rows, B1's product at
2^20 rows and its chain at 8192) and device ms per launch at the main
path's shapes (B1: the inverse at 8192 and 1, the product at 8192) and at
B1's large batch (the product at 2^20 rows, K = 16 and 24). Prints one JSON line per variant,
then the card's name and power limit.

    python3 -m zk_toolkit_tpu_torch.kernel_variants [VARIANT ...]

The variants are the design choices of csrc/field.cuh and point_add.cu:
`shipped` (the sources as they are), `4_blocks` (B2 at 4 blocks of 128
threads per SM, 128 registers), `sq_as_mul` (every square a product),
`cios_mul` (the 12-word product as CIOS, whose accumulator shifts a word a
round, instead of the pair-aligned one), `b1_block_128` (B1 at 128 threads
a block whatever the batch) and `b1_block_256` (B1 at 256 threads a block).
Builds go under the repository's build/ directory.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from zk_toolkit_tpu_torch import _build
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_kernels as CK
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils import samples as S
from zk_toolkit_tpu_torch.utils.profiling import device_ms

# name -> [(file, text, replacement)]
VARIANTS = {
    "shipped": [],
    "4_blocks": [("point_add.cu", "kMinBlocks = 3", "kMinBlocks = 4")],
    "sq_as_mul": [("field.cuh", "  mont_sq_aligned<N>(r, a, M);\n}",
                   "  mont_mul<N>(r, a, a, M);\n}")],
    "cios_mul": [("field.cuh", "if constexpr (N == 12)", "if constexpr (false)")],
    "b1_block_128": [("mont_mul.cu", "while (t > 32 &&", "while (false &&")],
    "b1_block_256": [("mont_mul.cu", "kMaxThreads = 128", "kMaxThreads = 256"),
                     ("mont_mul.cu", "while (t > 32 &&", "while (false &&")],
}
KERNELS = ("mont_mul", "point_add", "point_double")
VAR_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_variants")


def _build_all(names) -> None:
    procs = []
    for name in names:
        d = os.path.join(VAR_DIR, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for f, a, b in VARIANTS[name]:
            path = os.path.join(d, f)
            with open(path) as fh:
                src = fh.read()
            if a not in src:
                raise RuntimeError(f"variant {name}: {a!r} not in {f}")
            with open(path, "w") as fh:
                fh.write(src.replace(a, b))
        for k in KERNELS:
            log = open(os.path.join(d, f"{k}.log"), "w")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, f"{k}.so"),
                   os.path.join(d, f"{k}.cu")]
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    for proc, log in procs:
        if proc.wait(timeout=600) != 0:
            log.close()
            with open(log.name) as fh:
                raise RuntimeError(f"build failed: {log.name}\n{fh.read()[-3000:]}")
        log.close()


def _sass_mix(so: str) -> dict:
    """Instruction counts of the K = 24 kernel in the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if "ILi12E" not in fn.split("\n", 1)[0]:
            continue
        ops = collections.Counter(
            m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
        return {"instructions": sum(ops.values()),
                "imad_wide": sum(v for k, v in ops.items() if k.startswith("IMAD.WIDE")),
                "moves": ops["MOV"] + ops["IMAD.MOV.U32"]}
    return {}


def main(argv) -> int:
    names = argv[1:] or list(VARIANTS)
    dev = torch.device("cuda")
    _build_all(names)
    fq = L.field_spec(params.Q)
    plain = FqOps(fq, plain=True)
    rng = np.random.default_rng(3)
    pa, qa = S.point_pairs(rng, 1 << 16, dev)
    want_add = C._point_add_formula(plain, pa, qa)
    want_dbl = C._point_double_formula(plain, C._point_double_formula(plain, pa))
    pg, qg = S.point_pairs(rng, 1 << 16, dev, generic_only=True)
    ev, od = S.upsweep_views(pg, qg, 64)
    p32 = tuple(c[:32].contiguous() for c in pg)
    p1 = tuple(c[:1].contiguous() for c in pg)
    fr = L.field_spec(params.R)
    big = {s.K: (S.random_field(rng, 1 << 20, s, dev), S.random_field(rng, 1 << 20, s, dev))
           for s in (fr, fq)}
    want_big = {k: L.mont_mul_plain(a, b, fq if k == 24 else fr) for k, (a, b) in big.items()}
    inv_in = {n: S.chain_inputs(rng, n, fq, dev) for n in (8192, 1)}
    want_inv = L.mont_inv_plain(inv_in[8192], fq)
    lib_path = _build.lib_path
    try:
        for name in names:
            d = os.path.join(VAR_DIR, name)
            out = {"variant": name}
            for entry, kern in _build.ENTRIES.items():
                with open(os.path.join(d, f"{kern}.log")) as fh:
                    out[f"{entry}_ptxas_k24"] = _build.parse_ptxas(fh.read(), f"{entry}_kernel").get(12)
            out["point_add_sass_k24"] = _sass_mix(os.path.join(d, "point_add.so"))
            _build._fns.clear()
            _build.lib_path = lambda n, d=d: os.path.join(d, f"{n}.so")
            got = CK.point_add_fused(pa, qa, fq)
            out["b2_mismatching_rows"] = int(sum((g != w).any(-1).sum() for g, w in zip(got, want_add)))
            got = CK.point_double_n_fused(pa, fq, 2)
            out["b3_r2_mismatching_rows"] = int(sum((g != w).any(-1).sum() for g, w in zip(got, want_dbl)))
            out["b2_65536_device_ms"] = device_ms(lambda: CK.point_add_fused(pg, qg, fq), 50)[0]
            out["b2_upsweep_4194304_device_ms"] = device_ms(lambda: CK.point_add_fused(ev, od, fq), 5)[0]
            out["b3_32_device_ms"] = device_ms(lambda: CK.point_double_fused(p32, fq), 100)[0]
            out["b3_1_r8_device_ms"] = device_ms(lambda: CK.point_double_n_fused(p1, fq, 8), 50)[0]
            got = L.mont_inv(inv_in[8192], fq)
            out["b1_inv_8192_mismatching_rows"] = int((got != want_inv).any(-1).sum())
            for n, x in inv_in.items():
                out[f"b1_inv_{n}_device_ms"] = device_ms(lambda: L.mont_inv(x, fq), 20)[0]
            x = inv_in[8192]
            out["b1_mul_8192_device_ms"] = device_ms(lambda: L._mont_mul_fused(x, x, fq), 200)[0]
            for k, (a, b) in big.items():
                spec = fq if k == 24 else fr
                got = L._mont_mul_fused(a, b, spec)
                out[f"b1_mul_2p20_k{k}_mismatching_rows"] = int((got != want_big[k]).any(-1).sum())
                out[f"b1_mul_2p20_k{k}_device_ms"] = device_ms(
                    lambda: L._mont_mul_fused(a, b, spec), 50)[0]
            print(json.dumps(out), flush=True)
    finally:
        _build.lib_path = lib_path
        _build._fns.clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
