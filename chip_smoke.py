#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zk_toolkit_tpu_torch) on one NVIDIA
GPU: builds the kernels from csrc/, holds each against its plain PyTorch
version on the card (B1's static-exponent chain, B1 at the NTT, SpMV and
Fq2 shapes of the Groth16 prove, and B1 at q25519 on rows in [q, 2^255),
too), drives the 2^20-point BLS12-381 G1 MSM through the port's bench entry
point with the known-dlog check (phase `slice`), then the Groth16 prove and
verify at 2^16 constraints through bench_groth16 (phase `groth16`: every
proof equal to the trapdoor's multiples of the generators,
host_oracle_verify and the device verifier both accepting it and rejecting
a tampered statement, B1, B2 and B3 each launched inside one prove and
inside one verify), the batched optimal-ate pairing (phase `pairing`:
bench_pairing at B = 256 against the host optimal-ate, one timed batch,
bench_field_muls, entry()'s Miller loop on the kernels equal limb for limb
to the same loop on the plain versions), Pinocchio at 2^16 constraints
(phase `pinocchio`: bench_pinocchio, the nine proof elements equal to their
trapdoor multiples, the device verifier accepting and rejecting a wrong
statement, B1, B2 and B3 each launched inside the bench's one prove, which
is counted), and the secp256k1 tier at K = 16 (phase `secp256k1`: bench_ipa
at 2^10 accepting the true statement and rejecting P + G, bench_range_proof
at 64 bits accepting v < 2^64 and rejecting a flipped bit, bench_ecdsa at
4096 signatures verifying every row, rejecting the bad rows and matching
the host's (r, s); B1, B2 and B3 each launched inside one IPA and inside
one ECDSA verify), and the signature tier (phase `signatures`:
bench_ed25519 at 4096 signatures of 96-byte messages, the sampled keys and
signatures equal to the host Ed25519Sha512's, every row verifying and the
five bad rows of bench.ED25519_BAD_ROWS rejected; bench_bls at 64
signatures, every row verifying and the four bad rows of bench.BLS_BAD_ROWS
rejected; B1 launched, and B2 and B3 not, inside the Ed25519 sign, the
Ed25519 verify and the BLS verify, each counted on its bench's untimed
first call), and the remaining single-device engines (phase `engines`: the
native host engine built, with the 2^16 Lagrange values of the Groth16
domain equal on the engine and in Python; mont_pow_dynamic over 4096 Fr
and 1024 Fq rows, rows in [p, 2^(16K)) among them, equal to its plain
version and sampled rows to pow; the G1 and G2 fixed-base tables built
and saved by build_table_cached, then loaded by it, equal limb for limb;
profiling.trace writing a torch.profiler trace of one 2^20-point MSM),
and the sharded layer (phase `parallel`: a world of one over NCCL made in
this process by parallel.mesh.make_mesh; sharded_msm_explicit over phase
slice's 2^20-point stream equal to msm_pippenger in affine and to the known
dlog, sharded_h_from_evs at 2^16 rows equal to h_coset_then_coeffs limb
for limb, sharded_ipa at 2^10 accepting and rejecting P + G as
DeviceBulletproofs does, sharded_prove at 2^16 constraints on phase
groth16's CRS equal limb for limb to that phase's warm-up proof and
accepted by host_oracle_verify, which rejects a tampered statement; B1, B2
and B3 each launched inside the sharded prove).
The script runs on a fresh $ZKT_TABLE_CACHE_DIR, removed at its end (the
benches' timed CRS setups take an empty one of their own,
bench.cold_tables), and stops itself at SCRIPT_DEADLINE_S. It prints:

  phase lines, each with its seconds;
  the prove's seconds, stage split, launches by kernel and batch, peak
    memory and the NTT's B1 / add-sub split; for the Groth16 verify, the
    pairing batch and the Pinocchio prove and verify: seconds, launches by
    kernel and batch, plain add/sub/neg calls, _norm calls and host syncs
    (count_path), peak memory; the same for the IPA, the range proof and
    the ECDSA verify, with keygen, sign and verify seconds, and for the
    Ed25519 sign, the Ed25519 verify and the BLS verify;
  a `kernels` JSON line: per kernel its route, source, the TPU kernel it
    replaces, launches over the MSM run and the prove run together (and by
    path in `launches_by_path`), the largest limb difference from
    its plain version (tolerance 0: integer arithmetic), its registers and
    spills at K = 24 and K = 16 (ptxas, every entry of its library; the
    build phase refuses either with stack or spill), and at a shape
    the main path gives it its time per call (`ms`), its device time per
    launch (`device_ms`), its plain version's time and its bound; `timings`
    adds further shapes: for B1 the inverse as one product launch per step
    (the path before the chain entry), the product at 8192 rows, the
    inverse of one element and the product at 2^20 rows of Fr and Fq; for B2 an
    up-sweep level of 2^22 pairs; for B3 one point at r = 8; and the
    prove's batches: B1 at a [2^15]-product NTT stage (twiddle row
    broadcast) and the [2^16, 2] SpMV product, B2 at a 2^21-pair up-sweep
    level (the 2^17-point MSMs) and on 1 and 3 points (scalar_mul), B3 on 1
    and 3 points at r = 1 (scalar_mul); and the pairing's: B1 at the Fq12
    product stack of the Groth16 verify (54 x 4 rows) and of bench_pairing
    (54 x 256 rows), and B1's chain at the 256 rows of bench_pairing's Fq12
    inverse; and the secp256k1 tier's at K = 16: B2 and B3 on the 2048
    points of the first IPA fold and on one point (_single_mul), B1's
    product and chain mod n at the 4096 rows of bench_ecdsa; and the
    signature tier's, B1 at K = 16 mod q25519 = 2^255 - 19: the product at
    the Edwards stack of 4 x 4096 rows and on a stride-0 constant at 4096,
    the chain at 4096 rows for the inverse and the decode's square root;
    and phase engines': B1 at mont_pow_dynamic's stacked [2, B, K] batches
    (Fr 2 x 4096, Fq 2 x 1024); each timing entry carries its launches on
    each path (the paths of phase engines: mont_pow_dynamic, table_build;
    of phase parallel: parallel_msm_2^20, parallel_h_2^16,
    parallel_ipa_2^10, parallel_prove_2^16);
  for each sharded path of phase parallel: its seconds, peak memory,
    process-group calls (mesh.counts) and launches by kernel and batch;
  the card's name and power limit as nvidia-smi prints them;
  last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase exits non-zero before the last line. Without a CUDA device
it exits 2 and prints no result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

_T0 = time.monotonic()  # the script's start, before torch is imported

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; FP32 67 TFLOP/s
# = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz. A 32-bit integer multiply-add
# issues on half of those lanes: 67e12 / 2 / 2 = 16.7e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4

# Odd sizes around the launch grid, plus every batch the kernels are timed
# at (1, 32, 8192, 2^16). B2 and B3 at K = 16 are held at them on
# secp256k1 too.
BATCHES = (1, 32, 255, 257, 513, 1025, 8192, 1 << 16)
# B3's doubling counts held against r plain doublings: one, two, and the
# c = 8 of the Horner combine and the fixed-base table.
DOUBLINGS = (1, 2, 8)
# B1's chain against the plain chain of products: odd sizes around the
# grid, the 32 points of a fold and the 8192 table entries of to_affine.
CHAIN_BATCHES = (1, 32, 255, 257, 8192)
# The product at 2^20 rows of Fr and Fq.
LARGE_BATCH = 1 << 20
# The Groth16 prove of phase groth16: 2^16 constraints (bench.py's size),
# its NTT domain, its SpMV nnz width (synthetic gates have at most 2 terms a
# side), the stages its parity rows take and the first up-sweep level of
# its 2^17-point G1 MSMs (32 windows x 2^16 pairs).
GROTH16_LOG2_N = 16
NTT_N = 1 << GROTH16_LOG2_N
SPMV_KMAX = 2
NTT_STAGES = (1, 8, 16)
UPSWEEP_PAIRS_G16 = 1 << 21
# Fq2 parity batches: one element, odd sizes, the 8192 entries of the G2
# table's to_affine.
FQ2_BATCHES = (1, 257, 8192)
# B1 launches over one bench_msm(2^20) run: two to_affine (the fixed-base
# table, then the MSM result), each one chain launch for the inverse and 4
# products, then 2 from_mont of the result's coordinates.
B1_LAUNCHES_PER_BENCH = 2 * (1 + 4) + 2
# The first up-sweep level of the 2^20 MSM: even/odd rows of [2^23, 3K].
UPSWEEP_PAIRS = 1 << 22
# The pairing's B1 shapes: an Fq12 product is one launch over 54 stacked Fq
# rows per element; the Groth16 verify multiplies [B = 1, J = 4] Miller
# values, bench_pairing B = 256.
FQ12_STACKS = ((1, 4), (256,))
PAIRING_B = 256
# Timed batches of bench_pairing after its counted first one (its default 3
# cut to 1 to make room in the script's 1200 s for phase signatures).
PAIRING_REPS = 1
PINOCCHIO_LOG2_N = 16
# The secp256k1 tier: the IPA at bench.py:bench_ipa's 2^10, the 64-bit
# range proof, ECDSA over 4096 signatures; the first IPA fold's scalar_mul
# covers 2 x 2^10 points.
IPA_LOG2_N = 10
RANGE_BITS = 64
ECDSA_B = 4096
IPA_FOLD_POINTS = 2 << IPA_LOG2_N
# The signature tier: Ed25519 over 4096 signatures of 96-byte messages
# (bench_ed25519) and BLS over 64 (bench_bls, one Ethereum slot's
# committees). Edwards products go to B1 at K = 16 mod q25519 as stacks of
# 4 x 4096 rows, its inverses and square roots as 4096-row chains. A decode
# gives B1 the y of an encoding as read, so values in [q, 2^255) too.
Q25519 = 2**255 - 19
Q25519_ABOVE_P = (Q25519, Q25519 + 1, 2**255 - 1)
Q25519_SQRT_BITS = tuple(int(b) for b in bin((Q25519 + 3) // 8)[2:])
ED25519_B = 4096
EDWARDS_STACK = 4 * ED25519_B
BLS_B = 64
ED25519_SUB_PATHS = (f"ed25519_sign_{ED25519_B}", f"ed25519_verify_{ED25519_B}")
# The engines phase (the slice of the native engine, mont_pow_dynamic, the
# table cache and the profiler): mont_pow_dynamic over 4096 Fr rows with
# 255-bit exponents and 1024 Fq rows with 381-bit exponents (rows in
# [p, 2^(16K)) and the exponents 0, 1, p - 1, p - 2 among them).
POW_FR_ROWS, POW_FQ_ROWS = 4096, 1024
# Phase parallel: the sharded layer on a world of one over NCCL; its
# quotient chain at 2^16 rows (the Groth16 prove's domain).
PARALLEL_NTT_LOG2_N = 16
# The script stops itself at SCRIPT_DEADLINE_S, counted from its start,
# inside the 1200 s it is given. Each phase's limit is at least twice the
# longest time measured for it on an H100 80GB HBM3 at 700 W (PERF.md):
# build 24, parity 87.9, slice 8.6, groth16 189.9, pairing 41.7, pinocchio
# 164.1, secp256k1 18.8, signatures 68.2, engines 27.8 and parallel 82.1 s.
# The limits sum past the deadline; a phase's alarm is the smaller of its
# limit and the time left before the deadline, and the error names the
# phase that reached either. The phases took 490-744 s in all (PERF.md).
SCRIPT_DEADLINE_S = 1150
PHASE_LIMIT_S = {"build": 48, "parity": 188, "slice": 18, "groth16": 380, "pairing": 84,
                 "pinocchio": 329, "secp256k1": 38, "signatures": 137, "engines": 120,
                 "parallel": 240}


class PhaseTimeout(Exception):
    pass


@contextlib.contextmanager
def phase(name: str):
    """Prints the phase's seconds; fails it after PHASE_LIMIT_S[name] or at
    the script's deadline (SCRIPT_DEADLINE_S from its start), whichever
    comes first."""
    left = int(_T0 + SCRIPT_DEADLINE_S - time.monotonic())
    limit = min(PHASE_LIMIT_S[name], left)
    what = (f"its limit of {limit} s" if limit == PHASE_LIMIT_S[name] else
            f"the script's deadline of {SCRIPT_DEADLINE_S} s ({limit} s left at its start)")
    if limit <= 0:
        raise PhaseTimeout(f"phase {name} reached {what} before it started")

    def _alarm(signum, frame):
        raise PhaseTimeout(f"phase {name} reached {what}")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(limit)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def diff_stats(got, want):
    """(rows that differ, largest limb difference) between tuples of tensors."""
    rows = torch.zeros(got[0].reshape(-1, got[0].shape[-1]).shape[0], dtype=torch.bool,
                       device=got[0].device)
    err = 0
    for g, w in zip(got, want):
        d = (g.long() - w.long()).abs().reshape(rows.shape[0], -1)
        rows |= d.any(-1)
        err = max(err, int(d.max()) if d.numel() else 0)
    return int(rows.sum()), err


# -- phases ------------------------------------------------------------------------

# name, source, the TPU kernel it replaces, and the batch it is timed at: one
# the main path gives it (B1: the inverse in to_affine of the 8192-entry
# fixed-base table, one chain launch; B2: an up-sweep level of the 2^20 MSM;
# B3: the 255*T step, 32 points).
KERNELS = (
    ("mont_mul", "zk_toolkit_tpu_torch/csrc/mont_mul.cu",
     "zk_toolkit_tpu/ops/limbs.py:315 _mont_mul_kernel", 8192),
    ("point_add", "zk_toolkit_tpu_torch/csrc/point_add.cu",
     "zk_toolkit_tpu/ops/curve_kernels.py:152 _point_add_call", 1 << 16),
    ("point_double", "zk_toolkit_tpu_torch/csrc/point_double.cu",
     "zk_toolkit_tpu/ops/curve_kernels.py:227 _point_double_call", 32),
)
TIMING_BATCH = {name: batch for name, _, _, batch in KERNELS}


SECP256K1_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def bound_ms(n_bytes: float, n_imad: float):
    """(least ms, what bounds it): the larger of bytes over the HBM rate and
    32-bit multiply-adds over the INT32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_imad / IMAD_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def imad(k: int, muls: int, squares: int) -> int:
    """32-bit multiply-adds of `muls` Montgomery products and `squares`
    Montgomery squares at K limbs (N = K/2 words): a product is 2N^2 word
    products for a*b and the reduction, two multiply-adds each; a square
    needs N(N+1)/2 word products for a^2."""
    n = k // 2
    return muls * 4 * n * n + squares * (n * (n + 1) + 2 * n * n)


def timed(fn, plain, reps: int, plain_reps: int, n_bytes: float, n_imad: float,
          plain_warm: int = 1, **shape):
    """One timing entry: time per call, device time per launch, host us per
    call, the plain version's time and the bound."""
    from zk_toolkit_tpu_torch.utils.profiling import cuda_ms, device_ms

    dev_ms, host_us = device_ms(fn, reps)
    b_ms, b_by = bound_ms(n_bytes, n_imad)
    return dict(shape, ms=cuda_ms(fn, reps), device_ms=dev_ms, host_us=host_us,
                plain_ms=cuda_ms(plain, plain_reps, warm=plain_warm) if plain else None,
                bound_ms=b_ms, bound_by=b_by)


# Pairs of an up-sweep level that the plain add is timed on: its first
# 2^20 (the formula's int64 and float64 temporaries take about 15 GB there
# at K = 24; a whole level would take seconds per call).
PLAIN_PAIRS = 1 << 20


def plain_add_head(plain, ev, od):
    """A function that runs the plain add over the first PLAIN_PAIRS pairs
    of (ev, od)."""
    from zk_toolkit_tpu_torch.ops import curve_ops as C

    head_ev, head_od = (tuple(c[:PLAIN_PAIRS] for c in v) for v in (ev, od))
    return lambda: C._point_add_formula(plain, head_ev, head_od)


def _record(res: dict, name: str, got, want) -> None:
    """Adds got's mismatching rows and largest limb error against want to
    res[name]."""
    rows, err = diff_stats(got, want)
    res[name]["mismatches"] += rows
    res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)


def q25519_parity(dev, res: dict) -> None:
    """B1 at q25519 (K = 16), the Edwards field, against its plain version
    (into res, as parity_and_timing), from its own rng: the product at every
    batch of BATCHES and at 4096 rows on the corner rows with the unreduced
    values of Q25519_ABOVE_P first, and on an expanded (stride-0) right
    operand, as the Edwards constants and tiled bases reach it; the chain at
    every batch of CHAIN_BATCHES for q - 2, (q+3)/8, 1, 101b and 402 bits."""
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import samples as S

    record = functools.partial(_record, res)
    before = res["mont_mul"]["mismatches"]
    launches = L._mont_mul_fused.launches
    q25, rng25 = L.field_spec(Q25519), np.random.default_rng(2027)
    long25 = (1,) + tuple(int(b) for b in rng25.integers(0, 2, 401))
    for n in BATCHES + (ED25519_B,):
        a, b = S.corner_pairs(rng25, n, q25, dev, above_p=Q25519_ABOVE_P)
        c = b[-1:].expand(n, q25.K)
        for x, y in ((a, b), (a, c)):
            record("mont_mul", (L._mont_mul_fused(x, y, q25),), (L.mont_mul_plain(x, y, q25),))
    for n in CHAIN_BATCHES:
        a = S.chain_inputs(rng25, n, q25, dev)
        for bits in (q25.p_minus_2_bits, Q25519_SQRT_BITS, (1,), (1, 0, 1), long25):
            record("mont_mul", (L.mont_pow_static(a, bits, q25),),
                   (L.mont_pow_static_plain(a, bits, q25),))
    torch.cuda.synchronize()
    launches = L._mont_mul_fused.launches - launches
    want_launches = 2 * (len(BATCHES) + 1) + len(CHAIN_BATCHES) * (1 + 1 + 1 + 1 + 2)
    if launches != want_launches:
        raise RuntimeError(f"q25519 parity made {launches} B1 launches, expected {want_launches}")
    print(f"parity of B1 at q25519 = 2^255 - 19 (K = 16): products at {list(BATCHES)} and "
          f"{ED25519_B} (rows in [q, 2^255) included; also on a stride-0 operand), chains at "
          f"{list(CHAIN_BATCHES)} for q - 2, (q+3)/8, 1, 101b and {len(long25)} bits: "
          f"{res['mont_mul']['mismatches'] - before} mismatching rows", flush=True)


def parity_and_timing(dev) -> dict:
    """Each kernel against its plain version on the card at every batch of
    BATCHES (tolerance 0): B1's product on three fields, B2 on contiguous and
    on up-sweep (strided) views, B3 at every r of DOUBLINGS; B1's chain at
    every batch of CHAIN_BATCHES on three fields for the exponents p - 2,
    1, 101b and one of 402 bits (two launches), zero rows included; B1 at
    q25519 (q25519_parity). Then each
    is timed at its main-path batch, B1 also as the product at 8192 rows,
    the inverse of one element and the product at 2^20 rows of Fr and Fq, B2
    also at a 2^22-pair up-sweep level (checked against the plain result of
    the pairs it tiles) and B3 also on one point at r = 8. Returns per
    kernel: mismatching rows, max limb error and its timing entries."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import curve_kernels as CK
    from zk_toolkit_tpu_torch.ops import curve_ops as C
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.ops.tower_ops import Fq2Ops
    from zk_toolkit_tpu_torch.utils import samples as S

    rng = np.random.default_rng(2024)
    fq = L.field_spec(params.Q)
    k = fq.K
    plain = FqOps(fq, plain=True)
    res = {name: {"mismatches": 0, "max_abs_err": 0, "timings": []} for name, *_ in KERNELS}
    record = functools.partial(_record, res)

    for n in BATCHES:
        for p in (params.Q, params.R, SECP256K1_P):
            spec = L.field_spec(p)
            a, b = S.corner_pairs(rng, n, spec, dev)
            record("mont_mul", (L._mont_mul_fused(a, b, spec),), (L.mont_mul_plain(a, b, spec),))
        pp, qq = S.point_pairs(rng, n, dev)
        want = C._point_add_formula(plain, pp, qq)
        record("point_add", CK.point_add_fused(pp, qq, fq), want)
        record("point_add", CK.point_add_fused(*S.upsweep_views(pp, qq), fq), want)
        for r in DOUBLINGS:
            record("point_double", CK.point_double_n_fused(pp, fq, r), C.point_double_n(plain, pp, r))
        torch.cuda.synchronize()
    print(f"parity batches {list(BATCHES)} (B2 also on up-sweep views, B3 at r in "
          f"{list(DOUBLINGS)}): " + ", ".join(
              f"{name} {v['mismatches']} mismatching rows" for name, v in res.items()), flush=True)

    # B2 and B3 at K = 16 (their N = 8 build) on secp256k1 pairs: the same
    # batches, views, doubling counts and case classes, from their own rng.
    before = {name: res[name]["mismatches"] for name in ("point_add", "point_double")}
    secp, rng16 = L.field_spec(SECP256K1_P), np.random.default_rng(2025)
    plain16 = FqOps(secp, plain=True)
    for n in BATCHES:
        pp, qq = S.point_pairs(rng16, n, dev, curve="secp256k1")
        want = C._point_add_formula(plain16, pp, qq)
        record("point_add", CK.point_add_fused(pp, qq, secp), want)
        record("point_add", CK.point_add_fused(*S.upsweep_views(pp, qq), secp), want)
        for r in DOUBLINGS:
            record("point_double", CK.point_double_n_fused(pp, secp, r),
                   C.point_double_n(plain16, pp, r))
        torch.cuda.synchronize()
    print(f"parity at K = 16 on secp256k1, batches {list(BATCHES)} (B2 also on up-sweep views, "
          f"B3 at r in {list(DOUBLINGS)}): " + ", ".join(
              f"{name} {res[name]['mismatches'] - b} mismatching rows"
              for name, b in before.items()),
          flush=True)

    q25519_parity(dev, res)

    long_exp = (1,) + tuple(int(b) for b in rng.integers(0, 2, 401))
    before = res["mont_mul"]["mismatches"]
    chain_launches = L._mont_mul_fused.launches
    for n in CHAIN_BATCHES:
        for p in (params.Q, params.R, SECP256K1_P):
            spec = L.field_spec(p)
            a = S.chain_inputs(rng, n, spec, dev)
            for bits in (spec.p_minus_2_bits, (1,), (1, 0, 1), long_exp):
                record("mont_mul", (L.mont_pow_static(a, bits, spec),),
                       (L.mont_pow_static_plain(a, bits, spec),))
        torch.cuda.synchronize()
    chain_launches = L._mont_mul_fused.launches - chain_launches
    want_launches = len(CHAIN_BATCHES) * 3 * (1 + 1 + 1 + 2)
    if chain_launches != want_launches:
        raise RuntimeError(f"chain parity made {chain_launches} B1 launches, expected "
                           f"{want_launches} (one per 384 exponent bits)")
    print(f"parity of B1's chain, batches {list(CHAIN_BATCHES)}, exponents p - 2, 1, 101b "
          f"and {len(long_exp)} bits, {chain_launches} launches: "
          f"{res['mont_mul']['mismatches'] - before} mismatching rows", flush=True)

    word = 4 * k                                   # bytes of one coordinate
    inv_bits = fq.p_minus_2_bits
    sets = sum(inv_bits)
    for n, reps in ((TIMING_BATCH["mont_mul"], 20), (1, 20)):
        a = S.random_field(rng, n, fq, dev)
        record("mont_mul", (L.mont_inv(a, fq),), (L.mont_inv_plain(a, fq),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L.mont_inv(a, fq), lambda: L.mont_inv_plain(a, fq), reps, 1,
            n * 2 * word, n * imad(k, sets, len(inv_bits)), batch=n,
            entry="mont_pow", count_key=f"K=24 {n} x r={len(inv_bits)}",
            what="mont_inv (Fq, one launch)"))
        # The same inverse as one product launch per square and multiply,
        # the path of every inverse before the chain entry (610 launches).
        steps = functools.partial(L._mont_mul_fused, spec=fq)
        record("mont_mul", (L.mont_inv(a, fq, steps),), (L.mont_inv_plain(a, fq),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L.mont_inv(a, fq, steps), None, 1, 0,
            n * 2 * word, n * imad(k, sets, len(inv_bits)), batch=n, entry="mont_mul",
            what=f"mont_inv (Fq) as {sets + len(inv_bits)} product launches"))
        if n == 1:
            continue
        b = S.random_field(rng, n, fq, dev)
        record("mont_mul", (L._mont_mul_fused(a, b, fq),), (L.mont_mul_plain(a, b, fq),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L._mont_mul_fused(a, b, fq), lambda: L.mont_mul_plain(a, b, fq), 200, 5,
            n * 3 * word, n * imad(k, 1, 0), batch=n, entry="mont_mul", what="product (Fq)"))
    for p in (params.R, params.Q):
        spec = L.field_spec(p)
        n = LARGE_BATCH
        a, b = S.random_field(rng, n, spec, dev), S.random_field(rng, n, spec, dev)
        record("mont_mul", (L._mont_mul_fused(a, b, spec),), (L.mont_mul_plain(a, b, spec),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L._mont_mul_fused(a, b, spec), lambda: L.mont_mul_plain(a, b, spec), 50, 2,
            n * 3 * 4 * spec.K, n * imad(spec.K, 1, 0), batch=n, K=spec.K, entry="mont_mul",
            what="product, contiguous [2^20, K]"))
        del a, b

    # The prove's B1 shapes at K = 16: NTT stages (the twiddle row
    # broadcast over the blocks, the operand a strided half of each block)
    # and the SpMV product of [2^16, kmax] coefficients and gathered wires.
    fr = L.field_spec(params.R)
    kr = fr.K
    x = S.random_field(rng, NTT_N, fr, dev)
    for s in NTT_STAGES:
        half, m = 1 << (s - 1), 1 << s
        u = x.reshape(NTT_N // m, m, kr)[:, half:]
        tw = S.random_field(rng, half, fr, dev)[None]
        record("mont_mul", (L._mont_mul_fused(u, tw, fr),), (L.mont_mul_plain(u, tw, fr),))
        if s == NTT_STAGES[1]:
            res["mont_mul"]["timings"].append(timed(
                lambda: L._mont_mul_fused(u, tw, fr), lambda: L.mont_mul_plain(u, tw, fr), 200, 5,
                (2 * NTT_N // 2 + half) * 4 * kr, NTT_N // 2 * imad(kr, 1, 0), batch=NTT_N // 2,
                K=kr, entry="mont_mul", what=f"NTT stage {s} of 2^16: [{NTT_N // m}, {half}, 16] "
                f"x twiddle row [1, {half}, 16]"))
    val = S.random_field(rng, NTT_N * SPMV_KMAX, fr, dev).view(NTT_N, SPMV_KMAX, kr)
    gat = S.random_field(rng, NTT_N * SPMV_KMAX, fr, dev).view(NTT_N, SPMV_KMAX, kr)
    record("mont_mul", (L._mont_mul_fused(val, gat, fr),), (L.mont_mul_plain(val, gat, fr),))
    res["mont_mul"]["timings"].append(timed(
        lambda: L._mont_mul_fused(val, gat, fr), lambda: L.mont_mul_plain(val, gat, fr), 200, 5,
        3 * NTT_N * SPMV_KMAX * 4 * kr, NTT_N * SPMV_KMAX * imad(kr, 1, 0),
        batch=NTT_N * SPMV_KMAX, K=kr, entry="mont_mul",
        what=f"SpMV product [2^16, {SPMV_KMAX}, 16]"))
    del x, val, gat

    # Fq2 on the card (B1 and its chain) against Fq2Ops over the plain
    # FqOps, on random rows with zero, one and u among them.
    before = res["mont_mul"]["mismatches"]
    e2, e2p = Fq2Ops(FqOps(fq)), Fq2Ops(plain)
    for n in FQ2_BATCHES:
        a = S.random_field(rng, 2 * n, fq, dev).view(n, 2, k)
        b = S.random_field(rng, 2 * n, fq, dev).view(n, 2, k)
        a[0] = 0
        if n > 2:
            a[1] = e2.one_like(a[1])
            a[2, 0], a[2, 1] = 0, a[1, 0]
        for got, want in ((e2.mul(a, b), e2p.mul(a, b)), (e2.sq(a), e2p.sq(a)),
                          (e2.inv(a), e2p.inv(a))):
            record("mont_mul", (got,), (want,))
    torch.cuda.synchronize()
    print(f"parity of B1 at the prove's shapes (NTT stages {list(NTT_STAGES)} of 2^16, SpMV "
          f"[2^16, {SPMV_KMAX}], Fq2 mul/sq/inv at {list(FQ2_BATCHES)}): "
          f"{res['mont_mul']['mismatches'] - before} mismatching rows", flush=True)

    # The pairing: Fq12 mul, sq, inv and frobenius on the card (B1 and its
    # chain) against the same ops over the plain FqOps, at the stacks of the
    # Groth16 verify and of bench_pairing; then B1 alone at those stacks and
    # its chain at bench_pairing's 256-row inverse.
    from zk_toolkit_tpu_torch.ops import pairing_ops as P

    before = res["mont_mul"]["mismatches"]
    po, pp_ = P.bls_pairing_ops(), P.bls_pairing_ops(plain=True)
    e12, e12p = po.e12, pp_.e12
    for lead in FQ12_STACKS:
        rows = int(np.prod(lead))
        a = S.random_field(rng, 12 * rows, fq, dev).view(lead + (2, 3, 2, k))
        b = S.random_field(rng, 12 * rows, fq, dev).view(lead + (2, 3, 2, k))
        a.view(-1, 12, k)[0] = 0                       # a zero element (inverse 0)
        for got, want in ((e12.mul(a, b), e12p.mul(a, b)), (e12.sq(a), e12p.sq(a)),
                          (e12.inv(a), e12p.inv(a)),
                          *((po.frobenius(a, q), pp_.frobenius(a, q)) for q in (1, 2, 3))):
            record("mont_mul", (got,), (want,))
        n = 54 * rows
        x = S.random_field(rng, n, fq, dev).view((3, 6, 3) + lead + (k,))
        y = S.random_field(rng, n, fq, dev).view((3, 6, 3) + lead + (k,))
        record("mont_mul", (L._mont_mul_fused(x, y, fq),), (L.mont_mul_plain(x, y, fq),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L._mont_mul_fused(x, y, fq), lambda: L.mont_mul_plain(x, y, fq), 200, 5,
            n * 3 * word, n * imad(k, 1, 0), batch=n, entry="mont_mul", count_key=f"K=24 {n}",
            what=f"Fq12 product stack [3, 6, 3, {', '.join(map(str, lead))}, 24]"))
    a = S.random_field(rng, PAIRING_B, fq, dev)
    record("mont_mul", (L.mont_inv(a, fq),), (L.mont_inv_plain(a, fq),))
    res["mont_mul"]["timings"].append(timed(
        lambda: L.mont_inv(a, fq), lambda: L.mont_inv_plain(a, fq), 20, 1,
        PAIRING_B * 2 * word, PAIRING_B * imad(k, sets, len(inv_bits)), batch=PAIRING_B,
        entry="mont_pow", count_key=f"K=24 {PAIRING_B} x r={len(inv_bits)}",
        what="mont_inv (Fq), the chain of bench_pairing's Fq12 inverse"))
    torch.cuda.synchronize()
    print(f"parity of B1 at the pairing's shapes (Fq12 mul/sq/inv/frobenius at "
          f"{list(FQ12_STACKS)}, B1 at their 54-row stacks, the chain at {PAIRING_B}): "
          f"{res['mont_mul']['mismatches'] - before} mismatching rows", flush=True)

    n = TIMING_BATCH["point_add"]                  # generic pairs, as in the stream
    pp, qq = S.point_pairs(rng, n, dev, generic_only=True)
    want = C._point_add_formula(plain, pp, qq)
    record("point_add", CK.point_add_fused(pp, qq, fq), want)
    finite = int(((pp[2] != 0).any(-1) & (qq[2] != 0).any(-1)).sum())
    res["point_add"]["timings"].append(timed(
        lambda: CK.point_add_fused(pp, qq, fq), lambda: C._point_add_formula(plain, pp, qq),
        50, 2, n * 9 * word, finite * imad(k, 12, 4), batch=n))
    # An up-sweep level: the 2^16 pairs tiled to 2^22, interleaved in one
    # contiguous [2^23, 3K] tensor (2.4 GB) as _pair_halve reads it.
    tiles = UPSWEEP_PAIRS // n
    ev, od = S.upsweep_views(pp, qq, tiles)
    got = CK.point_add_fused(ev, od, fq)
    record("point_add", tuple(g.view(tiles, n, k) for g in got),
           tuple(w.expand(tiles, n, k) for w in want))
    del got
    res["point_add"]["timings"].append(timed(
        lambda: CK.point_add_fused(ev, od, fq), plain_add_head(plain, ev, od), 5, 1,
        UPSWEEP_PAIRS * 9 * word, tiles * finite * imad(k, 12, 4), plain_warm=0,
        batch=UPSWEEP_PAIRS, layout="up-sweep even/odd views of [2^23, 3K]",
        plain_batch=PLAIN_PAIRS))
    del ev, od
    # The first up-sweep level of the prove's 2^17-point G1 MSMs.
    tiles = UPSWEEP_PAIRS_G16 // n
    ev, od = S.upsweep_views(pp, qq, tiles)
    got = CK.point_add_fused(ev, od, fq)
    record("point_add", tuple(g.view(tiles, n, k) for g in got),
           tuple(w.expand(tiles, n, k) for w in want))
    del got
    res["point_add"]["timings"].append(timed(
        lambda: CK.point_add_fused(ev, od, fq), plain_add_head(plain, ev, od), 10, 1,
        UPSWEEP_PAIRS_G16 * 9 * word, tiles * finite * imad(k, 12, 4), plain_warm=0,
        batch=UPSWEEP_PAIRS_G16, layout="up-sweep even/odd views of [2^22, 3K]",
        plain_batch=PLAIN_PAIRS))
    del ev, od
    # The plain adds' temporaries go back to the card, so the MSMs after this
    # phase size their window groups from the same free memory as before.
    torch.cuda.empty_cache()
    # scalar_mul's batches: the three randomizers of delta, then one point.
    for rows in (3, 1):
        p1, q1 = tuple(c[:rows] for c in pp), tuple(c[:rows] for c in qq)
        res["point_add"]["timings"].append(timed(
            lambda: CK.point_add_fused(p1, q1, fq), lambda: C._point_add_formula(plain, p1, q1),
            200, 3, rows * 9 * word, rows * imad(k, 12, 4), batch=rows, what="scalar_mul step"))

    # B3 at its main-path batch, the Horner step, and scalar_mul's batches.
    for n, r in ((TIMING_BATCH["point_double"], 1), (1, 8), (3, 1), (1, 1)):
        p1 = tuple(c[:n].contiguous() for c in pp)
        record("point_double", CK.point_double_n_fused(p1, fq, r), C.point_double_n(plain, p1, r))
        res["point_double"]["timings"].append(timed(
            lambda: CK.point_double_n_fused(p1, fq, r), lambda: C.point_double_n(plain, p1, r),
            200, 3, n * 6 * word, n * imad(k, 2 * r, 5 * r), batch=n, r=r))
    return res


def secp256k1_timing(dev, res: dict) -> None:
    """B1, B2 and B3 at K = 16 at the secp256k1 tier's shapes, each held
    against its plain version (into res, as parity_and_timing) and timed,
    the entries appended to res[name]["timings"]: B2 and B3 (r = 1) on the
    2048 points of the first IPA fold's scalar_mul and on one point (a
    `_single_mul` step); B1's product mod n at bench_ecdsa's 4096 rows and
    its chain (mont_inv mod n, one launch) there."""
    from zk_toolkit_tpu_torch.ops import curve_kernels as CK
    from zk_toolkit_tpu_torch.ops import curve_ops as C
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.utils import samples as S

    record = functools.partial(_record, res)
    rng = np.random.default_rng(2026)
    fp, fn = L.field_spec(SECP256K1_P), L.field_spec(SECP256K1_N)
    k = fp.K
    word = 4 * k
    plain = FqOps(fp, plain=True)
    pp, qq = S.point_pairs(rng, IPA_FOLD_POINTS, dev, generic_only=True, curve="secp256k1")
    for n, what in ((IPA_FOLD_POINTS, "the first IPA fold's scalar_mul step"),
                    (1, "a _single_mul step")):
        p1 = tuple(c[:n].contiguous() for c in pp)
        q1 = tuple(c[:n].contiguous() for c in qq)
        record("point_add", CK.point_add_fused(p1, q1, fp), C._point_add_formula(plain, p1, q1))
        res["point_add"]["timings"].append(timed(
            lambda: CK.point_add_fused(p1, q1, fp), lambda: C._point_add_formula(plain, p1, q1),
            200, 3, n * 9 * word, n * imad(k, 12, 4), batch=n, K=k, entry="point_add",
            count_key=f"K={k} {n}", what=f"secp256k1, {what}"))
        record("point_double", CK.point_double_n_fused(p1, fp, 1), C.point_double_n(plain, p1, 1))
        res["point_double"]["timings"].append(timed(
            lambda: CK.point_double_n_fused(p1, fp, 1), lambda: C.point_double_n(plain, p1, 1),
            200, 3, n * 6 * word, n * imad(k, 2, 5), batch=n, r=1, K=k, entry="point_double",
            count_key=f"K={k} {n}", what=f"secp256k1, {what}"))
    n = ECDSA_B
    a, b = S.random_field(rng, n, fn, dev), S.random_field(rng, n, fn, dev)
    record("mont_mul", (L._mont_mul_fused(a, b, fn),), (L.mont_mul_plain(a, b, fn),))
    res["mont_mul"]["timings"].append(timed(
        lambda: L._mont_mul_fused(a, b, fn), lambda: L.mont_mul_plain(a, b, fn), 200, 5,
        n * 3 * word, n * imad(k, 1, 0), batch=n, K=k, entry="mont_mul", count_key=f"K={k} {n}",
        paths=(f"ecdsa_verify_{ECDSA_B}",),
        what="product mod the secp256k1 order n (bench_ecdsa's rows)"))
    bits = fn.p_minus_2_bits
    record("mont_mul", (L.mont_inv(a, fn),), (L.mont_inv_plain(a, fn),))
    res["mont_mul"]["timings"].append(timed(
        lambda: L.mont_inv(a, fn), lambda: L.mont_inv_plain(a, fn), 20, 1,
        n * 2 * word, n * imad(k, sum(bits), len(bits)), batch=n, K=k, entry="mont_pow",
        count_key=f"K={k} {n} x r={len(bits)}",
        what="mont_inv mod n, one chain launch (bench_ecdsa's k^-1 and s^-1)"))
    torch.cuda.synchronize()


def secp256k1_paths(dev) -> dict:
    """bench_ipa at 2^IPA_LOG2_N, bench_range_proof at RANGE_BITS and
    bench_ecdsa at ECDSA_B, each under path_run (so each path's launches
    per kernel are its own) with its first IPA, range proof and verify
    instrumented (count_path). Their refusals raise."""
    from zk_toolkit_tpu_torch.bench import bench_ecdsa, bench_ipa, bench_range_proof

    counts = {}
    observe = observing(counts)

    def ipa(d):
        return bench_ipa(IPA_LOG2_N, d, observe=observe)

    def range_proof(d):
        return bench_range_proof(RANGE_BITS, d, observe=observe)

    def ecdsa(d):
        return bench_ecdsa(ECDSA_B, d, observe=observe)

    out = {f"ipa_2^{IPA_LOG2_N}": path_run(ipa, dev, tuple(counters())),
           f"range_{RANGE_BITS}": path_run(range_proof, dev, tuple(counters())),
           f"ecdsa_{ECDSA_B}": path_run(ecdsa, dev, tuple(counters()))}
    require_all_launched(counts["ipa"]["launches"], "one IPA")
    require_all_launched(counts["verify"]["launches"], "one ECDSA verify")
    out["counts"] = counts
    return out


def signature_timing(dev, res: dict) -> None:
    """B1 at K = 16 mod q25519 at the signature tier's shapes, held against
    its plain version (into res, as parity_and_timing) and timed, the
    entries appended to res["mont_mul"]["timings"]: the product at the
    Edwards stack of 4 x 4096 rows, the 2d T1 T2 product of 4096 rows on a
    stride-0 constant, and the chain at 4096 rows for the inverse (q - 2) and
    the decode's square root ((q+3)/8)."""
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import samples as S

    record = functools.partial(_record, res)
    rng = np.random.default_rng(2028)
    q25 = L.field_spec(Q25519)
    k = q25.K
    word = 4 * k
    for rows, b_rows, what in ((EDWARDS_STACK, EDWARDS_STACK, "product, the Edwards stack "
                                f"[4, {ED25519_B}, 16] of a unified add"),
                               (ED25519_B, 1, f"product [{ED25519_B}, 16] x a stride-0 "
                                "constant (2d T1 T2)")):
        a = S.random_field(rng, rows, q25, dev)
        b = S.random_field(rng, b_rows, q25, dev).expand(rows, k)
        record("mont_mul", (L._mont_mul_fused(a, b, q25),), (L.mont_mul_plain(a, b, q25),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L._mont_mul_fused(a, b, q25), lambda: L.mont_mul_plain(a, b, q25), 200, 5,
            (2 * rows + b_rows) * word, rows * imad(k, 1, 0), batch=rows, K=k,
            entry="mont_mul", count_key=f"K={k} {rows}", paths=ED25519_SUB_PATHS,
            what=f"q25519, {what}"))
    a = S.random_field(rng, ED25519_B, q25, dev)
    for bits, what in ((q25.p_minus_2_bits, "mont_inv (to_affine, the decode's 1/v)"),
                       (Q25519_SQRT_BITS, "the decode's square root, exponent (q+3)/8")):
        record("mont_mul", (L.mont_pow_static(a, bits, q25),),
               (L.mont_pow_static_plain(a, bits, q25),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L.mont_pow_static(a, bits, q25), lambda: L.mont_pow_static_plain(a, bits, q25),
            20, 1, ED25519_B * 2 * word, ED25519_B * imad(k, sum(bits), len(bits)),
            batch=ED25519_B, K=k, entry="mont_pow", count_key=f"K={k} {ED25519_B} x r={len(bits)}",
            paths=ED25519_SUB_PATHS, what=f"q25519, chain at {ED25519_B} rows: {what}"))
    torch.cuda.synchronize()


def signature_paths(dev) -> dict:
    """bench_ed25519 at ED25519_B and bench_bls at BLS_B, each under
    path_run, with the Ed25519 sign, the Ed25519 verify and the BLS verify
    counted on their untimed first calls (count_path); their refusals raise.
    B1 must launch in each of the three, B2 and B3 in none (the Edwards law
    and the pairing run no Weierstrass kernel)."""
    from zk_toolkit_tpu_torch.bench import bench_bls, bench_ed25519

    counts = {"ed25519": {}, "bls": {}}

    def ed25519(d):
        return bench_ed25519(ED25519_B, d, observe=observing(counts["ed25519"]))

    def bls(d):
        return bench_bls(BLS_B, d, observe=observing(counts["bls"]))

    out = {f"ed25519_{ED25519_B}": path_run(ed25519, dev, ("mont_mul",)),
           f"bls_{BLS_B}": path_run(bls, dev, ("mont_mul",))}
    out["counts"] = {ED25519_SUB_PATHS[0]: counts["ed25519"]["sign"],
                     ED25519_SUB_PATHS[1]: counts["ed25519"]["verify"],
                     f"bls_verify_{BLS_B}": counts["bls"]["verify"]}
    for what, c in out["counts"].items():
        per = c["launches"]
        if not sum(sum(per.get(e, {}).values()) for e in ("mont_mul", "mont_pow")):
            raise RuntimeError(f"B1 not launched inside {what}")
        if per.get("point_add") or per.get("point_double"):
            raise RuntimeError(f"B2/B3 launched inside {what}, which has no Weierstrass law")
    return out


def engines_native(n_pad: int) -> dict:
    """The native host engine: engine(r) is built (not None), and the n_pad
    Lagrange values of groth16_setup's domain at bench's tau are the same
    ints on the engine and in Python; each branch timed on the host
    clock."""
    from zk_toolkit_tpu_torch.bench import TRAPDOOR
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.native import engine, host
    from zk_toolkit_tpu_torch.ops import ntt as NTT
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    eng = engine(params.R)
    out = {"library": os.path.basename(host.lib_path())}
    if eng is None:
        raise RuntimeError("native host engine not built: no g++ on the PATH")
    w = NTT.fr_domain(n_pad, "cpu").w
    res = {}
    for native in (True, False):
        t0 = time.perf_counter()
        res[native] = GD.lagrange_at(n_pad, TRAPDOOR["tau"], w, native=native)
        out["lagrange_native_s" if native else "lagrange_python_s"] = time.perf_counter() - t0
    if res[True] != res[False]:
        raise RuntimeError(f"native Lagrange values differ from Python's at n = {n_pad}")
    out["n_pad"] = n_pad
    return out


def engines_trace(dev) -> dict:
    """One 2^20-point G1 MSM (phase slice's inputs) under
    profiling.trace("msm_2^20") with ZKT_PROFILE_DIR a temporary directory:
    the trace file must be written; its kernel events are counted and the
    card's busy share of the span is read from them."""
    from zk_toolkit_tpu_torch.bench import msm_inputs
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops import msm as M
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.protocols.groth16_device import fixed_base_g1
    from zk_toolkit_tpu_torch.utils import profiling

    ops = FqOps(L.field_spec(params.Q))
    _, _, base, scalars = msm_inputs(1 << 20, dev)
    pts = fixed_base_g1(base)
    M.msm_pippenger(ops, pts, scalars, 255)              # warm
    torch.cuda.synchronize()
    profiling.reset()
    with tempfile.TemporaryDirectory() as d:
        os.environ["ZKT_PROFILE_DIR"] = d
        try:
            with profiling.trace("msm_2^20"):
                M.msm_pippenger(ops, pts, scalars, 255)
                torch.cuda.synchronize()
        finally:
            del os.environ["ZKT_PROFILE_DIR"]
        files = os.listdir(d)
        if len(files) != 1:
            raise RuntimeError(f"profiling.trace wrote {files}, expected one trace file")
        with open(os.path.join(d, files[0])) as fh:
            events = json.load(fh).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    if not kern:
        raise RuntimeError("the profiler trace of the MSM holds no kernel event")
    span_s = profiling.report()["msm_2^20"]["total_s"]
    kernel_us = sum(e.get("dur", 0) for e in kern)
    # one stream, so the kernels do not overlap: the card's busy share of
    # the span is their summed duration over the span's host-clock time
    return {"file": files[0], "events": len(events), "kernel_events": len(kern),
            "kernel_us": kernel_us, "span_s": span_s, "busy_share": kernel_us / 1e6 / span_s}


def pow_inputs(dev) -> list:
    """mont_pow_dynamic's inputs: (spec, bits, a, exponent limbs) for
    POW_FR_ROWS Fr rows with 255-bit exponents and POW_FQ_ROWS Fq rows with
    381-bit exponents; the first rows of a unreduced (p, p + 1, 2^(16K) - 1
    and five more in [p, 2^(16K))), rows 8-11 raised to 0, 1, p - 1, p - 2."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import samples as S
    from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

    rng = np.random.default_rng(2029)
    out = []
    for p, rows, nbits in ((params.R, POW_FR_ROWS, 255), (params.Q, POW_FQ_ROWS, 381)):
        spec = L.field_spec(p)
        k = spec.K
        a = S.random_field(rng, rows, spec, dev)
        above = [p, p + 1, (1 << (16 * k)) - 1] + [p + int(x) for x in rng.integers(2, 1 << 62, 5)]
        a[:len(above)] = torch.from_numpy(ints_to_array(above, k).astype(np.int32)).to(dev)
        e = rng.integers(0, 1 << 16, size=(rows, (nbits + 15) // 16), dtype=np.int64)
        e[:, -1] &= (1 << (nbits - 16 * (e.shape[1] - 1))) - 1
        e[8:12] = ints_to_array([0, 1, p - 1, p - 2], e.shape[1])
        out.append((spec, nbits, a, torch.from_numpy(e.astype(np.int32)).to(dev)))
    return out


def pow_checks(dev, res: dict, inputs: list, results: list) -> dict:
    """mont_pow_dynamic's results (the main path's run) against its plain
    version on the same inputs (into res, as parity_and_timing) and, on 32
    sampled rows (the unreduced and special ones among them), against
    Python's pow; each call's time against the plain version's; B1 timed
    at the stacked [2, B, K] batch of one bit."""
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import samples as S
    from zk_toolkit_tpu_torch.utils.profiling import cuda_ms

    rng = np.random.default_rng(2031)
    out = {}
    for (spec, nbits, a, e), got in zip(inputs, results):
        k, p, rows = spec.K, spec.p, a.shape[0]
        full = 1 << (16 * k)
        before = res["mont_mul"]["mismatches"]
        _record(res, "mont_mul", (got,), (L.mont_pow_dynamic_plain(a, e, spec, nbits),))
        sample = list(range(16)) + [int(i) for i in rng.integers(16, rows, 16)]
        xs = L.unpack(a[sample], spec, mont=False)
        es = [int.from_bytes(r.astype("<u2").tobytes(), "little")
              for r in e[sample].cpu().numpy()]
        vals = L.unpack(got[sample], spec, mont=False)
        r_inv = pow(full, -1, p)
        bad = sum(v != pow(x * r_inv, x_e, p) * full % p for x, x_e, v in zip(xs, es, vals))
        if bad:
            raise RuntimeError(f"mont_pow_dynamic differs from pow on {bad} sampled rows")
        out[f"K={k} {rows} x {nbits} bits"] = {
            "mismatches": res["mont_mul"]["mismatches"] - before,
            "sampled_rows_equal_pow": len(sample),
            "ms": cuda_ms(lambda: L.mont_pow_dynamic(a, e, spec, nbits), 3, warm=1),
            "plain_ms": cuda_ms(lambda: L.mont_pow_dynamic_plain(a, e, spec, nbits), 1, warm=0)}
        x = S.random_field(rng, 2 * rows, spec, dev).view(2, rows, k)
        y = S.random_field(rng, 2 * rows, spec, dev).view(2, rows, k)
        _record(res, "mont_mul", (L._mont_mul_fused(x, y, spec),), (L.mont_mul_plain(x, y, spec),))
        res["mont_mul"]["timings"].append(timed(
            lambda: L._mont_mul_fused(x, y, spec), lambda: L.mont_mul_plain(x, y, spec), 200, 5,
            2 * rows * 3 * 4 * k, 2 * rows * imad(k, 1, 0), batch=2 * rows, K=k,
            entry="mont_mul", count_key=f"K={k} {2 * rows}", paths=("mont_pow_dynamic",),
            what=f"product, mont_pow_dynamic's stacked [2, {rows}, {k}] of one bit"))
    torch.cuda.synchronize()
    return out


def engines_tables(dev) -> dict:
    """The fixed-base window tables of the Groth16 CRS (G1 and G2, 256 bits,
    c = 8): built and saved by build_table_cached into an empty directory
    of $ZKT_TABLE_CACHE_DIR (counted by kernel and batch), then loaded by
    it from there (build_table refused while it loads); loaded equal to
    built, limb for limb; build and load seconds."""
    from zk_toolkit_tpu_torch.ops import fixed_base as FB
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    d = str(dev)
    groups = {"bls12_381_g1": (GD._fq_ops(), GD._g1_base(d)),
              "bls12_381_g2": (GD._e2(), GD._g2_base(d))}
    out, built = {}, {}
    shared = os.environ["ZKT_TABLE_CACHE_DIR"]
    cache = os.environ["ZKT_TABLE_CACHE_DIR"] = tempfile.mkdtemp(dir=shared, prefix="engines_")
    make = FB.build_table
    try:
        def build():
            for key, (ops, base) in groups.items():
                t0 = time.perf_counter()
                built[key] = FB.build_table_cached(ops, base, GD.FR_BITS, GD.FB_WINDOW, key=key)
                torch.cuda.synchronize()
                out[f"{key}_build_s"] = time.perf_counter() - t0

        out["per_build"] = count_launches(build)

        def refuse(*args):
            raise RuntimeError("build_table_cached rebuilt a table it had saved")

        FB.build_table = refuse
        for key, (ops, base) in groups.items():
            t0 = time.perf_counter()
            loaded = FB.build_table_cached(ops, base, GD.FR_BITS, GD.FB_WINDOW, key=key)
            torch.cuda.synchronize()
            out[f"{key}_load_s"] = time.perf_counter() - t0
            if not all(torch.equal(a, b) for a, b in zip(loaded, built[key])):
                raise RuntimeError(f"the loaded {key} table differs from the built one")
    finally:
        FB.build_table = make
        os.environ["ZKT_TABLE_CACHE_DIR"] = shared
    out["cache_files"] = sorted(os.listdir(cache))
    return out


def count_launches(fn) -> dict:
    """Kernel launches of fn(), by launcher entry and batch size, counted at
    the launcher; every key carries K (16 for Fr and secp256k1, 24 for Fq)."""
    from zk_toolkit_tpu_torch import _build

    seen: dict = {}
    launch = _build.launch

    def counting(name, spec, views, n, reps=1, words=()):
        key = f"K={spec.K} {n}" if reps == 1 else f"K={spec.K} {n} x r={reps}"
        seen.setdefault(name, {}).setdefault(key, 0)
        seen[name][key] += 1
        return launch(name, spec, views, n, reps, words)

    _build.launch = counting
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _build.launch = launch
    return seen


def launches_by_batch(dev, n: int = 1 << 20) -> dict:
    """Kernel launches of one n-point MSM (the benchmark's inputs), by
    kernel and batch size."""
    from zk_toolkit_tpu_torch.bench import msm_inputs
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops import msm as M
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.protocols.groth16_device import fixed_base_g1

    _, _, base, scalars = msm_inputs(n, dev)
    pts = fixed_base_g1(base)
    return count_launches(lambda: M.msm_pippenger(FqOps(L.field_spec(params.Q)), pts, scalars, 255))


def count_field_ops(fn) -> dict:
    """During fn(): calls of the plain add_mod / sub_mod / neg_mod (the
    only field operations that run no kernel) and of their carry pass
    loop `_norm`, and the host syncs of every kind, as torch's sync debug
    mode reports them (one warning per synchronising call)."""
    import warnings

    from zk_toolkit_tpu_torch.ops import limbs as L

    seen = dict.fromkeys(("add_mod", "sub_mod", "neg_mod", "_norm"), 0)
    saved = {name: getattr(L, name) for name in seen}

    def counted(name, f):
        def call(*args, **kwargs):
            seen[name] += 1
            return f(*args, **kwargs)
        return call

    for name, f in saved.items():
        setattr(L, name, counted(name, f))
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        for name, f in saved.items():
            setattr(L, name, f)
    seen["host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    return seen


def add_sub_timings(dev) -> dict:
    """ms per call of add_mod and sub_mod (plain PyTorch on the card: a few
    dozen small ops and a host sync per carry pass) at the shapes the prove
    gives them: one G2 point's stacked Fq2 halves [6, 24] (the formulas of
    scalar_mul and the Horner chain) and an NTT butterfly half [2^15, 16]."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.utils import samples as S
    from zk_toolkit_tpu_torch.utils.profiling import cuda_ms

    rng = np.random.default_rng(6)
    out = {}
    for p, rows, label in ((params.Q, 6, "[6, 24] Fq"), (params.R, NTT_N // 2, "[2^15, 16] Fr")):
        spec = L.field_spec(p)
        a, b = S.random_field(rng, rows, spec, dev), S.random_field(rng, rows, spec, dev)
        for fn in (L.add_mod, L.sub_mod):
            out[f"{fn.__name__} {label}"] = cuda_ms(lambda: fn(a, b, spec), 100)
    return out


def count_path(fn, results: list | None = None) -> dict:
    """One instrumented run of fn(): launches by kernel and batch
    (count_launches), plain add/sub/neg calls, _norm calls and host syncs
    (count_field_ops), and the card's peak memory over it; fn's result is
    appended to `results` when given."""
    dev = torch.device("cuda")
    out = {}
    results = [] if results is None else results

    def run():
        out["field_ops"] = count_field_ops(lambda: results.append(fn()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out["launches"] = count_launches(run)
    out["seconds_instrumented"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def observing(into: dict, kept: dict | None = None):
    """An `observe` hook for bench's untimed first calls: runs the call under
    count_path, keeps its counts in into[name] (and its result in
    kept[name] when kept is given), returns the call's result."""
    def observe(name, f):
        results = []
        into[name] = count_path(f, results)
        if kept is not None:
            kept[name] = results[0]
        return results[0]
    return observe


def require_all_launched(per_batch: dict, what: str) -> None:
    """Raises unless B1 (either entry), B2 and B3 each launched in a
    count_launches result."""
    n = {"mont_mul": sum(sum(per_batch.get(e, {}).values()) for e in ("mont_mul", "mont_pow")),
         "point_add": sum(per_batch.get("point_add", {}).values()),
         "point_double": sum(per_batch.get("point_double", {}).values())}
    idle = [k for k, v in n.items() if v == 0]
    if idle:
        raise RuntimeError(f"kernels not launched inside {what}: {idle}")


def groth16_run(dev) -> tuple[dict, dict]:
    """bench_groth16 at 2^16 constraints (its checks raise on a wrong proof
    or a wrong verdict), its untimed warm-up prove and first verify
    instrumented (count_path). Returns its result and, for phase parallel,
    the setup (matrices, CRS, prover) and the warm-up proof at WARM_RS."""
    from zk_toolkit_tpu_torch.bench import bench_groth16, groth16_setup

    torch.cuda.reset_peak_memory_stats(dev)
    setup = groth16_setup(GROTH16_LOG2_N, dev)
    crs_peak = torch.cuda.max_memory_allocated(dev)
    print(f"groth16 setup: m = {setup['mat'].m}, n_pad = {setup['mat'].n_pad}, kmax = "
          f"{setup['mat'].kmax} | R1CS + matrices {setup['setup_s']:.2f} s | CRS (table mode) "
          f"{setup['crs_s']:.3f} s, peak {crs_peak / 2**30:.2f} GiB | prover init "
          f"{setup['prover_init_s']:.2f} s", flush=True)
    counts, kept = {}, {}
    out = bench_groth16(device=dev, setup=setup, observe=observing(counts, kept))
    out["crs_peak_bytes"] = crs_peak
    out["n_pad"] = setup["mat"].n_pad
    out["launches_per_prove"] = counts["prove"]["launches"]
    out["field_ops_per_prove"] = counts["prove"]["field_ops"]
    out["verify_count"] = counts["verify"]
    out["add_sub_ms"] = add_sub_timings(dev)
    return out, {"setup": setup, "proof": kept["prove"]}


def pairing_run(dev) -> dict:
    """bench_pairing at B = 256 (refused unless it equals the host
    optimal-ate; its untimed first batch instrumented, count_path),
    bench_field_muls, and entry()'s Miller loop on the kernels against the
    same loop on the plain versions (limb for limb)."""
    from zk_toolkit_tpu_torch.bench import bench_field_muls, bench_pairing
    from zk_toolkit_tpu_torch.entry import entry
    from zk_toolkit_tpu_torch.ops import pairing_ops as P

    counts = {}
    out = {"bench_pairing": bench_pairing(PAIRING_B, dev, reps=PAIRING_REPS,
                                          observe=observing(counts))}
    out["bench_field_muls"] = bench_field_muls(device=dev)
    fn, args = entry(dev)
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    out["entry_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = P.bls_pairing_ops(plain=True).miller_loop(*args)
    torch.cuda.synchronize()
    out["entry_plain_s"] = time.perf_counter() - t0
    rows, err = diff_stats((got,), (want,))
    if rows or err:
        raise RuntimeError(f"entry()'s Miller loop on the kernels differs from the plain "
                           f"versions: {rows} rows, max limb error {err}")
    out["entry_mismatches"] = 0
    out["entry_launches"] = count_launches(lambda: fn(*args))
    out["count"] = counts["pairing"]
    return out


def pinocchio_run(dev) -> dict:
    """bench_pinocchio at 2^16 constraints from a fresh CRS (its checks
    raise on a proof element that is not its trapdoor multiple or a wrong
    verdict), its prove and its first, untimed verify instrumented
    (count_path): prove_s is the instrumented prove's time."""
    from zk_toolkit_tpu_torch.bench import bench_pinocchio, pinocchio_setup
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    # the tables the Groth16 CRS built are dropped before the peak is reset
    # (pinocchio_setup builds its own under bench.cold_tables)
    GD._g1_table.cache_clear()
    GD._g2_table.cache_clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    setup = pinocchio_setup(PINOCCHIO_LOG2_N, dev)
    out = {"crs_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    counts = {}
    out.update(bench_pinocchio(device=dev, setup=setup, observe=observing(counts)))
    out["prove_count"] = counts["prove"]
    out["verify_count"] = counts["verify"]
    return out


def small_msm_check(dev):
    """A 64-point MSM on the card (kernels) against the host oracle."""
    from zk_toolkit_tpu_torch.bench import msm_inputs
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import curve_ops as C
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops import msm as M
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.utils import host_curve as HC

    spec = L.field_spec(params.Q)
    base_np, sc_np, _, sc = msm_inputs(64, dev)
    ks = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in base_np]
    ss = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in sc_np]
    affs = [HC.g1_mul_affine(k) for k in ks]
    pts = C.pack_points(affs, spec, device=dev)
    got = C.unpack_points(tuple(a[None] for a in M.msm_pippenger(FqOps(spec), pts, sc, 255, c=4)), spec)[0]
    F = HC.FpHost(params.Q)
    acc = (1, 1, 0)
    for a, s in zip(affs, ss):
        acc = HC.jac_add(F, acc, HC.jac_mul(F, HC.from_affine(F, a), s))
    if got != HC.jac_to_affine(F, acc):
        raise RuntimeError("64-point MSM on the card differs from the host oracle")


def parallel_path(mesh, fn, results: list) -> dict:
    """One run of a sharded path, fn(), its result appended to `results`:
    every kernel's launch count and mesh.counts set to 0 just before; the
    seconds (host clock, synchronised before and after), the card's peak
    memory, the process-group calls (mesh.counts) and the launches per
    kernel and by batch (count_launches)."""
    for f in counters().values():
        f.launches = 0
    mesh.counts.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    per_batch = count_launches(lambda: results.append(fn()))
    return {"seconds": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated(mesh.device),
            "collectives": dict(mesh.counts),
            "launches": {k: f.launches for k, f in counters().items()},
            "per_batch": per_batch}


def parallel_run(dev, g16_kept: dict) -> dict:
    """The sharded layer on a world of one over NCCL (make_mesh(1, "cuda"),
    in this process), each path under parallel_path and held against the
    single-device result on the same inputs: sharded_msm_explicit over phase
    slice's 2^20-point stream (== msm_pippenger in affine, and the known
    dlog); sharded_h_from_evs at 2^PARALLEL_NTT_LOG2_N rows (==
    h_coset_then_coeffs limb for limb); sharded_ipa at 2^IPA_LOG2_N
    (bench.ipa_setup's statement: accepts it, rejects P + G, as
    DeviceBulletproofs does on the same challenges); sharded_prove at 2^16
    constraints on phase groth16's matrices and CRS at WARM_RS (== that
    phase's warm-up proof limb for limb, bench.check_proof: the trapdoor's
    multiples, host_oracle_verify accepting it and rejecting a tampered
    statement; B1, B2 and B3 each launched). Ends the process group."""
    from zk_toolkit_tpu_torch.bench import WARM_RS, check_proof, ipa_setup, msm_inputs
    from zk_toolkit_tpu_torch.curves.bls12_381 import params
    from zk_toolkit_tpu_torch.ops import curve_ops as C
    from zk_toolkit_tpu_torch.ops import limbs as L
    from zk_toolkit_tpu_torch.ops import msm as M
    from zk_toolkit_tpu_torch.ops import ntt as NTT
    from zk_toolkit_tpu_torch.ops.field_ops import FqOps
    from zk_toolkit_tpu_torch.parallel.mesh import make_mesh
    from zk_toolkit_tpu_torch.parallel.sharded_groth16 import sharded_prove
    from zk_toolkit_tpu_torch.parallel.sharded_ipa import sharded_ipa
    from zk_toolkit_tpu_torch.parallel.sharded_msm import sharded_msm_explicit
    from zk_toolkit_tpu_torch.parallel.sharded_ntt import sharded_h_from_evs
    from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD
    from zk_toolkit_tpu_torch.protocols.groth16_device import fixed_base_g1
    from zk_toolkit_tpu_torch.utils import host_curve as HC
    from zk_toolkit_tpu_torch.utils import samples as S

    out = {}
    with make_mesh(1, "cuda") as mesh:
        out["mesh"] = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
                       "device": str(mesh.device)}
        # the explicit MSM over phase slice's stream
        spec = L.field_spec(params.Q)
        ops = FqOps(spec)
        base_np, sc_np, base, sc = msm_inputs(1 << 20, dev)
        pts = fixed_base_g1(base)
        got = []
        out["msm_2^20"] = parallel_path(
            mesh, lambda: sharded_msm_explicit(ops, pts, sc, 255, mesh), got)
        single = M.msm_pippenger(ops, pts, sc, 255)
        aff = [C.unpack_points(tuple(a[None] for a in p), spec)[0] for p in (got[0], single)]
        if aff[0] != aff[1]:
            raise RuntimeError("sharded_msm_explicit differs from msm_pippenger in affine")
        if aff[0] != HC.g1_mul_affine(HC._limb_dot_mod_r(base_np, sc_np, 255)):
            raise RuntimeError("sharded_msm_explicit differs from the known dlog")
        del pts, single, got

        # the quotient chain
        n = 1 << PARALLEL_NTT_LOG2_N
        rng = np.random.default_rng(2032)
        fr = L.field_spec(params.R)
        a, b, c = (S.random_field(rng, n, fr, dev) for _ in range(3))
        got = []
        out[f"h_2^{PARALLEL_NTT_LOG2_N}"] = parallel_path(
            mesh, lambda: sharded_h_from_evs(a, b, c, mesh), got)
        want = NTT.h_coset_then_coeffs(NTT.fr_domain(n, dev), a, b, c)
        rows, err = diff_stats((got[0],), (want,))
        if rows or err:
            raise RuntimeError(f"sharded_h_from_evs differs from h_coset_then_coeffs: {rows} "
                               f"rows, max limb error {err}")

        # the IPA, its true statement and P + G
        st = ipa_setup(IPA_LOG2_N, dev)
        bad_P = C.point_add(BD._P_OPS, st["P"], st["G"])
        args = lambda P: (st["n"], st["gg"], st["hh"], st["u"], P, st["a"], st["b"])
        got = []
        out[f"ipa_2^{IPA_LOG2_N}"] = parallel_path(
            mesh, lambda: [sharded_ipa(mesh, *args(P), st["chal"]) for P in (st["P"], bad_P)],
            got)
        single = [BD.DeviceBulletproofs(list(st["chal"])).inner_product_argument(*args(P))
                  for P in (st["P"], bad_P)]
        if got[0] != [True, False] or single != got[0]:
            raise RuntimeError(f"sharded_ipa verdicts {got[0]} (true statement, P + G), "
                               f"DeviceBulletproofs {single}, expected [True, False]")

        # the prove on phase groth16's setup, against its warm-up proof
        setup = g16_kept["setup"]
        mat, crs, prover = setup["mat"], setup["crs"], setup["prover"]
        got = []
        out["prove_2^16"] = parallel_path(
            mesh, lambda: sharded_prove(mesh, mat, crs, prover.wires, *WARM_RS), got)
        ref = g16_kept["proof"]
        rows, err = diff_stats(got[0].a + got[0].b + got[0].c, ref.a + ref.b + ref.c)
        if rows or err:
            raise RuntimeError(f"sharded_prove differs from prove_with_rs at {WARM_RS}: {rows} "
                               f"rows, max limb error {err}")
        out["prove_2^16"]["oracle_s"] = check_proof(crs, prover, got[0], *WARM_RS)
        require_all_launched(out["prove_2^16"]["per_batch"], "the sharded prove")
    return out


def counters():
    from zk_toolkit_tpu_torch.ops import curve_kernels as CK
    from zk_toolkit_tpu_torch.ops import limbs as L

    return {"mont_mul": L._mont_mul_fused, "point_add": CK.point_add_fused,
            "point_double": CK.point_double_fused}


def path_run(fn, dev, kernels) -> dict:
    """fn(dev) with every kernel's launch count set to 0 just before and read
    just after: {"out": its result, "launches": per kernel}; raises if one
    of `kernels`, those of the path, was launched no time."""
    for f in counters().values():
        f.launches = 0
    torch.cuda.synchronize()
    out = fn(dev)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters().items()}
    idle = [k for k in kernels if launches[k] == 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the path {fn.__name__}: {idle}")
    return {"out": out, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    # A fresh table cache: no run reads a table an earlier one left.
    cache_dir = tempfile.mkdtemp(prefix="zkt_tables_")
    os.environ["ZKT_TABLE_CACHE_DIR"] = cache_dir
    try:
        return run_phases()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run_phases() -> int:
    from zk_toolkit_tpu_torch import _build
    from zk_toolkit_tpu_torch.bench import bench_msm

    dev = torch.device("cuda")
    smi = nvidia_smi()
    with phase("build"):
        print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
        secs = _build.build(timeout=PHASE_LIMIT_S["build"] - 20)
        print("kernel build (parallel nvcc, s): " + json.dumps(
            {k: round(v, 1) for k, v in secs.items()}), flush=True)
        usage = {entry: _build.ptxas_usage(entry) for entry in _build.ENTRIES}
        for entry, per_n in usage.items():
            for n_words, u in sorted(per_n.items()):
                print(f"  ptxas {entry} K={2 * n_words}: " + json.dumps(u), flush=True)
        # N = 12 words (K = 24, BLS12-381 Fq) and N = 8 (K = 16: Fr, secp256k1)
        spilled = {f"{entry} K={2 * n_words}": usage[entry].get(n_words)
                   for entry in usage for n_words in (12, 8)
                   if usage[entry].get(n_words, {}).get("registers") is None
                   or usage[entry][n_words].get("stack_bytes", 0)
                   or usage[entry][n_words].get("spill_bytes", 0)}
        if spilled:
            raise RuntimeError("kernels at K = 24 or K = 16 use stack or spill (or no ptxas "
                               f"report): {spilled}")
    with phase("parity"):
        stats = parity_and_timing(dev)
        bad = {k: v["mismatches"] for k, v in stats.items() if v["mismatches"] or v["max_abs_err"]}
        if bad:
            raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    with phase("slice"):
        small_msm_check(dev)
        print("msm 64 points on the card == host oracle", flush=True)
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        out = bench_msm(1 << 20, dev, reps=3)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters().items()}
        print(f"msm 2^20: known-dlog OK | {out['seconds']:.4f} s/msm "
              f"({out['points_per_s']:.0f} points/s) wall {out['wall_seconds']:.4f} s | "
              f"point gen first call {out['point_gen_first_s']:.3f} s | split ms "
              + json.dumps({k: round(v, 2) for k, v in out["split_ms"].items()})
              + f" | peak {out['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        print("msm result: " + json.dumps(out), flush=True)
        idle = [k for k, v in launches.items() if v == 0]
        if idle:
            raise RuntimeError(f"kernels not launched on the main path: {idle}")
        if launches["mont_mul"] != B1_LAUNCHES_PER_BENCH:
            raise RuntimeError(f"B1 launched {launches['mont_mul']} times over bench_msm, expected "
                               f"{B1_LAUNCHES_PER_BENCH} (2 x (1 chain + 4 products) + 2 from_mont)")
        print(f"B1 launches over bench_msm: {launches['mont_mul']} (2 to_affine x (1 chain + "
              "4 products) + 2 from_mont)", flush=True)
        per_msm = launches_by_batch(dev)
        print("launches per 2^20 MSM by batch: " + json.dumps(per_msm), flush=True)
        # c = 8, W = 32: one r = 8 launch per Horner window, 7 for 255*T.
        b3 = per_msm.get("point_double", {})
        if b3.get("K=24 1 x r=8") != 32 or sum(b3.values()) != 32 + 7:
            raise RuntimeError(f"B3 launches per MSM {b3}, expected 32 Horner (r = 8) + 7")
        print(f"B3 launches per 2^20 MSM: {sum(b3.values())} (32 Horner at r = 8, 7 for 255*T)",
              flush=True)
    with phase("groth16"):
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        g16, g16_kept = groth16_run(dev)
        torch.cuda.synchronize()
        g16_launches = {k: fn.launches for k, fn in counters().items()}
        per_prove = g16["launches_per_prove"]
        split = g16["split_ms"]
        print(f"groth16 2^16: proofs == trapdoor multiples, host_oracle_verify accepts and "
              f"rejects a tampered statement ({g16['oracle_s']:.1f} s) | prove "
              f"{g16['prove_s']:.4f} s (first {g16['first_prove_s']:.3f} s) | crs "
              f"{g16['crs_s']:.3f} s | peak {g16['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        print("groth16 stage split, ms per prove (CUDA events): "
              + json.dumps({k: round(v, 3) for k, v in split.items()}), flush=True)
        print(f"groth16 NTT (7 transforms of 2^16): {split['ntt']:.3f} ms, of which B1 products "
              f"{split['ntt_b1']:.3f} ms and add_mod/sub_mod {split['ntt_addsub']:.3f} ms",
              flush=True)
        print("groth16 launches per prove by batch: " + json.dumps(per_prove), flush=True)
        print("groth16 per prove: plain add/sub/neg calls, their _norm calls and host syncs "
              "(sync debug mode): " + json.dumps(g16["field_ops_per_prove"])
              + " | ms per add/sub call: " + json.dumps(
                  {k: round(v, 4) for k, v in g16["add_sub_ms"].items()}), flush=True)
        print("groth16 result: " + json.dumps(g16), flush=True)
        require_all_launched(per_prove, "one Groth16 prove")
        idle = [k for k, v in g16_launches.items() if v == 0]
        if idle:
            raise RuntimeError(f"kernels not launched in phase groth16: {idle}")
        vc = g16["verify_count"]
        require_all_launched(vc["launches"], "one Groth16 verify")
        print(f"groth16 verify: the device verifier accepts the proof and rejects a tampered "
              f"statement, as host_oracle_verify does | verify_s {g16['verify_s']:.4f} s (first "
              f"{g16['verify_first_s']:.3f} s) | launches by batch " + json.dumps(vc["launches"])
              + " | add/sub/neg, _norm, host syncs " + json.dumps(vc["field_ops"])
              + f" | peak {vc['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    with phase("pairing"):
        pr = path_run(pairing_run, dev, ("mont_mul",))
        bp, bf, pc = pr["out"]["bench_pairing"], pr["out"]["bench_field_muls"], pr["out"]["count"]
        print(f"pairing B = {PAIRING_B}: rows 0 and {PAIRING_B - 1} == host optimal-ate | "
              f"{bp['seconds']:.4f} s per batch, {bp['pairings_per_s']:.2f} pairings/s (first "
              f"{bp['first_s']:.3f} s) | peak {bp['peak_bytes'] / 2**30:.3f} GiB | launches by "
              "batch " + json.dumps(pc["launches"]) + " | add/sub/neg, _norm, host syncs "
              + json.dumps(pc["field_ops"]), flush=True)
        print(f"field muls: {bf['muls_per_s']:.4e} Montgomery products/s ({bf['chain']} B1 "
              f"launches over {bf['b']} Fq rows, {bf['seconds']:.5f} s; plain chain equal)",
              flush=True)
        print(f"entry(): Miller loop of G1 x {{1, 7}}, G2 x {{1, 11}} on the kernels == plain "
              f"versions limb for limb ({pr['out']['entry_s']:.3f} s, plain "
              f"{pr['out']['entry_plain_s']:.3f} s) | launches " + json.dumps(
                  pr["out"]["entry_launches"]), flush=True)
        print("pairing result: " + json.dumps(pr["out"]), flush=True)
    with phase("pinocchio"):
        pn = path_run(pinocchio_run, dev, tuple(counters()))
        po = pn["out"]
        require_all_launched(po["prove_count"]["launches"], "one Pinocchio prove")
        print(f"pinocchio 2^{PINOCCHIO_LOG2_N}: the nine proof elements == trapdoor multiples, "
              f"the device verifier accepts and rejects a wrong statement | crs "
              f"{po['crs_s']:.3f} s | prove {po['prove_s']:.4f} s | verify_s "
              f"{po['verify_s']:.4f} s (first {po['verify_first_s']:.3f} s) | peak prove "
              f"{po['peak_bytes'] / 2**30:.2f} GiB, crs {po['crs_peak_bytes'] / 2**30:.2f} GiB",
              flush=True)
        for what in ("prove", "verify"):
            c = po[f"{what}_count"]
            print(f"pinocchio {what}: launches by batch " + json.dumps(c["launches"])
                  + " | add/sub/neg, _norm, host syncs " + json.dumps(c["field_ops"])
                  + f" | peak {c['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        print("pinocchio result: " + json.dumps(po), flush=True)
    with phase("secp256k1"):
        sp = secp256k1_paths(dev)
        sc = sp.pop("counts")
        ipa, rp, ec = (sp[k]["out"] for k in sp)
        print(f"ipa 2^{IPA_LOG2_N}: accepts the true statement, rejects P + G | ipa_s "
              f"{ipa['ipa_s']:.4f} s (first {ipa['first_s']:.3f} s, setup {ipa['setup_s']:.3f} s)"
              f" | peak {ipa['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        print(f"range proof {RANGE_BITS} bits (with the IPA): accepts v < 2^{RANGE_BITS}, rejects "
              f"a flipped bit | range_s {rp['range_s']:.4f} s (first {rp['first_s']:.3f} s) | peak "
              f"{rp['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        print(f"ecdsa B = {ECDSA_B}: every row verifies, rows {', '.join(ec['rejects_bad_rows'])} "
              f"rejected, sampled (r, s) == host | keygen {ec['keygen_s']:.4f} s | sign_s "
              f"{ec['sign_s']:.4f} s (first {ec['sign_first_s']:.3f} s, {ec['sign_per_s']:.1f} "
              f"signatures/s) | verify_s {ec['verify_s']:.4f} s (first {ec['verify_first_s']:.3f} "
              f"s, {ec['verify_per_s']:.1f} signatures/s) | peak {ec['peak_bytes'] / 2**30:.3f} "
              "GiB", flush=True)
        for what, c in (("ipa", sc["ipa"]), ("range proof", sc["range"]),
                        ("ecdsa verify", sc["verify"])):
            print(f"{what}: launches by batch " + json.dumps(c["launches"])
                  + " | add/sub/neg, _norm, host syncs " + json.dumps(c["field_ops"])
                  + f" | peak {c['peak_bytes'] / 2**30:.3f} GiB | instrumented run "
                  f"{c['seconds_instrumented']:.2f} s", flush=True)
        print("secp256k1 result: " + json.dumps({k: v["out"] for k, v in sp.items()}), flush=True)
        secp256k1_timing(dev, stats)
        print("secp256k1 kernel shapes (K = 16) == plain versions", flush=True)
        bad = {k: v["mismatches"] for k, v in stats.items() if v["mismatches"] or v["max_abs_err"]}
        if bad:
            raise RuntimeError(f"kernels disagree with their plain versions at K = 16: {bad}")
    with phase("signatures"):
        sg = signature_paths(dev)
        sgc = sg.pop("counts")
        ed, bl = (sg[k]["out"] for k in sg)
        print(f"ed25519 B = {ED25519_B}, {ed['msg_bytes']}-byte messages: rows 0, "
              f"{ED25519_B // 2}, {ED25519_B - 1} keys and signatures == host Ed25519Sha512, every "
              f"row verifies, rows {', '.join(ed['rejects_bad_rows'])} rejected | keys "
              f"{ed['keys_s']:.4f} s | sign_s {ed['sign_s']:.4f} s (first {ed['sign_first_s']:.3f} "
              f"s, {ed['sign_per_s']:.1f} signatures/s) | verify_s {ed['verify_s']:.4f} s (first "
              f"{ed['verify_first_s']:.3f} s, {ed['verify_per_s']:.1f} signatures/s) | peak "
              f"{ed['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        print(f"bls B = {BLS_B}: every row verifies, rows {', '.join(bl['rejects_bad_rows'])} "
              f"rejected | setup (host Signer) {bl['setup_s']:.3f} s | verify_s "
              f"{bl['verify_s']:.4f} s (first {bl['verify_first_s']:.3f} s, "
              f"{bl['verify_per_s']:.2f} verifications/s) | peak "
              f"{bl['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        for what, c in sgc.items():
            print(f"{what}: launches by batch " + json.dumps(c["launches"])
                  + " | add/sub/neg, _norm, host syncs " + json.dumps(c["field_ops"])
                  + f" | peak {c['peak_bytes'] / 2**30:.3f} GiB | instrumented run "
                  f"{c['seconds_instrumented']:.2f} s", flush=True)
        print("signatures result: " + json.dumps({k: v["out"] for k, v in sg.items()}), flush=True)
        signature_timing(dev, stats)
        print("signature kernel shapes (B1 at K = 16 mod q25519) == plain versions", flush=True)
        bad = {k: v["mismatches"] for k, v in stats.items() if v["mismatches"] or v["max_abs_err"]}
        if bad:
            raise RuntimeError(f"kernels disagree with their plain versions at q25519: {bad}")
    with phase("engines"):
        en = engines_native(g16["n_pad"])
        print(f"native engine {en['library']}: the {en['n_pad']} Lagrange values of the Groth16 "
              f"domain at tau equal on the engine ({en['lagrange_native_s']:.3f} s) and in Python "
              f"({en['lagrange_python_s']:.3f} s)", flush=True)
        print("profiling.trace('msm_2^20') under ZKT_PROFILE_DIR: "
              + json.dumps(engines_trace(dev)), flush=True)
        from zk_toolkit_tpu_torch.ops import limbs as L

        pow_in = pow_inputs(dev)

        def mont_pow_dynamic_path(d):
            results = []
            counts = count_launches(lambda: results.extend(
                L.mont_pow_dynamic(a, e, spec, nbits) for spec, nbits, a, e in pow_in))
            return results, counts

        pw = path_run(mont_pow_dynamic_path, dev, ("mont_mul",))
        pow_results, pow_counts = pw["out"]
        want_b1 = sum(1 + nbits for _, nbits, _, _ in pow_in)
        if pw["launches"]["mont_mul"] != want_b1:
            raise RuntimeError(f"mont_pow_dynamic made {pw['launches']['mont_mul']} B1 launches, "
                               f"expected {want_b1} (1 + one stacked launch per bit)")
        pow_chk = pow_checks(dev, stats, pow_in, pow_results)
        print(f"mont_pow_dynamic: {want_b1} B1 launches by batch " + json.dumps(pow_counts)
              + " | == plain version and sampled rows == pow: " + json.dumps(pow_chk), flush=True)
        tb = path_run(engines_tables, dev, tuple(counters()))
        to = tb["out"]
        print("fixed-base tables G1/G2 (256 bits, c = 8): built and saved, then loaded == "
              "built, limb for limb | seconds " + json.dumps(
                  {k: round(v, 3) for k, v in to.items() if k.endswith("_s")})
              + " | build launches by batch " + json.dumps(to["per_build"]), flush=True)
        bad = {k: v["mismatches"] for k, v in stats.items() if v["mismatches"] or v["max_abs_err"]}
        if bad:
            raise RuntimeError(f"kernels disagree with their plain versions in phase engines: {bad}")
    with phase("parallel"):
        par = parallel_run(dev, g16_kept)
        del g16_kept
        print(f"parallel: a world of one over {par['mesh']['backend']} on "
              f"{par['mesh']['device']}: sharded_msm_explicit 2^20 == msm_pippenger and the "
              f"known dlog; sharded_h_from_evs 2^{PARALLEL_NTT_LOG2_N} == h_coset_then_coeffs; "
              f"sharded_ipa 2^{IPA_LOG2_N} accepts, rejects P + G, as DeviceBulletproofs; "
              f"sharded_prove 2^16 == prove_with_rs at (5, 6), the trapdoor's, "
              f"host_oracle_verify accepts and rejects a tampered statement "
              f"({par['prove_2^16']['oracle_s']:.1f} s)", flush=True)
        for path in ("msm_2^20", f"h_2^{PARALLEL_NTT_LOG2_N}", f"ipa_2^{IPA_LOG2_N}",
                     "prove_2^16"):
            r = par[path]
            print(f"parallel {path}: {r['seconds']:.4f} s | peak {r['peak_bytes'] / 2**30:.3f} "
                  f"GiB | mesh.counts " + json.dumps(r["collectives"]) + " | launches "
                  + json.dumps(r["launches"]) + " | by batch " + json.dumps(r["per_batch"]),
                  flush=True)
    by_path = {"msm_2^20": launches, "groth16_2^16": g16_launches,
               f"pairing_{PAIRING_B}": pr["launches"],
               f"pinocchio_2^{PINOCCHIO_LOG2_N}": pn["launches"],
               **{path: v["launches"] for path, v in sp.items()},
               **{path: v["launches"] for path, v in sg.items()},
               "mont_pow_dynamic": pw["launches"], "table_build": tb["launches"],
               **{f"parallel_{path}": v["launches"] for path, v in par.items() if path != "mesh"}}
    # launches at each timed shape, by path, from the instrumented runs
    shape_counts = {"groth16_prove": g16["launches_per_prove"],
                    "groth16_verify": g16["verify_count"]["launches"],
                    f"pairing_{PAIRING_B}": pc["launches"],
                    "pinocchio_prove": po["prove_count"]["launches"],
                    "pinocchio_verify": po["verify_count"]["launches"],
                    f"ipa_2^{IPA_LOG2_N}": sc["ipa"]["launches"],
                    f"range_{RANGE_BITS}": sc["range"]["launches"],
                    f"ecdsa_verify_{ECDSA_B}": sc["verify"]["launches"],
                    **{path: c["launches"] for path, c in sgc.items()},
                    "mont_pow_dynamic": pow_counts, "table_build": to["per_build"],
                    **{f"parallel_{path}": v["per_batch"] for path, v in par.items()
                       if path != "mesh"}}
    kernels = []
    for name, source, replaces, _ in KERNELS:
        s = stats[name]
        for t in s["timings"]:
            if "count_key" in t:
                # a key names K and the batch, not the modulus: an entry whose
                # shape two K = 16 fields share lists the paths of its own
                paths = t.pop("paths", tuple(shape_counts))
                t["launches_on_path"] = {path: shape_counts[path].get(t["entry"], {}).get(
                    t["count_key"], 0) for path in paths}
        first = s["timings"][0]
        u = usage[first.get("entry", name)].get(12, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {path: p[name] for path, p in by_path.items()},
            "launches_by_sub_path": {path: sum(v for e, per in c.items()
                                               if _build.ENTRIES.get(e, e) == name
                                               for v in per.values())
                                     for path, c in shape_counts.items()},
            "max_abs_err": s["max_abs_err"],
            "mismatches": s["mismatches"], "batch": first["batch"], "ms": first["ms"],
            "device_ms": first["device_ms"], "host_us": first["host_us"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"], "library_ms": None,
            "registers": u.get("registers"), "stack_bytes": u.get("stack_bytes"),
            "spill_bytes": u.get("spill_bytes"), "timings": s["timings"][1:],
            "ptxas": {f"{e} K={2 * n_words}": usage[e][n_words]
                      for e, src in _build.ENTRIES.items() if src == name
                      for n_words in sorted(usage[e])},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
