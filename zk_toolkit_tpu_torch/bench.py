"""Benchmarks of the port (the twin of the repository's bench.py).

bench_msm: the 2^20-point BLS12-381 G1 MSM, the repository's headline
metric, over n DISTINCT points k_i * G made by the fixed-base path and
255-bit scalars. The result is asserted against the known-dlog oracle before
any timing: with P_i = k_i * G and known k_i the MSM must equal
(sum s_i k_i mod r) * G, an exact check that costs one uint64 matmul and one
host scalar multiplication. The benchmark refuses to report a wrong result.

bench_groth16: the Groth16 prove on the synthetic 2^16-constraint R1CS of
bench.py, on bench.py's trapdoor and randomness. The
device verifier is not ported yet, so the proofs are checked on the host:
A, B, C must equal the trapdoor multiples of the generators (recomputed
from the trapdoor, `trapdoor_proof`), and host_oracle_verify must accept
the proof and reject the statement with its last wire changed.

Run on a card: python -m zk_toolkit_tpu_torch.bench [log2_n]   (the MSM)
               python -m zk_toolkit_tpu_torch.bench groth16 [log2_n]
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

R = params.R


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


# bench.py's trapdoor and randomness: a warm-up prove, then TIMED_PROVES
# timed ones.
TRAPDOOR = dict(tau=987654321, alpha=11, beta=22, gamma=33, delta=44)
WARM_RS = (5, 6)
TIMED_RS = (7, 8)
TIMED_PROVES = 2


def trapdoor_proof(mat, wires, r, s, tau, alpha, beta, gamma, delta):
    """The proof (A, C as affine G1 int pairs, B as an affine G2 pair of
    int pairs) that the trapdoor fixes: A = a*G1, B = b*G2, C = c*G1 with
    a = alpha + u(tau) + r*delta, b = beta + v(tau) + s*delta and
    c = (sum_wit a_i uvw_i + h(tau) t(tau)) / delta + s*a + r*b - r*s*delta,
    every polynomial evaluated at tau through the Lagrange basis of the NTT
    domain, on the host."""
    from zk_toolkit_tpu_torch.ops.ntt import FR_GENERATOR

    n = mat.n_pad
    w_root = pow(FR_GENERATOR, (R - 1) >> (n.bit_length() - 1), R)
    t_tau = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, -1, R)
    lag, wj = [], 1
    for _ in range(n):
        lag.append(t_tau * wj % R * pow((tau - wj) % R, -1, R) % R * n_inv % R)
        wj = wj * w_root % R
    u, v, w = ([0] * (mat.m + 1) for _ in range(3))
    for j, cons in enumerate(mat.tmpl.constraints):
        for acc, side in ((u, cons.a), (v, cons.b), (w, cons.c)):
            for idx, coeff in side:
                acc[idx] = (acc[idx] + coeff.e * lag[j]) % R
    ua = sum(a * ui for a, ui in zip(wires, u)) % R
    va = sum(a * vi for a, vi in zip(wires, v)) % R
    wa = sum(a * wi for a, wi in zip(wires, w)) % R
    h_tau = (ua * va - wa) * pow(t_tau, -1, R) % R
    delta_inv = pow(delta, -1, R)
    a_scalar = (alpha + ua + r * delta) % R
    b_scalar = (beta + va + s * delta) % R
    uvw_wit = sum(wires[i] * ((beta * u[i] + alpha * v[i] + w[i]) % R)
                  for i in range(mat.l + 1, mat.m + 1)) % R * delta_inv % R
    c_scalar = (uvw_wit + h_tau * t_tau % R * delta_inv + s * a_scalar
                + r * b_scalar - r * s % R * delta) % R
    f2 = HC.Fp2Host(params.Q)
    b_pt = HC.jac_to_affine(f2, HC.jac_mul(f2, HC.from_affine(f2, HC.G2_AFFINE), b_scalar))
    return HC.g1_mul_affine(a_scalar), b_pt, HC.g1_mul_affine(c_scalar)


def proof_affine(proof) -> tuple:
    """A DeviceProof as host ints: (A, B, C) affine, None for infinity; B's
    coordinates are (u0, u1) pairs."""
    spec = L.field_spec(params.Q)

    def g1_pt(aff):
        if bool(aff[2].reshape(-1)[0]):
            return None
        return (L.unpack(aff[0], spec)[0], L.unpack(aff[1], spec)[0])

    def g2_pt(aff):
        if bool(aff[2].reshape(-1)[0]):
            return None
        return tuple(tuple(L.unpack(c, spec)) for c in aff[:2])

    return g1_pt(proof.a), g2_pt(proof.b), g1_pt(proof.c)


def check_proof(crs, prover, proof, r: int, s: int, trapdoor=TRAPDOOR) -> float:
    """Raises unless the proof is the trapdoor's and host_oracle_verify
    accepts it and rejects the statement with its last wire changed.
    Returns the oracle's seconds."""
    from zk_toolkit_tpu_torch.protocols.groth16_device import host_oracle_verify

    want = trapdoor_proof(prover.mat, prover.wires, r, s, **trapdoor)
    got = proof_affine(proof)
    for name, g, w in zip("ABC", got, want):
        if g != w:
            raise RuntimeError(f"proof element {name} differs from the trapdoor's — refusing to report")
    t0 = time.perf_counter()
    stmt = prover.statement()
    bad = list(stmt)
    bad[-1] = (bad[-1] + 1) % R
    if not host_oracle_verify(crs, proof, stmt):
        raise RuntimeError("host_oracle_verify rejects the proof — refusing to report")
    if host_oracle_verify(crs, proof, bad):
        raise RuntimeError("host_oracle_verify accepts a tampered statement — refusing to report")
    return time.perf_counter() - t0


def groth16_setup(log2_n: int = 16, device="cuda") -> dict:
    """What a prove needs, on synthetic_r1cs(SUBGROUP, 2^log2_n, seed=2):
    the matrices, the CRS from bench.py's trapdoor (crs_s, host clock after
    a synchronise) and the prover, with the seconds each took."""
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    dev = resolve_device(device)
    t0 = time.perf_counter()
    tmpl, wit = synthetic_r1cs(params.SUBGROUP, 1 << log2_n, seed=2)
    mat = GD.CircuitMatrices.from_tmpl(tmpl, dev)
    setup_s = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    crs = GD.DeviceCRS.from_trapdoor(mat, device=dev, **TRAPDOOR)
    _sync(dev)
    crs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prover = GD.DeviceGroth16Prover(mat, wit, dev)
    return {"mat": mat, "crs": crs, "prover": prover, "setup_s": setup_s, "crs_s": crs_s,
            "prover_init_s": time.perf_counter() - t0}


def bench_groth16(log2_n: int = 16, device="cuda", setup: dict | None = None) -> dict:
    """The Groth16 prove on synthetic_r1cs(SUBGROUP, 2^log2_n, seed=2)
    through the public API, as bench.py runs it (log2_n 16; its quick run
    takes 10): the CRS (groth16_setup, or `setup` when given), a warm-up
    prove at (r, s) = (5, 6) checked by check_proof, then TIMED_PROVES
    proves at (7, 8) (prove_s: host clock per prove, after a synchronise),
    the last one checked against the trapdoor. split_ms holds each stage's
    time per prove (utils.profiling.Spans: CUDA events on a card);
    peak_bytes the card's peak over the timed proves."""
    dev = resolve_device(device)
    reps = TIMED_PROVES
    if setup is None:
        setup = groth16_setup(log2_n, dev)
    mat, crs, prover = setup["mat"], setup["crs"], setup["prover"]

    t0 = time.perf_counter()
    proof = prover.prove_with_rs(crs, *WARM_RS)
    _sync(dev)
    first_prove_s = time.perf_counter() - t0
    oracle_s = check_proof(crs, prover, proof, *WARM_RS)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spans = Spans(dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        proof = prover.prove_with_rs(crs, *TIMED_RS, spans=spans)
    _sync(dev)
    prove_s = (time.perf_counter() - t0) / reps
    want = trapdoor_proof(mat, prover.wires, *TIMED_RS, **TRAPDOOR)
    if proof_affine(proof) != want:
        raise RuntimeError("timed proof differs from the trapdoor's — refusing to report")
    out = {
        "n_constraints": mat.n, "n_pad": mat.n_pad, "m": mat.m, "l": mat.l, "kmax": mat.kmax,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "trapdoor_ok": True, "oracle_ok": True,
        "prove_s": prove_s, "crs_s": setup["crs_s"], "first_prove_s": first_prove_s,
        "setup_s": setup["setup_s"], "prover_init_s": setup["prover_init_s"],
        "oracle_s": oracle_s,
        "split_ms": {k: v / reps for k, v in spans.totals().items()},
    }
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    if args and args[0] == "groth16":
        print(json.dumps(bench_groth16(int(args[1]) if len(args) > 1 else 16)))
    else:
        print(json.dumps(bench_msm(1 << (int(args[0]) if args else 20))))
