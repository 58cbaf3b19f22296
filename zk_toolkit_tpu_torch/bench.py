"""Benchmarks of the port (the twin of the repository's bench.py).

bench_msm: the 2^20-point BLS12-381 G1 MSM, the repository's headline
metric, over n DISTINCT points k_i * G made by the fixed-base path and
255-bit scalars. The result is asserted against the known-dlog oracle before
any timing: with P_i = k_i * G and known k_i the MSM must equal
(sum s_i k_i mod r) * G, an exact check that costs one uint64 matmul and one
host scalar multiplication. The benchmark refuses to report a wrong result.
host_msm_rate: the single-threaded host-tier MSM rate (points/s) on 64
points, the JAX package's bench.py stand-in baseline.

bench_groth16: the Groth16 prove and verify on the synthetic 2^16-constraint
R1CS of bench.py, on bench.py's trapdoor and randomness. A, B, C must equal
the trapdoor multiples of the generators (recomputed from the trapdoor,
`trapdoor_proof`), host_oracle_verify must accept the proof and reject the
statement with its last wire changed, and the device verifier must do the
same; verify_s is its second call, as bench.py times it.

bench_pairing: batched optimal-ate pairings per second at B = 256, refused
unless the first and last rows equal the host optimal-ate.

bench_field_muls: Montgomery products per second, a 64-step chain of B1
launches over 2^16 Fq rows, refused unless it equals the plain chain.

bench_pinocchio: the Pinocchio CRS, prove and verify on the same circuit;
the nine proof elements must equal their trapdoor multiples, the verifier
must accept the proof and reject a wrong statement.

bench_ipa: one Bulletproofs inner-product argument over 2^10 secp256k1
bases (bench.py:bench_ipa's size), refused unless it accepts the true
statement and rejects P + G. bench_range_proof: the 64-bit range proof with
the IPA, refused unless it accepts v < 2^64 and rejects a flipped witness
bit. bench_ecdsa: batched ECDSA keygen, sign and verify over 4096
signatures, refused unless every row verifies, the bad rows are rejected
and sampled rows equal the host's equations.

bench_ed25519: batched RFC 8032 sign and verify over 4096 signatures of
96-byte messages, refused unless sampled keys and signatures equal the host
Ed25519Sha512's, every true row verifies and the five bad rows are
rejected. bench_bls: batched BLS verification over 64 signatures (one
Ethereum slot's committees), refused unless every true row verifies and the
four bad rows are rejected.

Run on a card: python -m zk_toolkit_tpu_torch.bench [log2_n]   (the MSM)
               python -m zk_toolkit_tpu_torch.bench host_msm
               python -m zk_toolkit_tpu_torch.bench groth16 [log2_n]
               python -m zk_toolkit_tpu_torch.bench pairing [b]
               python -m zk_toolkit_tpu_torch.bench field_muls [log2_b]
               python -m zk_toolkit_tpu_torch.bench pinocchio [log2_n]
               python -m zk_toolkit_tpu_torch.bench ipa [log2_n]
               python -m zk_toolkit_tpu_torch.bench range [n]
               python -m zk_toolkit_tpu_torch.bench ecdsa [b]
               python -m zk_toolkit_tpu_torch.bench ed25519 [b]
               python -m zk_toolkit_tpu_torch.bench bls [b]
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import sys
import tempfile
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


def _peak(dev) -> dict:
    return {"peak_bytes": torch.cuda.max_memory_allocated(dev)} if dev.type == "cuda" else {}


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _timed(dev, f):
    """(f(), seconds on the host clock, synchronised before and after)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = f()
    _sync(dev)
    return out, time.perf_counter() - t0


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

    pts, point_gen_first_s = _timed(dev, lambda: fixed_base_g1(base))

    res = M.msm_pippenger(ops, pts, scalars, 255, c=c)
    got = C.unpack_points(tuple(a[None] for a in res), spec)[0]
    want = HC.g1_mul_affine(HC._limb_dot_mod_r(base_np, scalars_np, 255))
    if got != want:
        raise RuntimeError(
            f"MSM(n={n}) does not match the known-dlog host oracle — refusing to report"
        )

    _reset_peak(dev)
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
    return {
        "n": n,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "known_dlog_ok": True,
        "seconds": dt,
        "wall_seconds": wall,
        "points_per_s": n / dt,
        "point_gen_first_s": point_gen_first_s,
        "split_ms": split,
        **_peak(dev),
    }


def host_msm_rate() -> float:
    """Single-threaded host-tier MSM points/s (the host AffinePoint law,
    the reference's semantics), measured on 64 points, as the JAX package's
    bench.py:host_msm_rate."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1

    random.seed(3)
    n = 64
    pts = [g1.g() * random.randrange(1, params.R) for _ in range(n)]
    ks = [random.randrange(params.R) for _ in range(n)]
    t0 = time.perf_counter()
    acc = g1.infinity()
    for p, k in zip(pts, ks):
        acc = acc + p * k
    return n / (time.perf_counter() - t0)


# bench.py's trapdoor and randomness: a warm-up prove, then TIMED_PROVES
# timed ones.
TRAPDOOR = dict(tau=987654321, alpha=11, beta=22, gamma=33, delta=44)
WARM_RS = (5, 6)
TIMED_RS = (7, 8)
TIMED_PROVES = 2


def domain_root(n: int) -> int:
    """The primitive n-th root of unity of the NTT domain (ops/ntt.py's),
    computed on the host."""
    from zk_toolkit_tpu_torch.ops.ntt import FR_GENERATOR

    return pow(FR_GENERATOR, (R - 1) >> (n.bit_length() - 1), R)


def host_qap_at(mat, x: int):
    """(u_i(x), v_i(x), w_i(x) per wire, t(x)) over the domain of
    domain_root(n_pad), through the Lagrange basis
    L_j(x) = t(x) w^j / (n (x - w^j)), on the host. The trapdoor checks use
    this and not the CRS's own evaluation, so that a fault there cannot move
    the CRS and the expected multiples together."""
    n = mat.n_pad
    w_root = domain_root(n)
    t_x = (pow(x, n, R) - 1) % R
    n_inv = pow(n, -1, R)
    lag, wj = [], 1
    for _ in range(n):
        lag.append(t_x * wj % R * pow((x - wj) % R, -1, R) % R * n_inv % R)
        wj = wj * w_root % R
    cols = [[0] * (mat.m + 1) for _ in range(3)]
    for j, cons in enumerate(mat.tmpl.constraints):
        for col, side in zip(cols, (cons.a, cons.b, cons.c)):
            for idx, coeff in side:
                col[idx] = (col[idx] + coeff.e * lag[j]) % R
    return (*cols, t_x)


def trapdoor_proof(mat, wires, r, s, tau, alpha, beta, gamma, delta):
    """The proof (A, C as affine G1 int pairs, B as an affine G2 pair of
    int pairs) that the trapdoor fixes: A = a*G1, B = b*G2, C = c*G1 with
    a = alpha + u(tau) + r*delta, b = beta + v(tau) + s*delta and
    c = (sum_wit a_i uvw_i + h(tau) t(tau)) / delta + s*a + r*b - r*s*delta,
    every polynomial evaluated at tau through the Lagrange basis of the NTT
    domain, on the host."""
    u, v, w, t_tau = host_qap_at(mat, tau)
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


def g1_affine(pt) -> tuple | None:
    """A batch-1 G1 Jacobian point -> affine (x, y) ints, None for
    infinity."""
    return C.unpack_points(pt, L.field_spec(params.Q))[0]


def g2_affine(pt) -> tuple | None:
    """A batch-1 G2 Jacobian point -> affine ((x0, x1), (y0, y1)) ints, None
    for infinity."""
    from zk_toolkit_tpu_torch.ops.tower_ops import Fq2Ops

    spec = L.field_spec(params.Q)
    ax, ay, inf = C.to_affine(Fq2Ops(FqOps(spec)), pt)
    if bool(inf.reshape(-1)[0]):
        return None
    return tuple(tuple(L.unpack(c, spec)) for c in (ax, ay))


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


@contextlib.contextmanager
def cold_tables():
    """The CRS's fixed-base window tables as a first run in a fresh checkout
    finds them: none in memory (groth16_device's table caches cleared) and
    none on disk ($ZKT_TABLE_CACHE_DIR an empty directory for the block),
    so a crs_s timed inside counts both table builds, whatever earlier
    runs left."""
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    GD._g1_table.cache_clear()
    GD._g2_table.cache_clear()
    old = os.environ.get("ZKT_TABLE_CACHE_DIR")
    with tempfile.TemporaryDirectory(prefix="zkt_tables_") as d:
        os.environ["ZKT_TABLE_CACHE_DIR"] = d
        try:
            yield
        finally:
            if old is None:
                del os.environ["ZKT_TABLE_CACHE_DIR"]
            else:
                os.environ["ZKT_TABLE_CACHE_DIR"] = old


def groth16_setup(log2_n: int = 16, device="cuda") -> dict:
    """What a prove needs, on synthetic_r1cs(SUBGROUP, 2^log2_n, seed=2):
    the matrices, the CRS from bench.py's trapdoor (crs_s, host clock after
    a synchronise, under cold_tables) and the prover, with the seconds each
    took."""
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    dev = resolve_device(device)
    t0 = time.perf_counter()
    tmpl, wit = synthetic_r1cs(params.SUBGROUP, 1 << log2_n, seed=2)
    mat = GD.CircuitMatrices.from_tmpl(tmpl, dev)
    setup_s = time.perf_counter() - t0
    with cold_tables():
        crs, crs_s = _timed(dev, lambda: GD.DeviceCRS.from_trapdoor(mat, device=dev, **TRAPDOOR))
    t0 = time.perf_counter()
    prover = GD.DeviceGroth16Prover(mat, wit, dev)
    return {"mat": mat, "crs": crs, "prover": prover, "setup_s": setup_s, "crs_s": crs_s,
            "prover_init_s": time.perf_counter() - t0}


def tampered(stmt: list[int]) -> list[int]:
    """The statement with its last wire changed."""
    return stmt[:-1] + [(stmt[-1] + 1) % R]


def _run(observe, name: str, f):
    """f(), or observe(name, f) when an observer is given: it runs f (an
    instrumented run, say) and returns f's result. chip_smoke.py counts
    launches and field ops over these untimed first calls, which saves its
    run one more prove and one more verify per protocol."""
    return f() if observe is None else observe(name, f)


def check_device_verify(verify, proof, crs, stmt, observe=None) -> dict:
    """Runs the device verifier twice on the true statement (the first call,
    under observe("verify", ...) when given, must accept; the second, timed,
    must too) and once on the tampered one (must reject). Returns
    verify_first_s and verify_s (host clock after a synchronise)."""
    dev = crs.mat.a_idx.device
    ok, verify_first_s = _timed(dev, lambda: _run(observe, "verify",
                                                  lambda: verify(proof, crs, stmt)))
    if not ok:
        raise RuntimeError("the device verifier rejects the proof — refusing to report")
    ok, verify_s = _timed(dev, lambda: verify(proof, crs, stmt))
    if not ok:
        raise RuntimeError("the device verifier flipped on re-run — refusing to report")
    if verify(proof, crs, tampered(stmt)):
        raise RuntimeError("the device verifier accepts a tampered statement — "
                           "refusing to report")
    return {"verify_first_s": verify_first_s, "verify_s": verify_s}


def bench_groth16(log2_n: int = 16, device="cuda", setup: dict | None = None,
                  observe=None) -> dict:
    """The Groth16 prove and verify on synthetic_r1cs(SUBGROUP, 2^log2_n,
    seed=2) through the public API, as bench.py runs them (log2_n 16; its
    quick run takes 10): the CRS (groth16_setup, or `setup` when given), a
    warm-up prove at (r, s) = (5, 6) checked by check_proof and by the
    device verifier (check_device_verify: verify_s), then TIMED_PROVES
    proves at (7, 8) (prove_s: host clock per prove, after a synchronise),
    the last one checked against the trapdoor. split_ms holds each stage's
    time per prove (utils.profiling.Spans: CUDA events on a card);
    peak_bytes the card's peak over the timed proves. `observe(name, f)`,
    when given, runs the untimed first calls: the warm-up prove ("prove")
    and the first verify ("verify")."""
    from zk_toolkit_tpu_torch.protocols.groth16_device import DeviceGroth16Verifier

    dev = resolve_device(device)
    reps = TIMED_PROVES
    if setup is None:
        setup = groth16_setup(log2_n, dev)
    mat, crs, prover = setup["mat"], setup["crs"], setup["prover"]

    proof, first_prove_s = _timed(dev, lambda: _run(
        observe, "prove", lambda: prover.prove_with_rs(crs, *WARM_RS)))
    oracle_s = check_proof(crs, prover, proof, *WARM_RS)
    verify = check_device_verify(DeviceGroth16Verifier().verify, proof, crs, prover.statement(),
                                 observe)

    _reset_peak(dev)
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
    return {
        "n_constraints": mat.n, "n_pad": mat.n_pad, "m": mat.m, "l": mat.l, "kmax": mat.kmax,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "trapdoor_ok": True, "oracle_ok": True, "device_verify_ok": True,
        "prove_s": prove_s, "crs_s": setup["crs_s"], "first_prove_s": first_prove_s,
        **verify,
        "setup_s": setup["setup_s"], "prover_init_s": setup["prover_init_s"],
        "oracle_s": oracle_s,
        "split_ms": {k: v / reps for k, v in spans.totals().items()},
        **_peak(dev),
    }


def bench_pairing(b: int = 256, device="cuda", reps: int = 3, observe=None) -> dict:
    """Batched optimal-ate pairings per second: e(3 G1, 5 G2) tiled to b
    rows, as bench.py:bench_pairing. Refuses to report unless rows 0 and
    b - 1 of the first, untimed call (under observe("pairing", ...) when
    given) equal the host optimal-ate (curves/bls12_381/optimal_ate.py);
    then `reps` timed calls (host clock after a synchronise)."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
    from zk_toolkit_tpu_torch.curves.bls12_381 import optimal_ate as oa
    from zk_toolkit_tpu_torch.ops import pairing_ops as P
    from zk_toolkit_tpu_torch.ops.tower_ops import unpack_fq12

    dev = resolve_device(device)
    ops = P.bls_pairing_ops()
    spec = ops.f.spec
    pa1 = P.pack_g1_affine([g1.g() * 3], spec, dev)
    qa1 = P.pack_g2_affine([g2.g() * 5], spec, dev)
    pa = tuple(a.expand((b,) + a.shape[1:]).contiguous() for a in pa1)
    qa = tuple(a.expand((b,) + a.shape[1:]).contiguous() for a in qa1)
    out, first_s = _timed(dev, lambda: _run(observe, "pairing", lambda: P.pairing_e(ops, pa, qa)))
    gt = unpack_fq12(out[[0, -1]], spec)
    want = oa.OptimalAtePairing().e(g1.g() * 3, g2.g() * 5).e
    if gt[0] != want or gt[-1] != want:
        raise RuntimeError("device pairing does not match the host optimal-ate oracle — "
                           "refusing to report")
    _reset_peak(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = P.pairing_e(ops, pa, qa)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {"b": b, "host_oracle_ok": True, "seconds": dt, "first_s": first_s,
            "pairings_per_s": b / dt, **_peak(dev)}


def bench_field_muls(log2_b: int = 16, chain: int = 64, device="cuda", reps: int = 3) -> dict:
    """Montgomery products per second on BLS12-381 Fq, as
    bench.py:bench_field_muls: a chain of `chain` dependent products x <- x*c
    over 2^log2_b rows, one B1 launch each. The rows are random canonical
    elements (B1 takes operands below p; bench.py feeds its XLA product any
    16-bit limbs). Refuses to report unless the first 64 rows equal the
    plain chain."""
    from zk_toolkit_tpu_torch.utils import samples as S

    dev = resolve_device(device)
    spec = L.field_spec(params.Q)
    b = 1 << log2_b
    rng = np.random.default_rng(0)
    a, c = S.random_field(rng, b, spec, dev), S.random_field(rng, b, spec, dev)

    def chained(mul, x, y):
        for _ in range(chain):
            x = mul(x, y, spec)
        return x

    got = chained(L.mont_mul, a, c)
    if not torch.equal(got[:64], chained(L.mont_mul_plain, a[:64], c[:64])):
        raise RuntimeError("the product chain differs from the plain chain — refusing to report")
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        chained(L.mont_mul, a, c)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {"b": b, "chain": chain, "plain_ok": True, "seconds": dt,
            "muls_per_s": b * chain / dt}


# The Pinocchio trapdoor and prover randomness of the JAX package's tests
# (tests/test_pinocchio_device.py).
PINOCCHIO_TRAPDOOR = dict(r_v=3, r_w=5, alpha_v=7, alpha_w=11, alpha_y=13, beta=17,
                          gamma=19, s=23456789)
PINOCCHIO_DELTAS = (424243, 535354)
PINOCCHIO_G2 = ("g2_w_mid_s", "h_s")


def pinocchio_trapdoor_scalars(mat, wires, delta_v, delta_y, r_v, r_w, alpha_v, alpha_w,
                               alpha_y, beta, gamma, s) -> dict:
    """The scalar k of each of the nine proof elements k * G1 (or k * G2 for
    PINOCCHIO_G2) that the trapdoor and (delta_v, delta_y) fix, host ints:
    with V, W, Y the witness sums of v_i(s), w_i(s), y_i(s) over the mid
    wires (A, B, C over all wires), t = r_y t(s) and h = (A B - C) / t(s):
    v = dv t + r_v V, w = r_w W, y = dy t + r_y Y, the alpha multiples of
    each, beta_vwy = (dv + dy) beta t + beta (r_v V + r_w W + r_y Y), and
    h_s = h + dv r_w B - dy."""
    vs, ws, ys, t_s = host_qap_at(mat, s)
    r_y = r_v * r_w % R

    def dot(col, lo):
        return sum(wires[i] * col[i] for i in range(lo, mat.m + 1)) % R

    mid = mat.l + 1
    v_mid, w_mid, y_mid = dot(vs, mid), dot(ws, mid), dot(ys, mid)
    va, wa, ya = dot(vs, 0), dot(ws, 0), dot(ys, 0)
    h = (va * wa - ya) * pow(t_s, -1, R) % R
    t_sc = r_y * t_s % R
    return {
        "v_mid_s": (delta_v * t_sc + r_v * v_mid) % R,
        "g1_w_mid_s": r_w * w_mid % R,
        "g2_w_mid_s": r_w * w_mid % R,
        "y_mid_s": (delta_y * t_sc + r_y * y_mid) % R,
        "h_s": (h + delta_v * r_w * wa - delta_y) % R,
        "alpha_v_mid_s": alpha_v * (delta_v * t_sc + r_v * v_mid) % R,
        "alpha_w_mid_s": alpha_w * r_w * w_mid % R,
        "alpha_y_mid_s": alpha_y * (delta_y * t_sc + r_y * y_mid) % R,
        "beta_vwy_mid_s": beta * ((delta_v + delta_y) * t_sc + r_v * v_mid + r_w * w_mid
                                  + r_y * y_mid) % R,
    }


def check_pinocchio_proof(prover, proof, deltas=PINOCCHIO_DELTAS,
                          trapdoor=PINOCCHIO_TRAPDOOR) -> None:
    """Raises unless each of the nine proof elements equals its trapdoor
    scalar times the G1 (G2) generator, computed on the host with
    utils/host_curve.multi_mul."""
    import dataclasses

    scalars = pinocchio_trapdoor_scalars(prover.mat, prover.wires, *deltas, **trapdoor)
    names = [f.name for f in dataclasses.fields(proof)]
    g1_names = [n for n in names if n not in PINOCCHIO_G2]
    want = dict(zip(g1_names, HC.multi_mul(HC.FpHost(params.Q), (params.G1_X, params.G1_Y),
                                           [scalars[n] for n in g1_names])))
    want.update(zip(PINOCCHIO_G2, HC.multi_mul(HC.Fp2Host(params.Q), HC.G2_AFFINE,
                                               [scalars[n] for n in PINOCCHIO_G2])))
    for name in names:
        pt = getattr(proof, name)
        got = g2_affine(pt) if name in PINOCCHIO_G2 else g1_affine(pt)
        if got != want[name]:
            raise RuntimeError(f"Pinocchio proof element {name} differs from its trapdoor "
                               "multiple — refusing to report")


def pinocchio_setup(log2_n: int = 16, device="cuda") -> dict:
    """The Pinocchio CRS from PINOCCHIO_TRAPDOOR (crs_s, host clock after a
    synchronise, under cold_tables) and the prover, on synthetic_r1cs(SUBGROUP, 2^log2_n,
    seed=2), the circuit of bench_groth16."""
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.protocols import pinocchio_device as PD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    dev = resolve_device(device)
    tmpl, wit = synthetic_r1cs(params.SUBGROUP, 1 << log2_n, seed=2)
    mat = GD.CircuitMatrices.from_tmpl(tmpl, dev)
    with cold_tables():
        crs, crs_s = _timed(dev, lambda: PD.DevicePinocchioCRS.from_trapdoor(
            mat, device=dev, **PINOCCHIO_TRAPDOOR))
    return {"mat": mat, "crs": crs, "prover": PD.DevicePinocchioProver(mat, wit, dev),
            "crs_s": crs_s}


def bench_pinocchio(log2_n: int = 16, device="cuda", setup: dict | None = None,
                    observe=None) -> dict:
    """The Pinocchio CRS (pinocchio_setup, or `setup`), one prove at
    PINOCCHIO_DELTAS (prove_s, host clock after a synchronise; under
    observe("prove", ...) when given, so then an instrumented prove's time)
    checked by check_pinocchio_proof, then check_device_verify: the device
    verifier accepts the proof twice (verify_s: the second call; the first
    under observe("verify", ...) when given) and rejects a tampered
    statement. peak_bytes: the card's peak over the prove."""
    from zk_toolkit_tpu_torch.protocols.pinocchio_device import DevicePinocchioVerifier

    dev = resolve_device(device)
    if setup is None:
        setup = pinocchio_setup(log2_n, dev)
    mat, crs, prover = setup["mat"], setup["crs"], setup["prover"]
    _reset_peak(dev)
    proof, prove_s = _timed(dev, lambda: _run(
        observe, "prove", lambda: prover.prove_with_deltas(crs, *PINOCCHIO_DELTAS)))
    out = {"n_constraints": mat.n, "n_pad": mat.n_pad, "m": mat.m, "l": mat.l,
           "crs_s": setup["crs_s"], "prove_s": prove_s, **_peak(dev)}
    check_pinocchio_proof(prover, proof)
    out["trapdoor_ok"] = True
    out.update(check_device_verify(DevicePinocchioVerifier().verify, proof, crs,
                                   prover.statement(), observe))
    out["device_verify_ok"] = True
    return out


# -- the secp256k1 tier: Bulletproofs and ECDSA ---------------------------------

def secp_multiples(ks):
    """[k * G for k in ks] on secp256k1 as affine (x, y) ints (None for
    infinity), by the host's Jacobian formulas."""
    from zk_toolkit_tpu_torch.curves import secp256k1

    return HC.multi_mul(HC.FpHost(secp256k1.P), (secp256k1.GX, secp256k1.GY), ks)


def ipa_setup(log2_n: int = 10, device="cuda") -> dict:
    """bench.py:bench_ipa's statement, from random.Random(17): bases g, h
    (n each) and u as one batched scalar_mul of the generator on the
    device, random a, b, and P = g^a h^b u^<a,b> as one (2n+1)-point MSM;
    then the log2(n) challenges."""
    from zk_toolkit_tpu_torch.curves import secp256k1
    from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD

    dev = resolve_device(device)
    n = 1 << log2_n
    rng = random.Random(17)
    spec = BD._P_OPS.spec
    gp = C.pack_points([secp256k1.g()], spec, device=dev)
    ks = [rng.randrange(1, secp256k1.N) for _ in range(2 * n + 1)]
    base = tuple(t.expand((2 * n + 1,) + t.shape[1:]) for t in gp)
    pts = C.scalar_mul(BD._P_OPS, base, C.pack_scalars(ks, 256, device=dev), 256)
    a = [rng.randrange(secp256k1.N) for _ in range(n)]
    b = [rng.randrange(secp256k1.N) for _ in range(n)]
    c = sum(x * y for x, y in zip(a, b)) % secp256k1.N
    P = tuple(t[None] for t in M.msm_pippenger(
        BD._P_OPS, pts, C.pack_scalars(a + b + [c], 256, device=dev), 256))
    chal = [rng.randrange(1, secp256k1.N) for _ in range(log2_n)]
    return {"n": n, "gg": tuple(t[:n] for t in pts), "hh": tuple(t[n:2 * n] for t in pts),
            "u": tuple(t[2 * n:] for t in pts), "P": P, "G": gp, "a": BD._fr(a, dev),
            "b": BD._fr(b, dev), "chal": chal, "ks": ks, "c": c}


def bench_ipa(log2_n: int = 10, device="cuda", observe=None) -> dict:
    """Seconds for one 2^log2_n Bulletproofs inner-product argument (the
    port of bench.py:bench_ipa): a first call (under observe("ipa", ...)
    when given) must accept the true statement, the timed second call too
    (ipa_s), and a call on P + G must reject; else no number is reported.
    Before any of it, the setup's P is checked against the host: its affine
    point equals (sum a_i k_i + sum b_i k_(n+i) + c k_2n) * G, with k the
    dlogs of the bases."""
    from zk_toolkit_tpu_torch.curves import secp256k1
    from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD

    dev = resolve_device(device)
    st, setup_s = _timed(dev, lambda: ipa_setup(log2_n, dev))
    n, N = st["n"], secp256k1.N
    a, b = (L.unpack(st[k], BD._N_SPEC) for k in ("a", "b"))
    ks = st["ks"]
    dlog = (sum(x * k for x, k in zip(a + b, ks)) + st["c"] * ks[-1]) % N
    if C.unpack_points(st["P"], BD._P_OPS.spec)[0] != secp_multiples([dlog])[0]:
        raise RuntimeError("the IPA statement P differs from its known dlog — refusing to report")

    def ipa(P):
        return BD.DeviceBulletproofs(list(st["chal"])).inner_product_argument(
            n, st["gg"], st["hh"], st["u"], P, st["a"], st["b"])

    _reset_peak(dev)
    ok, first_s = _timed(dev, lambda: _run(observe, "ipa", lambda: ipa(st["P"])))
    if not ok:
        raise RuntimeError("the IPA rejects a true statement — refusing to report")
    ok, ipa_s = _timed(dev, lambda: ipa(st["P"]))
    if not ok:
        raise RuntimeError("the IPA flipped on re-run — refusing to report")
    out = {"n": n, "accepts": True, "ipa_s": ipa_s, "first_s": first_s, "setup_s": setup_s,
           **_peak(dev)}
    if ipa(C.point_add(BD._P_OPS, st["P"], st["G"])):
        raise RuntimeError("the IPA accepts P + G — refusing to report")
    out["rejects_perturbed"] = True
    return out


def range_setup(n: int = 64, device="cuda") -> dict:
    """A range-proof statement over n bits from random.Random(3): g, h, the
    bases gg, hh (each a random multiple of the generator, made on the
    host), gamma, V = h^gamma g^v for a random n-bit v, its bits, and the
    3 + log2(n) challenges and 2n + 5 random values the prover consumes."""
    from zk_toolkit_tpu_torch.curves import secp256k1
    from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD

    dev = resolve_device(device)
    N = secp256k1.N
    rng = random.Random(3)
    v = rng.randrange(1 << n)
    gamma = rng.randrange(1, N)
    ks = [rng.randrange(1, N) for _ in range(2 * n + 2)]
    pts = C.pack_points(secp_multiples(ks), BD._P_OPS.spec, device=dev)
    V = C.pack_points(secp_multiples([(ks[1] * gamma + ks[0] * v) % N]), BD._P_OPS.spec,
                      device=dev)
    return {"n": n, "v": v, "gamma": gamma, "V": V,
            "g": tuple(t[:1] for t in pts), "h": tuple(t[1:2] for t in pts),
            "gg": tuple(t[2:2 + n] for t in pts), "hh": tuple(t[2 + n:] for t in pts),
            "bits": [(v >> i) & 1 for i in range(n)],
            "chal": [rng.randrange(1, N) for _ in range(3 + n.bit_length() - 1)],
            "rand": [rng.randrange(1, N) for _ in range(2 * n + 5)]}


def range_proof(st: dict, bits=None) -> bool:
    """DeviceBulletproofs.range_proof with the IPA on a range_setup
    statement, with its bits or the given witness bits."""
    from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD

    bp = BD.DeviceBulletproofs(list(st["chal"]), list(st["rand"]))
    return bp.range_proof(st["n"], st["V"], st["bits"] if bits is None else bits, st["gamma"],
                          st["g"], st["h"], st["gg"], st["hh"], use_inner_product_argument=True)


def bench_range_proof(n: int = 64, device="cuda", observe=None) -> dict:
    """Seconds for the n-bit range proof with the inner-product argument:
    a first call (under observe("range", ...) when given) and the timed
    second call (range_s) must accept v < 2^n, and a call with the lowest
    witness bit flipped must reject; else no number is reported."""
    dev = resolve_device(device)
    st, setup_s = _timed(dev, lambda: range_setup(n, device=dev))
    _reset_peak(dev)
    ok, first_s = _timed(dev, lambda: _run(observe, "range", lambda: range_proof(st)))
    if not ok:
        raise RuntimeError("the range proof rejects v < 2^n — refusing to report")
    ok, range_s = _timed(dev, lambda: range_proof(st))
    if not ok:
        raise RuntimeError("the range proof flipped on re-run — refusing to report")
    out = {"n": n, "accepts": True, "range_s": range_s, "first_s": first_s,
           "setup_s": setup_s, **_peak(dev)}
    bad = list(st["bits"])
    bad[0] ^= 1
    if range_proof(st, bad):
        raise RuntimeError("the range proof accepts a flipped witness bit — refusing to report")
    out["rejects_flipped_bit"] = True
    return out


# Rows of bench_ecdsa's bad batch, each rejected for one reason.
ECDSA_BAD_ROWS = ("flipped digest", "r = 0", "s = n", "infinity public key",
                  "off-curve public key")


def ecdsa_inputs(b: int):
    """b private keys and nonces in [1, n-1] from random.Random(11), and
    the SHA-256 digests (uint8 [b, 32]) of the messages "message-<i>"."""
    from zk_toolkit_tpu_torch.curves import secp256k1
    from zk_toolkit_tpu_torch.hashers import Sha256

    rng = random.Random(11)
    privs = [rng.randrange(1, secp256k1.N) for _ in range(b)]
    ks = [rng.randrange(1, secp256k1.N) for _ in range(b)]
    digests = np.frombuffer(b"".join(Sha256.get_digest(f"message-{i}".encode())
                                     for i in range(b)), dtype=np.uint8).reshape(b, 32)
    return privs, ks, digests


def ecdsa_host_rs(priv: int, k: int, digest) -> tuple[int, int]:
    """(r, s) by the reference's equations on the host: r = (kG).x mod n,
    s = k^-1 (z + r d) mod n with z the digest mod n."""
    from zk_toolkit_tpu_torch.curves import secp256k1

    N = secp256k1.N
    r = secp_multiples([k])[0][0] % N
    z = int.from_bytes(bytes(digest), "big") % N
    return r, pow(k, -1, N) * (z + r * priv) % N


def ecdsa_bad_batch(r, s, pub, digests):
    """Copies of a signed batch with rows 0-4 made bad, one per reason of
    ECDSA_BAD_ROWS."""
    from zk_toolkit_tpu_torch.curves import secp256k1
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG

    r, s = r.clone(), s.clone()
    pub = tuple(t.clone() for t in pub)
    digests = digests.copy()
    digests[0, 0] ^= 1
    r[1] = 0
    s[2] = L.const_limbs(secp256k1.N, 16, str(s.device))
    inf = C.infinity_like(SIG._P_OPS, tuple(t[3:4] for t in pub))
    off = C.pack_points([(secp256k1.GX, (secp256k1.GY + 1) % secp256k1.P)], SIG._P_OPS.spec,
                        device=r.device)
    for t, i, o in zip(pub, inf, off):
        t[3], t[4] = i[0], o[0]
    return r, s, pub, digests


def bench_ecdsa(b: int = 4096, device="cuda", observe=None) -> dict:
    """Batched ECDSA over b signatures: keygen (keygen_s), sign (a first
    call, then the timed sign_s), then verify: a first call (under
    observe("verify", ...) when given) on a copy with rows 0-4 made bad
    (ECDSA_BAD_ROWS) must reject exactly those rows, and the timed call on
    the true batch (verify_s) must accept every row. Refuses to report
    unless, besides, every row signed (ok mask) and the first, middle and
    last rows' public keys and (r, s) equal the host's."""
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG

    dev = resolve_device(device)
    privs, ks, digests = ecdsa_inputs(b)
    d = C.pack_scalars(privs, 256, device=dev)
    k = C.pack_scalars(ks, 256, device=dev)
    _reset_peak(dev)
    pub, keygen_s = _timed(dev, lambda: SIG.ecdsa_keygen_batch(d))
    _, sign_first_s = _timed(dev, lambda: SIG.ecdsa_sign_batch(d, k, digests))
    (r, s, ok), sign_s = _timed(dev, lambda: SIG.ecdsa_sign_batch(d, k, digests))
    if not bool(ok.all()):
        raise RuntimeError("ecdsa_sign_batch flagged rows with r or s = 0 — refusing to report")
    rows = sorted({0, b // 2, b - 1})
    got_pub = C.unpack_points(tuple(t[rows] for t in pub), SIG._P_OPS.spec)
    got_r, got_s = (L.unpack(t[rows], SIG._N_SPEC, mont=False) for t in (r, s))
    for j, i in enumerate(rows):
        if got_pub[j] != secp_multiples([privs[i]])[0]:
            raise RuntimeError(f"public key {i} differs from d * G — refusing to report")
        if (got_r[j], got_s[j]) != ecdsa_host_rs(privs[i], ks[i], digests[i]):
            raise RuntimeError(f"signature {i} differs from the host equations — "
                               "refusing to report")
    bad = ecdsa_bad_batch(r, s, pub, digests)
    mask, verify_first_s = _timed(dev, lambda: _run(
        observe, "verify", lambda: SIG.ecdsa_verify_batch(*bad)))
    want = torch.ones(b, dtype=torch.bool)
    want[:len(ECDSA_BAD_ROWS)] = False
    if not torch.equal(mask.cpu(), want):
        wrong = (mask.cpu() != want).nonzero().flatten().tolist()
        raise RuntimeError(f"ecdsa_verify_batch is wrong on rows {wrong[:8]} of the bad batch "
                           f"(rows 0-4: {', '.join(ECDSA_BAD_ROWS)}) — refusing to report")
    mask, verify_s = _timed(dev, lambda: SIG.ecdsa_verify_batch(r, s, pub, digests))
    if not bool(mask.all()):
        raise RuntimeError("ecdsa_verify_batch rejects a valid signature — refusing to report")
    return {"b": b, "host_rs_ok": True, "rejects_bad_rows": list(ECDSA_BAD_ROWS),
            "keygen_s": keygen_s, "sign_first_s": sign_first_s, "sign_s": sign_s,
            "verify_first_s": verify_first_s, "verify_s": verify_s,
            "sign_per_s": b / sign_s, "verify_per_s": b / verify_s, **_peak(dev)}


# -- the signature tier: Ed25519 and BLS -----------------------------------------

ED25519_MSG_BYTES = 96          # the r and k digests' inputs take two SHA-512 blocks
# Rows of bench_ed25519's bad batch, each rejected for one reason.
ED25519_BAD_ROWS = ("flipped message byte", "S + l", "R not a point (y = 2)", "A with y >= q",
                    "R of another row")


def ed25519_inputs(b: int):
    """b private keys (uint8 [b, 32]) and messages (uint8 [b, 96]) from
    default_rng(12)."""
    rng = np.random.default_rng(12)
    return (rng.integers(0, 256, size=(b, 32), dtype=np.uint8),
            rng.integers(0, 256, size=(b, ED25519_MSG_BYTES), dtype=np.uint8))


def ed25519_bad_batch(sigs, pubs, msgs):
    """Copies of a signed batch with rows 0-4 made bad, one per reason of
    ED25519_BAD_ROWS."""
    from zk_toolkit_tpu_torch.curves import curve25519 as ed

    sigs, pubs, msgs = sigs.copy(), pubs.copy(), msgs.copy()
    msgs[0, 0] ^= 1
    s = int.from_bytes(sigs[1, 32:].tobytes(), "little") + ed.L
    sigs[1, 32:] = np.frombuffer(s.to_bytes(32, "little"), dtype=np.uint8)
    sigs[2, :32] = np.frombuffer((2).to_bytes(32, "little"), dtype=np.uint8)
    pubs[3] = np.frombuffer((ed.Q + 1).to_bytes(32, "little"), dtype=np.uint8)
    sigs[4, :32] = sigs[5, :32]
    return sigs, pubs, msgs


def bench_ed25519(b: int = 4096, device="cuda", observe=None) -> dict:
    """Batched Ed25519 over b signatures of 96-byte messages: the public
    keys from the port's device calls (keys_s: the key expansion, scalar_mul
    of B and encode_points, as ed25519_sign_batch makes them), sign (a first
    call under observe("sign", ...) when given, then the timed sign_s), then
    verify: a first call (under observe("verify", ...)) on a copy with rows
    0-4 made bad (ED25519_BAD_ROWS) must reject exactly those rows, and the
    timed call on the true batch (verify_s) must accept every row. Refuses
    to report unless, besides, both signs agree and the first, middle and
    last rows' keys and signatures equal the host Ed25519Sha512's."""
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG
    from zk_toolkit_tpu_torch.signatures.ed25519 import Ed25519Sha512

    if b <= len(ED25519_BAD_ROWS):
        raise ValueError(f"b must exceed the {len(ED25519_BAD_ROWS)} bad rows")
    dev = resolve_device(device)
    prv, msgs = ed25519_inputs(b)
    _reset_peak(dev)
    pubs, keys_s = _timed(dev, lambda: SIG._base_mul_encoded(SIG._expand_keys(prv, dev)[0], dev))
    sigs, sign_first_s = _timed(dev, lambda: _run(
        observe, "sign", lambda: SIG.ed25519_sign_batch(prv, msgs, dev)))
    again, sign_s = _timed(dev, lambda: SIG.ed25519_sign_batch(prv, msgs, dev))
    if not np.array_equal(sigs, again):
        raise RuntimeError("ed25519_sign_batch flipped on re-run — refusing to report")
    eng = Ed25519Sha512()
    for i in sorted({0, b // 2, b - 1}):
        if bytes(pubs[i]) != eng.gen_pub_key(prv[i].tobytes()):
            raise RuntimeError(f"public key {i} differs from the host engine's — "
                               "refusing to report")
        if bytes(sigs[i]) != eng.sign(msgs[i].tobytes(), prv[i].tobytes()):
            raise RuntimeError(f"signature {i} differs from the host engine's — "
                               "refusing to report")
    bad = ed25519_bad_batch(sigs, pubs, msgs)
    mask, verify_first_s = _timed(dev, lambda: _run(
        observe, "verify", lambda: SIG.ed25519_verify_batch(*bad, dev)))
    want = np.arange(b) >= len(ED25519_BAD_ROWS)
    if not np.array_equal(mask, want):
        wrong = np.flatnonzero(mask != want).tolist()
        raise RuntimeError(f"ed25519_verify_batch is wrong on rows {wrong[:8]} of the bad batch "
                           f"(rows 0-4: {', '.join(ED25519_BAD_ROWS)}) — refusing to report")
    mask, verify_s = _timed(dev, lambda: SIG.ed25519_verify_batch(sigs, pubs, msgs, dev))
    if not mask.all():
        raise RuntimeError("ed25519_verify_batch rejects a valid signature — refusing to report")
    return {"b": b, "msg_bytes": ED25519_MSG_BYTES, "host_engine_ok": True,
            "rejects_bad_rows": list(ED25519_BAD_ROWS), "keys_s": keys_s,
            "sign_first_s": sign_first_s, "sign_s": sign_s, "verify_first_s": verify_first_s,
            "verify_s": verify_s, "sign_per_s": b / sign_s, "verify_per_s": b / verify_s,
            **_peak(dev)}


# Rows of bench_bls's bad batch: rows 0 and 1 hold each other's signature.
BLS_BAD_ROWS = ("swapped signature", "swapped signature", "wrong message",
                "public key of another row")


def bls_inputs(b: int):
    """b private keys from Rng(64), their public keys and the signatures of
    the messages "committee-<i>", by the host Signer (the placeholder hash,
    as in the reference)."""
    from zk_toolkit_tpu_torch.signatures.bls import PrivateKey, Signer
    from zk_toolkit_tpu_torch.utils.rng import Rng

    signer, rng = Signer(), Rng(64)
    sks = [PrivateKey(rng=rng) for _ in range(b)]
    msgs = [f"committee-{i}".encode() for i in range(b)]
    return msgs, [signer.sign(m, sk) for m, sk in zip(msgs, sks)], \
        [signer.gen_public_key(sk) for sk in sks]


def bls_bad_batch(msgs, sigs, pks):
    """Copies of a signed batch with rows 0-3 made bad, as BLS_BAD_ROWS says."""
    msgs, sigs, pks = list(msgs), list(sigs), list(pks)
    sigs[0], sigs[1] = sigs[1], sigs[0]
    msgs[2] = msgs[2] + b"!"
    pks[3] = pks[4]
    return msgs, sigs, pks


def bench_bls(b: int = 64, device="cuda", observe=None) -> dict:
    """Batched BLS verification over b signatures (64: the committees of one
    Ethereum slot, each checked on its own). Keys and signatures from the
    host Signer (setup_s). A first call (under observe("verify", ...) when
    given) on a copy with rows 0-3 made bad (BLS_BAD_ROWS) must reject
    exactly those rows; the timed call on the true batch (verify_s) must
    accept every row."""
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG

    if b <= len(BLS_BAD_ROWS):
        raise ValueError(f"b must exceed the {len(BLS_BAD_ROWS)} bad rows")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    msgs, sigs, pks = bls_inputs(b)
    setup_s = time.perf_counter() - t0
    bad = bls_bad_batch(msgs, sigs, pks)
    _reset_peak(dev)
    mask, verify_first_s = _timed(dev, lambda: _run(
        observe, "verify", lambda: SIG.bls_verify_batch(*bad, device=dev)))
    want = np.arange(b) >= len(BLS_BAD_ROWS)
    if not np.array_equal(mask, want):
        wrong = np.flatnonzero(mask != want).tolist()
        raise RuntimeError(f"bls_verify_batch is wrong on rows {wrong[:8]} of the bad batch "
                           f"(rows 0-3: {', '.join(BLS_BAD_ROWS)}) — refusing to report")
    mask, verify_s = _timed(dev, lambda: SIG.bls_verify_batch(msgs, sigs, pks, device=dev))
    if not mask.all():
        raise RuntimeError("bls_verify_batch rejects a valid signature — refusing to report")
    return {"b": b, "rejects_bad_rows": list(BLS_BAD_ROWS), "setup_s": setup_s,
            "verify_first_s": verify_first_s, "verify_s": verify_s, "verify_per_s": b / verify_s,
            **_peak(dev)}


if __name__ == "__main__":
    args = sys.argv[1:]
    benches = {"groth16": (bench_groth16, 16), "pairing": (bench_pairing, 256),
               "field_muls": (bench_field_muls, 16), "pinocchio": (bench_pinocchio, 16),
               "ipa": (bench_ipa, 10), "range": (bench_range_proof, 64),
               "ecdsa": (bench_ecdsa, 4096), "ed25519": (bench_ed25519, 4096),
               "bls": (bench_bls, 64)}
    if args and args[0] in benches:
        fn, default = benches[args[0]]
        print(json.dumps(fn(int(args[1]) if len(args) > 1 else default)))
    elif args and args[0] == "host_msm":
        print(json.dumps({"host_msm_points_per_s": host_msm_rate()}))
    else:
        print(json.dumps(bench_msm(1 << (int(args[0]) if args else 20))))
