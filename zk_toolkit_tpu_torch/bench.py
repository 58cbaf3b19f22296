"""Benchmarks of the port (the twin of the repository's bench.py).

bench_msm: the 2^20-point BLS12-381 G1 MSM, the repository's headline
metric, over n DISTINCT points k_i * G made by the fixed-base path and
255-bit scalars. The result is asserted against the known-dlog oracle before
any timing: with P_i = k_i * G and known k_i the MSM must equal
(sum s_i k_i mod r) * G, an exact check that costs one uint64 matmul and one
host scalar multiplication. The benchmark refuses to report a wrong result.

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

Run on a card: python -m zk_toolkit_tpu_torch.bench [log2_n]   (the MSM)
               python -m zk_toolkit_tpu_torch.bench groth16 [log2_n]
               python -m zk_toolkit_tpu_torch.bench pairing [b]
               python -m zk_toolkit_tpu_torch.bench field_muls [log2_b]
               python -m zk_toolkit_tpu_torch.bench pinocchio [log2_n]
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
    _sync(dev)
    t0 = time.perf_counter()
    ok = _run(observe, "verify", lambda: verify(proof, crs, stmt))
    verify_first_s = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("the device verifier rejects the proof — refusing to report")
    t0 = time.perf_counter()
    ok = verify(proof, crs, stmt)
    verify_s = time.perf_counter() - t0
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

    t0 = time.perf_counter()
    proof = _run(observe, "prove", lambda: prover.prove_with_rs(crs, *WARM_RS))
    _sync(dev)
    first_prove_s = time.perf_counter() - t0
    oracle_s = check_proof(crs, prover, proof, *WARM_RS)
    verify = check_device_verify(DeviceGroth16Verifier().verify, proof, crs, prover.statement(),
                                 observe)

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
        "trapdoor_ok": True, "oracle_ok": True, "device_verify_ok": True,
        "prove_s": prove_s, "crs_s": setup["crs_s"], "first_prove_s": first_prove_s,
        **verify,
        "setup_s": setup["setup_s"], "prover_init_s": setup["prover_init_s"],
        "oracle_s": oracle_s,
        "split_ms": {k: v / reps for k, v in spans.totals().items()},
    }
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def bench_pairing(b: int = 256, device="cuda", reps: int = 3) -> dict:
    """Batched optimal-ate pairings per second: e(3 G1, 5 G2) tiled to b
    rows, as bench.py:bench_pairing. Refuses to report unless rows 0 and
    b - 1 equal the host optimal-ate (curves/bls12_381/optimal_ate.py);
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
    _sync(dev)
    t0 = time.perf_counter()
    out = P.pairing_e(ops, pa, qa)
    _sync(dev)
    first_s = time.perf_counter() - t0
    gt = unpack_fq12(out[[0, -1]], spec)
    want = oa.OptimalAtePairing().e(g1.g() * 3, g2.g() * 5).e
    if gt[0] != want or gt[-1] != want:
        raise RuntimeError("device pairing does not match the host optimal-ate oracle — "
                           "refusing to report")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = P.pairing_e(ops, pa, qa)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    res = {"b": b, "host_oracle_ok": True, "seconds": dt, "first_s": first_s,
           "pairings_per_s": b / dt}
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res


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
    synchronise) and the prover, on synthetic_r1cs(SUBGROUP, 2^log2_n,
    seed=2), the circuit of bench_groth16."""
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.protocols import pinocchio_device as PD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    dev = resolve_device(device)
    tmpl, wit = synthetic_r1cs(params.SUBGROUP, 1 << log2_n, seed=2)
    mat = GD.CircuitMatrices.from_tmpl(tmpl, dev)
    _sync(dev)
    t0 = time.perf_counter()
    crs = PD.DevicePinocchioCRS.from_trapdoor(mat, device=dev, **PINOCCHIO_TRAPDOOR)
    _sync(dev)
    crs_s = time.perf_counter() - t0
    return {"mat": mat, "crs": crs, "prover": PD.DevicePinocchioProver(mat, wit, dev),
            "crs_s": crs_s}


def bench_pinocchio(log2_n: int = 16, device="cuda", setup: dict | None = None,
                    observe=None) -> dict:
    """The Pinocchio CRS (pinocchio_setup, or `setup`), one prove at
    PINOCCHIO_DELTAS (prove_s, host clock after a synchronise) checked by
    check_pinocchio_proof, then check_device_verify: the device verifier
    accepts the proof twice (verify_s: the second call; the first under
    observe("verify", ...) when given) and rejects a tampered statement.
    peak_bytes: the card's peak over the prove."""
    from zk_toolkit_tpu_torch.protocols.pinocchio_device import DevicePinocchioVerifier

    dev = resolve_device(device)
    if setup is None:
        setup = pinocchio_setup(log2_n, dev)
    mat, crs, prover = setup["mat"], setup["crs"], setup["prover"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    proof = prover.prove_with_deltas(crs, *PINOCCHIO_DELTAS)
    _sync(dev)
    prove_s = time.perf_counter() - t0
    out = {"n_constraints": mat.n, "n_pad": mat.n_pad, "m": mat.m, "l": mat.l,
           "crs_s": setup["crs_s"], "prove_s": prove_s}
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    check_pinocchio_proof(prover, proof)
    out["trapdoor_ok"] = True
    out.update(check_device_verify(DevicePinocchioVerifier().verify, proof, crs,
                                   prover.statement(), observe))
    out["device_verify_ok"] = True
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    benches = {"groth16": (bench_groth16, 16), "pairing": (bench_pairing, 256),
               "field_muls": (bench_field_muls, 16), "pinocchio": (bench_pinocchio, 16)}
    if args and args[0] in benches:
        fn, default = benches[args[0]]
        print(json.dumps(fn(int(args[1]) if len(args) > 1 else default)))
    else:
        print(json.dumps(bench_msm(1 << (int(args[0]) if args else 20))))
