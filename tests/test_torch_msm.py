"""The MSM slice of the port on the CPU (plain versions):

- zk_toolkit_tpu_torch.ops.msm.msm_pippenger against the JAX package's
  host oracle (zk_toolkit_tpu.utils.host_curve) and the known-dlog check, at
  n in {16, 64, 257} and c in {4, 8}; the point sets hold a repeated point,
  a point and its negation, and infinity;
- one case, n = 16 and c = 4, against the JAX package's msm_pippenger
  itself, limb for limb (the JAX side compiles for about a minute on the
  CPU, so there is only this one);
- zk_toolkit_tpu_torch.protocols.groth16_device.fixed_base_g1 against
  host_curve.jac_mul, and the port's bench_msm (known-dlog check) at n = 16;
- the two doubling chains that run r-fold (one point_double_n per window):
  the Horner combine and the fixed-base table, against the host oracle at
  c = 4 over 64-bit scalars.

Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu.curves.bls12_381 import g1, params
from zk_toolkit_tpu.ops import limbs as JL
from zk_toolkit_tpu.ops import msm as JM
from zk_toolkit_tpu.ops.field_ops import FqOps as JFqOps
from zk_toolkit_tpu.utils import host_curve as JHC
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.bench import bench_msm
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import fixed_base as TFB
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops import msm as TM
from zk_toolkit_tpu_torch.ops.field_ops import FqOps as TFqOps
from zk_toolkit_tpu_torch.protocols.groth16_device import fixed_base_g1
from zk_toolkit_tpu_torch.utils import host_curve as THC
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

Q, R = params.Q, params.R
F1 = JHC.FpHost(Q)
G = JHC.from_affine(F1, (g1.GX, g1.GY))


def _inputs(n: int, seed: int):
    """Known dlogs k_i (with a repeated point, a negated one and infinity),
    the points k_i*G as random Jacobian representatives (uint32 Montgomery
    limbs), and 255-bit scalars (uint32 [n, 16])."""
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % R for _ in range(n)]
    ks[3] = ks[2]
    ks[5] = R - ks[4]
    ks[7] = 0
    spec = JL.field_spec(Q)
    cols = [[], [], []]
    for k in ks:
        aff = JHC.jac_to_affine(F1, JHC.jac_mul(F1, G, k))
        lam = int(rng.integers(2, 1 << 62))
        jac = (1, 1, 0) if aff is None else (
            aff[0] * lam * lam % Q, aff[1] * pow(lam, 3, Q) % Q, lam)
        for c, v in zip(cols, jac):
            c.append(v * spec.r_mod_p % Q)
    pts = tuple(ints_to_array(c, spec.K) for c in cols)
    sc = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    sc[:, 15] &= 0x7FFF
    return ks, pts, sc


def _affine(res):
    spec = TL.field_spec(Q)
    return TC.unpack_points(tuple(a[None] for a in res), spec)[0]


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("n", [16, 64, 257])
def test_msm_matches_host_oracle_and_known_dlog(n, c):
    ks, pts, sc = _inputs(n, seed=100 + n)
    ops = TFqOps(TL.field_spec(Q))
    res = TM.msm_pippenger(ops, convert.points_from_jax(pts, "cpu"),
                           convert.scalars_from_jax(sc, "cpu"), 255, c=c)
    got = _affine(res)
    # host oracle: sum_i s_i * P_i in raw ints
    s_int = [int.from_bytes(row.astype("<u2").tobytes(), "little") for row in sc]
    acc = (1, 1, 0)
    for k, s in zip(ks, s_int):
        acc = JHC.jac_add(F1, acc, JHC.jac_mul(F1, JHC.jac_mul(F1, G, k), s))
    assert got == JHC.jac_to_affine(F1, acc)
    # known dlog: (sum_i s_i k_i mod r) * G, through one uint64 matmul
    k_limbs = ints_to_array(ks, 16)
    assert got == THC.g1_mul_affine(THC._limb_dot_mod_r(k_limbs, sc, 255))


def test_msm_matches_jax_msm_pippenger_limb_for_limb():
    _, pts, sc = _inputs(16, seed=7)
    jres = JM.msm_pippenger(JFqOps(JL.field_spec(Q)), tuple(map(jnp.asarray, pts)),
                            jnp.asarray(sc), 255, c=4)
    tres = TM.msm_pippenger(TFqOps(TL.field_spec(Q)), convert.points_from_jax(pts, "cpu"),
                            convert.scalars_from_jax(sc, "cpu"), 255, c=4)
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(convert.limbs_to_jax(t), np.asarray(j))


def test_fixed_base_g1_matches_host_jac_mul():
    rng = np.random.default_rng(21)
    ks = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) ** 3 % (1 << 256)
          for _ in range(5)] + [0, 1, R, R - 1]
    scalars = torch.from_numpy(ints_to_array(ks, 16).astype(np.int32))
    pts = fixed_base_g1(scalars)
    got = TC.unpack_points(pts, TL.field_spec(Q))
    assert got == [JHC.jac_to_affine(F1, JHC.jac_mul(F1, G, k)) for k in ks]


def test_bench_msm_checks_known_dlog_on_cpu():
    """The benchmark's own path (fixed-base points, known-dlog assert,
    timed repetitions) at a small n on the CPU."""
    out = bench_msm(16, "cpu", reps=1, c=4)
    assert out["known_dlog_ok"] and out["n"] == 16 and out["device"] == "cpu"
    assert set(out["split_ms"]) == {"point_gen", "sort_gather", "upsweep_fenwick", "horner"}


def _count_double_n(monkeypatch):
    """Records the doubling count of every point_double_n call."""
    calls = []
    orig = TC.point_double_n

    def counting(ops, p, r):
        calls.append(r)
        return orig(ops, p, r)

    monkeypatch.setattr(TC, "point_double_n", counting)
    return calls


def test_horner_combine_doubles_once_per_window_and_matches_host(monkeypatch):
    """_horner_combine at c = 4 over 16 windows of random points: one
    4-fold point_double_n per window, and sum_w 2^(4w) S_w as the host
    computes it."""
    rng = np.random.default_rng(64)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(16)]
    ks[5] = 0                                              # an infinity window
    spec = TL.field_spec(Q)
    pts = TC.pack_points([THC.g1_mul_affine(k) for k in ks], spec, device="cpu")
    calls = _count_double_n(monkeypatch)
    got = TM._horner_combine(TFqOps(spec), pts, 4)
    assert calls == [4] * 16
    want = sum(k << (4 * w) for w, k in enumerate(ks)) % R
    assert _affine(got) == THC.g1_mul_affine(want)


def test_build_table_doubles_once_per_window_and_matches_host(monkeypatch):
    """build_table(G, 64 bits, c = 4): one 4-fold point_double_n per window,
    and every entry w * 16 + d equal to d * 2^(4w) * G from the host."""
    spec = TL.field_spec(Q)
    base = TC.pack_points([THC.g1_mul_affine(1)], spec, device="cpu")
    calls = _count_double_n(monkeypatch)
    ax, ay, inf = TFB.build_table(TFqOps(spec), base, 64, 4)
    assert calls == [4] * 16
    xs, ys = TL.unpack(ax, spec), TL.unpack(ay, spec)
    got = [None if i else (x, y) for x, y, i in zip(xs, ys, inf.tolist())]
    assert got == [THC.g1_mul_affine(d << (4 * w)) for w in range(16) for d in range(16)]


def test_c3_msm_streams_in_chunks_above_the_limit(monkeypatch):
    """C3: with ZKT_MSM_MAX_STREAM = 16, a 64-point MSM runs as four
    16-point sub-MSMs joined by point_add; it equals the unchunked MSM and
    the host sum in affine."""
    ks, pts, sc = _inputs(64, seed=33)
    sc[:, 4:] = 0                                       # 64-bit scalars
    ops = TFqOps(TL.field_spec(Q))
    tpts, tsc = convert.points_from_jax(pts, "cpu"), convert.scalars_from_jax(sc, "cpu")
    whole = _affine(TM.msm_pippenger(ops, tpts, tsc, 64, c=4))

    sizes = []
    orig = TM._auto_window_chunk

    def seen(n, *args):
        sizes.append(n)
        return orig(n, *args)

    monkeypatch.setattr(TM, "_auto_window_chunk", seen)
    monkeypatch.setenv("ZKT_MSM_MAX_STREAM", "16")
    chunked = _affine(TM.msm_pippenger(ops, tpts, tsc, 64, c=4))
    assert sizes == [16] * 4
    s_int = [int.from_bytes(row.astype("<u2").tobytes(), "little") for row in sc]
    assert chunked == whole == THC.g1_mul_affine(sum(k * s for k, s in zip(ks, s_int)) % R)
