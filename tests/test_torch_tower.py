"""Fq2 and G2 in the port (plain versions on the CPU), and the three faults
of the port that G2 inputs reach:

- zk_toolkit_tpu_torch.ops.tower_ops.Fq2Ops mul/sq/inv against the JAX
  package's Fq2Ops (limb for limb) and the host Fp2Host, on random rows with
  zero, one and u among them; pack_g2_affine against the JAX package's;
- a G2 msm_pippenger over Fq2Ops at n <= 16 against the host G2 sum;
- curve_ops.scalar_mul on G1 and on G2 against host_curve.jac_mul;
- C1: the MSM budgets a point at prod(shape[1:]) words, so Fq2 points get
  half the window group of G1 points;
- C2: a G2 fixed-base table keeps its [.., 2, K] coordinates, and
  scalar_mul_fixed over it gives the host multiples of the G2 generator.

Tolerance: exact equality, compared in affine where the Jacobian
representative may differ.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu.curves.bls12_381 import g2 as JG2
from zk_toolkit_tpu.curves.bls12_381 import params
from zk_toolkit_tpu.ops import limbs as JL
from zk_toolkit_tpu.ops import pairing_ops as JPO
from zk_toolkit_tpu.ops.field_ops import FqOps as JFqOps
from zk_toolkit_tpu.ops.tower_ops import Fq2Ops as JFq2Ops
from zk_toolkit_tpu.utils import host_curve as JHC
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.curves.bls12_381 import g2 as TG2
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import fixed_base as TFB
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops import msm as TM
from zk_toolkit_tpu_torch.ops import pairing_ops as TPO
from zk_toolkit_tpu_torch.ops import tower_ops as TT
from zk_toolkit_tpu_torch.ops.field_ops import FqOps as TFqOps
from zk_toolkit_tpu_torch.utils import host_curve as THC
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

Q, R = params.Q, params.R
SPEC = TL.field_spec(Q)
E2 = TT.Fq2Ops(TFqOps(SPEC))
F1, F2 = JHC.FpHost(Q), JHC.Fp2Host(Q)
G2 = JHC.from_affine(F2, THC.G2_AFFINE)


def _fq2_rows(rng, n):
    """n random Fq2 values as (u0, u1) int pairs, then zero, one and u."""
    vals = [(int(rng.integers(1, 1 << 62)) ** 7 % Q, int(rng.integers(1, 1 << 62)) ** 7 % Q)
            for _ in range(n)]
    return vals + [(0, 0), (1, 0), (0, 1)]


def _pack(vals) -> np.ndarray:
    """(u0, u1) int pairs -> uint32 [n, 2, K] Montgomery limbs."""
    flat = [v * SPEC.r_mod_p % Q for pair in vals for v in pair]
    return ints_to_array(flat, SPEC.K).reshape(len(vals), 2, SPEC.K)


def _unpack(t: torch.Tensor) -> list:
    ints = TL.unpack(t.reshape(-1, SPEC.K), SPEC)
    return list(zip(ints[0::2], ints[1::2]))


@pytest.mark.parametrize("op", ["mul", "sq", "inv"])
def test_fq2_ops_match_jax_and_host(op):
    rng = np.random.default_rng({"mul": 1, "sq": 2, "inv": 3}[op])
    a_vals, b_vals = _fq2_rows(rng, 6), _fq2_rows(rng, 6)[::-1]
    a, b = _pack(a_vals), _pack(b_vals)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = convert.limbs_from_jax(a, "cpu"), convert.limbs_from_jax(b, "cpu")
    jops = JFq2Ops(JFqOps(JL.field_spec(Q)))
    if op == "mul":
        got, want = E2.mul(ta, tb), jops.mul(ja, jb)
        host = [F2.mul(x, y) for x, y in zip(a_vals, b_vals)]
    elif op == "sq":
        got, want = E2.sq(ta), jops.sq(ja)
        host = [F2.sq(x) for x in a_vals]
    else:
        got, want = E2.inv(ta), jops.inv(ja)
        host = [(0, 0) if x == (0, 0) else F2.inv(x) for x in a_vals]
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))
    assert _unpack(got) == host


def test_fq2_struct_ops_span_both_axes():
    vals = [(0, 0), (0, 5), (5, 0), (1, 0)]
    t = convert.limbs_from_jax(_pack(vals), "cpu")
    assert E2.is_zero(t).tolist() == [True, False, False, False]
    assert E2.equal(t, E2.one_like(t)).tolist() == [False, False, False, True]
    mask = torch.tensor([True, False, True, False])
    assert _unpack(E2.select(mask, t, E2.zero_like(t))) == [(0, 0), (0, 0), (5, 0), (0, 0)]


def test_pack_g2_affine_matches_jax():
    pts = [JG2.g(), JG2.g() * 5, JG2.infinity()]
    tpts = [TG2.g(), TG2.g() * 5, TG2.infinity()]
    want = JPO.pack_g2_affine(pts, JL.field_spec(Q))
    got = TPO.pack_g2_affine(tpts, SPEC, device="cpu")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))
    assert got[2].tolist() == np.asarray(want[2]).tolist()


def _g2_points(ks):
    """k * G2 for each k as a Jacobian tuple of [n, 2, K] tensors, each
    finite row a random representative (x l^2, y l^3, l), l in Fq."""
    rng = np.random.default_rng(len(ks))
    jacs = []
    for k in ks:
        aff = JHC.jac_to_affine(F2, JHC.jac_mul(F2, G2, k))
        if aff is None:
            jacs.append(((1, 0), (1, 0), (0, 0)))
            continue
        lam = (int(rng.integers(2, 1 << 62)), 0)
        l2 = F2.sq(lam)
        jacs.append((F2.mul(aff[0], l2), F2.mul(aff[1], F2.mul(l2, lam)), lam))
    return tuple(convert.limbs_from_jax(_pack([j[c] for j in jacs]), "cpu") for c in range(3))


def _g2_affine(pt):
    """A G2 Jacobian tuple of [.., 2, K] tensors -> affine int pairs or None."""
    ax, ay, inf = TC.to_affine(E2, tuple(a.reshape(-1, 2, SPEC.K) for a in pt))
    xs, ys = _unpack(ax), _unpack(ay)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf.tolist())]


@pytest.mark.parametrize("n", [5, 16])
def test_g2_msm_matches_host_sum(n):
    rng = np.random.default_rng(40 + n)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(n)]
    ks[1] = ks[0]                      # a repeated point
    ks[3] = R - ks[2]                  # a point and its negation
    ks[4] = 0                          # infinity
    sc = [int(rng.integers(0, 1 << 63)) for _ in range(n)]
    pts = _g2_points(ks)
    scalars = torch.from_numpy(ints_to_array(sc, 4).astype(np.int32))
    res = TM.msm_pippenger(E2, pts, scalars, 64, c=4)
    want = sum(k * s for k, s in zip(ks, sc)) % R
    assert _g2_affine(tuple(a[None] for a in res)) == [
        JHC.jac_to_affine(F2, JHC.jac_mul(F2, G2, want))]


def test_scalar_mul_g1_matches_jac_mul():
    ks = [3, 1 << 40, 0, (1 << 64) - 1]
    pts = TC.pack_points([THC.g1_mul_affine(k) for k in (7, 11, 13, 0)], SPEC, device="cpu")
    scalars = torch.from_numpy(ints_to_array(ks, 4).astype(np.int32))
    got = TC.unpack_points(TC.scalar_mul(TFqOps(SPEC), pts, scalars, 64), SPEC)
    assert got == [THC.g1_mul_affine(b * k % R) for b, k in zip((7, 11, 13, 0), ks)]


def test_scalar_mul_g2_matches_jac_mul():
    bases, ks = [9, 0], [(1 << 64) - 3, 5]
    scalars = torch.from_numpy(ints_to_array(ks, 4).astype(np.int32))
    got = _g2_affine(TC.scalar_mul(E2, _g2_points(bases), scalars, 64))
    assert got == [JHC.jac_to_affine(F2, JHC.jac_mul(F2, G2, b * k % R))
                   for b, k in zip(bases, ks)]


class _GroupSeen(Exception):
    pass


def test_c1_msm_budgets_g2_points_at_their_words(monkeypatch):
    """C1: with the free memory fixed, msm_pippenger gives Fq2 points
    ([N, 2, K] coordinates, 6K words) half the window group of G1 points."""
    groups = []
    orig = TM._auto_window_chunk

    def seen(*args):
        groups.append(orig(*args))
        raise _GroupSeen

    per_g1_window = 16 * 3 * SPEC.K * 4 * 3          # n * words * 4 B * 3 copies
    monkeypatch.setattr(TM, "_free_bytes", lambda device: 2 * 8 * per_g1_window)
    monkeypatch.setattr(TM, "_auto_window_chunk", seen)
    scalars = torch.zeros((16, 4), dtype=torch.int32)
    g1 = TC.pack_points([THC.g1_mul_affine(k) for k in range(1, 17)], SPEC, device="cpu")
    for ops, pts in ((TFqOps(SPEC), g1), (E2, _g2_points(list(range(1, 17))))):
        with pytest.raises(_GroupSeen):
            TM.msm_pippenger(ops, pts, scalars, 64, c=4)
    assert groups == [8, 4]


def test_c2_g2_fixed_base_table_matches_host_multiples():
    """C2: build_table over Fq2Ops at c = 4 keeps [W * 2^c, 2, K]
    coordinates, and scalar_mul_fixed over it gives k * G2 from the host."""
    base = _g2_points([1])
    table = TFB.build_table(E2, base, 32, 4)
    assert table[0].shape == (8 * 16, 2, SPEC.K) and table[2].shape == (8 * 16,)
    ks = [0, 1, 2, 0xFFFFFFFF, 0x12345678, 1 << 31]
    scalars = torch.from_numpy(ints_to_array(ks, 2).astype(np.int32))
    got = _g2_affine(TFB.scalar_mul_fixed(E2, table, scalars, 4))
    assert got == [JHC.jac_to_affine(F2, JHC.jac_mul(F2, G2, k)) for k in ks]


def test_pack_fq2_matches_jax_and_round_trips():
    from zk_toolkit_tpu.curves.bls12_381 import tower as JTw
    from zk_toolkit_tpu.ops import tower_ops as JTO
    from zk_toolkit_tpu_torch.curves.bls12_381 import tower as TTw

    vals = _fq2_rows(np.random.default_rng(9), 3)
    jxs = [JTw.Fq2(JTw.fq1(u1), JTw.fq1(u0)) for u0, u1 in vals]
    txs = [TTw.Fq2(TTw.fq1(u1), TTw.fq1(u0)) for u0, u1 in vals]
    got = TT.pack_fq2(txs, SPEC, device="cpu")
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(JTO.pack_fq2(jxs, JL.field_spec(Q))))
    assert [(x.u0.e, x.u1.e) for x in TT.unpack_fq2(got, SPEC)] == vals


# -- Fq6 / Fq12 ----------------------------------------------------------------

def _tower_rows(rng, n, struct):
    """n random elements with `struct` Fq slots, then zero and one, as uint32
    [n + 2, *struct, K] Montgomery limbs."""
    slots = int(np.prod(struct))
    vals = [int.from_bytes(rng.bytes(48), "little") % Q for _ in range(n * slots)]
    vals += [0] * slots + [1] + [0] * (slots - 1)
    flat = ints_to_array([v * SPEC.r_mod_p % Q for v in vals], SPEC.K)
    return flat.reshape((n + 2,) + struct + (SPEC.K,))


TOWER_OPS = {6: ("mul", "sq", "inv", "mul_by_w", "mul_fq2"), 12: ("mul", "sq", "inv", "conjugate")}


@pytest.fixture(scope="module")
def tower_cases():
    """Per level (6, 12): the inputs and the JAX package's results of every
    op in TOWER_OPS, from one jitted function per level."""
    import jax

    from zk_toolkit_tpu.ops.tower_ops import make_tower as j_make_tower

    _, _, j6, j12 = j_make_tower(Q)
    rng = np.random.default_rng(66)
    out = {}
    for level, struct, jops in ((6, (3, 2), j6), (12, (2, 3, 2), j12)):
        a, b = _tower_rows(rng, 4, struct), _tower_rows(rng, 4, struct)[::-1].copy()
        s = _pack(_fq2_rows(rng, 3)[:a.shape[0]])

        def run(a, b, s, jops=jops, level=level):
            res = {"mul": jops.mul(a, b), "sq": jops.sq(a), "inv": jops.inv(a)}
            if level == 6:
                res.update(mul_by_w=jops.mul_by_w(a), mul_fq2=jops.mul_fq2(a, s))
            else:
                res["conjugate"] = jops.conjugate(a)
            return res

        want = jax.jit(run)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s))
        out[level] = (a, b, s, {k: np.asarray(v) for k, v in want.items()})
    return out


@pytest.mark.parametrize("level,op", [(lv, op) for lv, ops in TOWER_OPS.items() for op in ops])
def test_fq6_fq12_ops_match_jax(tower_cases, level, op):
    a, b, s, want = tower_cases[level]
    _, _, e6, e12 = TT.make_tower(Q)
    ops = e6 if level == 6 else e12
    ta, tb, ts = (convert.limbs_from_jax(x, "cpu") for x in (a, b, s))
    got = {"mul": lambda: ops.mul(ta, tb), "sq": lambda: ops.sq(ta), "inv": lambda: ops.inv(ta),
           "mul_by_w": lambda: ops.mul_by_w(ta), "mul_fq2": lambda: ops.mul_fq2(ta, ts),
           "conjugate": lambda: ops.conjugate(ta)}[op]()
    np.testing.assert_array_equal(convert.limbs_to_jax(got), want[op])


def test_fq12_ops_match_host_tower():
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq12

    rng = np.random.default_rng(12)
    a = convert.limbs_from_jax(_tower_rows(rng, 2, (2, 3, 2)), "cpu")
    b = convert.limbs_from_jax(_tower_rows(rng, 2, (2, 3, 2))[::-1].copy(), "cpu")
    _, _, _, e12 = TT.make_tower(Q)
    xs, ys = TT.unpack_fq12(a, SPEC), TT.unpack_fq12(b, SPEC)
    assert TT.unpack_fq12(e12.mul(a, b), SPEC) == [x * y for x, y in zip(xs, ys)]
    assert TT.unpack_fq12(e12.inv(a), SPEC) == [Fq12.zero() if x.is_zero() else x.inv() for x in xs]
    assert TT.unpack_fq12(e12.conjugate(a), SPEC) == [x.conjugate() for x in xs]
    one = e12.one_like(a)
    assert TT.unpack_fq12(one, SPEC) == [Fq12.one()] * 4
    assert TT.unpack_fq12(e12.const(5, a[:1]), SPEC) == [Fq12.from_int(5)]
    assert e12.equal(a, one).tolist() == [False, False, False, True]
    assert e12.is_zero(a).tolist() == [False, False, True, False]
    mask = torch.tensor([True, False, True, False])
    assert torch.equal(e12.select(mask, a, one)[1], one[1])


def test_pack_fq6_fq12_match_jax_and_round_trip():
    from zk_toolkit_tpu.curves.bls12_381 import tower as JTw
    from zk_toolkit_tpu.ops import tower_ops as JTO
    from zk_toolkit_tpu_torch.curves.bls12_381 import tower as TTw

    rng = np.random.default_rng(13)
    vals = [int.from_bytes(rng.bytes(48), "little") % Q for _ in range(24)]

    def fq12(tw, v):
        f2 = [tw.Fq2(tw.fq1(v[i + 1]), tw.fq1(v[i])) for i in range(0, 12, 2)]
        return tw.Fq12(tw.Fq6(f2[5], f2[4], f2[3]), tw.Fq6(f2[2], f2[1], f2[0]))

    jxs = [fq12(JTw, vals[:12]), fq12(JTw, vals[12:])]
    txs = [fq12(TTw, vals[:12]), fq12(TTw, vals[12:])]
    jspec = JL.field_spec(Q)
    got12 = TT.pack_fq12(txs, SPEC, device="cpu")
    np.testing.assert_array_equal(convert.limbs_to_jax(got12),
                                  np.asarray(JTO.pack_fq12(jxs, jspec)))
    got6 = TT.pack_fq6([x.w1 for x in txs], SPEC, device="cpu")
    np.testing.assert_array_equal(convert.limbs_to_jax(got6),
                                  np.asarray(JTO.pack_fq6([x.w1 for x in jxs], jspec)))
    assert TT.unpack_fq12(got12, SPEC) == txs
    assert TT.unpack_fq6(got6, SPEC) == [x.w1 for x in txs]


def test_fq2_mul_by_xi_conjugate_mul_fq1_match_host():
    rng = np.random.default_rng(14)
    vals = _fq2_rows(rng, 4)
    t = convert.limbs_from_jax(_pack(vals), "cpu")
    s_vals = [int(rng.integers(1, 1 << 62)) ** 5 % Q for _ in vals]
    s = convert.limbs_from_jax(ints_to_array([v * SPEC.r_mod_p % Q for v in s_vals], SPEC.K), "cpu")
    assert _unpack(E2.mul_by_xi(t)) == [F2.mul(x, (1, 1)) for x in vals]
    assert _unpack(E2.conjugate(t)) == [(x[0], (Q - x[1]) % Q) for x in vals]
    assert _unpack(E2.mul_fq1(t, s)) == [F2.mul(x, (k, 0)) for x, k in zip(vals, s_vals)]
    assert _unpack(E2.const(7, t)) == [(7, 0)] * len(vals)
