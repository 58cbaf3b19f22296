"""The port's optimal-ate pairing (zk_toolkit_tpu_torch/ops/pairing_ops.py,
plain versions on the CPU):

- frobenius (powers 1-3), one Miller doubling step and one addition step,
  point_add_mixed and pow_u against the JAX package's, limb for limb (each
  JAX function under jax.jit);
- pairing_e against the JAX package's host OptimalAtePairing().e on
  G1 * {1, 7, 123456789, inf} x G2 * {1, 11, 987654321, 1}, as
  tests/test_device_pairing.py does, the infinity row giving 1;
- pairing_product_is_one with an accepting and a rejecting row in one call;
- the port's host optimal_ate.py against the JAX package's; pack_g1_affine;
  entry();
- marked slow, as the JAX package marks its own: the Miller loop against
  the JAX package's miller_only limb for limb (a long compile), and the
  naive Weil/Tate pairings against the JAX package's host Pairing.

Inputs are made from numpy seeds; tolerance 0 (integer arithmetic).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zk_toolkit_tpu.curves.bls12_381 import g1 as JG1
from zk_toolkit_tpu.curves.bls12_381 import g2 as JG2
from zk_toolkit_tpu.curves.bls12_381 import optimal_ate as joa
from zk_toolkit_tpu.curves.bls12_381 import params
from zk_toolkit_tpu.ops import curve_ops as JC
from zk_toolkit_tpu.ops import limbs as JL
from zk_toolkit_tpu.ops import pairing_ops as JPO
from zk_toolkit_tpu.utils import host_curve as JHC
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.curves.bls12_381 import g1 as TG1
from zk_toolkit_tpu_torch.curves.bls12_381 import g2 as TG2
from zk_toolkit_tpu_torch.curves.bls12_381 import optimal_ate as toa
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops import pairing_ops as TPO
from zk_toolkit_tpu_torch.ops.tower_ops import unpack_fq12
from zk_toolkit_tpu_torch.utils import host_curve as THC
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

Q, R = params.Q, params.R
SPEC = TL.field_spec(Q)
OPS = TPO.bls_pairing_ops()
JOPS = JPO.bls_pairing_ops()
F2 = JHC.Fp2Host(Q)


def _coeffs(x) -> list:
    """An Fq12 of either package's host tower as its 12 ints."""
    return [c.e for six in (x.w0, x.w1) for f2 in (six.v0, six.v1, six.v2)
            for c in (f2.u0, f2.u1)]


def _mont(vals) -> np.ndarray:
    return ints_to_array([v * SPEC.r_mod_p % Q for v in vals], SPEC.K)


def _rand_fq12(rng, n) -> np.ndarray:
    vals = [int.from_bytes(rng.bytes(48), "little") % Q for _ in range(12 * n)]
    return _mont(vals).reshape(n, 2, 3, 2, SPEC.K)


def _g2_jacobian(rng, ks) -> np.ndarray:
    """k * G2 as Jacobian [3, n, 2, K] limbs, a random representative per
    row (x l^2, y l^3, l), l in Fq2."""
    g2 = JHC.from_affine(F2, THC.G2_AFFINE)
    rows = []
    for k in ks:
        x, y = JHC.jac_to_affine(F2, JHC.jac_mul(F2, g2, k))
        lam = (int.from_bytes(rng.bytes(48), "little") % Q, int(rng.integers(1, 1 << 60)))
        l2 = F2.sq(lam)
        rows.append((F2.mul(x, l2), F2.mul(y, F2.mul(l2, lam)), lam))
    return np.stack([_mont([v for r in rows for v in r[c]]).reshape(len(ks), 2, SPEC.K)
                     for c in range(3)])


def _affines(ps, qs):
    """(JAX, port) packs of G1 and G2 affine points given as multiples."""
    jspec = JL.field_spec(Q)
    jp = JPO.pack_g1_affine([JG1.g() * k if k else JG1.infinity() for k in ps], jspec)
    jq = JPO.pack_g2_affine([JG2.g() * k if k else JG2.infinity() for k in qs], jspec)
    tp = TPO.pack_g1_affine([TG1.g() * k if k else TG1.infinity() for k in ps], SPEC, "cpu")
    tq = TPO.pack_g2_affine([TG2.g() * k if k else TG2.infinity() for k in qs], SPEC, "cpu")
    return jp, jq, tp, tq


def _np(t):
    return t.numpy() if t.dtype == torch.bool else convert.limbs_to_jax(t)


def test_pack_g1_affine_matches_jax():
    jp, _, tp, _ = _affines([1, 5, 0], [1])
    for g, w in zip(tp, jp):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_host_optimal_ate_copy_matches_jax():
    assert toa.miller_bits() == joa.miller_bits()
    for p in (1, 2, 3):
        assert [(g.u0.e, g.u1.e) for g in toa.GAMMA[p]] == [(g.u0.e, g.u1.e) for g in joa.GAMMA[p]]
    got = toa.OptimalAtePairing().e(TG1.g() * 2, TG2.g() * 3).e
    want = joa.OptimalAtePairing().e(JG1.g() * 2, JG2.g() * 3).e
    assert _coeffs(got) == _coeffs(want)


@pytest.mark.parametrize("power", [1, 2, 3])
def test_frobenius_matches_jax(power):
    a = _rand_fq12(np.random.default_rng(power), 3)
    want = jax.jit(lambda x: JOPS.frobenius(x, power))(jnp.asarray(a))
    got = OPS.frobenius(convert.limbs_from_jax(a, "cpu"), power)
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


@pytest.fixture(scope="module")
def step_inputs():
    """A G2 Jacobian T and affine Q, G1 affine P (rows: generic, T = inf via
    z = 0), in both packages' types."""
    rng = np.random.default_rng(77)
    t = _g2_jacobian(rng, [5, 9])
    t[2, 1] = 0                                    # row 1: T = infinity
    jp, jq, tp, tq = _affines([3, 4], [7, 0])      # row 1: Q = infinity too
    return t, jp, jq, tp, tq


def test_dbl_step_matches_jax(step_inputs):
    t, jp, _, tp, _ = step_inputs
    f = JOPS.f
    xp3 = f.add(f.dbl(jp[0]), jp[0])
    jt, jl = jax.jit(JOPS._dbl_step)(tuple(jnp.asarray(c) for c in t), xp3, jp[1])
    txp3 = OPS.f.add(OPS.f.dbl(tp[0]), tp[0])
    tt, tl = OPS._dbl_step(tuple(convert.limbs_from_jax(c, "cpu") for c in t), txp3, tp[1])
    for g, w in zip(tt + (tl,), jt + (jl,)):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))


def test_add_step_matches_jax(step_inputs):
    t, jp, jq, tp, tq = step_inputs
    jt, jl = jax.jit(JOPS._add_step)(tuple(jnp.asarray(c) for c in t), jq, jp[0], jp[1])
    tt, tl = OPS._add_step(tuple(convert.limbs_from_jax(c, "cpu") for c in t), tq, tp[0], tp[1])
    for g, w in zip(tt + (tl,), jt + (jl,)):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))


def test_point_add_mixed_matches_jax():
    """Rows: generic, T == Q (doubling), T == -Q (infinity), T = inf,
    Q = inf."""
    rng = np.random.default_rng(78)
    t = _g2_jacobian(rng, [5, 6, 6, 8, 9])
    t[2, 3] = 0
    jq = JPO.pack_g2_affine([JG2.g() * 3, JG2.g() * 6, -(JG2.g() * 6), JG2.g() * 2,
                             JG2.infinity()], JL.field_spec(Q))
    tq = TPO.pack_g2_affine([TG2.g() * 3, TG2.g() * 6, -(TG2.g() * 6), TG2.g() * 2,
                             TG2.infinity()], SPEC, "cpu")
    want = jax.jit(lambda p, q: JC.point_add_mixed(JOPS.e2, p, q))(
        tuple(jnp.asarray(c) for c in t), jq)
    got = TC.point_add_mixed(OPS.e2, tuple(convert.limbs_from_jax(c, "cpu") for c in t), tq)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))
    assert OPS.e2.is_zero(got[2]).tolist() == [False, False, True, False, False]


def test_pow_u_matches_jax():
    a = _rand_fq12(np.random.default_rng(79), 2)
    want = JPO._pow_u(JOPS, jnp.asarray(a))
    got = OPS.pow_u(convert.limbs_from_jax(a, "cpu"))
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


def test_pairing_e_matches_host_optimal_ate():
    ks_p, ks_q = [1, 7, 123456789, 0], [1, 11, 987654321, 1]
    _, _, tp, tq = _affines(ks_p, ks_q)
    got = unpack_fq12(TPO.pairing_e(OPS, tp, tq), SPEC)
    pair = joa.OptimalAtePairing()
    for i, (a, b) in enumerate(zip(ks_p, ks_q)):
        want = pair.e(JG1.g() * a if a else JG1.infinity(), JG2.g() * b).e
        assert _coeffs(got[i]) == _coeffs(want), f"pairing {i}"
    assert _coeffs(got[3]) == [1] + [0] * 11


def test_pairing_product_is_one_accepts_and_rejects_in_one_call():
    """Row 0: e(42 P, Q) e(-P, 42 Q) == 1; row 1: e(3P, Q) e(P, Q) != 1."""
    rows_p = [[TG1.g() * 42, -TG1.g()], [TG1.g() * 3, TG1.g()]]
    rows_q = [[TG2.g(), TG2.g() * 42], [TG2.g(), TG2.g()]]
    pa = [TPO.pack_g1_affine(r, SPEC, "cpu") for r in rows_p]
    qa = [TPO.pack_g2_affine(r, SPEC, "cpu") for r in rows_q]
    p_b = tuple(torch.stack([r[i] for r in pa]) for i in range(3))
    q_b = tuple(torch.stack([r[i] for r in qa]) for i in range(3))
    assert TPO.pairing_product_is_one(OPS, p_b, q_b).tolist() == [True, False]


def test_entry_runs_the_miller_loop():
    from zk_toolkit_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    f = fn(*args)
    assert f.shape == (2, 2, 3, 2, SPEC.K)
    got = unpack_fq12(OPS.final_exp(f), SPEC)
    pair = toa.OptimalAtePairing()
    assert got == [pair.e(TG1.g(), TG2.g()).e, pair.e(TG1.g() * 7, TG2.g() * 11).e]


def test_entry_defaults_to_the_card():
    from zk_toolkit_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.slow
def test_miller_loop_matches_jax_miller_only():
    jp, jq, tp, tq = _affines([1, 7, 0], [1, 11, 5])
    want = JPO.miller_only(JOPS, jp, jq)
    got = OPS.miller_loop(tp, tq)
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


@pytest.mark.slow
def test_naive_weil_tate_match_host():
    from zk_toolkit_tpu.curves.bls12_381.pairing import Pairing

    ks_p, ks_q = [1, 5], [1, 9]
    pa = TPO.pack_g1_affine([TG1.g() * a for a in ks_p], SPEC, "cpu")
    qa = TPO.pack_g2_affine([TG2.g() * b for b in ks_q], SPEC, "cpu")
    host = Pairing()
    tate = unpack_fq12(TPO.pairing_tate(OPS, pa, qa), SPEC)
    weil = unpack_fq12(TPO.pairing_weil(OPS, pa, qa), SPEC)
    for i, (a, b) in enumerate(zip(ks_p, ks_q)):
        jp, jq = JG1.g() * a, JG2.g() * b
        assert _coeffs(tate[i]) == _coeffs(host.tate(jp, jq).e), f"tate {i}"
        assert _coeffs(weil[i]) == _coeffs(host.weil(jp, jq).e), f"weil {i}"
