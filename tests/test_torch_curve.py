"""The port's group law (zk_toolkit_tpu_torch/ops/curve_ops.py, plain
versions on the CPU) against the JAX package's `_point_add_formula`,
`_point_double_formula` and `to_affine`, bit for bit, on every case class:
generic, P == Q (the doubling case, with different Jacobian
representations of the point), P == -Q, and infinity on either or both
sides. Points are k*G from the host oracle, re-scaled to random Jacobian
representatives (x*l^2, y*l^3, l) so z != 1. Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zk_toolkit_tpu.curves.bls12_381 import g1, params
from zk_toolkit_tpu.ops import curve_ops as JC
from zk_toolkit_tpu.ops import limbs as JL
from zk_toolkit_tpu.ops.field_ops import FqOps as JFqOps
from zk_toolkit_tpu.utils import host_curve as JHC
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops.field_ops import FqOps as TFqOps
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

Q = params.Q
F1 = JHC.FpHost(Q)
G = JHC.from_affine(F1, (g1.GX, g1.GY))


def _jac(affine, lam):
    """Jacobian representative (x l^2, y l^3, l) of an affine point; the
    canonical (1, 1, 0) for infinity."""
    if affine is None:
        return (1, 1, 0)
    x, y = affine
    return (x * lam * lam % Q, y * pow(lam, 3, Q) % Q, lam % Q)


def _pack(jacs):
    """Raw-int Jacobian list -> uint32 Montgomery limb arrays (x, y, z)."""
    spec = JL.field_spec(Q)
    cols = list(zip(*jacs))
    return tuple(ints_to_array([v * spec.r_mod_p % Q for v in c], spec.K) for c in cols)


def _case_points(seed: int):
    """P, Q rows: 24 generic, 3 doubling, 3 inverse, 2 P=inf, 2 Q=inf,
    1 both inf, and 1 both inf with P non-canonical (z = 0, random x, y)."""
    rng = np.random.default_rng(seed)
    lam = lambda: int(rng.integers(2, 1 << 62)) * int(rng.integers(2, 1 << 62)) % Q
    aff = lambda k: JHC.jac_to_affine(F1, JHC.jac_mul(F1, G, k))
    neg = lambda a: None if a is None else (a[0], (Q - a[1]) % Q)
    ps, qs = [], []
    for _ in range(24):
        a, b = int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 62))
        ps.append(_jac(aff(a), lam()))
        qs.append(_jac(aff(b), lam()))
    for _ in range(3):
        pa = aff(int(rng.integers(1, 1 << 62)))
        ps.append(_jac(pa, lam()))
        qs.append(_jac(pa, lam()))
    for _ in range(3):
        pa = aff(int(rng.integers(1, 1 << 62)))
        ps.append(_jac(pa, lam()))
        qs.append(_jac(neg(pa), lam()))
    for _ in range(2):
        ps.append(_jac(None, 1))
        qs.append(_jac(aff(int(rng.integers(1, 1 << 62))), lam()))
    for _ in range(2):
        ps.append(_jac(aff(int(rng.integers(1, 1 << 62))), lam()))
        qs.append(_jac(None, 1))
    ps.append(_jac(None, 1))
    qs.append(_jac(None, 1))
    ps.append((lam(), lam(), 0))      # a non-canonical infinity
    qs.append(_jac(None, 1))
    return _pack(ps), _pack(qs)


def _torch(p):
    return convert.points_from_jax(p, "cpu")


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))


@pytest.fixture(scope="module")
def ops():
    spec = JL.field_spec(Q)
    return JFqOps(spec), TFqOps(TL.field_spec(Q))


def test_point_add_matches_jax_formula(ops):
    jops, tops = ops
    p, q = _case_points(seed=5)
    want = jax.jit(lambda a, b: JC._point_add_formula(jops, a, b))(
        tuple(map(jnp.asarray, p)), tuple(map(jnp.asarray, q)))
    got = TC.point_add(tops, _torch(p), _torch(q))
    _eq(got, want)
    # the case classes came out as intended: P == -Q rows are infinity
    z = convert.limbs_to_jax(got[2])
    assert not z[27:30].any() and z[:27].any(axis=1).all()


def test_point_double_matches_jax_formula(ops):
    jops, tops = ops
    p, _ = _case_points(seed=6)
    want = jax.jit(lambda a: JC._point_double_formula(jops, a))(tuple(map(jnp.asarray, p)))
    _eq(TC.point_double(tops, _torch(p)), want)


@pytest.mark.parametrize("r", [1, 3])
def test_point_double_n_matches_jax_formula_applied_r_times(ops, r):
    """2^r * P through the port's point_double_n (plain version on the CPU)
    against r applications of the JAX package's _point_double_formula, at
    batch 8 on numpy-seeded random representatives, infinity included."""
    jops, tops = ops
    rng = np.random.default_rng(40 + r)
    lam = lambda: int(rng.integers(2, 1 << 62)) * int(rng.integers(2, 1 << 62)) % Q
    aff = lambda: JHC.jac_to_affine(F1, JHC.jac_mul(F1, G, int(rng.integers(1, 1 << 62))))
    p = _pack([_jac(aff(), lam()) for _ in range(7)] + [_jac(None, 1)])
    dbl = jax.jit(lambda a: JC._point_double_formula(jops, a))
    want = tuple(map(jnp.asarray, p))
    for _ in range(r):
        want = dbl(want)
    _eq(TC.point_double_n(tops, _torch(p), r), want)


def test_point_double_n_refuses_a_count_below_one(ops):
    _, tops = ops
    p, _ = _case_points(seed=9)
    with pytest.raises(ValueError, match=">= 1"):
        TC.point_double_n(tops, _torch(p), 0)


def test_to_affine_matches_jax(ops):
    jops, tops = ops
    p, _ = _case_points(seed=7)
    jx, jy, jinf = JC.to_affine(jops, tuple(map(jnp.asarray, p)))
    tx, ty, tinf = TC.to_affine(tops, _torch(p))
    _eq((tx, ty), (jx, jy))
    np.testing.assert_array_equal(tinf.numpy(), np.asarray(jinf))


def test_plain_ops_namespace_is_the_formula(ops):
    """FqOps(plain=True) runs the same formulas (it is the reference the
    kernels are held against on the card)."""
    _, tops = ops
    plain = TFqOps(tops.spec, plain=True)
    p, q = _case_points(seed=8)
    a = TC.point_add(tops, _torch(p), _torch(q))
    b = TC.point_add(plain, _torch(p), _torch(q))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
