"""The port's NTT over Fr (zk_toolkit_tpu_torch/ops/ntt.py, plain versions
on the CPU):

- ntt / intt / coset_ntt / coset_intt against the JAX package's, limb for
  limb, at n = 8 and 64 (one XLA compile each), and against a Python-int
  evaluation of the polynomial at n = 8..64;
- the domain tables (twiddles, bit reversal, coset powers, constants)
  against the JAX package's NttDomain;
- h_coset_then_coeffs against the JAX package's on random evaluations, and
  against the host quotient (A*B - C) / t where A*B - C vanishes on H.

Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu.ops import ntt as JN
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops import ntt as TN
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

R = TN.R
SPEC = TL.field_spec(R)


def _mont(vals) -> np.ndarray:
    return ints_to_array([v * SPEC.r_mod_p % R for v in vals], SPEC.K)


def _ints(t: torch.Tensor) -> list:
    return TL.unpack(t, SPEC)


def _rand(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 1 << 62)) ** 5 % R for _ in range(n)]


@pytest.mark.parametrize("fn", ["ntt", "intt", "coset_ntt", "coset_intt"])
@pytest.mark.parametrize("n", [8, 64])
def test_transforms_match_jax(n, fn):
    x = _mont(_rand(n, n + len(fn)))
    want = getattr(JN, fn)(JN.fr_domain(n), jnp.asarray(x))
    got = getattr(TN, fn)(TN.fr_domain(n, "cpu"), convert.limbs_from_jax(x, "cpu"))
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_transforms_match_host_evaluation(n):
    dom = TN.fr_domain(n, "cpu")
    coeffs = _rand(n, 100 + n)
    g = TN.FR_GENERATOR

    def evals(shift):
        return [sum(c * pow(shift * pow(dom.w, j, R) % R, i, R) for i, c in enumerate(coeffs)) % R
                for j in range(n)]

    x = convert.limbs_from_jax(_mont(coeffs), "cpu")
    assert _ints(TN.ntt(dom, x)) == evals(1)
    assert _ints(TN.coset_ntt(dom, x)) == evals(g)
    assert _ints(TN.intt(dom, TN.ntt(dom, x))) == coeffs
    assert _ints(TN.coset_intt(dom, TN.coset_ntt(dom, x))) == coeffs


@pytest.mark.parametrize("n", [2, 8, 64])
def test_domain_tables_match_jax(n):
    j, t = JN.fr_domain(n), TN.fr_domain(n, "cpu")
    assert t.w == j.w and t.log_n == j.log_n
    for a, b in zip(t.twiddles + t.inv_twiddles, j.twiddles + j.inv_twiddles):
        np.testing.assert_array_equal(convert.limbs_to_jax(a), b)
    np.testing.assert_array_equal(t.bitrev.numpy(), j.bitrev.astype(np.int64))
    for name in ("n_inv_mont", "coset_pows", "coset_pows_inv", "t_coset_inv_mont"):
        np.testing.assert_array_equal(convert.limbs_to_jax(getattr(t, name)), getattr(j, name))


def test_domain_refuses_sizes_it_cannot_take():
    with pytest.raises(ValueError):
        TN.fr_domain(12, "cpu")
    with pytest.raises(ValueError):
        TN.fr_domain(1, "cpu")


def test_h_coset_then_coeffs_matches_jax():
    n = 8
    a, b, c = (_mont(_rand(n, s)) for s in (1, 2, 3))
    want = JN.h_coset_then_coeffs(JN.fr_domain(n), *map(jnp.asarray, (a, b, c)))
    got = TN.h_coset_then_coeffs(TN.fr_domain(n, "cpu"),
                                 *(convert.limbs_from_jax(v, "cpu") for v in (a, b, c)))
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


def test_h_coset_then_coeffs_is_the_exact_quotient():
    """With C = A * B on H, A*B - C = t * h for t = x^n - 1: h's
    coefficients are those of the host polynomial quotient."""
    n = 16
    dom = TN.fr_domain(n, "cpu")
    a_ev, b_ev = _rand(n, 7), _rand(n, 8)
    c_ev = [x * y % R for x, y in zip(a_ev, b_ev)]
    h = _ints(TN.h_coset_then_coeffs(
        dom, *(convert.limbs_from_jax(_mont(v), "cpu") for v in (a_ev, b_ev, c_ev))))
    # host: coefficients of A and B by the inverse transform, A*B as a
    # polynomial of degree < 2n, then division by x^n - 1.
    ac = _ints(TN.intt(dom, convert.limbs_from_jax(_mont(a_ev), "cpu")))
    bc = _ints(TN.intt(dom, convert.limbs_from_jax(_mont(b_ev), "cpu")))
    cc = _ints(TN.intt(dom, convert.limbs_from_jax(_mont(c_ev), "cpu")))
    num = [0] * (2 * n)
    for i, x in enumerate(ac):
        for j, y in enumerate(bc):
            num[i + j] = (num[i + j] + x * y) % R
    for i, x in enumerate(cc):
        num[i] = (num[i] - x) % R
    quot = [0] * n
    for d in range(2 * n - 1, n - 1, -1):        # long division by x^n - 1
        q = num[d]
        quot[d - n] = q
        num[d] = 0
        num[d - n] = (num[d - n] + q) % R
    assert all(v == 0 for v in num)
    assert h == quot
