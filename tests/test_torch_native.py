"""The port's native host engine (zk_toolkit_tpu_torch/native/, g++ and
ctypes over its own copy of zkt_host.cpp) against Python ints and the JAX
package's engine, as tests/test_native.py holds the JAX package's; and the
CRS branch that calls it: groth16_device.lagrange_at / qap_at give the
same ints on the engine and in Python (at 2^4 and 2^10 points), and the
flagship circuit's DeviceCRS is the same limb for limb whichever branch
built it. Skipped without g++. Tolerance 0.
"""

from __future__ import annotations

import random
import shutil

import numpy as np
import pytest
import torch

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.native import available, engine
from zk_toolkit_tpu_torch.native import host as H

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")

R = params.R


@pytest.fixture(scope="module")
def eng():
    assert available()
    return engine(R)


def test_mul_add_sub_inv(eng):
    random.seed(4)
    p = eng.p
    xs = [random.randrange(p) for _ in range(257)]
    ys = [random.randrange(p) for _ in range(257)]
    a, b = eng.from_ints(xs), eng.from_ints(ys)
    assert eng.to_ints(eng.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert eng.to_ints(eng.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert eng.to_ints(eng.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert eng.to_ints(eng.inv(a)) == [pow(x, -1, p) for x in xs]
    assert eng.to_ints(eng.mul_scalar(a, eng.from_ints([7]))) == [7 * x % p for x in xs]
    z = eng.from_ints([0, 5])
    assert eng.to_ints(eng.inv(z)) == [0, pow(5, -1, p)]


def test_equals_the_jax_packages_engine(eng):
    from zk_toolkit_tpu.native import engine as jengine

    je = jengine(R)
    if je is None:
        pytest.skip("the JAX package's engine did not build")
    random.seed(8)
    xs = [random.randrange(R) for _ in range(64)]
    a, ja = eng.from_ints(xs), je.from_ints(xs)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(eng.inv(a), je.inv(ja))
    np.testing.assert_array_equal(eng.pow_table(5, 33), je.pow_table(5, 33))


def test_pow_table_and_plain_round_trip(eng):
    p = eng.p
    t = eng.pow_table(7, 64)
    assert eng.to_ints(t) == [pow(7, i, p) for i in range(64)]
    vals = [123456789, p - 1, 0, 1, (1 << 255) - 1 - (1 << 255) % p]
    a = eng.from_ints(vals, to_mont=False)
    assert eng.to_ints(a, from_mont=False) == vals
    assert eng.to_ints(eng.to_mont(a)) == vals
    assert eng.to_ints(eng.from_ints(vals + [p, p + 5])) == vals + [0, 5]


def test_secp_order_engine():
    from zk_toolkit_tpu_torch.curves import secp256k1

    e2 = engine(secp256k1.N)
    random.seed(9)
    xs = [random.randrange(secp256k1.N) for _ in range(64)]
    assert e2.to_ints(e2.inv(e2.from_ints(xs))) == [pow(x, -1, secp256k1.N) for x in xs]


def test_wide_or_even_moduli_raise():
    with pytest.raises(ValueError):
        engine(params.Q)                  # 381 bits: never wrong ints
    with pytest.raises(ValueError):
        H.FrEngine(params.Q)
    with pytest.raises(ValueError):
        engine(1 << 200)


@pytest.mark.parametrize("log2_n", (4, 10))
def test_lagrange_branches_agree(log2_n):
    from zk_toolkit_tpu_torch.ops import ntt as NTT
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    n = 1 << log2_n
    w = NTT.fr_domain(n, "cpu").w
    x = random.Random(log2_n).randrange(R)
    native, t_native = GD.lagrange_at(n, x, w)
    plain, t_plain = GD.lagrange_at(n, x, w, native=False)
    assert native == plain and t_native == t_plain
    assert len(native) == n
    # sum_j L_j(x) = 1 on any domain
    assert sum(native) % R == 1


def test_flagship_crs_equal_whichever_branch_built_it(monkeypatch):
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    mat = GD.CircuitMatrices.from_expr("(x * x * x) + x + 5 == 35", device="cpu")
    trapdoor = dict(tau=987654321, alpha=11, beta=22, gamma=33, delta=44)
    native = GD.DeviceCRS.from_trapdoor(mat, **trapdoor, point_mode="host", device="cpu")
    monkeypatch.setattr(GD, "engine", lambda p: None)
    plain = GD.DeviceCRS.from_trapdoor(mat, **trapdoor, point_mode="host", device="cpu")
    for name in ("g1_alpha", "g1_beta", "g1_delta", "g2_beta", "g2_gamma", "g2_delta", "g1_u",
                 "g1_v", "g2_v", "g1_uvw_stmt", "g1_uvw_wit", "g1_xt"):
        for a, b in zip(getattr(native, name), getattr(plain, name)):
            assert torch.equal(a, b), name
