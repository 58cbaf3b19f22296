"""The port's aux subsystems against the JAX package's: the curve registry
(zk_toolkit_tpu_torch/config.py), the profiling spans (utils/profiling.py:
timed, report, reset, trace writing a torch.profiler trace on the CPU),
the fixed-base table cache (ops/fixed_base.build_table_cached: build then
load, a foreign or corrupt file rebuilt, and files written by either
package loaded by the other, at secp256k1, 32 bits, c = 4 as
tests/test_aux.py), and limbs.mont_pow_dynamic against the JAX package's
and Python's pow. Tolerance 0.
"""

from __future__ import annotations

import functools
import os
import random

import numpy as np
import pytest
import torch

from zk_toolkit_tpu_torch import config
from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import fixed_base as FB
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils import profiling
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array


def test_registry_equals_jax():
    from zk_toolkit_tpu import config as jconfig

    for name in ("secp256k1", "curve25519", "bls12_381_g1"):
        got, want = config.curve(name), jconfig.curve(name)
        assert (got.base_modulus, got.group_order, got.generator, got.kind, got.b) == \
            (want.base_modulus, want.group_order, want.generator, want.kind, want.b)
        assert got.limbs == want.limbs
        assert got.field_spec() is L.field_spec(got.base_modulus)
        assert got.scalar_spec().K == want.scalar_spec().K
    assert config.curve("secp256k1").limbs == 16 and config.curve("bls12_381_g1").limbs == 24
    assert sorted(config.registry()) == sorted(jconfig.registry())
    with pytest.raises(KeyError):
        config.curve("nope")


def test_config_knobs(monkeypatch):
    monkeypatch.delenv("ZKT_PROFILE_DIR", raising=False)
    assert config.profile_dir() is None
    monkeypatch.setenv("ZKT_PROFILE_DIR", "")
    assert config.profile_dir() is None
    monkeypatch.setenv("ZKT_PROFILE_DIR", "/tmp/x")
    assert config.profile_dir() == "/tmp/x"


def test_profiling_spans(monkeypatch):
    monkeypatch.delenv("ZKT_PROFILE_DIR", raising=False)
    profiling.reset()
    with profiling.timed("unit"):
        pass
    with profiling.trace("unit"):
        pass
    rep = profiling.report()
    assert rep["unit"]["count"] == 2
    assert rep["unit"]["total_s"] >= rep["unit"]["mean_s"] >= 0
    profiling.reset()
    assert profiling.report() == {}


def test_trace_writes_a_cpu_trace(tmp_path, monkeypatch):
    import json

    monkeypatch.setenv("ZKT_PROFILE_DIR", str(tmp_path / "traces"))
    profiling.reset()
    a = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    with profiling.trace("limbs"):
        L.mont_mul(a, a, L.field_spec(params.R))
    files = os.listdir(tmp_path / "traces")
    assert len(files) == 1 and files[0].startswith("limbs-") and files[0].endswith(".json")
    with open(tmp_path / "traces" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert profiling.report()["limbs"]["count"] == 1
    profiling.reset()


# -- the table cache ------------------------------------------------------------

NBITS, WINDOW = 32, 4


def _secp():
    spec = L.field_spec(secp256k1.P)
    return FqOps(spec), C.pack_points([secp256k1.g()], spec, device="cpu")


def _tables_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_table_cache_builds_then_loads(tmp_path, monkeypatch):
    monkeypatch.setenv("ZKT_TABLE_CACHE_DIR", str(tmp_path))
    ops, base = _secp()
    t1 = FB.build_table_cached(ops, base, NBITS, WINDOW, key="secp_t")
    assert (tmp_path / "secp_t_n32_c4.npz").exists()
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    monkeypatch.setattr(FB, "build_table", lambda *a: pytest.fail("rebuilt a valid file"))
    t2 = FB.build_table_cached(ops, base, NBITS, WINDOW, key="secp_t")
    assert _tables_equal(t1, t2)
    assert t2[0].dtype == torch.int32 and t2[2].dtype == torch.bool
    ks = [1, 5, 12345, (1 << 32) - 1]
    pts = FB.scalar_mul_fixed(ops, t2, C.pack_scalars(ks, 32, device="cpu"), WINDOW)
    for got, k in zip(C.unpack_points(pts, ops.spec), ks):
        want = secp256k1.g() * k
        assert got == (want.x.e, want.y.e)


@pytest.mark.parametrize("before", ("unset", "set"))
def test_cold_tables_empties_the_cache_for_a_timed_setup(tmp_path, monkeypatch, before):
    """bench.cold_tables: no table in memory and an empty cache directory
    inside the block, the caller's ZKT_TABLE_CACHE_DIR restored after, so a
    crs_s timed inside always counts the table builds."""
    from zk_toolkit_tpu_torch.bench import cold_tables
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    if before == "set":
        monkeypatch.setenv("ZKT_TABLE_CACHE_DIR", str(tmp_path))
        (tmp_path / "bls12_381_g1_n256_c8.npz").write_bytes(b"left by an earlier run")
    else:
        monkeypatch.delenv("ZKT_TABLE_CACHE_DIR", raising=False)
    monkeypatch.setattr(GD, "_g1_table", functools.lru_cache(maxsize=None)(lambda d: d))
    GD._g1_table("cpu")
    with cold_tables():
        inside = os.environ["ZKT_TABLE_CACHE_DIR"]
        assert inside != str(tmp_path) and os.listdir(inside) == []
        assert GD._g1_table.cache_info().currsize == 0
        assert GD._g2_table.cache_info().currsize == 0
    assert not os.path.exists(inside)
    assert os.environ.get("ZKT_TABLE_CACHE_DIR") == (str(tmp_path) if before == "set" else None)


@pytest.mark.parametrize("damage", ("meta_p", "entry", "corrupt"))
def test_table_cache_rebuilds_a_foreign_or_corrupt_file(tmp_path, monkeypatch, damage):
    monkeypatch.setenv("ZKT_TABLE_CACHE_DIR", str(tmp_path))
    ops, base = _secp()
    good = FB.build_table_cached(ops, base, NBITS, WINDOW, key="secp_t")
    path = tmp_path / "secp_t_n32_c4.npz"
    if damage == "corrupt":
        path.write_bytes(b"not an npz")
    else:
        data = dict(np.load(path))
        if damage == "meta_p":      # a table of another field under the same key
            data["meta_p"] = data["meta_p"].copy()
            data["meta_p"][0] ^= 2
        else:                       # entry w = 0, d = 1 is not the base point
            data["t0"] = data["t0"].copy()
            data["t0"][1, 0] ^= 1
        np.savez_compressed(path, **data)
    rebuilt = []
    build = FB.build_table
    monkeypatch.setattr(FB, "build_table", lambda *a: rebuilt.append(1) or build(*a))
    again = FB.build_table_cached(ops, base, NBITS, WINDOW, key="secp_t")
    assert rebuilt == [1] and _tables_equal(again, good)
    data = np.load(path)          # the file was replaced by a good one
    assert int(data["meta_p"][0]) == secp256k1.P & 0xFFFFFFFF
    assert np.array_equal(data["t0"].astype(np.int32), good[0].numpy())


@pytest.mark.parametrize("writer", ("jax", "port"))
def test_table_cache_files_cross_between_the_packages(tmp_path, monkeypatch, writer):
    """A file written by one package loads in the other without a build."""
    from zk_toolkit_tpu.curves import secp256k1 as jsecp
    from zk_toolkit_tpu.ops import curve_ops as JC
    from zk_toolkit_tpu.ops import fixed_base as JFB
    from zk_toolkit_tpu.ops import limbs as JL
    from zk_toolkit_tpu.ops.field_ops import FqOps as JFqOps

    monkeypatch.setenv("ZKT_TABLE_CACHE_DIR", str(tmp_path))
    ops, base = _secp()
    jspec = JL.field_spec(secp256k1.P)
    jops = JFqOps(jspec)
    jbase = JC.pack_points([jsecp.g()], jspec)
    if writer == "jax":
        jt = JFB.build_table_cached(jops, jbase, NBITS, WINDOW, key="t")
        monkeypatch.setattr(FB, "build_table", lambda *a: pytest.fail("port rebuilt a JAX file"))
        tt = FB.build_table_cached(ops, base, NBITS, WINDOW, key="t")
    else:
        tt = FB.build_table_cached(ops, base, NBITS, WINDOW, key="t")
        monkeypatch.setattr(JFB, "build_table", lambda *a: pytest.fail("JAX rebuilt a port file"))
        jt = JFB.build_table_cached(jops, jbase, NBITS, WINDOW, key="t")
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


# -- mont_pow_dynamic -----------------------------------------------------------

@pytest.mark.parametrize("p", (params.R, params.Q), ids=("fr", "fq"))
def test_mont_pow_dynamic_equals_jax_and_pow(p):
    import jax.numpy as jnp

    from zk_toolkit_tpu.ops import limbs as JL

    spec, nbits = L.field_spec(p), 64
    rng = random.Random(p % 997)
    full = 1 << (16 * spec.K)
    # Montgomery representations, rows in [p, 2^(16K)) among them
    xs = [rng.randrange(p) for _ in range(5)] + [0, p, p + 1, full - 1]
    es = [0, 1, 2, (1 << nbits) - 1] + [rng.randrange(1 << nbits) for _ in range(5)]
    a = torch.from_numpy(ints_to_array(xs, spec.K).astype(np.int32))
    e = torch.from_numpy(ints_to_array(es, nbits // 16).astype(np.int32))
    got = L.mont_pow_dynamic(a, e, spec, nbits)
    assert torch.equal(got, L.mont_pow_dynamic_plain(a, e, spec, nbits))
    want = JL.mont_pow_dynamic(jnp.asarray(a.numpy().astype(np.uint32)),
                               jnp.asarray(e.numpy().astype(np.uint32)),
                               JL.field_spec(p), nbits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    r_inv = pow(full, -1, p)
    for x, k, v in zip(xs, es, L.unpack(got, spec, mont=False)):
        assert v == pow(x * r_inv, k, p) * full % p
