"""Rules of the port that a reader cannot see from one file:

- zk_toolkit_tpu_torch/ and chip_smoke.py import neither jax nor the JAX
  package zk_toolkit_tpu (only the tests import both);
- convert.py moves the JAX package's arrays into the port's tensors and
  back without changing a limb;
- the port's native host engine builds from the port's own source
  (zk_toolkit_tpu_torch/native/zkt_host.cpp) into build/, and writes nothing
  under the repository's native/, where the JAX package keeps its own.
"""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu_torch import convert

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "zk_toolkit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "zk_toolkit_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    for module in ("ops/msm.py", "ops/ntt.py", "ops/tower_ops.py", "ops/pairing_ops.py",
                   "protocols/groth16_device.py", "snark/r1cs.py", "snark/synthetic.py",
                   "fields/prime_field.py", "curves/bls12_381/pairing.py", "utils/rng.py",
                   "curves/bls12_381/optimal_ate.py", "protocols/pinocchio_device.py",
                   "utils/serialize.py", "entry.py", "bench.py", "curves/secp256k1.py",
                   "hashers/sha256.py", "hashers/sha512.py", "hashers/hmac.py",
                   "protocols/bulletproofs.py", "protocols/bulletproofs_device.py",
                   "ops/signature_ops.py", "signatures/ecdsa.py", "ops/sha_ops.py",
                   "ops/edwards_ops.py", "curves/curve25519.py", "signatures/ed25519.py",
                   "signatures/bls.py", "fields/polynomial.py", "snark/qap.py",
                   "snark/circuits.py", "protocols/groth16.py", "protocols/pinocchio.py",
                   "config.py", "utils/profiling.py", "native/__init__.py", "native/host.py",
                   "ops/fixed_base.py", "ops/limbs.py", "ops/curve_ops.py",
                   "parallel/mesh.py", "parallel/sharded_ntt.py", "parallel/sharded_groth16.py"):
        assert f"zk_toolkit_tpu_torch/{module}" in names
    assert _forbidden("jax.numpy") and _forbidden("zk_toolkit_tpu.ops.limbs")
    assert not _forbidden("zk_toolkit_tpu_torch.ops.limbs")


def test_convert_round_trips_jax_arrays():
    rng = np.random.default_rng(3)
    pts = tuple(jnp.asarray(rng.integers(0, 1 << 16, size=(9, 24), dtype=np.uint32))
                for _ in range(3))
    sc = jnp.asarray(rng.integers(0, 1 << 16, size=(9, 16), dtype=np.uint32))
    table = (pts[0], pts[1], jnp.asarray(rng.integers(0, 2, size=9).astype(bool)))

    tp = convert.points_from_jax(pts, "cpu")
    assert all(t.dtype == torch.int32 for t in tp)
    for a, b in zip(convert.points_to_jax(tp), pts):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.uint32
    np.testing.assert_array_equal(
        convert.limbs_to_jax(convert.scalars_from_jax(sc, "cpu")), np.asarray(sc))
    for a, b in zip(convert.table_to_jax(convert.table_from_jax(table, "cpu")), table):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_convert_rejects_what_is_not_a_limb_array():
    with pytest.raises(ValueError):
        convert.limbs_from_jax(np.zeros((2, 24), dtype=np.int64), "cpu")
    with pytest.raises(ValueError):
        convert.limbs_from_jax(np.full((2, 24), 1 << 16, dtype=np.uint32), "cpu")


def test_native_engine_builds_from_its_own_source(tmp_path, monkeypatch):
    import shutil

    from zk_toolkit_tpu_torch.native import host as H

    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    assert pathlib.Path(H.SRC) == ROOT / "zk_toolkit_tpu_torch" / "native" / "zkt_host.cpp"
    assert pathlib.Path(H.lib_path()).parent == ROOT / "build" / "zk_toolkit_tpu_torch"
    native = ROOT / "native"
    before = {f.name: f.stat().st_mtime_ns for f in native.iterdir()}
    monkeypatch.setattr(H, "BUILD_DIR", str(tmp_path))
    H._load.cache_clear()
    H.engine.cache_clear()
    try:
        eng = H.engine(0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001)
        assert eng.to_ints(eng.inv(eng.from_ints([2]))) == [pow(2, -1, eng.p)]
        built = sorted(f.name for f in tmp_path.iterdir())
        assert built == [pathlib.Path(H.lib_path()).name]
        assert built[0].startswith("libzkthost-") and built[0].endswith(".so")
    finally:
        H._load.cache_clear()
        H.engine.cache_clear()
    assert {f.name: f.stat().st_mtime_ns for f in native.iterdir()} == before
