"""Python bindings for the native host Montgomery engine (the port of
zk_toolkit_tpu/native/host.py, over the port's own copy of its source,
native/zkt_host.cpp beside this file).

Usage:
    eng = engine(modulus)            # None only when g++ is not on the PATH
    c = eng.mul(a, b)                # numpy uint64[n, 4] LE-limb arrays
    inv = eng.inv(a)                 # Montgomery-trick batch inversion
    t = eng.pow_table(w, n)          # [1, w, w^2, ...] for NTT domains
    ints = eng.to_ints(a)            # back to Python ints

All values are in Montgomery form unless converted with to_mont/from_mont.

The library is built at first use (never at import) with
`g++ -O3 -shared -fPIC` into build/zk_toolkit_tpu_torch/libzkthost-<digest>.so
under the repository root, the digest hashing the source and the flags, as
_build.py names the kernels. Unlike the JAX package's loader, a compiler
that is present but fails to build or load the library raises: a broken
engine is never hidden behind the pure-Python branch. Moduli are odd and
at most 256 bits (4 x 64-bit words); a wider one (BLS12-381 Fq) raises
ValueError.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zkt_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(SRC))),
                         "build", "zk_toolkit_tpu_torch")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def lib_path() -> str:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha256()
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libzkthost-{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=1)
def _load():
    """The loaded library; None when g++ is not on the PATH. Raises when the
    build or the load fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    lib = lib_path()
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.tmp{os.getpid()}"
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native host engine:\n{proc.stderr}")
        os.replace(tmp, lib)
    dll = ctypes.CDLL(lib)
    dll.zkt_mont_init.restype = ctypes.c_int
    dll.zkt_mont_struct_size.restype = ctypes.c_int
    return dll


def available() -> bool:
    return _load() is not None


def _as_u64(a) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"expected uint64 [n, 4] rows, got shape {a.shape}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class FrEngine:
    """Batched Montgomery arithmetic mod an odd <= 256-bit prime."""

    def __init__(self, p: int):
        if p.bit_length() > 256:
            raise ValueError("FrEngine supports moduli up to 256 bits")
        dll = _load()
        if dll is None:
            raise RuntimeError("native host engine unavailable (no g++ on the PATH)")
        self.dll = dll
        self.p = p
        self._m = ctypes.create_string_buffer(dll.zkt_mont_struct_size())
        p_le = np.frombuffer(p.to_bytes(32, "little"), dtype=np.uint64).copy()
        rc = dll.zkt_mont_init(p_le.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), self._m)
        if rc != 0:
            raise ValueError("modulus must be odd")

    # -- conversions --
    def from_ints(self, xs, to_mont: bool = True) -> np.ndarray:
        raw = b"".join((int(x) % self.p).to_bytes(32, "little") for x in xs)
        out = np.frombuffer(raw, dtype=np.uint64).reshape(len(xs), 4).copy()
        return self.to_mont(out) if to_mont else out

    def to_ints(self, a, from_mont: bool = True) -> list[int]:
        a = _as_u64(a)
        if from_mont:
            a = self.from_mont(a)
        return [int.from_bytes(row.tobytes(), "little") for row in a]

    def _binary(self, name, a, b):
        a, b = _as_u64(a), _as_u64(b)
        if a.shape != b.shape:
            raise ValueError(f"{name}: shapes differ: {a.shape} vs {b.shape}")
        out = np.empty_like(a)
        getattr(self.dll, name)(self._m, _ptr(a), _ptr(b), _ptr(out), ctypes.c_size_t(a.shape[0]))
        return out

    def mul(self, a, b) -> np.ndarray:
        return self._binary("zkt_mul_batch", a, b)

    def add(self, a, b) -> np.ndarray:
        return self._binary("zkt_add_batch", a, b)

    def sub(self, a, b) -> np.ndarray:
        return self._binary("zkt_sub_batch", a, b)

    def mul_scalar(self, a, s) -> np.ndarray:
        """Every row of a times the one value s ([1, 4])."""
        a, s = _as_u64(a), _as_u64(s)
        out = np.empty_like(a)
        self.dll.zkt_mul_scalar_batch(self._m, _ptr(a), _ptr(s), _ptr(out),
                                      ctypes.c_size_t(a.shape[0]))
        return out

    def _unary(self, name, a):
        a = _as_u64(a)
        out = np.empty_like(a)
        getattr(self.dll, name)(self._m, _ptr(a), _ptr(out), ctypes.c_size_t(a.shape[0]))
        return out

    def to_mont(self, a) -> np.ndarray:
        return self._unary("zkt_to_mont_batch", a)

    def from_mont(self, a) -> np.ndarray:
        return self._unary("zkt_from_mont_batch", a)

    def inv(self, a) -> np.ndarray:
        """Batch inverse (Montgomery trick); the inverse of 0 is 0."""
        return self._unary("zkt_inv_batch", a)

    def pow_table(self, base: int, n: int) -> np.ndarray:
        """[base^0 .. base^(n-1)] in Montgomery form."""
        b = self.from_ints([base])
        out = np.empty((n, 4), dtype=np.uint64)
        self.dll.zkt_pow_table(self._m, _ptr(b), _ptr(out), ctypes.c_size_t(n))
        return out


@functools.lru_cache(maxsize=None)
def engine(p: int) -> FrEngine | None:
    """Cached engine per modulus; None only when g++ is not on the PATH.
    Raises ValueError for a modulus over 256 bits or an even one, and
    RuntimeError when the library fails to build or load."""
    if p.bit_length() > 256:
        raise ValueError("the native host engine supports moduli up to 256 bits")
    if not available():
        return None
    return FrEngine(p)
