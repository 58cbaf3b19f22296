"""Builds the package's CUDA kernels and loads them.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, `build/zk_toolkit_tpu_torch/<name>-<digest>.so`
under the repository root, where the digest hashes the sources, the headers
and the flags; the library is loaded with ctypes. No PyTorch headers are
compiled, so a build takes seconds, not minutes. A build runs at first use,
or for all kernels at once (one nvcc process per source, started together)
through `build()`. A failed build raises: there is no fallback.

Every library exports one launcher with the same signature,

    int zkt_<name>(int n_words, const long long* args, long long n,
                   const unsigned* p_words, unsigned n0, int reps,
                   void* stream)

where `args` holds the views' base pointers, then their row strides, and
`reps` is B3's doubling count (1 for the others). It launches on the given
stream and returns cudaGetLastError(); `launch()` raises if it is not 0.
B1's library (`mont_mul.cu`) exports a second entry with that signature,
`zkt_mont_pow`, the static-exponent chain: there `reps` is the chunk's bit
count (1 to 384) and `args` goes on after the strides with the 12 exponent
words (`launch(..., words=...)`), which the launcher passes to the kernel
by value. `ENTRIES` maps each entry to the source that holds it.
The loaded function and each field's modulus words are cached, so a
launch costs the view checks, one argument array and the ctypes call.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

# Every launcher entry (zkt_<entry>) and the source csrc/<source>.cu that
# holds it; each source builds into one library.
ENTRIES = {"mont_mul": "mont_mul", "mont_pow": "mont_mul",
           "point_add": "point_add", "point_double": "point_double"}
KERNELS = tuple(dict.fromkeys(ENTRIES.values()))

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zk_toolkit_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_fns: dict[str, tuple] = {}      # name -> (launcher, error-string function)
_moduli: dict[int, tuple] = {}   # p -> (p's 32-bit words as a ctypes array, n0)
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    files = [os.path.join(CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for f in files:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def build(names=KERNELS, timeout: float = 600.0) -> dict[str, float]:
    """Compiles every kernel in `names` whose library is missing, one nvcc
    process per source, all started together. Returns the seconds each
    build took (0.0 where the library was already there). The ptxas report
    (registers, spills) goes to the `.log` beside each library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    procs = {}
    t0 = time.perf_counter()
    nvcc = _nvcc() if todo else None
    for name in todo:
        out = lib_path(name)
        tmp = f"{out}.tmp{os.getpid()}"
        log = open(out[:-3] + ".log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    secs = {n: 0.0 for n in names}
    failed = []
    try:
        for name, (proc, tmp, out, log) in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = "timeout"
            log.close()
            secs[name] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, out)
            else:
                with open(log.name) as fh:
                    failed.append(f"{name} (nvcc: {rc}):\n{fh.read()[-4000:]}")
    finally:
        for proc, _, _, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return secs


def ptxas_usage(entry: str) -> dict[int, dict]:
    """Per instantiation of the kernel of launcher entry `entry` (ENTRIES)
    in its last build, keyed by the words per element N (K = 2N limbs),
    what ptxas reported: registers, stack frame and spill bytes. {} when
    there is no build log."""
    path = lib_path(ENTRIES[entry])[:-3] + ".log"
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return parse_ptxas(fh.read(), f"{entry}_kernel")


def parse_ptxas(log: str, kernel: str | None = None) -> dict[int, dict]:
    """Parses `-Xptxas -v` output; an entry's N is the template argument of
    its mangled name (`ILi12E` for N = 12). With `kernel`, only the
    functions of that name (`mont_pow_kernel`) count."""
    usage: dict[int, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            n = re.search(r"ILi(\d+)E", m.group(1))
            if kernel is not None and f"{kernel}ILi" not in m.group(1):
                n = None
            cur = usage.setdefault(int(n.group(1)), {}) if n else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["stack_bytes"] = int(m.group(1))
            cur["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return usage


def _kernel(name: str) -> tuple:
    """(launcher, error-string function) of launcher entry `name`, its
    library built and loaded at first use."""
    fns = _fns.get(name)
    if fns is not None:
        return fns
    with _lock:
        if name not in _fns:
            src = ENTRIES[name]
            build((src,))
            lib = ctypes.CDLL(lib_path(src))
            fn = getattr(lib, f"zkt_{name}")
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.zkt_error_string.argtypes = [ctypes.c_int]
            lib.zkt_error_string.restype = ctypes.c_char_p
            _fns[name] = (fn, lib.zkt_error_string)
        return _fns[name]


def _modulus(spec) -> tuple:
    m = _moduli.get(spec.p)
    if m is None:
        words = spec.p_words32
        m = _moduli[spec.p] = ((ctypes.c_uint * len(words))(*words), spec.n0inv32)
    return m


def _stream(device: torch.device) -> int:
    """The raw handle of the current stream of `device` (the call Triton's
    launcher makes: no Stream object is built)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check_view(t: torch.Tensor, k: int) -> tuple[int, int]:
    """(data pointer, row stride) of `t`, an int32 [rows, k] CUDA view the
    kernels can read or write: limb stride 1, row stride a multiple of 4
    elements, 16-byte aligned. Raises on anything else (callers make such
    views; see ops/curve_kernels.as_rows)."""
    if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != k:
        raise ValueError(f"kernel operand must be int32 [rows, {k}] on CUDA, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    s0, s1 = t.stride()
    ptr = t.data_ptr()
    if s1 != 1 or s0 % 4 or ptr % 16:
        raise ValueError(f"kernel operand has strides {t.stride()} at offset "
                         f"{ptr % 16} mod 16; need limb stride 1, row "
                         "stride % 4 == 0, 16-byte alignment")
    return ptr, s0


_arg_arrays: dict[int, type] = {}   # args -> ctypes array type of that length


def launch(name: str, spec, views, n: int, reps: int = 1, words: tuple = ()) -> None:
    """Launches entry `name` over `n` rows of the int32 [rows, K] CUDA
    `views` (inputs first, then outputs) for the field of `spec`, on the
    current stream; `reps` is B3's doubling count or the chain's bit count,
    `words` the chain's exponent words."""
    fn, error_string = _kernel(name)
    k = spec.K
    if k not in (16, 24):
        raise ValueError(f"kernels are built for K = 16 and 24 limbs, not {k}")
    ptrs, strides = zip(*[check_view(v, k) for v in views])
    m = 2 * len(views) + len(words)
    arr = _arg_arrays.get(m)
    if arr is None:
        arr = _arg_arrays[m] = ctypes.c_longlong * m
    p_words, n0 = _modulus(spec)
    rc = fn(k // 2, arr(*ptrs, *strides, *words), n, p_words, n0, reps,
            _stream(views[0].device))
    if rc != 0:
        raise RuntimeError(f"kernel {name} launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")
