"""Windowed fixed-base scalar multiplication (the port of
zk_toolkit_tpu/ops/fixed_base.py, its on-disk table cache included).

Precompute T[w][d] = d * 2^(c*w) * G once; every scalar multiplication is
then W = ceil(nbits/c) table gathers plus a log2(W)-deep tree of batched
point additions — no doublings. The table is stored in affine form
((x, y, inf)) and lifted to Jacobian z in {0, 1} for the gathers. Batches
are chunked to fit the device's free memory.

Generic over the field-ops namespace: FqOps gives G1 tables, Fq2Ops G2
ones. A coordinate keeps its struct axes ([..., K] or [..., 2, K]) through
the table and the gathers, and is budgeted at prod(shape[1:]) words.

build_table_cached keeps each table in $ZKT_TABLE_CACHE_DIR (default
<repo>/.zkt_tables) as the JAX package's .npz: t0..t2 (x, y as uint32
limbs, inf as bool) and the derivation keys meta_*, so either package loads
the other's file.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.utils.bigint import LIMB_BITS


def _digits(scalars: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """Digit of window w (bits [c*w, c*(w+1))) of each scalar.
    scalars: int32 [B, S] 16-bit limbs -> int64 [B] in [0, 2^c)."""
    per = LIMB_BITS // c
    limb = scalars[:, w // per].long()
    return (limb >> ((w % per) * c)) & ((1 << c) - 1)


def build_table(ops, base_jac, nbits: int, c: int):
    """Affine window table for one base point.

    base_jac: Jacobian tuple with leading batch axis 1.
    Returns (ax, ay, inf) each with leading axis W * 2^c, entry
    w * 2^c + d holding d * 2^(c*w) * G (d = 0 rows are infinity).
    """
    if LIMB_BITS % c:
        raise ValueError("window size must divide the limb width")
    n_win = (nbits + c - 1) // c
    m = 1 << c

    # G_w = 2^(c*w) * G for every window: c-fold doubling of a 1-point batch.
    g_ws = []
    p = base_jac
    for _ in range(n_win):
        g_ws.append(p)
        p = C.point_double_n(ops, p, c)
    g_ws = tuple(torch.cat([g[i] for g in g_ws], dim=0) for i in range(3))  # [W, K]

    # d * G_w for d = 0..2^c-1: running batched add over the window axis.
    acc = C.infinity_like(ops, g_ws)
    entries = []
    for _ in range(m):
        entries.append(acc)
        acc = C.point_add(ops, acc, g_ws)
    # [2^c, W, ...] -> flat [W * 2^c, ...] with index w * 2^c + d
    flat = tuple(
        torch.stack([e[i] for e in entries], dim=0).transpose(0, 1)
        .reshape((n_win * m,) + entries[0][i].shape[1:])
        for i in range(3)
    )
    return C.to_affine(ops, flat)


def _table_cache_dir() -> str:
    d = os.environ.get("ZKT_TABLE_CACHE_DIR")
    if not d:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        d = os.path.join(root, ".zkt_tables")
    return d


def _host_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def _load_table(path: str, meta: dict, dev):
    """The (x, y, inf) table in `path` on `dev` if the file loads and every
    meta field equals `meta`'s; None for a missing, corrupt, stale or
    foreign file."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            if not all(k in data and data[k].shape == v.shape and (data[k] == v).all()
                       for k, v in meta.items()):
                return None
            return (torch.from_numpy(data["t0"].astype(np.int32)).to(dev),
                    torch.from_numpy(data["t1"].astype(np.int32)).to(dev),
                    torch.from_numpy(data["t2"].astype(bool)).to(dev))
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def build_table_cached(ops, base_jac, nbits: int, c: int, key: str):
    """build_table with .npz persistence: the table is deterministic in
    (base point, field, nbits, c), so it is built once per cache directory
    and loaded onto the device of `base_jac` after that.

    The file is named by (key, nbits, c) alone, so it stores the table's
    derivation (the modulus as 12 32-bit words, [K, nbits, c], the base
    point's Jacobian limbs) and the loader trusts it only if every one of
    those equals this call's and its entry w = 0, d = 1 equals the affine
    base point. A file that fails either, or that does not load, is rebuilt
    and replaced; the write goes to a temporary file renamed into place, so
    a reader never sees half of one."""
    spec = ops.spec
    meta = {
        "meta_p": np.asarray([spec.p >> (32 * i) & 0xFFFFFFFF for i in range(12)],
                             dtype=np.uint64),
        "meta_dims": np.asarray([spec.K, nbits, c], dtype=np.int64),
        "meta_bx": _host_u32(base_jac[0]),
        "meta_by": _host_u32(base_jac[1]),
        "meta_bz": _host_u32(base_jac[2]),
    }
    path = os.path.join(_table_cache_dir(), f"{key}_n{nbits}_c{c}.npz")
    table = _load_table(path, meta, base_jac[0].device)
    if table is not None:
        # structural self-check: entry w = 0, d = 1 is 1 * 2^0 * G = G
        g_aff = C.to_affine(ops, base_jac)
        if torch.equal(table[0][1], g_aff[0][0]) and torch.equal(table[1][1], g_aff[1][0]):
            return table
    table = build_table(ops, base_jac, nbits, c)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.npz"
        np.savez_compressed(tmp, t0=_host_u32(table[0]), t1=_host_u32(table[1]),
                            t2=table[2].cpu().numpy().astype(bool), **meta)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only filesystem: the table stays in memory
    return table


def _lift(ops, aff):
    """Affine (x, y, inf) -> Jacobian with z in {0, 1}."""
    ax, ay, inf = aff
    one = ops.one_like(ax)
    zero = ops.zero_like(ax)
    x = ops.select(inf, one, ax)
    y = ops.select(inf, one, ay)
    z = ops.select(inf, zero, one)
    return (x, y, z)


def _gather_fold(ops, table, scalars: torch.Tensor, c: int):
    """One chunk: gather each scalar's W window entries and tree-sum them.
    Returns a Jacobian tuple with leading axis B."""
    n_win = scalars.shape[1] * LIMB_BITS // c
    m = 1 << c
    k = table[0].shape[-1]
    # digit index matrix [W, B] -> flat table rows w * 2^c + d
    digs = torch.stack([_digits(scalars, c, w) for w in range(n_win)], dim=0)
    wi = torch.arange(n_win, device=scalars.device)[:, None]
    flat_idx = wi * m + digs
    # one gather of fused [..., x | y | z] rows of the lifted table
    comb = torch.cat(_lift(ops, table), dim=-1)              # [T, ..., 3K]
    g = comb[flat_idx]                                       # [W, B, ..., 3K]
    pts = (g[..., :k], g[..., k:2 * k], g[..., 2 * k:])
    # pad W to a power of two with infinity, then halve along axis 0
    n = n_win
    target = 1 << max(0, (n - 1).bit_length())
    if target != n:
        pad = C.infinity_like(ops, tuple(a[: target - n] for a in pts))
        pts = tuple(torch.cat([a, b], dim=0) for a, b in zip(pts, pad))
        n = target
    while n > 1:
        half = n // 2
        pts = C.point_add(
            ops, tuple(a[:half] for a in pts), tuple(a[half:] for a in pts)
        )
        n = half
    return tuple(a[0] for a in pts)


def _free_bytes(device: torch.device) -> int:
    """Free memory of `device` as measured now (half of what the host
    reports free for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2


def scalar_mul_fixed(ops, table, scalars: torch.Tensor, c: int):
    """[k_i * G] for a batch of scalars against a precomputed window table.

    scalars: int32 [B, S] plain 16-bit limbs. Chunked so the gathered
    per-window point copies stay inside half the device's free memory."""
    b = scalars.shape[0]
    n_win = scalars.shape[1] * LIMB_BITS // c
    words = table[0][0].numel()                  # prod(shape[1:]) a coordinate
    # gathered [W, B, ..., 3K] copy + the first tree level + its inputs' views
    per_row = n_win * 3 * words * 4 * 2
    chunk = max(1, _free_bytes(scalars.device) // 2 // per_row)
    if b <= chunk:
        return _gather_fold(ops, table, scalars, c)
    parts = [_gather_fold(ops, table, scalars[lo:lo + chunk], c)
             for lo in range(0, b, chunk)]
    return tuple(torch.cat([p[i] for p in parts], dim=0) for i in range(3))
