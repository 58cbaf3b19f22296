"""Sharded radix-2 NTT over BLS12-381 Fr: the four-step transform with
all_to_all transposes (the port of zk_toolkit_tpu/parallel/sharded_ntt.py).

The size-n transform is factored as n = n1 * n2 (both powers of two, both
divisible by the world size D, n1 as close to sqrt(n) as possible):

    X[k2*n1 + k1] = NTT_n2 over j2 { w^(j2*k1) * NTT_n1 over j1 { x[j1*n2 + j2] } }

With x viewed as an [n1, n2] matrix whose rows are split over the ranks,
a rank holds one contiguous block of n/D elements of x, and the transform
is, on every rank:

    [coset pre-scale] -> transpose -> dit_rows over n1 -> mid twiddle
    -> transpose -> dit_rows over n2 -> transpose -> [coset post-scale]

Each transpose is one all_to_all with equal splits: three a transform and
no other collective; every butterfly is local. The output is again one
contiguous block of n/D elements per rank, in natural order. The inverse
transform is the same dataflow over the inverse tables, with 1/n folded
into the mid twiddle (every output passes through exactly one). The
arithmetic is exact and canonical, so the limbs equal the single-device
ops/ntt.py transforms'.

The public functions follow the sharded layer's contract (parallel/mesh.py):
every rank is handed the whole [n, K] (or [B, n, K]) input, keeps its
block, and returns the whole result, gathered with one all_gather after
the transform. `sharded_h_from_evs` is the Groth16 quotient chain (intt ->
coset_ntt -> quotient -> coset_intt) with every intermediate kept in
blocks: nine all_to_alls and the final gather. The sharded prove runs its
block form (`h_from_evs_local`) on the blocks its SpMV makes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import ntt as NTT
from zk_toolkit_tpu_torch.parallel.mesh import Mesh, shard_leading
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

R = params.R


def _spec():
    return L.field_spec(R)


def _split(n: int, d: int) -> tuple[int, int]:
    """n = n1 * n2, both powers of two divisible by d, n1 = 2^ceil(log2(n)/2).
    Raises where d does not divide both (n < d^2, or d not a power of two)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"the four-step NTT needs a power-of-two size, not {n}")
    log_n = n.bit_length() - 1
    n1 = 1 << ((log_n + 1) // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise ValueError(f"four-step shards need d | n1 and d | n2 (n={n}, d={d}); "
                         "use the single-device ops/ntt.py path for n < d^2")
    return n1, n2


def _mont_np(vals, spec) -> np.ndarray:
    """Montgomery limbs uint32 [len(vals), K] of ints mod p."""
    return ints_to_array([v * spec.r_mod_p % spec.p for v in vals], spec.K)


@functools.lru_cache(maxsize=8)
def _mid_table(n: int, n1: int, inverse: bool, fold_ninv: bool) -> np.ndarray:
    """uint32 [n2, n1, K] Montgomery table T[j2, k1] = w^(+-j2*k1), times
    1/n when fold_ninv: the JAX package's array, byte for byte."""
    spec = _spec()
    n2 = n // n1
    w = pow(NTT.FR_GENERATOR, (R - 1) // n, R)
    if inverse:
        w = pow(w, -1, R)
    scale = pow(n, -1, R) if fold_ninv else 1
    vals = []
    row_base = 1
    for _ in range(n2):
        cur = scale
        for _ in range(n1):
            vals.append(cur)
            cur = cur * row_base % R
        row_base = row_base * w % R
    return _mont_np(vals, spec).reshape(n2, n1, spec.K)


@functools.lru_cache(maxsize=8)
def _coset_table(n: int, rows: int, inverse: bool) -> np.ndarray:
    """uint32 [rows, n // rows, K] Montgomery table of g^(+-(r*cols + c)):
    the coset pre-scale (forward, [n1, n2] input layout) or post-scale
    (inverse, [n2, n1] output layout); the JAX package's array."""
    spec = _spec()
    g = NTT.FR_GENERATOR
    if inverse:
        g = pow(g, -1, R)
    vals = []
    cur = 1
    for _ in range(n):
        vals.append(cur)
        cur = cur * g % R
    return _mont_np(vals, spec).reshape(rows, n // rows, spec.K)


def _block(mesh: Mesh, table: np.ndarray) -> torch.Tensor:
    """This rank's rows of a table, as int32 on the mesh's device."""
    return shard_leading(mesh, torch.from_numpy(table.astype(np.int32)))


def _transpose(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[B, r/D, c, K] rows of this rank -> [B, c/D, r, K]: the rank's block
    of the columns, every row, transposed. One all_to_all: the column block
    k of the rank's rows goes to rank k."""
    b, rl, c, k = t.shape
    d = mesh.world
    out = mesh.all_to_all(t.reshape(b, rl, d, c // d, k).permute(2, 0, 1, 3, 4))
    # out[src, b, i, j] = element (row src*rl + i, column rank*c/D + j)
    return out.permute(1, 3, 0, 2, 4).reshape(b, c // d, d * rl, k)


def _four_step(x: torch.Tensor, n: int, mesh: Mesh, inverse: bool, fold_ninv: bool,
               pre: bool, post: bool) -> torch.Tensor:
    """One size-n transform of a [B, n/D, K] block (rows j1 of the [n1, n2]
    view) -> [B, n/D, K] block of the natural-order output. Three
    all_to_alls."""
    spec = _spec()
    b, nl, k = x.shape
    d = mesh.world
    n1, n2 = _split(n, d)
    if nl * d != n:
        raise ValueError(f"a block of {nl} rows is not 1/{d} of {n}")
    dev = x.device
    x = x.reshape(b, n1 // d, n2, k)
    if pre:
        x = L.mont_mul(x, _block(mesh, _coset_table(n, n1, False)), spec)
    xt = _transpose(mesh, x)                                 # [B, n2/D, n1, K] rows j2
    xt = NTT.dit_rows(NTT.fr_domain(n1, dev), xt, inverse)   # j1 -> k1
    xt = L.mont_mul(xt, _block(mesh, _mid_table(n, n1, inverse, fold_ninv)), spec)
    y = _transpose(mesh, xt)                                 # [B, n1/D, n2, K] rows k1
    y = NTT.dit_rows(NTT.fr_domain(n2, dev), y, inverse)     # j2 -> k2
    out = _transpose(mesh, y)                                # [B, n2/D, n1, K] rows k2
    if post:
        out = L.mont_mul(out, _block(mesh, _coset_table(n, n2, True)), spec)
    return out.reshape(b, nl, k)


def _gather_blocks(mesh: Mesh, blocks: torch.Tensor) -> torch.Tensor:
    """[B, n/D, K] blocks of every rank -> [B, n, K], one all_gather."""
    g = mesh.all_gather(blocks)                              # [D, B, n/D, K]
    return g.transpose(0, 1).reshape(blocks.shape[0], -1, blocks.shape[-1])


def _run(x, mesh: Mesh, inverse: bool, fold_ninv: bool, pre: bool, post: bool):
    """x [n, K] or [B, n, K], the same on every rank -> the whole
    transform, natural order, on every rank."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    n = x.shape[1]
    _split(n, mesh.world)
    blk = shard_leading(mesh, x.transpose(0, 1)).transpose(0, 1)
    out = _gather_blocks(mesh, _four_step(blk, n, mesh, inverse, fold_ninv, pre, post))
    return out[0] if squeeze else out


def sharded_ntt(x, mesh: Mesh):
    """Coefficients -> evaluations (== ops/ntt.py ntt, limb for limb)."""
    return _run(x, mesh, inverse=False, fold_ninv=False, pre=False, post=False)


def sharded_intt(x, mesh: Mesh):
    """Evaluations -> coefficients (== intt)."""
    return _run(x, mesh, inverse=True, fold_ninv=True, pre=False, post=False)


def sharded_coset_ntt(x, mesh: Mesh):
    """Coefficients -> evaluations on the coset gH (== coset_ntt)."""
    return _run(x, mesh, inverse=False, fold_ninv=False, pre=True, post=False)


def sharded_coset_intt(x, mesh: Mesh):
    """Coset evaluations -> coefficients (== coset_intt)."""
    return _run(x, mesh, inverse=True, fold_ninv=True, pre=False, post=True)


def h_from_evs_local(abc: torch.Tensor, n: int, mesh: Mesh) -> torch.Tensor:
    """The quotient chain on blocks: abc [3, n/D, K], this rank's block of
    the A/B/C evaluations over H -> its [n/D, K] block of the h
    coefficients (Montgomery). intt and coset_ntt over the [3] batch, the
    quotient (A*B - C) * t_coset^-1 on the rank's coset evaluations, then
    coset_intt: nine all_to_alls."""
    spec = _spec()
    coeffs = _four_step(abc, n, mesh, inverse=True, fold_ninv=True, pre=False, post=False)
    cs = _four_step(coeffs, n, mesh, inverse=False, fold_ninv=False, pre=True, post=False)
    t_inv = NTT.fr_domain(n, abc.device).t_coset_inv_mont[None]
    h_cs = L.mont_mul(L.sub_mod(L.mont_mul(cs[0], cs[1], spec), cs[2], spec), t_inv, spec)
    return _four_step(h_cs[None], n, mesh, inverse=True, fold_ninv=True, pre=False,
                      post=True)[0]


def sharded_h_from_evs(a_ev, b_ev, c_ev, mesh: Mesh):
    """h coefficients from the A/B/C evaluations over H, each [n, K]
    Montgomery and the same on every rank: limb for limb
    ops/ntt.py h_coset_then_coeffs, on every rank."""
    n = a_ev.shape[0]
    _split(n, mesh.world)
    abc = torch.stack([a_ev, b_ev, c_ev])
    blk = shard_leading(mesh, abc.transpose(0, 1)).transpose(0, 1)
    return _gather_blocks(mesh, h_from_evs_local(blk, n, mesh)[None])[0]
