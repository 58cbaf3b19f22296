"""Multi-scalar multiplication (Pippenger, the sum-tree/Fenwick engine) —
the port of zk_toolkit_tpu/ops/msm.py's default path.

Per group of W windows, every stage a batched device op:

  1. digits:   c-bit windows of each scalar (c | 16 so digits are limb slices)
  2. sort:     per window, points sorted by digit (stable torch.sort) and
               gathered with ONE index of the fused [N, 3K] point rows
  3. up-sweep: a pairwise sum tree over the sorted stream —
               levels[l][i] = sum of block [i*2^l, (i+1)*2^l) — one kernel
               B2 launch per level for all W windows
  4. window:   sum_b b * B_b without materializing buckets, via the suffix
               identity sum_b b*B_b = (2^c-1)*Total - sum_k S_ex[p_k]:
               boundary positions p_k by binary search on the sorted keys,
               exclusive prefix sums at the boundaries by Fenwick
               decomposition over the up-sweep levels
  5. combine:  Horner over windows, c doublings per step in one launch.

Window-major layout [W, N, ...]: N is a power of two, so the even/odd rows
of a level, flattened over all windows, are one strided [W*N/2, K] view
per coordinate, which kernel B2 reads in place.

Every group-law call goes through ops/curve_ops.point_add/point_double, so
on a card a G1 MSM (FqOps) runs on kernels B2/B3 and on the CPU on the
plain formulas; a G2 MSM (Fq2Ops, coordinates [N, 2, K]) runs the formulas
everywhere, their products on B1. The operations and their order are the
JAX package's, so the result's limbs are its limbs.

Above ZKT_MSM_MAX_STREAM points (default 2^20) the stream is cut into
sub-MSMs of that many points whose results are joined by point_add, as in
the JAX package: the result is the same point, in another Jacobian
representation.

msm_pippenger_many runs B independent MSMs (B point streams, as the
Bulletproofs rounds give L and R) in one pass: every (stream, window) pair
is a digit column of the same sort/up-sweep/Fenwick pass, whose gather
reads each column's points from its own stream, and one Horner over the
[W, B] window sums combines the windows; each stream's limbs are those msm_pippenger gives it.
"""

from __future__ import annotations

import contextlib
import os

import torch

from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops.fixed_base import _free_bytes
from zk_toolkit_tpu_torch.utils.bigint import LIMB_BITS


def default_window_bits(n: int) -> int:
    """Window size c (must divide 16): roughly log2(N) - 5 capped at 8."""
    target = max(1, n.bit_length() - 5)
    for c in (8, 4, 2, 1):
        if c <= target:
            return c
    return 1


def _window_digits(scalars: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """Digit of window w (bits [c*w, c*(w+1))) for every scalar.
    scalars: int32 [N, S] 16-bit limbs; returns int64 [N] in [0, 2^c)."""
    per = LIMB_BITS // c
    limb = scalars[:, w // per].long()
    return (limb >> ((w % per) * c)) & ((1 << c) - 1)


def _window_digits_group(scalars: torch.Tensor, c: int, lo: int, hi: int) -> torch.Tensor:
    """Digits of windows [lo, hi), window-major -> int64 [hi-lo, N]."""
    return torch.stack([_window_digits(scalars, c, w) for w in range(lo, hi)], dim=0)


def _window_digits_cols(scalars: torch.Tensor, c: int, lo: int, hi: int) -> torch.Tensor:
    """Column-batched digits of windows [lo, hi): scalars int32 [B, N, S]
    (B independent streams) -> int64 [B * (hi-lo), N], row b*W + w the
    digits of window lo + w of stream b (the JAX package's column order)."""
    per = LIMB_BITS // c
    cols = [(scalars[:, :, w // per].long() >> ((w % per) * c)) & ((1 << c) - 1)
            for w in range(lo, hi)]
    return torch.stack(cols, dim=1).reshape(-1, scalars.shape[1])


def _sorted_stream(pts, digits: torch.Tensor, src_cols: int | None = None):
    """Sorted (keys, points) per window. digits: int64 [M, N], one row per
    window column. pts: Jacobian tuple [N, K] when src_cols is None (one
    source stream), else [B, N, K] with B = src_cols source streams, and
    row j of digits gathers from stream j // (M / B). Stable sort along N
    (the JAX package's argsort is stable too, so equal digits keep the same
    order), then ONE gather of the fused [N, 3K] rows; the returned
    coordinates are column views of the [M, N, 3K] sorted copy."""
    keys, order = torch.sort(digits, dim=1, stable=True)
    k = pts[0].shape[-1]
    comb = torch.cat(pts, dim=-1)                        # [(B,) N, 3K]
    if src_cols is None:
        out = comb[order]                                # [M, N, 3K]
    else:
        m = digits.shape[0]
        src = torch.arange(m, device=digits.device) // (m // src_cols)
        out = comb[src[:, None], order]                  # [M, N, 3K]
    return keys, (out[..., :k], out[..., k:2 * k], out[..., 2 * k:])


def _pair_halve(ops, cur):
    """One up-sweep level: add even/odd neighbours along the stream axis."""
    return C.point_add(ops, tuple(a[:, 0::2] for a in cur), tuple(a[:, 1::2] for a in cur))


def _half_fold(ops, cur):
    """One reduction level: add first half to second half along axis 0."""
    n = cur[0].shape[0]
    return C.point_add(ops, tuple(a[: n // 2] for a in cur), tuple(a[n // 2:] for a in cur))


def _boundary_positions(keys: torch.Tensor, m: int) -> torch.Tensor:
    """p[w, k-1] = number of entries < k == first index with key >= k, for
    k = 1..m-1. keys int64 [W, N] sorted ascending along N; returns int64
    [m-1, W] (boundary-major, as the JAX package's [m-1, W]) in [0, N]."""
    ks = torch.arange(1, m, device=keys.device).expand(keys.shape[0], m - 1).contiguous()
    return torch.searchsorted(keys, ks).transpose(0, 1)


def _fenwick_gather_level(ops, lev, p: torch.Tensor, l: int):
    """Level-l contribution to S_ex[p]: levels[l][(p >> l) - 1] where bit l
    of p is set, infinity elsewhere. lev: [W, N_l, K] coordinates; p:
    [m-1, W]; returns [m-1, W, K] coordinates."""
    bit = (p >> l) & 1
    idx = torch.clamp(p >> l, min=1) - 1                 # [m-1, W]
    w = torch.arange(p.shape[1], device=p.device)
    g = tuple(a[w, idx] for a in lev)                    # [m-1, W, K]
    inf = C.infinity_like(ops, g)
    return C.select_point(ops, bit == 1, g, inf)


def _small_scalar_mul(ops, p, k: int):
    """k * P for a small static integer k: unrolled double-and-add."""
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = C.point_double(ops, acc)
        if bit == "1":
            acc = p if acc is None else C.point_add(ops, acc, p)
    return acc


def _msm_window(ops, pts, digits: torch.Tensor, c: int, spans=None,
                src_cols: int | None = None):
    """One Pippenger window group: sort by digit, up-sweep sum tree with each
    level's Fenwick contribution folded in as the level is produced (so no
    level list stays live), boundary reduction. digits int64 [W, N] ->
    points [W, K]; with src_cols, pts are src_cols streams (_sorted_stream)."""
    span = spans.span if spans is not None else contextlib.nullcontext
    with span("sort_gather"):
        keys, spts = _sorted_stream(pts, digits, src_cols)
    with span("upsweep_fenwick"):
        p = _boundary_positions(keys, 1 << c)            # [2^c-1, W]
        sex = _fenwick_gather_level(ops, spts, p, 0)
        cur = spts
        l = 0
        while cur[0].shape[1] > 1:
            cur = _pair_halve(ops, cur)
            l += 1
            sex = C.point_add(ops, sex, _fenwick_gather_level(ops, cur, p, l))
        total = tuple(a[:, 0] for a in cur)              # [W, K]
        sex = C.pad_to_pow2(ops, sex)
        while sex[0].shape[0] > 1:                       # reduce the k axis
            sex = _half_fold(ops, sex)
        sum_sex = tuple(a[0] for a in sex)               # [W, K]
        wt = _small_scalar_mul(ops, total, (1 << c) - 1)
        return C.point_add(ops, wt, C.point_neg(ops, sum_sex))


def _horner_combine(ops, window_pts, c: int):
    """sum_w 2^(c*w) * S_w, MSB window first: acc = 2^c * acc + S_w.
    window_pts: Jacobian tuple with leading window axis W (ascending); any
    batch axes after it are carried through."""
    w = window_pts[0].shape[0]
    acc = C.infinity_like(ops, tuple(a[0] for a in window_pts))
    for i in range(w):
        acc = C.point_double_n(ops, acc, c)
        acc = C.point_add(ops, acc, tuple(a[w - 1 - i] for a in window_pts))
    return acc


def _pad_stream_axis1(ops, pts, scalars: torch.Tensor):
    """Pad the stream axis (axis 1) of batched [B, n, ...] inputs to a power
    of two with infinity points and zero scalars."""
    n = pts[0].shape[1]
    m = 1 << max(0, (n - 1).bit_length())
    if m == n:
        return pts, scalars
    pad = m - n
    inf = C.infinity_like(ops, tuple(a[:, :1].expand((a.shape[0], pad) + a.shape[2:])
                                     for a in pts))
    pts = tuple(torch.cat([a, i], dim=1) for a, i in zip(pts, inf))
    z = scalars.new_zeros(scalars.shape[:1] + (pad,) + scalars.shape[2:])
    return pts, torch.cat([scalars, z], dim=1)


def _point_words(pts) -> int:
    """32-bit words of one point: prod(shape[1:]) over its coordinates
    (3K for G1, 6K for G2)."""
    return sum(a[0].numel() for a in pts)


def _auto_window_chunk(n: int, n_windows: int, struct_elems: int, device) -> int:
    """How many windows to batch per group: as many as fit in half of the
    device memory free right now, at ~3 live W-wide stream copies per pass
    (the sorted copy and two up-sweep levels). Prefers a divisor of
    n_windows so every group has the same shape."""
    per_window = n * struct_elems * 4 * 3
    raw = max(1, min(n_windows, _free_bytes(torch.device(device)) // 2 // max(per_window, 1)))
    for d in range(raw, 0, -1):
        if n_windows % d == 0:
            return d
    return raw


def msm_pippenger(ops, pts, scalars: torch.Tensor, nbits: int, c: int | None = None,
                  spans=None):
    """sum_i k_i * P_i. pts: batched Jacobian tuple of int32 [N, K]
    Montgomery limbs, scalars: int32 [N, S] plain 16-bit limbs. Returns one
    Jacobian point (tuple of int32 [K] tensors).

    Windows are processed in groups sized from the device's free memory;
    one sort/up-sweep/Fenwick pass covers a whole group. `spans`, a
    utils.profiling.Spans, times the stages when given."""
    span = spans.span if spans is not None else contextlib.nullcontext
    n_raw = pts[0].shape[0]
    step = 1 << (int(os.environ.get("ZKT_MSM_MAX_STREAM", 1 << 20)).bit_length() - 1)
    if n_raw > step:
        acc = None
        for lo in range(0, n_raw, step):
            part = msm_pippenger(ops, tuple(a[lo:lo + step] for a in pts),
                                 scalars[lo:lo + step], nbits, c, spans)
            acc = part if acc is None else tuple(x[0] for x in C.point_add(
                ops, tuple(x[None] for x in acc), tuple(x[None] for x in part)))
        return acc
    pts, scalars = C.pad_to_pow2(ops, pts, scalars)
    n = pts[0].shape[0]
    c = c or default_window_bits(n)
    if LIMB_BITS % c:
        raise ValueError("window size must divide the limb width")
    n_windows = (nbits + c - 1) // c
    wc = _auto_window_chunk(n, n_windows, _point_words(pts), scalars.device)
    partials = []  # per group: tuple of [W, K], ascending windows
    for lo in range(0, n_windows, wc):
        hi = min(lo + wc, n_windows)
        with span("sort_gather"):
            digits = _window_digits_group(scalars, c, lo, hi)   # [W, N]
        partials.append(_msm_window(ops, pts, digits, c, spans))
    stacked = tuple(torch.cat([p[i] for p in partials], dim=0) for i in range(3))
    with span("horner"):
        return _horner_combine(ops, stacked, c)


def msm_pippenger_many(ops, pts, scalars: torch.Tensor, nbits: int, c: int | None = None):
    """B independent MSMs in one batched pass: pts Jacobian tuple [B, n, K]
    over distinct point sets, scalars int32 [B, n, S] -> results [B, K].

    The stream axis is padded to a power of two with infinity points and
    zero scalars. Every (stream, window) pair is its own digit column of
    one sort + up-sweep + Fenwick pass over the group, which gathers each
    column's points from its own stream; one Horner over [W, B] combines
    the windows. The operations and their order are the JAX package's."""
    b = pts[0].shape[0]
    pts, scalars = _pad_stream_axis1(ops, pts, scalars)
    n = pts[0].shape[1]
    c = c or default_window_bits(n)
    if LIMB_BITS % c:
        raise ValueError("window size must divide the limb width")
    n_windows = (nbits + c - 1) // c
    wc = _auto_window_chunk(n * b, n_windows, _point_words(tuple(a[0] for a in pts)),
                            scalars.device)
    partials = []  # per group: tuple of [B, W, K]
    for lo in range(0, n_windows, wc):
        hi = min(lo + wc, n_windows)
        digits = _window_digits_cols(scalars, c, lo, hi)      # [B*W, n]
        grp = _msm_window(ops, pts, digits, c, src_cols=b)    # [B*W, K]
        partials.append(tuple(x.reshape((b, hi - lo) + x.shape[1:]) for x in grp))
    stacked = tuple(torch.cat([p[i] for p in partials], dim=1).transpose(0, 1)
                    for i in range(3))                        # [W, B, K]
    return _horner_combine(ops, stacked, c)
