"""Batched short-Weierstrass (a = 0) group law in Jacobian coordinates (the
port of zk_toolkit_tpu/ops/curve_ops.py).

Point representation: a `(x, y, z)` tuple of int32 Montgomery limb tensors
[..., K] over FqOps (G1) or [..., 2, K] over ops/tower_ops.Fq2Ops (G2);
infinity <=> z == 0 (canonically (1, 1, 0) in Montgomery form). Scalars
are plain (non-Montgomery) 16-bit limb tensors [..., S].

`point_add` / `point_double` / `point_double_n` launch kernels B2 / B3
(ops/curve_kernels.py) for every CUDA batch of a base-field FqOps, at every
batch size; the formulas `_point_add_formula` / `_point_double_formula` are
their plain versions, run for CPU tensors and for FqOps(plain=True), the
reference the kernels are held against. Over Fq2Ops the formulas always
run (their products on B1), as in the JAX package, which takes its fused
law only for one struct axis.
"""

from __future__ import annotations

import numpy as np
import torch

from zk_toolkit_tpu_torch.ops import curve_kernels as CK
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils import host_curve as HC
from zk_toolkit_tpu_torch.utils.bigint import LIMB_BITS, ints_to_array


# -- point helpers -----------------------------------------------------------

def select_point(ops, mask, p, q):
    """Per-element point select: p where mask else q."""
    return tuple(ops.select(mask, a, b) for a, b in zip(p, q))


def infinity_like(ops, p):
    """(1, 1, 0) in Montgomery form, shaped like point p."""
    one = ops.one_like(p[0])
    return (one, one, ops.zero_like(p[2]))


def is_infinity(ops, p):
    return ops.is_zero(p[2])


def point_neg(ops, p):
    x, y, z = p
    return (x, ops.neg(y), z)


# -- group law (a = 0) -------------------------------------------------------

def _s(*xs):
    return torch.stack(xs, dim=0)


def _same_shape(coords):
    """The coordinates broadcast to one shape (as they are, when they have it)."""
    shape = coords[0].shape
    return coords if all(c.shape == shape for c in coords) else torch.broadcast_tensors(*coords)


def _use_kernels(ops, pts) -> bool:
    """Kernels B2/B3 take every CUDA batch of a base-field FqOps."""
    return (isinstance(ops, FqOps) and not ops.plain
            and any(a.is_cuda for p in pts for a in p))


def point_double(ops, p):
    return point_double_n(ops, p, 1)


def point_double_n(ops, p, r: int):
    """2^r * P: r doublings, one launch of kernel B3 on a card; the plain
    version is r applications of `_point_double_formula`."""
    if r < 1:
        raise ValueError(f"doubling count must be >= 1, got {r}")
    if _use_kernels(ops, (p,)):
        return CK.point_double_n_fused(_same_shape(tuple(p)), ops.spec, r)
    for _ in range(r):
        p = _point_double_formula(ops, p)
    return p


def _point_double_formula(ops, p):
    """dbl-2009-l for y^2 = x^3 + b. Y=0 and Z=0 inputs both yield Z3=0 —
    no case analysis needed."""
    x, y, z = p
    a, b = ops.sq(_s(x, y))
    e = ops.add(ops.dbl(a), a)
    c, g, f = ops.sq(_s(b, ops.add(x, b), e))
    d = ops.dbl(ops.sub(ops.sub(g, a), c))
    x3 = ops.sub(f, ops.dbl(d))
    c8 = ops.dbl(ops.dbl(ops.dbl(c)))
    t1, z3h = ops.mul(_s(e, y), _s(ops.sub(d, x3), z))
    y3 = ops.sub(t1, c8)
    z3 = ops.dbl(z3h)
    return (x3, y3, z3)


def point_add(ops, p, q):
    if _use_kernels(ops, (p, q)):
        coords = _same_shape((*p, *q))
        return CK.point_add_fused(coords[:3], coords[3:], ops.spec)
    return _point_add_formula(ops, p, q)


def _point_add_formula(ops, p, q):
    """Complete add: add-2007-bl with branch-free handling of
    P=inf / Q=inf / P=Q (double) / P=-Q (-> inf, automatic via H=0 => Z3=0)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = ops.sq(_s(z1, z2))
    u1, u2, a, b, zz = ops.mul(
        _s(x1, x2, y1, y2, z1), _s(z2z2, z1z1, z2, z1, z2)
    )
    s1, s2 = ops.mul(_s(a, b), _s(z2z2, z1z1))
    h = ops.sub(u2, u1)
    r = ops.dbl(ops.sub(s2, s1))
    i, rr = ops.sq(_s(ops.dbl(h), r))
    j, v = ops.mul(_s(h, u1), _s(i, i))
    x3 = ops.sub(ops.sub(rr, j), ops.dbl(v))
    t1, t2, z3h = ops.mul(_s(r, s1, h), _s(ops.sub(v, x3), j, zz))
    y3 = ops.sub(t1, ops.dbl(t2))
    z3 = ops.dbl(z3h)
    out = (x3, y3, z3)

    same_x = ops.is_zero(h)
    same_y = ops.is_zero(r)
    out = select_point(ops, same_x & same_y, _point_double_formula(ops, p), out)
    out = select_point(ops, is_infinity(ops, q), p, out)
    out = select_point(ops, is_infinity(ops, p), q, out)
    return out


def point_add_mixed(ops, p, q_affine):
    """madd-2007-bl: add an affine (z = 1) point, a formula over `ops` on
    every device (the Miller loop's add step runs it over Fq2Ops).
    `q_affine` is (x2, y2, inf_mask) with inf_mask bool[...batch]."""
    x1, y1, z1 = p
    x2, y2, q_inf = q_affine
    z1z1 = ops.sq(z1)
    u2, a = ops.mul(_s(x2, y2), _s(z1z1, z1))
    s2 = ops.mul(a, z1z1)
    h = ops.sub(u2, x1)
    r = ops.dbl(ops.sub(s2, y1))
    i, rr = ops.sq(_s(ops.dbl(h), r))
    j, v = ops.mul(_s(h, x1), _s(i, i))
    x3 = ops.sub(ops.sub(rr, j), ops.dbl(v))
    t1, t2, z3h = ops.mul(_s(r, y1, h), _s(ops.sub(v, x3), j, z1))
    y3 = ops.sub(t1, ops.dbl(t2))
    z3 = ops.dbl(z3h)
    out = (x3, y3, z3)

    same_x = ops.is_zero(h)
    same_y = ops.is_zero(r)
    out = select_point(ops, same_x & same_y, point_double(ops, p), out)
    one = ops.one_like(x2)
    out = select_point(ops, is_infinity(ops, p), (x2, y2, one), out)
    out = select_point(ops, q_inf, p, out)
    return out


def pad_to_pow2(ops, p, scalars=None):
    """Pad leading axis with infinity points (and zero scalars) to a power
    of two."""
    n = p[0].shape[0]
    m = 1 << max(0, (n - 1).bit_length())
    if m == n:
        return (p, scalars) if scalars is not None else p
    pad = m - n
    inf = infinity_like(ops, tuple(a[:pad] for a in p))
    p = tuple(torch.cat([a, b], dim=0) for a, b in zip(p, inf))
    if scalars is not None:
        z = torch.zeros((pad,) + tuple(scalars.shape[1:]), dtype=scalars.dtype,
                        device=scalars.device)
        return p, torch.cat([scalars, z], dim=0)
    return p


def _halving_add(ops, p):
    """One tree level: the first half of axis 0 added to the second."""
    half = p[0].shape[0] // 2
    return point_add(ops, tuple(a[:half] for a in p), tuple(a[half:] for a in p))


def tree_sum(ops, p):
    """Sum points over axis 0 by pairwise halving: log2(N) batched adds. N
    must be a power of two (pad with infinity)."""
    n = p[0].shape[0]
    if n & (n - 1):
        raise ValueError(f"tree_sum needs a power-of-two leading axis, got {n}")
    while n > 1:
        p = _halving_add(ops, p)
        n //= 2
    return tuple(a[0] for a in p)


def scan_fold(ops, pts):
    """Fold axis 0 of a Jacobian batch of any length: starting from
    infinity, point_add row 0, then row 1, ... in order, as the JAX
    package's scanned add does, so the Jacobian limbs are its limbs. One
    add per row, sequential: for short axes (the ranks' partials, proof
    assembly), never for point streams."""
    acc = infinity_like(ops, tuple(a[0] for a in pts))
    for i in range(pts[0].shape[0]):
        acc = point_add(ops, acc, tuple(a[i] for a in pts))
    return acc


# -- scalar multiplication ---------------------------------------------------

def _scalar_bit(scalars: torch.Tensor, i: int) -> torch.Tensor:
    """Bit i (0 = LSB) of each batched scalar limb vector, int32[...batch]."""
    return (scalars[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1


def scalar_mul(ops, p, scalars: torch.Tensor, nbits: int):
    """Batched double-and-add, MSB first over a static bit count: per bit a
    doubling, an add of P and a select on the bit, in the JAX package's
    order. On a card over a base-field FqOps each step is one launch of B3
    and one of B2, 2 * nbits dependent launches a call; over Fq2Ops the
    formulas run."""
    acc = infinity_like(ops, p)
    for i in range(nbits - 1, -1, -1):
        acc = point_double(ops, acc)
        added = point_add(ops, acc, p)
        acc = select_point(ops, _scalar_bit(scalars, i) == 1, added, acc)
    return acc


def msm_naive(ops, p, scalars: torch.Tensor, nbits: int):
    """sum_i k_i * P_i by a batched double-and-add per point (scalar_mul),
    then a tree sum over the points padded to a power of two: the
    correctness anchor the Pippenger engine (ops/msm.py) is held against,
    and the local engine of parallel/sharded_msm.sharded_msm."""
    muls = scalar_mul(ops, p, scalars, nbits)
    return tree_sum(ops, pad_to_pow2(ops, muls))


# -- affine normalization ----------------------------------------------------

def to_affine(ops, p):
    """Jacobian -> affine: (x/z^2, y/z^3, inf_mask). Batch inverse via
    Fermat; infinity rows return x=y=0."""
    x, y, z = p
    inf = is_infinity(ops, p)
    zi = ops.inv(z)
    zi2 = ops.sq(zi)
    ax = ops.mul(x, zi2)
    ay = ops.mul(y, ops.mul(zi2, zi))
    ax = ops.select(inf, ops.zero_like(ax), ax)
    ay = ops.select(inf, ops.zero_like(ay), ay)
    return ax, ay, inf


# -- host conversion (base-field curves: secp256k1, BLS12-381 G1) -------------

def pack_points(affs, spec: L.FieldSpec, device="cuda"):
    """Host affine points -> Jacobian tuple of int32 [N, K] Montgomery
    tensors on `device`. A point is a host AffinePoint (secp256k1 at
    K = 16, as the JAX package's pack_points takes it), an (x, y) int pair
    or None (infinity)."""
    from zk_toolkit_tpu_torch import resolve_device

    dev = resolve_device(device)
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                 for a in HC.pack_g1_jac(affs, spec))


def unpack_points(p, spec: L.FieldSpec) -> list:
    """Jacobian tuple -> list of (x, y) int tuples or None (infinity)."""
    ops = FqOps(spec)
    ax, ay, inf = to_affine(ops, p)
    xs = L.unpack(ax, spec)
    ys = L.unpack(ay, spec)
    infs = inf.reshape(-1).cpu().numpy()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def pack_scalars(ks, nbits: int, device="cuda") -> torch.Tensor:
    """Host ints -> plain limb tensor int32 [N, ceil(nbits/16)]."""
    from zk_toolkit_tpu_torch import resolve_device

    s = (nbits + LIMB_BITS - 1) // LIMB_BITS
    arr = ints_to_array(ks, s).astype(np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))
