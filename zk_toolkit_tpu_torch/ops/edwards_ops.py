"""Batched twisted-Edwards group law on a device, curve25519 / Ed25519 (the
port of zk_toolkit_tpu/ops/edwards_ops.py).

Points are extended homogeneous coordinates (X, Y, Z, T): x = X/Z, y = Y/Z,
T = XY/Z on -x^2 + y^2 = 1 + d x^2 y^2 (a = -1), each an int32 Montgomery
limb tensor [B, 16] mod q = 2^255 - 19. The HWCD'08 unified addition is one
formula for add, double and identity, so there is no case analysis and the
identity is the plain point (0, 1, 1, 0). Doubling is `point_add(P, P)`, as
in the JAX package, so the limbs come from the same sequence of operations.

The products run on kernel B1 (csrc/mont_mul.cu) at K = 16 through FqOps:
every `ops.mul` is one launch, with the JAX package's stacking of four
independent products into one launch kept (3 launches a unified add); the
sums and differences are stacked the same way (4 plain add/sub calls). The
decode's fixed-exponent square root (q+3)/8 and every Fermat inverse are one
launch of B1's chain entry each. Kernels B2/B3 are the a = 0 Weierstrass
laws and take no Edwards operation, as in the JAX package. On CPU tensors
the plain versions run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.curves import curve25519 as ed
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils.bigint import LIMB_BITS, ints_to_array


@functools.lru_cache(maxsize=1)
def fq_ops() -> FqOps:
    return FqOps(L.field_spec(ed.Q))


@functools.lru_cache(maxsize=1)
def _consts():
    return {"d2": 2 * ed.d().e % ed.Q}


def _mont(v: int) -> int:
    return v * fq_ops().spec.r_mod_p % ed.Q


def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    """The Montgomery form of v broadcast to like's shape, on its device."""
    return L.const_limbs(_mont(v), fq_ops().spec.K, str(like.device)).expand(like.shape)


def identity_like(x: torch.Tensor):
    """(0, 1, 1, 0) broadcast to the batch shape of limb tensor x."""
    one = fq_ops().one_like(x)
    zero = torch.zeros_like(x)
    return (zero, one, one, zero)


def point_add(p, q):
    """Unified extended-coordinate addition (a = -1):
    A=(Y1-X1)(Y2-X2), B=(Y1+X1)(Y2+X2), C=2d T1 T2, D=2 Z1 Z2,
    E=B-A, F=D-C, G=D+C, H=B+A; X3=EF, Y3=GH, T3=EH, Z3=FG.
    Independent sums and differences go stacked into one add_mod or sub_mod
    call each (4 calls an add, where the JAX package makes 9 that XLA
    fuses): on a card every plain add/sub call costs host syncs, and each
    row's values are the same."""
    ops = fq_ops()
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    s1, s2 = ops.sub(torch.stack([y1, y2]), torch.stack([x1, x2]))
    a1, a2, zz = ops.add(torch.stack([y1, y2, z2]), torch.stack([x1, x2, z2]))
    c1 = ops.mul(t1, _const(_consts()["d2"], t1))
    a, b, c, dd = ops.mul(torch.stack([s1, a1, c1, z1]), torch.stack([s2, a2, t2, zz]))
    e, f = ops.sub(torch.stack([b, dd]), torch.stack([a, c]))
    g, h = ops.add(torch.stack([dd, b]), torch.stack([c, a]))
    x3, y3, t3, z3 = ops.mul(torch.stack([e, g, e, f]), torch.stack([f, h, h, g]))
    return (x3, y3, z3, t3)


def select(mask, p, q):
    ops = fq_ops()
    return tuple(ops.select(mask, a, b) for a, b in zip(p, q))


def scalar_mul(p, scalars: torch.Tensor, nbits: int):
    """Batched double-and-add, MSB first over a static bit count, with the
    unified law: per bit a doubling point_add(acc, acc), an add of P and a
    select on the bit. scalars: plain limbs int32 [B, ceil(nbits/16)],
    unreduced (the verify's 8 s reaches 2^259)."""
    acc = identity_like(p[0])
    for i in range(nbits - 1, -1, -1):
        acc = point_add(acc, acc)
        bit = (scalars[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1
        acc = select(bit == 1, point_add(acc, p), acc)
    return acc


def to_affine(p):
    """(x, y) affine via one batched Fermat inversion of Z."""
    ops = fq_ops()
    x, y, z, _ = p
    zi = ops.inv(z)
    ax, ay = ops.mul(torch.stack([x, y]), zi.expand((2,) + zi.shape))
    return ax, ay


# -- batched point codecs (device) -------------------------------------------

@functools.lru_cache(maxsize=1)
def _codec_consts():
    q = ed.Q
    # (q + 3) / 8 = 2^252 - 2; sqrt(-1) = 2^((q-1)/4)
    return {"d": ed.d().e, "sqrt_m1": pow(2, (q - 1) // 4, q),
            "exp_bits": tuple(int(b) for b in bin((q + 3) // 8)[2:])}


def _decode_core(enc: torch.Tensor):
    """enc: int32 [B, 32] little-endian encoding bytes on the device."""
    ops = fq_ops()
    spec = ops.spec
    cc = _codec_consts()
    sign = (enc[:, 31] >> 7) & 1
    e = enc.clone()
    e[:, 31] &= 0x7F
    y_plain = e[:, 0::2] | (e[:, 1::2] << 8)              # [B, 16] limbs
    _, borrow = L._sub_limbs(y_plain, L.const_limbs(ed.Q, spec.K, str(enc.device)))
    y_in_range = borrow == 1                                # y < q

    # y may lie in [q, 2^255) on a row that is rejected: B1's K = 16 build
    # is exact on any 16-bit limbs, so such rows equal the JAX package's too.
    y = L.to_mont(y_plain, spec)
    one = ops.one_like(y)
    y2 = ops.sq(y)
    u = ops.sub(y2, one)
    v = ops.add(ops.mul(_const(cc["d"], y2), y2), one)
    # candidate root x = (u/v)^((q+3)/8); accept iff v x^2 == +-u, with the
    # sqrt(-1) fixup on the negative branch (reference affine_point.rs:83-104
    # recover_x semantics; the v-multiplied check also rejects v == 0 safely
    # since inv(0) == 0 here)
    t = ops.mul(u, ops.inv(v))
    x = L.mont_pow_static(t, cc["exp_bits"], spec)
    vx2 = ops.mul(v, ops.sq(x))
    root_pos = ops.equal(vx2, u)
    root_neg = ops.equal(vx2, ops.neg(u))
    x = ops.select(root_neg, ops.mul(x, _const(cc["sqrt_m1"], x)), x)
    ok = y_in_range & (root_pos | root_neg)
    # parity select (negation flips the lsb since q is odd)
    parity = L.from_mont(x, spec)[:, 0] & 1
    x = ops.select(parity != sign, ops.neg(x), x)
    # RFC 8032: x == 0 with sign bit 1 is invalid
    ok = ok & ~(ops.is_zero(x) & (sign == 1))
    return (x, y, one, ops.mul(x, y)), ok


def decode_points(enc: np.ndarray, device="cuda"):
    """Batched RFC 8032 point decoding on `device`: the y range check,
    x-recovery through the fixed-exponent square root (q+3)/8 (one chain
    launch of B1 for the whole batch), the sqrt(-1) fixup and the parity
    select (reference ed25519_sha512.rs:85-98 + affine_point.rs:83-104).
    enc: uint8 [B, 32]. Returns (extended point tuple, bool ok [B] on the
    device); failed rows decode to an arbitrary valid-shape point and must be
    masked."""
    enc = np.ascontiguousarray(np.asarray(enc, dtype=np.uint8))
    return _decode_core(torch.from_numpy(enc.astype(np.int32)).to(resolve_device(device)))


def encode_points(p_ext) -> np.ndarray:
    """Batched point encoding (y little-endian bytes, x-parity in bit 255;
    reference ed25519_sha512.rs:63-83): the affine conversion, parity select
    and byte assembly run on the points' device; the host fetches the uint8
    [B, 32] buffer."""
    spec = fq_ops().spec
    ax, ay = to_affine(p_ext)
    parity = L.from_mont(ax, spec)[:, 0] & 1
    y_plain = L.from_mont(ay, spec)
    y_plain[:, spec.K - 1] |= parity << 15                   # y < 2^255: bit 255 free
    out = torch.stack([y_plain & 0xFF, y_plain >> 8], dim=-1).reshape(y_plain.shape[0], 32)
    return out.to(torch.uint8).cpu().numpy()


# -- host conversions -----------------------------------------------------------

def pack_points(pts, device="cuda") -> tuple:
    """Host affine Edwards points ((x, y) ints or EdwardsPoint with .x/.y
    elements; the identity as (0, 1)) -> extended coordinates, int32 [N, 16]
    Montgomery tensors on `device`."""
    xs, ys = [], []
    for pt in pts:
        if hasattr(pt, "is_zero") and pt.is_zero():
            x, y = 0, 1
        elif hasattr(pt, "x"):
            x, y = pt.x.e, pt.y.e
        else:
            x, y = pt
        xs.append(x)
        ys.append(y)
    k, dev = fq_ops().spec.K, resolve_device(device)
    coords = (xs, ys, [1] * len(xs), [x * y % ed.Q for x, y in zip(xs, ys)])
    return tuple(torch.from_numpy(ints_to_array([_mont(v) for v in c], k).astype(np.int32)).to(dev)
                 for c in coords)


def unpack_points(p) -> list:
    """Extended coordinates -> list of (x, y) host ints."""
    spec = fq_ops().spec
    ax, ay = to_affine(p)
    return list(zip(L.unpack(ax, spec), L.unpack(ay, spec)))
