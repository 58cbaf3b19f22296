"""Batched BLS12-381 tower arithmetic on the device: Fq2 / Fq6 / Fq12 (the
port of zk_toolkit_tpu/ops/tower_ops.py).

Tower structure is extra trailing axes before the limb axis, as in the JAX
package, so every array compares limb for limb with its counterpart:

    Fq1:  int32 [..., K]
    Fq2:  int32 [..., 2, K]        (index 0 = u0, 1 = u1;  u^2 = -1)
    Fq6:  int32 [..., 3, 2, K]     (index i = v_i;         w^3 = xi = 1 + u)
    Fq12: int32 [..., 2, 3, 2, K]  (index i = w_i;         z^2 = w)

Each level speaks the same protocol as FqOps, so ops/curve_ops.py runs the
G2 group law on Fq2Ops and ops/pairing_ops.py the Miller loop on all three;
curve_ops sends Fq2Ops to its formulas, never to kernels B2/B3, as the JAX
package does.

Every method stacks its independent products along a new leading axis and
hands them to the level below in ONE call, so on a card an Fq2 mul is one
launch of kernel B1 over 3 stacked Fq rows per element, an Fq6 mul one
launch over 18 and an Fq12 mul one launch over 54 (Karatsuba at every
level); an inverse at any level reaches one launch of B1's chain. B1 takes
only canonical operands (below p): every sum a Karatsuba product consumes
goes through add_mod, and the constants (Montgomery one, Frobenius tables)
are reduced.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils.bigint import int_to_limbs, ints_to_array


@functools.lru_cache(maxsize=None)
def _c0_const(value: int, struct: tuple, device: str) -> torch.Tensor:
    """int32 `struct` (the struct axes and K): `value`'s limbs in the first
    Fq slot, zeros elsewhere (cached per device)."""
    out = torch.zeros(struct, dtype=torch.int32)
    out.view(-1, struct[-1])[0] = torch.tensor(int_to_limbs(value, struct[-1]),
                                               dtype=torch.int32)
    return out.to(device)


@dataclasses.dataclass(frozen=True)
class Fq2Ops:
    """u0 + u1*u over Fq, u^2 = -1."""

    base: FqOps
    ndim_struct: int = 2

    @property
    def spec(self):
        return self.base.spec

    # -- structure-agnostic (limbwise mod p) --
    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def dbl(self, a):
        return self.base.dbl(a)

    def is_zero(self, a):
        return (a == 0).flatten(-self.ndim_struct).all(-1)

    def equal(self, a, b):
        return (a == b).flatten(-self.ndim_struct).all(-1)

    def select(self, mask, a, b):
        """a where mask (bool[...batch]) else b; the mask spans every
        struct axis."""
        return torch.where(mask.reshape(mask.shape + (1,) * self.ndim_struct), a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def _embed_const(self, c0_int: int, shape_like):
        """The Fq constant c0_int, in Montgomery form, in the c0 slot of
        this level, broadcast to shape_like's shape."""
        spec = self.spec
        v = c0_int % spec.p * spec.r_mod_p % spec.p
        struct = tuple(shape_like.shape[-self.ndim_struct:])
        return _c0_const(v, struct, str(shape_like.device)).expand(shape_like.shape)

    def one_like(self, a):
        """Montgomery 1 (in the c0 slot) broadcast to a's shape."""
        return self._embed_const(1, a)

    def const(self, value: int, shape_like):
        return self._embed_const(value, shape_like)

    # -- level-specific: one stacked base-field product each --
    def mul(self, a, b):
        f = self.base
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        A = torch.stack([a0, a1, f.add(a0, a1)])
        B = torch.stack([b0, b1, f.add(b0, b1)])
        m0, m1, m2 = f.mul(A, B)
        r0 = f.sub(m0, m1)                       # u0*v0 - u1*v1
        r1 = f.sub(f.sub(m2, m0), m1)            # u0*v1 + u1*v0
        return torch.stack([r0, r1], -2)

    def sq(self, a):
        f = self.base
        a0, a1 = a[..., 0, :], a[..., 1, :]
        # (a0 + a1)(a0 - a1), a0 * a1
        A = torch.stack([f.add(a0, a1), a0])
        B = torch.stack([f.sub(a0, a1), a1])
        r0, m = f.mul(A, B)
        return torch.stack([r0, f.dbl(m)], -2)

    def inv(self, a):
        """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); zero maps to zero."""
        f = self.base
        a0, a1 = a[..., 0, :], a[..., 1, :]
        sq = torch.stack([a0, a1])
        s0, s1 = f.mul(sq, sq)
        fac = f.inv(f.add(s0, s1))
        p0, p1 = f.mul(sq, fac.expand((2,) + fac.shape))
        return torch.stack([p0, f.neg(p1)], -2)

    def mul_by_xi(self, a):
        """Multiply by xi = 1 + u: (u0 - u1, u0 + u1)."""
        f = self.base
        a0, a1 = a[..., 0, :], a[..., 1, :]
        return torch.stack([f.sub(a0, a1), f.add(a0, a1)], -2)

    def conjugate(self, a):
        return torch.stack([a[..., 0, :], self.base.neg(a[..., 1, :])], -2)

    def mul_fq1(self, a, s):
        """Multiply by a base-field scalar s: int32 [..., K] (canonical)."""
        p0, p1 = self.base.mul(torch.stack([a[..., 0, :], a[..., 1, :]]),
                               s.expand((2,) + s.shape))
        return torch.stack([p0, p1], -2)


@dataclasses.dataclass(frozen=True)
class Fq6Ops:
    """v0 + v1*w + v2*w^2 over Fq2, w^3 = xi."""

    fq2: Fq2Ops
    ndim_struct: int = 3

    @property
    def spec(self):
        return self.fq2.spec

    @property
    def base(self):
        return self.fq2.base

    add = Fq2Ops.add
    sub = Fq2Ops.sub
    neg = Fq2Ops.neg
    dbl = Fq2Ops.dbl
    is_zero = Fq2Ops.is_zero
    equal = Fq2Ops.equal
    select = Fq2Ops.select
    zero_like = Fq2Ops.zero_like
    _embed_const = Fq2Ops._embed_const
    one_like = Fq2Ops.one_like
    const = Fq2Ops.const

    @staticmethod
    def _parts(a):
        return a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]

    def mul(self, a, b):
        """Karatsuba-3 over Fq2 with xi-folding of the w^3 / w^4 terms; all
        six Fq2 products in one stacked call (one B1 launch)."""
        e = self.fq2
        a0, a1, a2 = self._parts(a)
        b0, b1, b2 = self._parts(b)
        A = torch.stack([a0, a1, a2, e.add(a0, a1), e.add(a0, a2), e.add(a1, a2)])
        B = torch.stack([b0, b1, b2, e.add(b0, b1), e.add(b0, b2), e.add(b1, b2)])
        m0, m1, m2, k01, k02, k12 = e.mul(A, B)
        s01 = e.sub(e.sub(k01, m0), m1)
        s02 = e.sub(e.sub(k02, m0), m2)
        s12 = e.sub(e.sub(k12, m1), m2)
        r0 = e.add(m0, e.mul_by_xi(s12))
        r1 = e.add(s01, e.mul_by_xi(m2))
        r2 = e.add(s02, m1)
        return torch.stack([r0, r1, r2], -3)

    def sq(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """The three t-products and the three norm products each go to one
        stacked Fq2 mul; one Fq2 inverse (one chain launch)."""
        e = self.fq2
        a0, a1, a2 = self._parts(a)
        p0, p1, p2, p3, p4, p5 = e.mul(
            torch.stack([a0, a1, a2, a0, a1, a0]),
            torch.stack([a0, a2, a2, a1, a1, a2]),
        )  # a0^2, a1*a2, a2^2, a0*a1, a1^2, a0*a2
        t0 = e.sub(p0, e.mul_by_xi(p1))
        t1 = e.sub(e.mul_by_xi(p2), p3)
        t2 = e.sub(p4, p5)
        n0, n1, n2 = e.mul(torch.stack([a0, a2, a1]), torch.stack([t0, t1, t2]))
        fac = e.inv(e.add(n0, e.add(e.mul_by_xi(n1), e.mul_by_xi(n2))))
        q0, q1, q2 = e.mul(torch.stack([t0, t1, t2]), fac.expand((3,) + fac.shape))
        return torch.stack([q0, q1, q2], -3)

    def mul_by_w(self, a):
        """Multiply by w: (xi*v2, v0, v1)."""
        a0, a1, a2 = self._parts(a)
        return torch.stack([self.fq2.mul_by_xi(a2), a0, a1], -3)

    def mul_fq2(self, a, s):
        """Multiply componentwise by an Fq2 scalar s: int32 [..., 2, K]."""
        p0, p1, p2 = self.fq2.mul(torch.stack(self._parts(a)), s.expand((3,) + s.shape))
        return torch.stack([p0, p1, p2], -3)


@dataclasses.dataclass(frozen=True)
class Fq12Ops:
    """w0 + w1*z over Fq6, z^2 = w."""

    fq6: Fq6Ops
    ndim_struct: int = 4

    @property
    def spec(self):
        return self.fq6.spec

    @property
    def base(self):
        return self.fq6.base

    add = Fq2Ops.add
    sub = Fq2Ops.sub
    neg = Fq2Ops.neg
    dbl = Fq2Ops.dbl
    is_zero = Fq2Ops.is_zero
    equal = Fq2Ops.equal
    select = Fq2Ops.select
    zero_like = Fq2Ops.zero_like
    _embed_const = Fq2Ops._embed_const
    one_like = Fq2Ops.one_like
    const = Fq2Ops.const

    def mul(self, a, b):
        """Karatsuba over Fq6: three Fq6 products in one stacked call, so
        54 stacked Fq rows per element in one B1 launch."""
        s = self.fq6
        a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
        b0, b1 = b[..., 0, :, :, :], b[..., 1, :, :, :]
        A = torch.stack([a0, a1, s.add(a0, a1)])
        B = torch.stack([b0, b1, s.add(b0, b1)])
        m0, m1, m2 = s.mul(A, B)
        r0 = s.add(m0, s.mul_by_w(m1))           # w0*v0 + w*(w1*v1)
        r1 = s.sub(s.sub(m2, m0), m1)            # w0*v1 + w1*v0
        return torch.stack([r0, r1], -4)

    def sq(self, a):
        return self.mul(a, a)

    def inv(self, a):
        s = self.fq6
        a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
        halves = torch.stack([a0, a1])
        s0, s1 = s.mul(halves, halves)
        fac = s.inv(s.sub(s0, s.mul_by_w(s1)))
        p0, p1 = s.mul(halves, fac.expand((2,) + fac.shape))
        return torch.stack([p0, s.neg(p1)], -4)

    def conjugate(self, a):
        """z -> -z (the q^6 Frobenius)."""
        return torch.stack([a[..., 0, :, :, :], self.fq6.neg(a[..., 1, :, :, :])], -4)


def make_tower(p: int, plain: bool = False):
    """(FqOps, Fq2Ops, Fq6Ops, Fq12Ops) for base modulus p; plain=True runs
    the plain version of every product and inverse (the reference the
    kernels are held against)."""
    f = FqOps(L.field_spec(p), plain=plain)
    e2 = Fq2Ops(f)
    e6 = Fq6Ops(e2)
    return f, e2, e6, Fq12Ops(e6)


# -- host conversions --------------------------------------------------------

def _fq2_coeffs(x) -> list:
    return [x.u0.e, x.u1.e]


def _fq6_coeffs(x) -> list:
    return [c for v in (x.v0, x.v1, x.v2) for c in _fq2_coeffs(v)]


def _fq12_coeffs(x) -> list:
    return [c for six in (x.w0, x.w1) for c in _fq6_coeffs(six)]


def _pack(xs, coeffs, struct, spec, device) -> torch.Tensor:
    """Host tower objects -> int32 [n, *struct, K] Montgomery tensor on
    `device`."""
    from zk_toolkit_tpu_torch import resolve_device

    vals = [c * spec.r_mod_p % spec.p for x in xs for c in coeffs(x)]
    arr = ints_to_array(vals, spec.K).reshape((len(xs),) + struct + (spec.K,))
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


def pack_fq2(xs, spec, device="cuda") -> torch.Tensor:
    """Host Fq2 objects (curves/bls12_381/tower.Fq2) -> int32 [n, 2, K]
    Montgomery tensor on `device`."""
    return _pack(xs, _fq2_coeffs, (2,), spec, device)


def pack_fq6(xs, spec, device="cuda") -> torch.Tensor:
    """Host Fq6 objects -> int32 [n, 3, 2, K]."""
    return _pack(xs, _fq6_coeffs, (3, 2), spec, device)


def pack_fq12(xs, spec, device="cuda") -> torch.Tensor:
    """Host Fq12 objects -> int32 [n, 2, 3, 2, K]."""
    return _pack(xs, _fq12_coeffs, (2, 3, 2), spec, device)


def unpack_fq2(a: torch.Tensor, spec) -> list:
    """int32 [..., 2, K] Montgomery tensor -> host Fq2 objects (flattened
    batch)."""
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq2, fq1

    ints = L.unpack(a.reshape(-1, spec.K), spec)
    return [Fq2(fq1(ints[i + 1]), fq1(ints[i])) for i in range(0, len(ints), 2)]


def unpack_fq6(a: torch.Tensor, spec) -> list:
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq6

    fq2s = unpack_fq2(a.reshape(-1, 2, spec.K), spec)
    return [Fq6(fq2s[i + 2], fq2s[i + 1], fq2s[i]) for i in range(0, len(fq2s), 3)]


def unpack_fq12(a: torch.Tensor, spec) -> list:
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq12

    fq6s = unpack_fq6(a.reshape(-1, 3, 2, spec.K), spec)
    return [Fq12(fq6s[i + 1], fq6s[i]) for i in range(0, len(fq6s), 2)]
