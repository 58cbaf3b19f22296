"""Batched BLS12-381 Fq2 arithmetic on the device (the port of
zk_toolkit_tpu/ops/tower_ops.py, its Fq2 level; Fq6/Fq12 come with the
pairing).

An Fq2 element u0 + u1*u (u^2 = -1) is an int32 Montgomery limb tensor
[..., 2, K] (index 0 = u0, 1 = u1). Fq2Ops speaks the same protocol as
FqOps, so ops/curve_ops.py runs the G2 group law on it; curve_ops sends
Fq2Ops to its formulas, never to kernels B2/B3, as the JAX package does.

Every method stacks its independent Fq products along a new leading axis
and hands them to the base field in ONE call, so on a card an Fq2 mul or
sq is one launch of kernel B1, an inv two and one launch of B1's chain.
Karatsuba: 3 Fq products per mul. The operands the base field multiplies
are canonical: the sums a0 + a1 go through add_mod.
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
def _u0_const(value: int, k: int, device: str) -> torch.Tensor:
    """int32 [2, K]: `value`'s limbs in the u0 row, zeros in u1 (cached)."""
    out = torch.zeros((2, k), dtype=torch.int32)
    out[0] = torch.tensor(int_to_limbs(value, k), dtype=torch.int32)
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
        """a where mask (bool[...batch]) else b; the mask spans both struct
        axes."""
        return torch.where(mask[..., None, None], a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        """Montgomery 1 (in the u0 slot) broadcast to a's shape."""
        return _u0_const(self.spec.r_mod_p, self.spec.K, str(a.device)).expand(a.shape)

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


# -- host conversions --------------------------------------------------------

def pack_fq2(xs, spec, device="cuda") -> torch.Tensor:
    """Host Fq2 objects (curves/bls12_381/tower.Fq2) -> int32 [n, 2, K]
    Montgomery tensor on `device`."""
    from zk_toolkit_tpu_torch import resolve_device

    vals = [c.e * spec.r_mod_p % spec.p for x in xs for c in (x.u0, x.u1)]
    arr = ints_to_array(vals, spec.K).reshape(len(xs), 2, spec.K).astype(np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))


def unpack_fq2(a: torch.Tensor, spec) -> list:
    """int32 [..., 2, K] Montgomery tensor -> host Fq2 objects (flattened
    batch)."""
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq2, fq1

    ints = L.unpack(a.reshape(-1, spec.K), spec)
    return [Fq2(fq1(ints[i + 1]), fq1(ints[i])) for i in range(0, len(ints), 2)]
