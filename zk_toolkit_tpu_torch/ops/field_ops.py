"""Batched field-operation namespace for the group law (the port of
zk_toolkit_tpu/ops/field_ops.py, base field only).

ops/curve_ops.py is written once against this small protocol —
`mul/sq/add/sub/neg/dbl/inv/is_zero/equal/select/zero_like/one_like/const`
over int32 limb tensors [..., K] in Montgomery form.
"""

from __future__ import annotations

import dataclasses

import torch

from zk_toolkit_tpu_torch.ops import limbs as L


@dataclasses.dataclass(frozen=True)
class FqOps:
    """Base-prime-field ops bound to a FieldSpec.

    plain=False (the default) multiplies and inverts with kernel B1 on CUDA
    tensors and lets ops/curve_ops.py run kernels B2/B3; plain=True runs the plain
    PyTorch version of every operation on any device — the reference the
    kernels are held against on the card."""

    spec: L.FieldSpec
    plain: bool = False

    def mul(self, a, b):
        mul = L.mont_mul_plain if self.plain else L.mont_mul
        return mul(a, b, self.spec)

    def sq(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return L.add_mod(a, b, self.spec)

    def sub(self, a, b):
        return L.sub_mod(a, b, self.spec)

    def neg(self, a):
        return L.neg_mod(a, self.spec)

    def dbl(self, a):
        return L.add_mod(a, a, self.spec)

    def inv(self, a):
        inv = L.mont_inv_plain if self.plain else L.mont_inv
        return inv(a, self.spec)

    def is_zero(self, a):
        """bool[...batch] — true where the element is 0."""
        return (a == 0).all(-1)

    def equal(self, a, b):
        return (a == b).all(-1)

    def select(self, mask, a, b):
        """Elementwise: a where mask (bool[...batch]) else b."""
        return torch.where(mask[..., None], a, b)

    def zero_like(self, a):
        return torch.zeros_like(a)

    def one_like(self, a):
        """Montgomery 1 broadcast to a's shape."""
        return L.const_limbs(self.spec.r_mod_p, self.spec.K, str(a.device)).expand(a.shape)

    def const(self, value: int, shape_like):
        """Embed a host integer constant (Montgomery form), broadcast to the
        batch shape of `shape_like`."""
        v = (value % self.spec.p) * self.spec.r_mod_p % self.spec.p
        return L.const_limbs(v, self.spec.K, str(shape_like.device)).expand(shape_like.shape)
