"""Wrappers of the group-law kernels B2 (complete Jacobian add,
csrc/point_add.cu) and B3 (r-fold Jacobian doubling, csrc/point_double.cu)
— the port of zk_toolkit_tpu/ops/curve_kernels.py, whose Pallas kernels
they replace.

ops/curve_ops.point_add / point_double / point_double_n call these for every
CUDA batch of a base-field FqOps, at every batch size; the plain versions
(curve_ops._point_add_formula / _point_double_formula) serve CPU tensors and
the parity checks. B2 and B3 each count their launches in `.launches` of
point_add_fused and point_double_fused (point_double_n_fused launches B3
and counts there).

A kernel reads each operand as an int32 [rows, K] view with any row stride
that is a multiple of 4 elements, so the even/odd rows of an up-sweep level,
or the x/y/z columns of a fused [rows, 3K] stream, go in without a copy. The
three outputs are the column views of one fresh [rows, 3K] tensor: the next
level's gathers and halvings read them in place.
"""

from __future__ import annotations

import torch

from zk_toolkit_tpu_torch import _build


def as_rows(t: torch.Tensor, k: int) -> torch.Tensor:
    """int32 [..., k] tensor as the [rows, k] view the kernels take, copied
    only where its layout does not allow one (limb stride 1, row stride a
    multiple of 4, 16-byte alignment)."""
    if t.dtype != torch.int32:
        raise ValueError(f"limb tensors are int32, got {t.dtype}")
    r = t if t.dim() == 2 else t.reshape(-1, k)
    s0, s1 = r.stride()
    if s1 != 1 or s0 % 4 or r.data_ptr() % 16:
        r = r.clone(memory_format=torch.contiguous_format)
    return r


def _run(name: str, spec, coords, reps: int = 1):
    """Flatten the leading axes of 3 or 6 same-shape coordinates, launch,
    return three [..., K] outputs (column views of one [rows, 3K] tensor)."""
    shape = coords[0].shape
    k = spec.K
    rows = []
    for c in coords:
        if c.shape != shape:
            raise ValueError(f"{name}: coordinate shapes differ: "
                             f"{[tuple(c.shape) for c in coords]}")
        rows.append(as_rows(c, k))
    n = rows[0].shape[0]
    outs = torch.empty((n, 3, k), dtype=torch.int32, device=rows[0].device).unbind(1)
    _build.launch(name, spec, (*rows, *outs), n, reps)
    if len(shape) == 2:
        return outs
    return tuple(o.reshape(shape) for o in outs)


def point_add_fused(p, q, spec):
    """Complete Jacobian add on kernel B2. p, q: same-shape (x, y, z) tuples
    of int32 [..., K] Montgomery limbs on a CUDA device."""
    out = _run("point_add", spec, tuple(p) + tuple(q))
    point_add_fused.launches += 1
    return out


def point_double_n_fused(p, spec, r: int):
    """2^r * P on kernel B3 in one launch: r Jacobian doublings in
    registers (the launcher refuses r < 1)."""
    out = _run("point_double", spec, tuple(p), r)
    point_double_fused.launches += 1
    return out


def point_double_fused(p, spec):
    """Jacobian doubling on kernel B3 (r = 1)."""
    return point_double_n_fused(p, spec, 1)


point_add_fused.launches = 0
point_double_fused.launches = 0
