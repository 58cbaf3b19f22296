"""Sharded multi-scalar multiplication over a Mesh (the port of
zk_toolkit_tpu/parallel/sharded_msm.py).

Every rank is handed the whole stream (points and scalars, the same on
every rank), pads it with infinity points and zero scalars to a multiple
of the world size D, keeps its contiguous block of n/D rows and runs a
local MSM on it with no collective. Then one all_gather per coordinate
brings the D partial points to every rank, and scan_fold adds them in rank
order, so the fold takes any D, not only powers of two. Every rank
returns the same Jacobian point; its limbs may differ from a
single-device MSM's (the partials are added in another order), the affine
point does not.

The JAX package has three variants: `sharded_msm` and
`sharded_msm_pippenger` place the stream on the mesh and let XLA
partition the single-device engines (auto-SPMD), `sharded_msm_explicit`
runs a collective-free local Pippenger per device in shard_map. torch has
no auto-SPMD, so all three are the explicit two-phase dataflow here; they
differ in the local engine: the batched double-and-add (curve_ops.
msm_naive), msm_pippenger, and msm_pippenger_many over the rank's one
stream (the JAX explicit path's local engine).
"""

from __future__ import annotations

import torch

from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import msm as M
from zk_toolkit_tpu_torch.parallel.mesh import Mesh, shard_leading


def pad_rows(ops, pts, scalars, length: int):
    """A (points, scalars) stream padded to `length` rows with infinity
    points and zero scalars (they add nothing to the sum); scalars may be
    None."""
    pad = length - pts[0].shape[0]
    if not pad:
        return pts, scalars
    inf = C.infinity_like(ops, tuple(a[:1].expand((pad,) + a.shape[1:]) for a in pts))
    pts = tuple(torch.cat([a, i], dim=0) for a, i in zip(pts, inf))
    if scalars is None:
        return pts, None
    z = scalars.new_zeros((pad,) + tuple(scalars.shape[1:]))
    return pts, torch.cat([scalars, z], dim=0)


def pad_to_multiple(ops, pts, scalars, d: int):
    """The stream padded to the next multiple of d rows (pad_rows)."""
    return pad_rows(ops, pts, scalars, -(-pts[0].shape[0] // d) * d)


def _local_stream(ops, pts, scalars, mesh: Mesh):
    pts, scalars = pad_to_multiple(ops, pts, scalars, mesh.world)
    return shard_leading(mesh, pts), shard_leading(mesh, scalars)


def gather_fold(ops, part, mesh: Mesh):
    """Every rank's partial point (a Jacobian tuple, no batch axis, or with
    batch axes carried through): one all_gather per coordinate, then
    scan_fold over the ranks in order. The only collectives of a sharded
    MSM."""
    return C.scan_fold(ops, tuple(mesh.all_gather(a) for a in part))


def sharded_msm(ops, pts, scalars, nbits: int, mesh: Mesh):
    """sum_i k_i P_i with the stream sharded over the mesh, each rank's
    block through curve_ops.msm_naive. Returns one Jacobian point tuple,
    the same on every rank."""
    lp, ls = _local_stream(ops, pts, scalars, mesh)
    return gather_fold(ops, C.msm_naive(ops, lp, ls, nbits), mesh)


def sharded_msm_pippenger(ops, pts, scalars, nbits: int, mesh: Mesh, c: int | None = None):
    """As sharded_msm, each rank's block through msm_pippenger (window c,
    or the default for the block's length)."""
    lp, ls = _local_stream(ops, pts, scalars, mesh)
    return gather_fold(ops, M.msm_pippenger(ops, lp, ls, nbits, c=c), mesh)


def local_phase(ops, pts, scalars, nbits: int, mesh: Mesh, c: int | None = None):
    """Phase 1 of sharded_msm_explicit: msm_pippenger_many over this rank's
    block as one stream (window c, or the default for n/D points). No
    collective. Returns the rank's partial point (no batch axis)."""
    lp, ls = _local_stream(ops, pts, scalars, mesh)
    c = c or M.default_window_bits(ls.shape[0])
    part = M.msm_pippenger_many(ops, tuple(a[None] for a in lp), ls[None], nbits, c)
    return tuple(a[0] for a in part)


def sharded_msm_explicit(ops, pts, scalars, nbits: int, mesh: Mesh, c: int | None = None):
    """The two-phase sharded Pippenger: the collective-free local_phase,
    then gather_fold of the D partials. Returns one Jacobian point tuple
    (no batch axis), the same on every rank."""
    return gather_fold(ops, local_phase(ops, pts, scalars, nbits, mesh, c), mesh)
