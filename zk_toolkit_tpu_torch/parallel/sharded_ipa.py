"""Sharded Bulletproofs inner-product argument over a Mesh (the port of
zk_toolkit_tpu/parallel/sharded_ipa.py), on secp256k1 at K = 16.

Layout: the length-n vectors g, h, a, b are split cyclically: global
element i lives on rank i mod D at local row i div D. Every fold pairs
element i with i + n/2, and i = i + n/2 (mod D) whenever D | n/2, so under
this layout every halving fold is local until each rank holds one
element. Every rank is handed the whole vectors (the same on every rank),
keeps its elements (`shard_ipa_inputs`) and returns the same verdict.

A round, on every rank:
  1. the cross inner-product partials cl, cr of its elements, gathered
     (one all_gather of 2 field elements a rank) and summed in rank order;
  2. ONE scalar_mul over [L/R terms pre-scaled by x^2 / x^-2 (4 half) |
     basis folds (4 half) | u*cl*x^2, u*cr*x^-2 (2)], as the JAX round;
  3. the rank's L and R partials by halving adds, gathered (one all_gather
     of its two points, the coordinates stacked) and folded in rank order
     (scan_fold); P' = P + (L x^2 + u cl x^2) + (R x^-2 + u cr x^-2);
  4. the local basis and scalar folds.
Two all_gathers a round, whatever n. When each rank holds one element,
one all_gather of its g, h, a, b brings the D elements to every rank in
global order, and the last log2(D) rounds and the final check run there
through protocols/bulletproofs_device._ipa_round and _ipa_final. Accept
and reject equal DeviceBulletproofs.inner_product_argument's on the same
challenges.
"""

from __future__ import annotations

import torch

from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.parallel.mesh import Mesh, replicate
from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD

_OPS = BD._P_OPS
_SPEC = BD._N_SPEC
N_ORDER = BD.N_ORDER


def shard_ipa_inputs(mesh: Mesh, gg, hh, a, b):
    """This rank's elements {i : i mod D == rank} of [n, ...] arrays (point
    tuples or tensors), in order, on the mesh's device."""
    d = mesh.world

    def cyc(x):
        if x.shape[0] % d:
            raise ValueError("vector length must be a multiple of the mesh size")
        return x[mesh.rank::d].to(mesh.device)

    def put(x):
        return tuple(cyc(t) for t in x) if isinstance(x, tuple) else cyc(x)

    return put(gg), put(hh), put(a), put(b)


def _gather_points(mesh: Mesh, pts):
    """Every rank's points [m, K] (a Jacobian tuple) -> [D, m, K] each
    coordinate: one all_gather of the stacked coordinates."""
    g = mesh.all_gather(torch.stack(pts))                    # [D, 3, m, K]
    return tuple(g[:, i] for i in range(3))


def _round(mesh: Mesh, g, h, a0, b0, Pt, u, x_m, xi_m):
    """One sharded round on this rank's elements: g/h point tuples
    [nloc, K], a0/b0 Montgomery Fr(n) [nloc, K], Pt/u replicated [1, K]
    tuples, x_m/xi_m the challenge and its inverse (Montgomery [K])."""
    half = a0.shape[0] // 2
    mul = lambda x, y: L.mont_mul(x, y, _SPEC)
    xsq, xsqi = mul(x_m, x_m), mul(xi_m, xi_m)

    cl_p = BD._tree_sum_fr(mul(a0[:half], b0[half:]))
    cr_p = BD._tree_sum_fr(mul(a0[half:], b0[:half]))
    sc_all = mesh.all_gather(torch.stack([cl_p, cr_p]))     # [D, 2, K]
    cl, cr = sc_all[0, 0], sc_all[0, 1]
    for k in range(1, mesh.world):
        cl = L.add_mod(cl, sc_all[k, 0], _SPEC)
        cr = L.add_mod(cr, sc_all[k, 1], _SPEC)

    def bcast(s):
        return s.expand((half,) + tuple(s.shape))

    lr_pts = tuple(torch.cat([gt[half:], ht[:half], gt[:half], ht[half:]])
                   for gt, ht in zip(g, h))
    lr_scal = torch.cat([mul(a0[:half], bcast(xsq)), mul(b0[half:], bcast(xsq)),
                         mul(a0[half:], bcast(xsqi)), mul(b0[:half], bcast(xsqi))])
    fold_pts = tuple(torch.cat([gt[:half], gt[half:], ht[:half], ht[half:]])
                     for gt, ht in zip(g, h))
    fold_scal = torch.cat([bcast(xi_m), bcast(x_m), bcast(x_m), bcast(xi_m)])
    u_scal = torch.stack([mul(cl, xsq), mul(cr, xsqi)])
    pts = tuple(torch.cat([lp, fp, ut, ut]) for lp, fp, ut in zip(lr_pts, fold_pts, u))
    scal = L.from_mont(torch.cat([lr_scal, fold_scal, u_scal]), _SPEC)
    muls = C.scalar_mul(_OPS, pts, scal, 256)

    # the L and R partials: two contiguous segments of 2*half, halved in turn
    lr = tuple(t[:4 * half].reshape((2, 2 * half) + tuple(t.shape[1:])) for t in muls)
    while lr[0].shape[1] > 1:
        m = lr[0].shape[1] // 2
        lr = C.point_add(_OPS, tuple(t[:, :m] for t in lr), tuple(t[:, m:] for t in lr))
    lr_sum = C.scan_fold(_OPS, _gather_points(mesh, tuple(t[:, 0] for t in lr)))   # [2, K]

    ut = tuple(t[8 * half:] for t in muls)
    both = C.point_add(_OPS, lr_sum, ut)
    P2 = C.point_add(_OPS, C.point_add(_OPS, Pt, tuple(t[:1] for t in both)),
                     tuple(t[1:] for t in both))

    fm = tuple(t[4 * half:8 * half] for t in muls)
    gg2 = C.point_add(_OPS, tuple(t[:half] for t in fm), tuple(t[half:2 * half] for t in fm))
    hh2 = C.point_add(_OPS, tuple(t[2 * half:3 * half] for t in fm),
                      tuple(t[3 * half:] for t in fm))
    a2 = L.add_mod(mul(a0[:half], bcast(x_m)), mul(a0[half:], bcast(xi_m)), _SPEC)
    b2 = L.add_mod(mul(b0[:half], bcast(xi_m)), mul(b0[half:], bcast(x_m)), _SPEC)
    return gg2, hh2, a2, b2, P2


def sharded_ipa(mesh: Mesh, n: int, gg, hh, u, Pt, a, b, challenges: list[int]) -> bool:
    """P == g^a h^b u^<a,b>, the argument sharded over the mesh. gg/hh:
    point tuples [n, K]; u/Pt: [1, K]; a/b: Montgomery Fr(n) [n, K]; the
    log2(n) challenges consumed in transcript order. n and the world size
    must be powers of two with n >= D. The same verdict on every rank."""
    d = mesh.world
    if not (n >= d and n & (n - 1) == 0 and d & (d - 1) == 0):
        raise ValueError("sharded IPA needs power-of-two n and mesh size with n >= D")
    dev = mesh.device
    chal = list(challenges)
    g, h, a, b = shard_ipa_inputs(mesh, gg, hh, a, b)
    u, Pt = replicate(mesh, u), replicate(mesh, Pt)

    def challenge():
        x = chal.pop(0) % N_ORDER
        return x, pow(x, -1, N_ORDER)

    while n > d:
        x, xi = challenge()
        x_m, xi_m = BD._fr([x, xi], dev)
        g, h, a, b, Pt = _round(mesh, g, h, a, b, Pt, u, x_m, xi_m)
        n //= 2

    # one element a rank: rank k's element is global element k
    tail = mesh.all_gather(torch.stack(list(g) + list(h) + [a, b]))   # [D, 8, 1, K]
    tail = tail[:, :, 0].transpose(0, 1)                              # [8, D, K]
    g, h, a, b = tuple(tail[:3]), tuple(tail[3:6]), tail[6], tail[7]
    while n > 1:
        x, xi = challenge()
        g, h, a, b, Pt = BD._ipa_round(g, h, a, b, Pt, u, x, xi)
        n //= 2
    return BD._ipa_final(g, h, a, b, Pt, u)
