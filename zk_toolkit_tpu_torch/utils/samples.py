"""Sample inputs for holding the kernels against their plain versions:
random canonical field elements, the adversarial corner residues of the JAX
package's parity tests (alone, and spread over random rows for the
static-exponent chain), point pairs of BLS12-381 G1 (K = 24) or secp256k1
(K = 16) in every case class of the complete addition, and pairs laid out
as an up-sweep level. Used by chip_smoke.py, kernel_variants.py and
tests/test_torch_kernels.py."""

from __future__ import annotations

import numpy as np
import torch

from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.utils import host_curve as HC
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array


def random_field(rng, n: int, spec, dev) -> torch.Tensor:
    """n random canonical field elements (limbs), top limb below p's."""
    arr = rng.integers(0, 1 << 16, size=(n, spec.K), dtype=np.int64)
    arr[:, -1] %= int(spec.p_limbs[-1])
    return torch.from_numpy(arr.astype(np.int32)).to(dev)


def corner_pairs(rng, n: int, spec, dev, above_p=()):
    """First n rows of: every pair of corner residues (field boundaries,
    saturated limbs), then random rows. `above_p`: unreduced corner values
    in [p, 2^(16K)), put first (the Ed25519 decode gives B1 such values, read
    from the bytes of an encoding)."""
    p, k = spec.p, spec.K
    sat = int("ffff" * k, 16)
    corners = [*above_p, 0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2,
               sat % p, (sat >> 16) % p, (1 << (16 * (k - 1))) % p]
    a = ints_to_array([x for x in corners for _ in corners], k).astype(np.int32)
    b = ints_to_array([y for _ in corners for y in corners], k).astype(np.int32)
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    if n > len(corners) ** 2:
        m = n - len(corners) ** 2
        ta = torch.cat([ta, random_field(rng, m, spec, dev)])
        tb = torch.cat([tb, random_field(rng, m, spec, dev)])
    return ta[:n], tb[:n]


def chain_inputs(rng, n: int, spec, dev) -> torch.Tensor:
    """n canonical elements for a static-exponent chain: random rows, with
    every fourth row from the second on on a corner residue (0 first, then
    1, 2, p - 1, ...)."""
    a = random_field(rng, n, spec, dev)
    corners = corner_pairs(rng, 10, spec, dev)[1]      # the 10 corner residues
    idx = torch.arange(1, n, 4, device=dev)
    a[idx] = corners[((idx - 1) // 4) % 10]
    return a


# Each curve's base field and generator (affine ints).
CURVES = {"bls12_381_g1": (params.Q, (params.G1_X, params.G1_Y)),
          "secp256k1": (secp256k1.P, (secp256k1.GX, secp256k1.GY))}


def point_pairs(rng, n: int, dev, generic_only: bool = False, curve: str = "bls12_381_g1"):
    """P, Q Jacobian batches over 64 host points k*G of `curve` (CURVES),
    each row a random representative (x l^2, y l^3, l) made with the plain
    multiply. Unless generic_only, rows cycle through the case classes by
    row % 8: 0 P == Q (another representative), 1 P == -Q, 2 P = inf,
    3 Q = inf, 4 both inf, else generic. Every limb is canonical."""
    modulus, gen = CURVES[curve]
    spec = L.field_spec(modulus)
    mul = lambda a, b: L.mont_mul_plain(a, b, spec)
    ks = [int(x) for x in np.random.default_rng(99).integers(1, 1 << 62, 64)]
    bx, by, _ = C.pack_points(HC.multi_mul(HC.FpHost(modulus), gen, ks), spec, device=dev)
    ip = torch.from_numpy(rng.integers(0, 64, n)).to(dev)
    iq = (ip + torch.from_numpy(rng.integers(1, 64, n)).to(dev)) % 64

    def rep(idx):
        lam = random_field(rng, n, spec, dev)
        l2 = mul(lam, lam)
        return (mul(bx[idx], l2), mul(by[idx], mul(l2, lam)), lam)

    p = rep(ip)
    if generic_only:
        return p, rep(iq)
    case = torch.arange(n, device=dev) % 8
    q = rep(torch.where(case <= 1, ip, iq))
    q = (q[0], torch.where((case == 1)[:, None], L.neg_mod(q[1], spec), q[1]), q[2])
    zero = torch.zeros_like(p[2])
    p = (p[0], p[1], torch.where(((case == 2) | (case == 4))[:, None], zero, p[2]))
    q = (q[0], q[1], torch.where(((case == 3) | (case == 4))[:, None], zero, q[2]))
    return p, q


def upsweep_views(p, q, tiles: int = 1):
    """P and Q (same-size batches) as an up-sweep level lays pairs out: the
    even and odd rows of one contiguous [2 * tiles * n, 3K] tensor whose
    rows interleave P and Q, repeated `tiles` times. Returns the (x, y, z)
    views of the even rows and of the odd rows."""
    n, k = p[0].shape
    buf = torch.empty((tiles, n, 2, 3 * k), dtype=torch.int32, device=p[0].device)
    buf[:, :, 0] = torch.cat(p, -1)
    buf[:, :, 1] = torch.cat(q, -1)
    flat = buf.view(-1, 3 * k)
    return tuple(tuple(flat[s::2, c * k:(c + 1) * k] for c in range(3)) for s in (0, 1))
