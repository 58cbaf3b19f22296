"""Batched signature operations on a device (the port of
zk_toolkit_tpu/ops/signature_ops.py): its ECDSA half over secp256k1.

Each routine is the reference algorithm restructured so that every group
and field operation runs as one batched operation over all signatures: the
scalar multiplications on kernels B2/B3, the products and inverses on B1 at
K = 16 limbs. Host code only packs bytes. The nonce k is an argument, so
runs replay exactly. Every input is batched on its leading axis and the
results stay on its device.

Not ported yet: the Ed25519 half of the JAX module (its :149-233) needs
ops/edwards_ops.py and ops/sha_ops.py, and its BLS half (:236-257) needs
g2.hash_to_g2point_swu; both come with the next slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps

# -- secp256k1 ECDSA ---------------------------------------------------------

_P_OPS = FqOps(L.field_spec(secp256k1.P))
_N_SPEC = L.field_spec(secp256k1.N)


@functools.lru_cache(maxsize=None)
def _secp_gen(device: str):
    return C.pack_points([secp256k1.g()], _P_OPS.spec, device=device)


def _tile(pt, n: int):
    return tuple(a.expand((n,) + a.shape[1:]) for a in pt)


def _n_limbs(like: torch.Tensor) -> torch.Tensor:
    return L.const_limbs(secp256k1.N, _N_SPEC.K, str(like.device)).expand(like.shape)


def _x_mod_n(pt_jac):
    """Affine x coordinate reduced mod the group order n (plain limbs), and
    the infinity mask. x < p < 2n, so one conditional subtract reduces it."""
    ax, _, inf = C.to_affine(_P_OPS, pt_jac)
    x_plain = L.from_mont(ax, _P_OPS.spec)
    diff, borrow = L._sub_limbs(x_plain, _n_limbs(x_plain))
    return torch.where((borrow == 0)[..., None], diff, x_plain), inf


def _digest_to_z_plain(digests: np.ndarray, device) -> torch.Tensor:
    """SHA-256 digests (uint8 [B, 32], big-endian) -> z mod n as plain limbs
    int32 [B, 16] on `device` (reference ecdsa.rs:56-60). The digest is
    below 2^256 < 2n, so one conditional subtract reduces it: z, a kernel
    input of to_mont, is below n."""
    le = np.ascontiguousarray(np.asarray(digests, dtype=np.uint8)[:, ::-1])
    z = torch.from_numpy(le.view("<u2").astype(np.int32)).to(device)
    diff, borrow = L._sub_limbs(z, _n_limbs(z))
    return torch.where((borrow == 0)[..., None], diff, z)


def ecdsa_keygen_batch(priv_plain: torch.Tensor):
    """Batched public-key derivation Q = d * G (reference ecdsa.rs:33-35).
    priv_plain: int32 [B, 16] plain limbs, each d in [1, n-1]. Returns a
    Jacobian point tuple [B, 16] on priv_plain's device."""
    n = priv_plain.shape[0]
    gen = _secp_gen(str(priv_plain.device))
    return C.scalar_mul(_P_OPS, _tile(gen, n), priv_plain, 256)


def ecdsa_sign_batch(priv_plain: torch.Tensor, k_plain: torch.Tensor, digests: np.ndarray):
    """Batched ECDSA signing (reference ecdsa.rs:37-85 with the fresh-k loop
    hoisted to the caller): r = (kG).x mod n, s = k^-1 (z + r d) mod n.
    priv_plain/k_plain: int32 [B, 16] plain limb scalars in [1, n-1] (so
    below n, as B1 takes them). Returns (r, s) plain limbs and the ok mask
    (False where r or s is 0: the caller retries with a new k, as the
    reference's loop does)."""
    n = k_plain.shape[0]
    kg = C.scalar_mul(_P_OPS, _tile(_secp_gen(str(k_plain.device)), n), k_plain, 256)
    r_plain, inf = _x_mod_n(kg)
    z = _digest_to_z_plain(digests, k_plain.device)
    spec = _N_SPEC
    r_m, z_m, d_m, k_m = (L.to_mont(r_plain, spec), L.to_mont(z, spec),
                          L.to_mont(priv_plain, spec), L.to_mont(k_plain, spec))
    s_m = L.mont_mul(L.mont_inv(k_m, spec),
                     L.add_mod(z_m, L.mont_mul(r_m, d_m, spec), spec), spec)
    s_plain = L.from_mont(s_m, spec)
    ok = (~inf) & (r_plain != 0).any(-1) & (s_plain != 0).any(-1)
    return r_plain, s_plain, ok


def ecdsa_verify_batch(r_plain: torch.Tensor, s_plain: torch.Tensor, pub_jac,
                       digests: np.ndarray) -> torch.Tensor:
    """Batched ECDSA verification with the reference's rejection checks
    (ecdsa.rs:88-135): public key on the curve, not infinity and of order
    dividing n; r and s in [1, n-1]; then
    x(u1 G + u2 Q) mod n == r. r_plain/s_plain: int32 [B, 16] plain limbs
    below 2^256; pub_jac: Jacobian tuple [B, 16] of canonical Montgomery
    limbs. Returns bool [B]."""
    spec = _N_SPEC
    n = r_plain.shape[0]

    def in_range(v):
        _, borrow = L._sub_limbs(v, _n_limbs(v))
        return (v != 0).any(-1) & (borrow == 1)  # 0 < v < n

    r_ok, s_ok = in_range(r_plain), in_range(s_plain)
    ok = r_ok & s_ok

    # public-key checks (reference ecdsa.rs:96-110)
    px, py, pinf = C.to_affine(_P_OPS, pub_jac)
    x3b = _P_OPS.add(_P_OPS.mul(_P_OPS.sq(px), px), _P_OPS.const(7, px))
    on_curve = (_P_OPS.sq(py) == x3b).all(-1)
    ok = ok & (~pinf) & on_curve
    n_scalar = C.pack_scalars([secp256k1.N] * n, 256, device=r_plain.device)
    ok = ok & C.is_infinity(_P_OPS, C.scalar_mul(_P_OPS, pub_jac, n_scalar, 256))

    z = _digest_to_z_plain(digests, r_plain.device)
    # r and s go into B1 (to_mont, the inverse) only where they are below n;
    # a row out of range is rejected by `ok` whatever it computes, so it
    # computes with 0 (the JAX package feeds the raw value to its product,
    # which is exact on any limbs).
    r_in = torch.where(r_ok[..., None], r_plain, 0)
    s_inv = L.mont_inv(L.to_mont(torch.where(s_ok[..., None], s_plain, 0), spec), spec)
    u1 = L.from_mont(L.mont_mul(L.to_mont(z, spec), s_inv, spec), spec)
    u2 = L.from_mont(L.mont_mul(L.to_mont(r_in, spec), s_inv, spec), spec)
    p1 = C.scalar_mul(_P_OPS, _tile(_secp_gen(str(r_plain.device)), n), u1, 256)
    p2 = C.scalar_mul(_P_OPS, pub_jac, u2, 256)
    x_mod_n, inf = _x_mod_n(C.point_add(_P_OPS, p1, p2))
    return ok & (~inf) & (x_mod_n == r_plain).all(-1)
