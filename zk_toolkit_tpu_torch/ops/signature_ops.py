"""Batched signature operations on a device (the port of
zk_toolkit_tpu/ops/signature_ops.py): ECDSA over secp256k1, Ed25519 (RFC
8032) and BLS verification over BLS12-381.

Each routine is the reference algorithm restructured so that every group
and field operation runs as one batched operation over all signatures.
Host code only packs bytes and per-row integers. The nonce k of ECDSA is an
argument, so runs replay exactly.

- ECDSA: the scalar multiplications on kernels B2/B3, the products and
  inverses mod n on B1 at K = 16 limbs. Every input is batched on its
  leading axis and the results stay on its device.
- Ed25519: SHA-512 batched on the device (ops/sha_ops.py), the unified
  Edwards law and the point codec (ops/edwards_ops.py), whose products and
  inverses run on B1 at K = 16 mod q = 2^255 - 19. Byte batches are numpy
  uint8 arrays in and out; `device` picks where they are computed.
- BLS: one batched pairing product (ops/pairing_ops.py, B1 at K = 24) over
  B rows of 2 pairs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.curves import curve25519 as ed25519_curve
from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import edwards_ops as E
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import sha_ops as S
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.signatures.ed25519 import Ed25519Sha512

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


# -- Ed25519 -------------------------------------------------------------------

_ED = ed25519_curve
_ELL = _ED.L


def _le_bytes_to_int(rows: np.ndarray) -> list[int]:
    return [int.from_bytes(bytes(row.tobytes()), "little") for row in rows]


@functools.lru_cache(maxsize=None)
def _ed_base(device: str):
    return E.pack_points([_ED.B()], device=device)


def ed25519_verify_batch(sigs: np.ndarray, pub_keys: np.ndarray, msgs: np.ndarray,
                         device="cuda") -> np.ndarray:
    """Batched RFC 8032 verify: 8S B == 8R + 8k A (reference
    ed25519_sha512.rs:160-186, the cofactor-8 form). sigs uint8 [B, 64],
    pub_keys uint8 [B, 32], msgs uint8 [B, L] of equal length. The point
    decodes, the k digest, the three scalar multiplications and the affine
    comparison run on `device`; the host packs bytes and checks s < l.
    Returns bool [B] (numpy)."""
    dev = resolve_device(device)
    b = sigs.shape[0]
    dev_r, r_ok = E.decode_points(sigs[:, :32], dev)
    dev_a, a_ok = E.decode_points(pub_keys, dev)
    decode_ok = (r_ok & a_ok).cpu().numpy()

    # k = SHA512(R || A || msg) mod l, batched on the device
    k_digest = S.sha512_batch(np.concatenate([sigs[:, :32], pub_keys, msgs], axis=1), dev)
    ks = [v % _ELL for v in _le_bytes_to_int(k_digest)]
    ss = _le_bytes_to_int(sigs[:, 32:])
    s_in_range = np.asarray([v < _ELL for v in ss])

    # 8 s is not reduced: it reaches 2^259, 17 limbs of 260 bits
    s8 = C.pack_scalars([v * 8 for v in ss], 260, dev)
    k8 = C.pack_scalars([k * 8 % (_ELL * 8) for k in ks], 260, dev)
    eight = C.pack_scalars([8] * b, 260, dev)
    lhs = E.scalar_mul(_tile(_ed_base(str(dev)), b), s8, 260)
    r8 = E.scalar_mul(dev_r, eight, 260)
    ka8 = E.scalar_mul(dev_a, k8, 260)
    lx, ly = E.to_affine(lhs)
    rx, ry = E.to_affine(E.point_add(r8, ka8))
    eq = ((lx == rx).all(-1) & (ly == ry).all(-1)).cpu().numpy()
    return decode_ok & eq & s_in_range


def _expand_keys(prv_keys: np.ndarray, device):
    """The secret scalars s (pruned low halves of SHA-512(key)) and the
    prefixes (high halves) of uint8 [B, 32] private keys, hashed on
    `device` (reference ed25519_sha512.rs:100-125)."""
    h = S.sha512_batch(prv_keys, device)
    s_scalars = []
    for row in h:
        lower = bytearray(row[:32].tobytes())
        Ed25519Sha512._prune(lower)
        s_scalars.append(int.from_bytes(bytes(lower), "little"))
    return s_scalars, h[:, 32:]


def _base_mul_encoded(scalars: list[int], device) -> np.ndarray:
    """Encodings uint8 [B, 32] of scalars[i] * B, with one 256-bit
    scalar_mul over the batch on `device`."""
    b = len(scalars)
    pts = E.scalar_mul(_tile(_ed_base(str(device)), b), C.pack_scalars(scalars, 256, device), 256)
    return _encode_points_batch(pts)


def ed25519_sign_batch(prv_keys: np.ndarray, msgs: np.ndarray, device="cuda") -> np.ndarray:
    """Batched RFC 8032 signing (reference ed25519_sha512.rs:127-158): the
    key expansion and the r and k digests on `device` (SHA-512 batches), the
    two scalar multiplications A = s B and R = r B there too, the pruning and
    S = r + k s mod l per row on the host. prv_keys uint8 [B, 32], msgs
    uint8 [B, L]. Returns uint8 [B, 64] signatures (numpy)."""
    dev = resolve_device(device)
    s_scalars, prefixes = _expand_keys(prv_keys, dev)
    a_enc = _base_mul_encoded(s_scalars, dev)
    rs = [v % _ELL for v in _le_bytes_to_int(
        S.sha512_batch(np.concatenate([prefixes, msgs], axis=1), dev))]
    r_enc = _base_mul_encoded(rs, dev)
    ks = [v % _ELL for v in _le_bytes_to_int(
        S.sha512_batch(np.concatenate([r_enc, a_enc, msgs], axis=1), dev))]
    out = np.zeros((prv_keys.shape[0], 64), dtype=np.uint8)
    out[:, :32] = r_enc
    out[:, 32:] = np.frombuffer(b"".join(((r + k * s) % _ELL).to_bytes(32, "little")
                                         for r, k, s in zip(rs, ks, s_scalars)),
                                dtype=np.uint8).reshape(-1, 32)
    return out


def _encode_points_batch(p_ext) -> np.ndarray:
    """Batched point encoding on the points' device (edwards_ops
    encode_points); the JAX package's alias, kept for its callers."""
    return E.encode_points(p_ext)


# -- BLS -------------------------------------------------------------------------

def bls_verify_batch(msgs: list[bytes], sigs: list, pks: list, hash_fn=None,
                     device="cuda") -> np.ndarray:
    """Batched BLS verification e(g1, sig) == e(pk, H(m)) (reference
    bls12_381/signature.rs:29-44) as one pairing-product batch
    e(-g1, sig) * e(pk, H(m)) == 1 over B rows of 2 pairs, with one final
    exponentiation per row. H is `hash_fn` on the host, by default the
    reference placeholder g2.hash_to_g2point. Returns bool [B] (numpy)."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
    from zk_toolkit_tpu_torch.ops import pairing_ops as PO

    hash_fn = hash_fn or g2.hash_to_g2point
    dev = resolve_device(device)
    po = PO.bls_pairing_ops()
    spec = po.f.spec
    b = len(msgs)
    neg_g1 = -g1.g()
    p_rows = [pt for pk in pks for pt in (neg_g1, pk)]
    q_rows = [pt for sig, m in zip(sigs, msgs) for pt in (sig, hash_fn(m))]
    p_b = tuple(a.view((b, 2) + a.shape[1:]) for a in PO.pack_g1_affine(p_rows, spec, dev))
    q_b = tuple(a.view((b, 2) + a.shape[1:]) for a in PO.pack_g2_affine(q_rows, spec, dev))
    return PO.pairing_product_is_one(po, p_b, q_b).cpu().numpy()
