"""Batched SHA-256 / SHA-512 / HMAC on a device (the port of
zk_toolkit_tpu/ops/sha_ops.py).

One call hashes a batch of equal-length messages, vectorised over the batch:
the FIPS-180-4 engine of hashers/sha_common.py, bit for bit. The JAX package
runs the block loop and the 64/80 rounds as `lax.scan`s; here they are
Python loops of plain PyTorch ops on the batch's device. No kernel: the JAX
package has no Pallas kernel for SHA, and a hand-written one would be an
addition, not part of the port.

Words are held in int64 lanes, masked to 32 bits after every add, shift and
rotate: torch.uint32 has no CPU arithmetic, and `>>` on a signed type would
drag a sign bit in. A 64-bit SHA-512 word is a (hi, lo) pair of such 32-bit
halves with an explicit carry, as in the JAX package (its :80-113).

Used by the batched signature paths (ops/signature_ops.py): Ed25519's key
expansion and its r and k digests (reference ed25519_sha512.rs:140-148).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.hashers import sha256 as h256
from zk_toolkit_tpu_torch.hashers import sha512 as h512

M32 = 0xFFFFFFFF


def _rotr32(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """blocks: int64 [B, NB, 16] big-endian 32-bit words. Returns int64
    [B, 8]."""
    b = blocks.shape[0]
    h = [torch.full((b,), v, dtype=torch.int64, device=blocks.device) for v in h256.IV256]
    for blk in range(blocks.shape[1]):
        w = [blocks[:, blk, t] for t in range(16)]
        for t in range(16, 64):
            x1, x14 = w[t - 15], w[t - 2]
            s0 = _rotr32(x1, 7) ^ _rotr32(x1, 18) ^ (x1 >> 3)
            s1 = _rotr32(x14, 17) ^ _rotr32(x14, 19) ^ (x14 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        a, bb, c, d, e, f, g, hh = h
        for t in range(64):
            s1 = _rotr32(e, 6) ^ _rotr32(e, 11) ^ _rotr32(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = hh + s1 + ch + h256.K256[t] + w[t]
            s0 = _rotr32(a, 2) ^ _rotr32(a, 13) ^ _rotr32(a, 22)
            maj = (a & bb) ^ (a & c) ^ (bb & c)
            a, bb, c, d, e, f, g, hh = (t1 + s0 + maj) & M32, a, bb, c, (d + t1) & M32, e, f, g
        h = [(x + y) & M32 for x, y in zip(h, (a, bb, c, d, e, f, g, hh))]
    return torch.stack(h, dim=1)


# -- u64 as (hi, lo) pairs of 32-bit halves --------------------------------------

def _add64(*xs):
    """Sum mod 2^64 of (hi, lo) pairs: the low halves' carry goes up."""
    lo = functools.reduce(torch.add, [x[1] for x in xs])
    hi = functools.reduce(torch.add, [x[0] for x in xs]) + (lo >> 32)
    return (hi & M32, lo & M32)


def _rotr64(a, n: int):
    hi, lo = a
    if n == 32:
        return (lo, hi)
    if n > 32:
        hi, lo, n = lo, hi, n - 32
    return (((hi >> n) | (lo << (32 - n))) & M32, ((lo >> n) | (hi << (32 - n))) & M32)


def _shr64(a, n: int):
    hi, lo = a
    if n < 32:
        return (hi >> n, ((lo >> n) | (hi << (32 - n))) & M32)
    return (torch.zeros_like(hi), hi >> (n - 32))


def _xor64(*xs):
    return (functools.reduce(torch.bitwise_xor, [x[0] for x in xs]),
            functools.reduce(torch.bitwise_xor, [x[1] for x in xs]))


def _sha512_blocks(blocks_hi: torch.Tensor, blocks_lo: torch.Tensor):
    """blocks_{hi,lo}: int64 [B, NB, 16] halves of the big-endian 64-bit
    words. Returns (hi, lo) int64 [B, 8]."""
    b, dev = blocks_hi.shape[0], blocks_hi.device

    def const(v):
        return (torch.full((b,), v >> 32, dtype=torch.int64, device=dev),
                torch.full((b,), v & M32, dtype=torch.int64, device=dev))

    h = [const(v) for v in h512.IV512]
    for blk in range(blocks_hi.shape[1]):
        w = [(blocks_hi[:, blk, t], blocks_lo[:, blk, t]) for t in range(16)]
        for t in range(16, 80):
            x1, x14 = w[t - 15], w[t - 2]
            s0 = _xor64(_rotr64(x1, 1), _rotr64(x1, 8), _shr64(x1, 7))
            s1 = _xor64(_rotr64(x14, 19), _rotr64(x14, 61), _shr64(x14, 6))
            w.append(_add64(w[t - 16], s0, w[t - 7], s1))
        a, bb, c, d, e, f, g, hh = h
        for t in range(80):
            kt = (h512.K512[t] >> 32, h512.K512[t] & M32)
            s1 = _xor64(_rotr64(e, 14), _rotr64(e, 18), _rotr64(e, 41))
            ch = tuple((ei & fi) ^ (~ei & gi) for ei, fi, gi in zip(e, f, g))
            t1 = _add64(hh, s1, ch, kt, w[t])
            s0 = _xor64(_rotr64(a, 28), _rotr64(a, 34), _rotr64(a, 39))
            maj = tuple((ai & bi) ^ (ai & ci) ^ (bi & ci) for ai, bi, ci in zip(a, bb, c))
            a, bb, c, d, e, f, g, hh = _add64(t1, s0, maj), a, bb, c, _add64(d, t1), e, f, g
        h = [_add64(x, y) for x, y in zip(h, (a, bb, c, d, e, f, g, hh))]
    return torch.stack([x[0] for x in h], dim=1), torch.stack([x[1] for x in h], dim=1)


# -- host-side padding + public batch API ---------------------------------------

def _pad_batch(msgs: np.ndarray, block_bytes: int, len_bytes: int) -> np.ndarray:
    """FIPS-180-4 padding of a batch of equal-length messages
    (host sha_common.pad_msg parity, reference sha_common.rs:158-186)."""
    b, length = msgs.shape
    total = length + 1 + len_bytes
    nblocks = -(-total // block_bytes)
    padded = np.zeros((b, nblocks * block_bytes), dtype=np.uint8)
    padded[:, :length] = msgs
    padded[:, length] = 0x80
    padded[:, -len_bytes:] = np.frombuffer((length * 8).to_bytes(len_bytes, "big"),
                                           dtype=np.uint8)
    return padded


def _words(padded: np.ndarray, word_bytes: int) -> np.ndarray:
    """Padded bytes [B, NB * block] -> big-endian words, uint64 [B, NB, 16]."""
    w = np.ascontiguousarray(padded).view(f">u{word_bytes}").astype(np.uint64)
    return w.reshape(padded.shape[0], -1, 16)


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))


def sha256_batch(msgs: np.ndarray, device="cuda") -> np.ndarray:
    """msgs: uint8 [B, L] equal-length messages -> uint8 [B, 32] digests,
    hashed on `device`."""
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    h = _sha256_blocks(_to_dev(_words(_pad_batch(msgs, 64, 8), 4), device))
    return h.cpu().numpy().astype(">u4").view(np.uint8).reshape(msgs.shape[0], 32)


def sha512_batch(msgs: np.ndarray, device="cuda") -> np.ndarray:
    """msgs: uint8 [B, L] -> uint8 [B, 64] digests, hashed on `device`."""
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    w = _words(_pad_batch(msgs, 128, 16), 8)
    hh, hl = _sha512_blocks(_to_dev(w >> np.uint64(32), device),
                            _to_dev(w & np.uint64(M32), device))
    h = (hh.cpu().numpy().astype(np.uint64) << np.uint64(32)) | hl.cpu().numpy().astype(np.uint64)
    return h.astype(">u8").view(np.uint8).reshape(msgs.shape[0], 64)


def _hmac_batch(key: bytes, msgs: np.ndarray, hash_batch, block: int) -> np.ndarray:
    """RFC 2104 over a device hash (host hmac.py parity, reference
    hmac.rs:5-46): one shared key, a batch of messages."""
    if len(key) > block:
        key = bytes(hash_batch(np.frombuffer(key, dtype=np.uint8)[None])[0])
    k = np.frombuffer(key.ljust(block, b"\x00"), dtype=np.uint8)
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    b = msgs.shape[0]
    ipad = np.broadcast_to(k ^ np.uint8(0x36), (b, block))
    opad = np.broadcast_to(k ^ np.uint8(0x5C), (b, block))
    inner = hash_batch(np.concatenate([ipad, msgs], axis=1))
    return hash_batch(np.concatenate([opad, inner], axis=1))


def hmac_sha256_batch(key: bytes, msgs: np.ndarray, device="cuda") -> np.ndarray:
    return _hmac_batch(key, msgs, functools.partial(sha256_batch, device=device), 64)


def hmac_sha512_batch(key: bytes, msgs: np.ndarray, device="cuda") -> np.ndarray:
    return _hmac_batch(key, msgs, functools.partial(sha512_batch, device=device), 128)
