"""Batched SHA-256 / SHA-512 / HMAC of the port (ops/sha_ops.py) on the CPU:
against hashlib and hmac at lengths around the padding boundaries (55/56
bytes for SHA-256, 111/112 for SHA-512, and a block and more), and against
the JAX package's sha_ops on one batch of 96-byte messages from a numpy
seed. Tolerance: the bytes are equal.
"""

from __future__ import annotations

import hashlib
import hmac

import numpy as np
import pytest

from zk_toolkit_tpu.ops import sha_ops as JS
from zk_toolkit_tpu_torch.ops import sha_ops as S


def _msgs(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [0, 3, 55, 56, 63, 64, 119, 200])
def test_sha256_matches_hashlib(length):
    m = _msgs(3, length, length)
    d = S.sha256_batch(m, device="cpu")
    assert d.shape == (3, 32) and d.dtype == np.uint8
    for i in range(3):
        assert bytes(d[i]) == hashlib.sha256(m[i].tobytes()).digest()


@pytest.mark.parametrize("length", [0, 3, 111, 112, 127, 128, 160, 300])
def test_sha512_matches_hashlib(length):
    m = _msgs(3, length, 1000 + length)
    d = S.sha512_batch(m, device="cpu")
    assert d.shape == (3, 64) and d.dtype == np.uint8
    for i in range(3):
        assert bytes(d[i]) == hashlib.sha512(m[i].tobytes()).digest()


@pytest.mark.parametrize("key", [b"key", bytes(range(64)), bytes(range(150))],
                         ids=["short", "one-block", "longer-than-a-block"])
@pytest.mark.parametrize("name", ["sha256", "sha512"])
def test_hmac_matches_hmac_module(key, name):
    m = _msgs(2, 40, 7)
    fn = S.hmac_sha256_batch if name == "sha256" else S.hmac_sha512_batch
    d = fn(key, m, device="cpu")
    for i in range(2):
        assert bytes(d[i]) == hmac.new(key, m[i].tobytes(), name).digest()


def test_words_with_the_top_bit_set():
    """Message words >= 2^63 (SHA-512) and >= 2^31 (SHA-256): the int64 lanes
    hold them as 32-bit halves, never as a negative word."""
    m = np.full((2, 130), 0xFF, dtype=np.uint8)
    m[1, ::2] = 0x80
    for i in range(2):
        assert bytes(S.sha512_batch(m, device="cpu")[i]) == hashlib.sha512(m[i].tobytes()).digest()
        assert bytes(S.sha256_batch(m, device="cpu")[i]) == hashlib.sha256(m[i].tobytes()).digest()


def test_batch_matches_jax_sha_ops():
    m = _msgs(4, 96, 96)
    np.testing.assert_array_equal(S.sha256_batch(m, device="cpu"), JS.sha256_batch(m))
    np.testing.assert_array_equal(S.sha512_batch(m, device="cpu"), JS.sha512_batch(m))
    np.testing.assert_array_equal(S.hmac_sha512_batch(b"k" * 200, m, device="cpu"),
                                  JS.hmac_sha512_batch(b"k" * 200, m))


def test_pad_batch_matches_jax():
    for length, block, len_bytes in ((55, 64, 8), (56, 64, 8), (111, 128, 16), (112, 128, 16)):
        m = _msgs(2, length, length)
        np.testing.assert_array_equal(S._pad_batch(m, block, len_bytes),
                                      JS._pad_batch(m, block, len_bytes))


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.sha256_batch(_msgs(1, 3, 0))
