"""SHA-256: u32 / 64-round instantiation of the generic SHA-2 engine.

(The port's own copy of zk_toolkit_tpu/hashers/sha256.py;
the port imports nothing of the JAX package.)

Parity: reference sha256.rs (rotation constants :36-46, K table :48-59,
IV :61-72, Hasher<32> impl :75-86). Constants are the standard FIPS-180-4
values (fractional parts of cube/square roots of the first primes).
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.hashers.sha_common import ShaCore

K256 = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

IV256 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

CORE256 = ShaCore(
    word_bits=32,
    rounds=64,
    k_table=K256,
    iv=IV256,
    ssig0=(7, 18, 3),
    ssig1=(17, 19, 10),
    bsig0=(2, 13, 22),
    bsig1=(6, 11, 25),
    length_bytes=8,
)


class Sha256:
    """Hasher with 32-byte digests (reference Hasher<32> impl, sha256.rs:75-86)."""

    DIGEST_SIZE = 32
    BLOCK_SIZE = 64

    @staticmethod
    def get_digest(msg: bytes) -> bytes:
        return CORE256.digest(msg)

    @staticmethod
    def get_block_size() -> int:
        return Sha256.BLOCK_SIZE
