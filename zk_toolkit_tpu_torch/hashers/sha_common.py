"""Generic FIPS-180-4 SHA-2 engine, parameterized by word width.

(The port's own copy of zk_toolkit_tpu/hashers/sha_common.py;
the port imports nothing of the JAX package.)

Behavioral parity with the reference's generic `CoreLogic` engine
(reference: building_block/hasher/sha_common.rs:9-186): message padding,
message-schedule expansion, and the 64/80-round compression with the
Sigma/sigma/ch/maj functions. Instantiated by sha256.py (u32/64 rounds) and
sha512.py (u64/80 rounds).

This host engine is the bit-exactness oracle for a batched device SHA-2
(the JAX package's ops/sha_ops.py; not ported yet).
"""

from __future__ import annotations


class ShaCore:
    """One SHA-2 family member: word width, round count, constants."""

    def __init__(
        self,
        word_bits: int,
        rounds: int,
        k_table: tuple[int, ...],
        iv: tuple[int, ...],
        ssig0: tuple[int, int, int],
        ssig1: tuple[int, int, int],
        bsig0: tuple[int, int, int],
        bsig1: tuple[int, int, int],
        length_bytes: int,
    ):
        self.word_bits = word_bits
        self.word_bytes = word_bits // 8
        self.mask = (1 << word_bits) - 1
        self.rounds = rounds
        self.k = k_table
        self.iv = iv
        self.ssig0 = ssig0
        self.ssig1 = ssig1
        self.bsig0 = bsig0
        self.bsig1 = bsig1
        self.block_bytes = 16 * self.word_bytes
        self.length_bytes = length_bytes  # 8 for SHA-256, 16 for SHA-512

    # -- word primitives ----------------------------------------------------
    def _rotr(self, x: int, n: int) -> int:
        return ((x >> n) | (x << (self.word_bits - n))) & self.mask

    def _small_sigma(self, x: int, spec: tuple[int, int, int]) -> int:
        r1, r2, s = spec
        return self._rotr(x, r1) ^ self._rotr(x, r2) ^ (x >> s)

    def _big_sigma(self, x: int, spec: tuple[int, int, int]) -> int:
        r1, r2, r3 = spec
        return self._rotr(x, r1) ^ self._rotr(x, r2) ^ self._rotr(x, r3)

    # -- padding (sha_common.rs:158-186) ------------------------------------
    def pad(self, msg: bytes) -> bytes:
        bit_len = len(msg) * 8
        padded = msg + b"\x80"
        rem = len(padded) % self.block_bytes
        pad_zeros = (self.block_bytes - self.length_bytes - rem) % self.block_bytes
        padded += b"\x00" * pad_zeros
        padded += bit_len.to_bytes(self.length_bytes, "big")
        assert len(padded) % self.block_bytes == 0
        return padded

    # -- schedule + compression (sha_common.rs:91-155) ----------------------
    def expand_schedule(self, block_words: list[int]) -> list[int]:
        w = list(block_words)
        for t in range(16, self.rounds):
            s1 = self._small_sigma(w[t - 2], self.ssig1)
            s0 = self._small_sigma(w[t - 15], self.ssig0)
            w.append((s1 + w[t - 7] + s0 + w[t - 16]) & self.mask)
        return w

    def compress(self, state: list[int], w: list[int]) -> list[int]:
        m = self.mask
        a, b, c, d, e, f, g, h = state
        for t in range(self.rounds):
            ch = (e & f) ^ ((~e & m) & g)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t1 = (h + self._big_sigma(e, self.bsig1) + ch + self.k[t] + w[t]) & m
            t2 = (self._big_sigma(a, self.bsig0) + maj) & m
            h, g, f, e, d, c, b, a = g, f, e, (d + t1) & m, c, b, a, (t1 + t2) & m
        return [(x + y) & m for x, y in zip(state, [a, b, c, d, e, f, g, h])]

    def digest(self, msg: bytes) -> bytes:
        state = list(self.iv)
        padded = self.pad(msg)
        for off in range(0, len(padded), self.block_bytes):
            words = [
                int.from_bytes(padded[off + i * self.word_bytes : off + (i + 1) * self.word_bytes], "big")
                for i in range(16)
            ]
            state = self.compress(state, self.expand_schedule(words))
        return b"".join(x.to_bytes(self.word_bytes, "big") for x in state)
