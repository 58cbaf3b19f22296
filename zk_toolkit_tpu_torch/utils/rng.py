"""Deterministic, injectable randomness.

(The port's own copy of zk_toolkit_tpu/utils/rng.py;
the port imports nothing of the JAX package.)

The reference samples OS entropy everywhere (ChaCha20 CSPRNG,
reference: building_block/random_number.rs:4-16, and per-use sampling inside
ECDSA sign, CRS setup, and Bulletproofs challenges). For reproducible
cross-implementation testing every random draw in this framework goes through
an injectable `Rng` so tests can pin k-values, trapdoors, and challenges while
production use draws from OS entropy.
"""

from __future__ import annotations

import os
import hashlib


class Rng:
    """Deterministic expand-from-seed RNG (SHA-256 counter mode) with an
    OS-entropy default, used for scalars, nonces, and protocol challenges.

    `randint(lo, hi)` is inclusive on both ends, matching the sampling ranges
    used by the reference (e.g. scalar in [1, r-1],
    reference: bls12_381/private_key.rs:10-27).
    """

    def __init__(self, seed: bytes | int | None = None):
        if seed is None:
            seed = os.urandom(32)
        elif isinstance(seed, int):
            seed = seed.to_bytes(32, "big")
        self._seed = bytes(seed)
        self._counter = 0

    def _block(self) -> bytes:
        h = hashlib.sha256(self._seed + self._counter.to_bytes(8, "big")).digest()
        self._counter += 1
        return h

    def randbytes(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += self._block()
        return out[:n]

    def randbits(self, k: int) -> int:
        nbytes = (k + 7) // 8
        v = int.from_bytes(self.randbytes(nbytes), "big")
        return v >> (nbytes * 8 - k)

    def randint(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi] via rejection sampling."""
        if lo > hi:
            raise ValueError("empty range")
        span = hi - lo + 1
        k = span.bit_length()
        while True:
            v = self.randbits(k)
            if v < span:
                return lo + v


#: Process-global default RNG (OS entropy). Tests construct seeded `Rng`s.
GLOBAL_RNG = Rng()
