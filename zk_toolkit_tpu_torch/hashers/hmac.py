"""HMAC (RFC 2104) generic over any hasher.

(The port's own copy of zk_toolkit_tpu/hashers/hmac.py;
the port imports nothing of the JAX package.)

Parity: reference hasher/hmac.rs:5-46 — key hashed down if longer than the
block size, zero-padded to the block size, ipad=0x36 / opad=0x5c.
"""

from __future__ import annotations


class Hmac:
    def __init__(self, hasher):
        self.hasher = hasher

    def get_digest(self, key: bytes, text: bytes) -> bytes:
        block = self.hasher.get_block_size()
        if len(key) > block:
            key = self.hasher.get_digest(key)
        key = key + b"\x00" * (block - len(key))
        ipad = bytes(k ^ 0x36 for k in key)
        opad = bytes(k ^ 0x5C for k in key)
        return self.hasher.get_digest(opad + self.hasher.get_digest(ipad + text))


def HmacSha256() -> Hmac:
    from zk_toolkit_tpu_torch.hashers.sha256 import Sha256

    return Hmac(Sha256)


def HmacSha512() -> Hmac:
    from zk_toolkit_tpu_torch.hashers.sha512 import Sha512

    return Hmac(Sha512)
