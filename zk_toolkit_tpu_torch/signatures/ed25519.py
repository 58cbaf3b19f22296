"""Ed25519 with SHA-512 per RFC 8032 (host tier).

Parity: reference curves/curve25519/ed25519_sha512.rs — point encode/decode
with the x-parity bit in the top bit of the last octet (:63-98), key pruning
(:100-113), `gen_pub_key` (:115-125), `sign` with r = H(prefix || msg),
S = r + H(R || A || msg) * s mod l (:127-158), and `verify` with the
cofactor-8 check 8S*B == 8R + 8k*A (:160-186).

(The port's own copy of zk_toolkit_tpu/signatures/ed25519.py;
the port imports nothing of the JAX package.)

Reference quirk (documented, harmless): scalars are lifted into the *base*
field (mod q) before the scalar multiplication (ed25519_sha512.rs:121,137) —
scalar mul treats the scalar as a plain integer, and all scalars here are
already reduced mod l < q, so behavior is identical. We use plain ints.
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves import curve25519 as curve
from zk_toolkit_tpu_torch.curves.curve25519 import EdwardsPoint, Parity
from zk_toolkit_tpu_torch.hashers.sha512 import Sha512


class Ed25519Sha512:
    def _encode_point(self, pt: EdwardsPoint) -> bytes:
        if pt.is_zero():
            raise ValueError("Not expecting point at infinity")
        x_parity = curve.get_parity(pt.x)
        buf = bytearray(pt.y.e.to_bytes(32, "little"))
        assert buf[31] & 0x80 == 0
        if x_parity == Parity.ODD:
            buf[31] |= 0x80
        return bytes(buf)

    def _decode_point(self, buf: bytes) -> EdwardsPoint:
        b = bytearray(buf)
        x_parity = Parity.EVEN if b[31] & 0x80 == 0 else Parity.ODD
        b[31] &= 0x7F
        y = curve.BASE_FIELD.elem(int.from_bytes(bytes(b), "little"))
        x = curve.recover_x(curve.d(), y, x_parity)
        return EdwardsPoint(x, y)

    @staticmethod
    def _prune(buf: bytearray) -> None:
        """(ed25519_sha512.rs:100-104)."""
        buf[31] &= 0x7F
        buf[31] |= 0x40
        buf[0] &= 0xF8

    @staticmethod
    def _gen_s(digest_lower_32: bytes) -> int:
        buf = bytearray(digest_lower_32)
        Ed25519Sha512._prune(buf)
        return int.from_bytes(bytes(buf), "little")

    def gen_pub_key(self, prv_key: bytes) -> bytes:
        digest = Sha512.get_digest(bytes(prv_key))
        s = self._gen_s(digest[:32])
        return self._encode_point(curve.B() * s)

    def sign(self, msg: bytes, prv_key: bytes) -> bytes:
        l = curve.L
        b_pt = curve.B()
        digest = Sha512.get_digest(bytes(prv_key))
        s = self._gen_s(digest[:32])
        prefix = digest[32:64]
        a_enc = self._encode_point(b_pt * s)
        r = int.from_bytes(Sha512.get_digest(prefix + bytes(msg)), "little") % l
        r_enc = self._encode_point(b_pt * r)
        k = int.from_bytes(Sha512.get_digest(r_enc + a_enc + bytes(msg)), "little") % l
        s_scalar = (r + k * s) % l
        return r_enc + s_scalar.to_bytes(32, "little")

    def verify(self, sig: bytes, pub_key: bytes, msg: bytes) -> bool:
        l = curve.L
        b_pt = curve.B()
        s_scalar = int.from_bytes(sig[32:64], "little")
        if s_scalar >= l:
            return False
        r_pt = self._decode_point(sig[:32])
        r_enc = self._encode_point(r_pt)
        k = int.from_bytes(Sha512.get_digest(r_enc + bytes(pub_key) + bytes(msg)), "little")
        a_pt = self._decode_point(bytes(pub_key))
        # cofactor-8 check: 8S*B == 8*R + 8k*A (ed25519_sha512.rs:175-186)
        lhs = b_pt * (s_scalar * 8 % l)
        rhs = r_pt * 8 + a_pt * (k * 8 % l)
        return lhs == rhs
