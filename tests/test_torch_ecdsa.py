"""ECDSA on the CPU (plain versions): the port's host copy and batched
device functions against the JAX package.

- the port's host Ecdsa (signatures/ecdsa.py) against the JAX package's on
  the same Rng seed: public key, (r, s), verify on the true and a wrong
  message;
- `_digest_to_z_plain` against the JAX package's, digests at and above n
  included;
- ecdsa_keygen_batch and ecdsa_sign_batch at B = 4: the public keys and
  (r, s) against the JAX package's host equations with the same nonces;
- ecdsa_verify_batch on 7 rows (good rows, a flipped digest, r = 0, s = n,
  an infinity public key, an off-curve public key): the mask equals the
  JAX package's host Ecdsa.verify row by row;
- ecdsa_sign_batch limb for limb and ecdsa_verify_batch's mask against the
  JAX package's batch functions (marked slow: their CPU compile takes
  minutes).

Tolerance: exact equality (integer limbs, booleans).
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import pytest

import jax.numpy as jnp

from zk_toolkit_tpu.curves import secp256k1 as JS
from zk_toolkit_tpu.ops import signature_ops as JSIG
from zk_toolkit_tpu.signatures import ecdsa as JE
from zk_toolkit_tpu.utils.rng import Rng as JRng
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.curves import secp256k1 as TS
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops import signature_ops as SIG
from zk_toolkit_tpu_torch.signatures import ecdsa as TE
from zk_toolkit_tpu_torch.utils.rng import Rng

N, P = TS.N, TS.P
B = 4


def _xy(pt):
    return None if pt.is_zero() else (pt.x.e, pt.y.e)


def test_host_ecdsa_matches_jax():
    for i in range(3):
        jd = JS.curve_group().rand_elem(True, JRng(40 + i))
        td = TS.curve_group().rand_elem(True, Rng(40 + i))
        assert jd.e == td.e
        msg = f"message {i}".encode()
        jsig = JE.Ecdsa().sign(jd, msg, JRng(50 + i))
        tsig = TE.Ecdsa().sign(td, msg, Rng(50 + i))
        assert (tsig.r.e, tsig.s.e) == (jsig.r.e, jsig.s.e)
        jq, tq = JE.Ecdsa().gen_pub_key(jd), TE.Ecdsa().gen_pub_key(td)
        assert _xy(tq) == _xy(jq)
        assert TE.Ecdsa().verify(tsig, tq, msg) and JE.Ecdsa().verify(jsig, jq, msg)
        assert not TE.Ecdsa().verify(tsig, tq, msg + b"!")


def test_digest_to_z_matches_jax():
    rng = np.random.default_rng(60)
    d = rng.integers(0, 256, size=(6, 32), dtype=np.uint8)
    d[0] = 0xFF                                       # 2^256 - 1 > n
    d[1] = np.frombuffer(N.to_bytes(32, "big"), dtype=np.uint8)
    d[2] = np.frombuffer((N - 1).to_bytes(32, "big"), dtype=np.uint8)
    d[3] = 0
    got = SIG._digest_to_z_plain(d, "cpu")
    np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(JSIG._digest_to_z_plain(d)))
    assert TL.unpack(got, TL.field_spec(N), mont=False)[:4] == [(2**256 - 1) % N, 0, N - 1, 0]


def _batch():
    rng = random.Random(11)
    privs = [rng.randrange(1, N) for _ in range(B)]
    ks = [rng.randrange(1, N) for _ in range(B)]
    msgs = [f"message-{i}".encode() for i in range(B)]
    digests = np.stack([np.frombuffer(hashlib.sha256(m).digest(), dtype=np.uint8) for m in msgs])
    return privs, ks, msgs, digests


@pytest.fixture(scope="module")
def signed():
    privs, ks, msgs, digests = _batch()
    d = TC.pack_scalars(privs, 256, device="cpu")
    k = TC.pack_scalars(ks, 256, device="cpu")
    pub = SIG.ecdsa_keygen_batch(d)
    r, s, ok = SIG.ecdsa_sign_batch(d, k, digests)
    return privs, ks, msgs, digests, pub, r, s, ok


def test_keygen_and_sign_match_host_equations(signed):
    privs, ks, msgs, digests, pub, r, s, ok = signed
    assert bool(ok.all())
    assert TC.unpack_points(pub, SIG._P_OPS.spec) == [_xy(JS.g() * d) for d in privs]
    rs = TL.unpack(r, SIG._N_SPEC, mont=False)
    ss = TL.unpack(s, SIG._N_SPEC, mont=False)
    for i in range(B):
        r_exp = (JS.g() * ks[i]).x.e % N
        z = int.from_bytes(hashlib.sha256(msgs[i]).digest(), "big") % N
        assert rs[i] == r_exp
        assert ss[i] == pow(ks[i], -1, N) * (z + r_exp * privs[i]) % N


def _seven_rows(signed):
    """Rows 0-1 good, then a flipped digest, r = 0, s = n, an infinity and
    an off-curve public key (on signatures 0, 1, 0, 1, 2, 3, 0); with the
    host public keys of the rows."""
    privs, ks, msgs, digests, pub, r, s, _ = signed
    idx = [0, 1, 0, 1, 2, 3, 0]
    r7, s7 = r[idx].clone(), s[idx].clone()
    pub7 = tuple(t[idx].clone() for t in pub)
    d7 = digests[idx].copy()
    d7[2, 0] ^= 1                                       # flipped digest
    r7[3] = 0                                           # r = 0
    s7[4] = TL.const_limbs(N, 16, "cpu")                # s = n
    off_curve = (TS.GX, (TS.GY + 1) % P)
    bad_pubs = TC.pack_points([None, off_curve], SIG._P_OPS.spec, device="cpu")
    for t, b in zip(pub7, bad_pubs):
        t[5:] = b                                       # infinity, off-curve public key
    host_pubs = [JS.g() * privs[i] for i in idx[:5]] + [JS.infinity(), JS.point(*off_curve)]
    return r7, s7, pub7, d7, host_pubs


WANT_MASK = [True, True, False, False, False, False, False]


def test_verify_mask_matches_jax_host_row_by_row(signed):
    r7, s7, pub7, d7, host_pubs = _seven_rows(signed)
    got = SIG.ecdsa_verify_batch(r7, s7, pub7, d7)
    ecdsa = JE.Ecdsa(hasher=_DigestOf(d7))
    rr = TL.unpack(r7, SIG._N_SPEC, mont=False)
    sr = TL.unpack(s7, SIG._N_SPEC, mont=False)
    want = [ecdsa.verify(JE.Signature(_RawElem(rr[j]), _RawElem(sr[j])), host_pubs[j], j)
            for j in range(len(rr))]
    assert got.tolist() == want == WANT_MASK


class _RawElem:
    """A signature component as the host verify reads it (.e, .inv(), *),
    without reducing it mod n, so s = n reaches the range check."""

    def __init__(self, e):
        self.e = e

    def inv(self):
        return JS.curve_group().elem(pow(self.e, -1, N))

    def __mul__(self, other):
        return JS.curve_group().elem(self.e * other.e)

    __rmul__ = __mul__


class _DigestOf:
    """A hasher whose digest of message j is row j of a digest array."""

    def __init__(self, digests):
        self.digests = digests

    def get_digest(self, j):
        return bytes(self.digests[j])


@pytest.mark.slow
def test_batch_functions_match_jax(signed):
    privs, ks, msgs, digests, pub, r, s, _ = signed
    jr, js, jok = JSIG.ecdsa_sign_batch(JSIG.C.pack_scalars(privs, 256),
                                         JSIG.C.pack_scalars(ks, 256), digests)
    np.testing.assert_array_equal(convert.limbs_to_jax(r), np.asarray(jr))
    np.testing.assert_array_equal(convert.limbs_to_jax(s), np.asarray(js))
    assert np.asarray(jok).all()
    r7, s7, pub7, d7, _ = _seven_rows(signed)
    want = JSIG.ecdsa_verify_batch(convert.limbs_to_jax(r7), convert.limbs_to_jax(s7),
                                   tuple(jnp.asarray(a) for a in convert.points_to_jax(pub7)), d7)
    got = SIG.ecdsa_verify_batch(r7, s7, pub7, d7)
    assert got.tolist() == np.asarray(want).tolist() == WANT_MASK
