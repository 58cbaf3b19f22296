"""The secp256k1 tier's host copies and batched MSM on the CPU (plain
versions):

- the port's curves/secp256k1.py against the JAX package's: multiples of
  the generator (0, 1, n - 1, n, random), rand_point and the AffinePoints
  vector ops on the same Rng seed;
- the port's hashers (SHA-256, SHA-512, HMAC) against hashlib/hmac and the
  JAX package's hashers, on messages around the block boundaries;
- ops/limbs._sub_limbs against the JAX package's, borrow included;
- pack_points / unpack_points on secp256k1 AffinePoints at K = 16 against
  the JAX package's pack_points, and convert.py's round trip of [N, 16]
  point tuples and Fr(n) limbs;
- ops/msm.msm_pippenger_many at B = 2, n in {5, 8}, c = 2 and the default
  window, with an all-zero scalar row and an infinity base: limb for limb
  against the port's msm_pippenger on each stream, and against the JAX
  package's host multiples; limb for limb against the JAX package's
  msm_pippenger_many (marked slow: its CPU compile takes minutes).

Tolerance: exact equality (integer limbs).
"""

from __future__ import annotations

import hashlib
import hmac

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu.curves import secp256k1 as JS
from zk_toolkit_tpu.fields.prime_field import PrimeFieldElems as JElems
from zk_toolkit_tpu.hashers import Hmac as JHmac, Sha256 as JSha256, Sha512 as JSha512
from zk_toolkit_tpu.ops import curve_ops as JC
from zk_toolkit_tpu.ops import limbs as JL
from zk_toolkit_tpu.utils.rng import Rng as JRng
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.curves import secp256k1 as TS
from zk_toolkit_tpu_torch.fields.prime_field import PrimeFieldElems as TElems
from zk_toolkit_tpu_torch.hashers import Hmac, HmacSha256, HmacSha512, Sha256, Sha512
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.ops import msm as TM
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array
from zk_toolkit_tpu_torch.utils.rng import Rng

N, P = TS.N, TS.P
SPEC = TL.field_spec(P)
OPS = FqOps(SPEC)


def _xy(pt):
    return None if pt.is_zero() else (pt.x.e, pt.y.e)


# -- host copies ---------------------------------------------------------------

def test_constants_match_jax():
    assert (TS.P, TS.N, TS.GX, TS.GY) == (JS.P, JS.N, JS.GX, JS.GY)
    assert TS.g().is_rational_point() and not TS.infinity().is_rational_point()


@pytest.mark.parametrize("k", [0, 1, 2, 7, N - 1, N, N + 5, 0xDEADBEEF << 200])
def test_multiples_match_jax(k):
    assert _xy(TS.g() * k) == _xy(JS.g() * k)


def test_rand_point_and_affine_points_ops_match_jax():
    tp = TS.AffinePoints.rand_points(4, True, Rng(5))
    jp = JS.AffinePoints.rand_points(4, True, JRng(5))
    assert [_xy(p) for p in tp] == [_xy(p) for p in jp]
    ts = TElems([TS.curve_group().elem(x) for x in (3, 0, N - 1, 99)])
    js = JElems([JS.curve_group().elem(x) for x in (3, 0, N - 1, 99)])
    assert [_xy(p) for p in tp * ts] == [_xy(p) for p in jp * js]
    assert [_xy(p) for p in tp + tp] == [_xy(p) for p in jp + jp]
    assert _xy(tp.inner_prod(ts)) == _xy(jp.inner_prod(js))
    assert _xy(tp.sum()) == _xy(jp.sum())
    assert [_xy(p) for p in tp.from_(1).to(2)] == [_xy(p) for p in jp.from_(1).to(2)]
    assert _xy(-tp[0] + tp[0]) is None


MESSAGES = [b"", b"abc", b"a" * 55, b"a" * 56, b"b" * 64, b"c" * 111, b"d" * 112, b"e" * 300]


@pytest.mark.parametrize("msg", MESSAGES, ids=lambda m: f"len{len(m)}")
def test_sha2_matches_hashlib_and_jax(msg):
    assert Sha256.get_digest(msg) == hashlib.sha256(msg).digest() == JSha256.get_digest(msg)
    assert Sha512.get_digest(msg) == hashlib.sha512(msg).digest() == JSha512.get_digest(msg)


@pytest.mark.parametrize("key", [b"", b"key", b"k" * 64, b"K" * 200], ids=lambda k: f"key{len(k)}")
def test_hmac_matches_stdlib_and_jax(key):
    msg = b"The quick brown fox jumps over the lazy dog"
    assert HmacSha256().get_digest(key, msg) == hmac.new(key, msg, hashlib.sha256).digest()
    assert HmacSha512().get_digest(key, msg) == hmac.new(key, msg, hashlib.sha512).digest()
    assert Hmac(Sha256).get_digest(key, msg) == JHmac(JSha256).get_digest(key, msg)


# -- limbs and packing -----------------------------------------------------------

def test_sub_limbs_matches_jax_with_borrow():
    rng = np.random.default_rng(31)
    a = rng.integers(0, 1 << 16, size=(64, 16), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(64, 16), dtype=np.uint32)
    b[:8] = a[:8]                                     # a == b: no borrow
    b[8:16, :15] = a[8:16, :15]                       # differ in the top limb only
    a[16:24], b[16:24] = 0, 0xFFFF                    # borrow through every limb
    b[24:32] = ints_to_array([N] * 8, 16)
    a[24:32] = ints_to_array([0, 1, N - 1, N, N + 1, P, 2**256 - 1, N >> 1], 16)
    jd, jb = JL._sub_limbs(jnp.asarray(a), jnp.asarray(b))
    td, tb = TL._sub_limbs(convert.limbs_from_jax(a, "cpu"), convert.limbs_from_jax(b, "cpu"))
    np.testing.assert_array_equal(convert.limbs_to_jax(td), np.asarray(jd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int32))


def test_pack_points_takes_secp256k1_points_as_jax_does():
    pts = [JS.g() * k for k in (1, 5, N - 1)] + [JS.infinity()]
    want = JC.pack_points(pts, JL.field_spec(P))
    tpts = [TS.g() * k for k in (1, 5, N - 1)] + [TS.infinity()]
    got = TC.pack_points(tpts, SPEC, device="cpu")
    assert got[0].shape == (4, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))
    # (x, y) pairs and None go in as before
    for g, w in zip(TC.pack_points([_xy(p) for p in tpts], SPEC, device="cpu"), got):
        assert torch.equal(g, w)
    assert TC.unpack_points(got, SPEC) == [_xy(p) for p in tpts]


def test_convert_carries_secp256k1_points_and_fr_limbs():
    pts = JC.pack_points([JS.g() * k for k in (3, 9)], JL.field_spec(P))
    fr = JL.pack([5, N - 1, 0], JL.field_spec(N), mont=True)
    tp = convert.points_from_jax(pts, "cpu")
    assert TC.unpack_points(tp, SPEC) == [_xy(TS.g() * k) for k in (3, 9)]
    for a, b in zip(convert.points_to_jax(tp), pts):
        np.testing.assert_array_equal(a, np.asarray(b))
    tf = convert.limbs_from_jax(fr, "cpu")
    assert TL.unpack(tf, TL.field_spec(N)) == [5, N - 1, 0]
    np.testing.assert_array_equal(convert.limbs_to_jax(tf), np.asarray(fr))


# -- msm_pippenger_many -----------------------------------------------------------

def _many_inputs(n: int, seed: int):
    """B = 2 streams of n distinct secp256k1 points (stream 1 holds
    infinity at row 1) and 256-bit scalars (stream 0's row 2 and all of
    stream 1's last row zero), as host ints and tensors."""
    rng = np.random.default_rng(seed)
    ks = [[int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % N for _ in range(n)]
          for _ in range(2)]
    ks[1][1] = 0
    ss = [[int.from_bytes(rng.bytes(32), "little") for _ in range(n)] for _ in range(2)]
    ss[0][2] = 0
    ss[1][n - 1] = 0
    pts = [TC.pack_points([_xy(TS.g() * k) for k in row], SPEC, device="cpu") for row in ks]
    pts = tuple(torch.stack([a, b]) for a, b in zip(*pts))
    sc = torch.from_numpy(np.stack([ints_to_array(row, 16) for row in ss]).astype(np.int32))
    return ks, ss, pts, sc


@pytest.mark.parametrize("n,c", [(5, 2), (5, None), (8, 2), (8, None)])
def test_msm_many_matches_single_msms_and_host(n, c):
    ks, ss, pts, sc = _many_inputs(n, seed=40 + n)
    got = TM.msm_pippenger_many(OPS, pts, sc, 256, c=c)
    assert got[0].shape == (2, 16)
    for b in range(2):
        one = TM.msm_pippenger(OPS, tuple(a[b] for a in pts), sc[b], 256, c=c)
        for g, w in zip(got, one):
            assert torch.equal(g[b], w)
        want = JS.infinity()
        for k, s in zip(ks[b], ss[b]):
            want = want + JS.g() * (k * s % N)
        assert TC.unpack_points(tuple(a[b:b + 1] for a in got), SPEC)[0] == _xy(want)


def test_msm_many_windows_in_groups_match_one_group(monkeypatch):
    _, _, pts, sc = _many_inputs(5, seed=47)
    whole = TM.msm_pippenger_many(OPS, pts, sc, 256, c=4)
    monkeypatch.setattr(TM, "_auto_window_chunk", lambda *args: 5)
    for g, w in zip(TM.msm_pippenger_many(OPS, pts, sc, 256, c=4), whole):
        assert torch.equal(g, w)


@pytest.mark.slow
def test_msm_many_matches_jax_limb_for_limb():
    from zk_toolkit_tpu.ops import msm as JM
    from zk_toolkit_tpu.ops.field_ops import FqOps as JFqOps

    _, _, pts, sc = _many_inputs(5, seed=45)
    jres = JM.msm_pippenger_many(JFqOps(JL.field_spec(P)),
                                 tuple(jnp.asarray(convert.limbs_to_jax(a)) for a in pts),
                                 jnp.asarray(convert.limbs_to_jax(sc)), 256, c=2)
    tres = TM.msm_pippenger_many(OPS, pts, sc, 256, c=2)
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(convert.limbs_to_jax(t), np.asarray(j))
