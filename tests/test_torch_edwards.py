"""The port's twisted-Edwards layer (ops/edwards_ops.py, curves/curve25519.py)
on the CPU, where its products and chains run the plain versions of kernel
B1, against the JAX package and the host curve:

- the host curve25519 copy against the JAX package's (d, B, recover_x, the
  addition law);
- pack_points and point_add against the JAX package's limb for limb, on
  rows that include the identity, a doubling and P + (-P);
- decode_points / encode_points against the JAX package's limb for limb
  and byte for byte, on the six points and two bad encodings of
  tests/test_device_signatures.py (y >= q and a non-square), plus the
  identity, a y in [q, 2^255) with the sign bit, and x = 0 with the sign
  bit;
- scalar_mul at 16 bits against the host EdwardsPoint;
- convert.py carrying extended points (4 x uint32 [B, 16]) both ways.

Tolerance: exact equality (integer limbs, bytes, booleans).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zk_toolkit_tpu.curves import curve25519 as jed
from zk_toolkit_tpu.ops import edwards_ops as JE
from zk_toolkit_tpu.signatures.ed25519 import Ed25519Sha512 as JEngine
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.curves import curve25519 as ed
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import edwards_ops as E
from zk_toolkit_tpu_torch.signatures.ed25519 import Ed25519Sha512

Q = ed.Q


def _xy(pt):
    return (0, 1) if pt.is_zero() else (pt.x.e, pt.y.e)


def _equal_jax(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.limbs_to_jax(g), np.asarray(w))


def test_host_curve_matches_jax():
    assert ed.d().e == jed.d().e and (ed.Q, ed.L) == (jed.Q, jed.L)
    b, jb = ed.B(), jed.B()
    assert _xy(b) == _xy(jb)
    for k in (2, 3, 12345):
        assert _xy(b * k) == _xy(jb * k)
    assert _xy(b + b * 5) == _xy(jb + jb * 5)
    assert _xy(b * ed.L) == (0, 1) and b.is_on_curve()       # l B: the affine (0, 1)
    y = ed.BASE_FIELD.elem(4) / ed.BASE_FIELD.elem(5)
    for parity in (ed.Parity.EVEN, ed.Parity.ODD):
        jp = jed.Parity.EVEN if parity is ed.Parity.EVEN else jed.Parity.ODD
        assert ed.recover_x(ed.d(), y, parity).e == jed.recover_x(jed.d(), jed.BASE_FIELD.elem(y.e),
                                                                  jp).e


def _points():
    b = ed.B()
    return [b, b * 2, b * 12345, ed.EdwardsPoint.infinity(), b * 7, -(b * 7)]


def test_pack_and_point_add_match_jax():
    pts = _points()
    jpts = [jed.EdwardsPoint(None, None, inf=True) if p.is_zero()
            else jed.EdwardsPoint(jed.BASE_FIELD.elem(p.x.e), jed.BASE_FIELD.elem(p.y.e))
            for p in pts]
    p = E.pack_points(pts, device="cpu")
    jp = JE.pack_points(jpts)
    _equal_jax(p, jp)
    # rows: P + P (a doubling), P + identity, generic, identity + P,
    # P + (-P), generic
    perm = [0, 3, 1, 0, 5, 2]
    q = tuple(a[perm] for a in p)
    jq = tuple(a[np.asarray(perm)] for a in jp)
    got = E.point_add(p, q)
    _equal_jax(got, JE.point_add(jp, jq))
    want = [_xy(pts[i] + pts[j]) for i, j in enumerate(perm)]
    assert E.unpack_points(got) == want
    assert want[4] == (0, 1)                           # P + (-P) is the identity


def _encodings():
    eng = Ed25519Sha512()
    pts = [ed.B() * k for k in (1, 2, 3, 9, 31, 2**60 + 7)]
    encs = [np.frombuffer(eng._encode_point(p), dtype=np.uint8) for p in pts]
    bad1 = np.full(32, 0xFF, dtype=np.uint8)
    bad1[31] = 0x7F                                    # y = 2^255 - 1 >= q
    bad2 = np.zeros(32, dtype=np.uint8)
    bad2[0] = 2                                        # y = 2: no x
    above = np.frombuffer((Q + 3).to_bytes(32, "little"), dtype=np.uint8).copy()
    above[31] |= 0x80                                  # y = q + 3, sign bit set
    ident = np.zeros(32, dtype=np.uint8)
    ident[0] = 1                                       # the identity (0, 1)
    x0_sign = ident.copy()
    x0_sign[31] |= 0x80                                # x = 0 with the sign bit
    return pts, np.stack(encs + [bad1, bad2, above, ident, x0_sign])


OK_ROWS = [True] * 6 + [False, False, False, True, False]


def test_decode_and_encode_match_jax_and_host():
    pts, encs = _encodings()
    dev, ok = E.decode_points(encs, device="cpu")
    jdev, jok = JE.decode_points(encs)
    assert ok.tolist() == np.asarray(jok).tolist() == OK_ROWS
    _equal_jax(dev, jdev)                              # rejected rows included
    got = E.unpack_points(tuple(a[:6] for a in dev))
    assert got == [_xy(p) for p in pts]
    good = tuple(a[:6] for a in dev)
    re_enc = E.encode_points(good)
    np.testing.assert_array_equal(re_enc, encs[:6])
    np.testing.assert_array_equal(re_enc, JE.encode_points(tuple(a[:6] for a in jdev)))
    eng = JEngine()
    assert [bytes(r) for r in re_enc] == [eng._encode_point(jed.B() * k)
                                          for k in (1, 2, 3, 9, 31, 2**60 + 7)]


def test_scalar_mul_16_bits_matches_host():
    pts = _points()[:4]
    ks = [7, 99, 2**15 + 12345, 42]
    res = E.scalar_mul(E.pack_points(pts, device="cpu"), C.pack_scalars(ks, 16, device="cpu"), 16)
    assert E.unpack_points(res) == [_xy(p * k) for p, k in zip(pts, ks)]


def test_scalar_mul_on_a_tiled_base_reads_unreduced_wide_scalars():
    """A stride-0 base (as signature_ops tiles B) and 20-bit scalars whose
    top limb is set, as the verify's 8 s reaches beyond 2^256."""
    base = tuple(a.expand(3, 16) for a in E.pack_points([ed.B()], device="cpu"))
    ks = [1, 2**19 + 5, 2**20 - 1]
    res = E.scalar_mul(base, C.pack_scalars(ks, 20, device="cpu"), 20)
    assert E.unpack_points(res) == [_xy(ed.B() * k) for k in ks]


def test_convert_carries_extended_points_both_ways():
    p = E.pack_points(_points(), device="cpu")
    back = convert.points_from_jax(convert.points_to_jax(p), device="cpu")
    assert len(back) == 4
    for a, b in zip(back, p):
        assert torch.equal(a, b)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.decode_points(np.zeros((1, 32), dtype=np.uint8))
