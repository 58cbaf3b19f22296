"""Ed25519 (RFC 8032) of the port on the CPU: its host engine
(signatures/ed25519.py) against the JAX package's, the key expansion and
the bench's bad batch, and, marked slow (about 20-30 s on the plain
versions), the whole slice: ed25519_sign_batch / ed25519_verify_batch at
B = 3 with one tampered row, byte for byte equal to the JAX package's batch
functions and to the host engine.

Tolerance: exact equality (bytes, booleans).
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from zk_toolkit_tpu.ops import signature_ops as JSIG
from zk_toolkit_tpu.signatures.ed25519 import Ed25519Sha512 as JEngine
from zk_toolkit_tpu_torch import bench as B
from zk_toolkit_tpu_torch.curves import curve25519 as ed
from zk_toolkit_tpu_torch.ops import signature_ops as SIG
from zk_toolkit_tpu_torch.signatures.ed25519 import Ed25519Sha512


def _keys(b: int) -> np.ndarray:
    return np.random.default_rng(25519).integers(0, 256, size=(b, 32), dtype=np.uint8)


@pytest.mark.parametrize("row", [0, 1])
def test_host_engine_matches_jax(row):
    key = _keys(2)[row].tobytes()
    msg = f"ed25519 message {row}".encode()
    eng, jeng = Ed25519Sha512(), JEngine()
    pub = eng.gen_pub_key(key)
    assert pub == jeng.gen_pub_key(key)
    sig = eng.sign(msg, key)
    assert sig == jeng.sign(msg, key)
    assert eng.verify(sig, pub, msg) and not eng.verify(sig, pub, msg + b"!")


def test_expand_keys_matches_host_pruning():
    keys = _keys(3)
    s, prefixes = SIG._expand_keys(keys, "cpu")
    for i, k in enumerate(keys):
        h = hashlib.sha512(k.tobytes()).digest()
        assert s[i] == JEngine._gen_s(h[:32])
        assert bytes(prefixes[i]) == h[32:]
        assert s[i] % 8 == 0 and s[i] >> 254 == 1


def test_bench_bad_batch_rows():
    sigs = np.random.default_rng(1).integers(0, 256, size=(6, 64), dtype=np.uint8)
    sigs[:, 63] &= 0x0F                                 # s < 2^252
    pubs = np.random.default_rng(2).integers(0, 256, size=(6, 32), dtype=np.uint8)
    msgs = np.random.default_rng(3).integers(0, 256, size=(6, 96), dtype=np.uint8)
    s2, p2, m2 = B.ed25519_bad_batch(sigs, pubs, msgs)
    assert (m2[0] != msgs[0]).sum() == 1
    s = int.from_bytes(sigs[1, 32:].tobytes(), "little")
    assert int.from_bytes(s2[1, 32:].tobytes(), "little") == s + ed.L >= ed.L
    assert int.from_bytes(s2[2, :32].tobytes(), "little") == 2
    assert int.from_bytes(p2[3].tobytes(), "little") == ed.Q + 1
    assert (s2[4, :32] == sigs[5, :32]).all()
    assert (s2[5:] == sigs[5:]).all() and (p2[4:] == pubs[4:]).all()


def test_verify_scalars_are_packed_unreduced():
    """8 s of the verify reaches 8 (2^256 - 1) < 2^259: pack_scalars keeps it
    whole in 17 limbs (nothing on the path reduces it mod l)."""
    from zk_toolkit_tpu_torch.ops import curve_ops as C
    from zk_toolkit_tpu_torch.ops import limbs as L

    vals = [8 * (2**256 - 1), 8 * (ed.L + 5), 8]
    packed = C.pack_scalars(vals, 260, device="cpu")
    assert packed.shape == (3, 17)
    assert L.unpack(packed, L.field_spec(2**261 - 1), mont=False) == vals


@pytest.fixture(scope="module")
def batch():
    b = 3
    keys = np.stack([np.frombuffer(bytes([i + 1] * 32), dtype=np.uint8) for i in range(b)])
    msgs = np.random.default_rng(96).integers(0, 256, size=(b, B.ED25519_MSG_BYTES),
                                              dtype=np.uint8)
    return keys, msgs


@pytest.mark.slow
def test_sign_and_verify_batch_match_jax_and_host(batch):
    keys, msgs = batch
    eng = JEngine()
    sigs = SIG.ed25519_sign_batch(keys, msgs, device="cpu")
    np.testing.assert_array_equal(sigs, JSIG.ed25519_sign_batch(keys, msgs))
    for i in range(len(keys)):
        assert bytes(sigs[i]) == eng.sign(msgs[i].tobytes(), keys[i].tobytes())
    pubs = np.stack([np.frombuffer(eng.gen_pub_key(k.tobytes()), dtype=np.uint8) for k in keys])
    bad = msgs.copy()
    bad[1, 0] ^= 1
    got = SIG.ed25519_verify_batch(sigs, pubs, bad, device="cpu")
    assert got.tolist() == JSIG.ed25519_verify_batch(sigs, pubs, bad).tolist() == [True, False,
                                                                                 True]
