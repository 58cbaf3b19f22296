"""BLS signatures of the port on the CPU: the host copies (signatures/bls.py,
g2.hash_to_g2point_swu with _fq2_sqrt / _fq_sqrt) against the JAX
package's, the bench's bad batch, and, marked slow, bls_verify_batch at
B = 2 against the JAX package's row for row (the pairing product on the
plain versions) and the host Signer's sign / verify round trip (the Tate
pairing on the host).

Tolerance: exact equality (integers, booleans).
"""

from __future__ import annotations

import numpy as np
import pytest

from zk_toolkit_tpu.curves.bls12_381 import g2 as jg2
from zk_toolkit_tpu.curves.bls12_381.tower import Fq2 as JFq2
from zk_toolkit_tpu.curves.bls12_381.tower import fq1 as jfq1
from zk_toolkit_tpu.ops import signature_ops as JSIG
from zk_toolkit_tpu.signatures import bls as JBLS
from zk_toolkit_tpu.utils.rng import Rng as JRng
from zk_toolkit_tpu_torch import bench as B
from zk_toolkit_tpu_torch.curves.bls12_381 import g2, params
from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq2, fq1
from zk_toolkit_tpu_torch.ops import signature_ops as SIG
from zk_toolkit_tpu_torch.signatures import bls
from zk_toolkit_tpu_torch.utils.rng import Rng


def _g2xy(pt):
    return None if pt.is_zero() else (pt.x.u1.e, pt.x.u0.e, pt.y.u1.e, pt.y.u0.e)


@pytest.mark.parametrize("msg", [b"", b"proper hash to curve", bytes(range(200))],
                         ids=["empty", "text", "200-bytes"])
def test_hash_to_g2point_swu_matches_jax(msg):
    pt = g2.hash_to_g2point_swu(msg)
    assert _g2xy(pt) == _g2xy(jg2.hash_to_g2point_swu(msg))
    assert (pt * params.R).is_zero()


def test_fq_sqrts_match_jax():
    rng = np.random.default_rng(381)
    q = params.Q
    for _ in range(6):
        a0, a1 = (int.from_bytes(rng.bytes(48), "big") % q for _ in range(2))
        assert g2._fq_sqrt(a0) == jg2._fq_sqrt(a0)
        for x0, x1 in ((a0, a1), (a0, 0), ((a0 * a0) % q, 0), (0, a1)):
            got = g2._fq2_sqrt(Fq2(fq1(x1), fq1(x0)))
            want = jg2._fq2_sqrt(JFq2(jfq1(x1), jfq1(x0)))
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.u1.e, got.u0.e) == (want.u1.e, want.u0.e)
                assert got * got == Fq2(fq1(x1), fq1(x0))


@pytest.mark.parametrize("hash_name", ["placeholder", "swu"])
def test_host_signer_matches_jax(hash_name):
    hash_fn, jhash_fn = ((g2.hash_to_g2point, jg2.hash_to_g2point) if hash_name == "placeholder"
                         else (g2.hash_to_g2point_swu, jg2.hash_to_g2point_swu))
    sk, jsk = bls.PrivateKey(rng=Rng(42)), JBLS.PrivateKey(rng=JRng(42))
    assert sk.value == jsk.value
    signer, jsigner = bls.Signer(hash_fn), JBLS.Signer(jhash_fn)
    pk, jpk = signer.gen_public_key(sk), jsigner.gen_public_key(jsk)
    assert (pk.x.e, pk.y.e) == (jpk.x.e, jpk.y.e)
    assert _g2xy(signer.sign(b"chili crab", sk)) == _g2xy(jsigner.sign(b"chili crab", jsk))


def test_bench_inputs_and_bad_batch():
    msgs, sigs, pks = B.bls_inputs(5)
    bm, bs, bp = B.bls_bad_batch(msgs, sigs, pks)
    assert (bs[0], bs[1]) == (sigs[1], sigs[0]) and bm[2] != msgs[2] and bp[3] == pks[4]
    assert bm[4:] == msgs[4:] and bs[4:] == sigs[4:] and bp[4:] == pks[4:]
    signer, sk = bls.Signer(), bls.PrivateKey(rng=Rng(64))
    assert _g2xy(sigs[0]) == _g2xy(signer.sign(msgs[0], sk))


@pytest.mark.slow
def test_verify_batch_matches_jax_row_for_row():
    """The port's batch on its own host points, the JAX package's on the
    JAX package's, both from the same keys: true rows, then swapped
    signatures."""
    msgs, sigs, pks = B.bls_inputs(2)
    rng = JRng(64)
    jsks = [JBLS.PrivateKey(rng=rng) for _ in range(2)]
    jsigner = JBLS.Signer()
    jsigs = [jsigner.sign(m, sk) for m, sk in zip(msgs, jsks)]
    jpks = [jsigner.gen_public_key(sk) for sk in jsks]
    assert [_g2xy(s) for s in sigs] == [_g2xy(s) for s in jsigs]
    for order, want in (((0, 1), [True, True]), ((1, 0), [False, False])):
        got = SIG.bls_verify_batch(msgs, [sigs[i] for i in order], pks, device="cpu")
        jgot = JSIG.bls_verify_batch(msgs, [jsigs[i] for i in order], jpks)
        assert got.tolist() == np.asarray(jgot).tolist() == want


@pytest.mark.slow
def test_host_signer_round_trip():
    signer = bls.Signer()
    sk = bls.PrivateKey(rng=Rng(42))
    pk = signer.gen_public_key(sk)
    sig = signer.sign(b"chili crab", sk)
    assert signer.verify(b"chili crab", sig, pk)
    assert not signer.verify(b"chili craab", sig, pk)
