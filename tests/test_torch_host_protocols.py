"""The port's host Groth16 and Pinocchio (zk_toolkit_tpu_torch/protocols/
{groth16,pinocchio}.py) against the JAX package's on the flagship circuit
(x * x * x) + x + 5 == 35 with x = 3: with the same Rng seeds the CRS and
the proof are the same ints (tolerance 0). The CRS cases run no host
pairing: both Groth16 CRS constructions get a pairing stand-in whose
`tate` records its arguments, and e(alpha, beta) is compared in the slow
cases, which also run the verifiers (accept, and reject a wrong statement).
"""

from __future__ import annotations

import pytest

from zk_toolkit_tpu.curves.bls12_381 import params as JP
from zk_toolkit_tpu.curves.bls12_381.pairing import Pairing as JPairing
from zk_toolkit_tpu.fields.sparse_vec import SparseVec as JVec
from zk_toolkit_tpu.protocols import groth16 as JG
from zk_toolkit_tpu.protocols import pinocchio as JPin
from zk_toolkit_tpu.snark import term as JT
from zk_toolkit_tpu.utils.rng import Rng as JRng
from zk_toolkit_tpu_torch.curves.bls12_381 import params as TP
from zk_toolkit_tpu_torch.curves.bls12_381.pairing import Pairing as TPairing
from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec as TVec
from zk_toolkit_tpu_torch.protocols import groth16 as TG
from zk_toolkit_tpu_torch.protocols import pinocchio as TPin
from zk_toolkit_tpu_torch.snark import term as TT
from zk_toolkit_tpu_torch.utils.rng import Rng as TRng

EXPR = "(x * x * x) + x + 5 == 35"
VALUES = ((lambda T: T.One(), 1), (lambda T: T.Var("x"), 3), (lambda T: T.Out(), 35),
          (lambda T: T.TmpVar(1), 9), (lambda T: T.TmpVar(2), 27),
          (lambda T: T.TmpVar(3), 8), (lambda T: T.TmpVar(4), 35))


def witness(T, f):
    return {make(T): f.elem(v) for make, v in VALUES}


def as_ints(v):
    """Points, field and tower elements -> nested tuples of ints (None for
    the point at infinity)."""
    if isinstance(v, (list, tuple)):
        return tuple(as_ints(x) for x in v)
    if isinstance(v, dict):
        return {k: as_ints(x) for k, x in v.items()}
    if hasattr(v, "inf"):
        return None if v.inf else (as_ints(v.x), as_ints(v.y))
    if hasattr(v, "e"):
        return v.e if isinstance(v.e, int) else as_ints(v.e)
    return tuple(as_ints(getattr(v, s)) for s in type(v).__slots__)


class RecordingPairing:
    """Stands in for Pairing in a CRS: tate() records its points."""

    def __init__(self):
        self.calls = []

    def tate(self, p, q):
        self.calls.append((p, q))
        return None


G16_CRS_FIELDS = ("g1_uvw_stmt", "g1_uvw_wit", "g1_xi", "g2_xi", "g1_xt_by_delta", "g1_alpha",
                  "g1_beta", "g1_delta", "g2_beta", "g2_gamma", "g2_delta")


def _groth16(mod, T, f, Rng, pairing, crs_seed, proof_seed):
    prover = mod.Prover(f, EXPR, witness(T, f))
    crs = mod.CRS(f, prover, pairing, rng=Rng(crs_seed))
    return prover, crs, prover.prove(crs, rng=Rng(proof_seed))


def _pinocchio(mod, T, f, Rng, crs_seed, proof_seed):
    prover = mod.Prover(f, EXPR, witness(T, f))
    crs = mod.CRS(f, prover, rng=Rng(crs_seed))
    return prover, crs, prover.prove(crs, rng=Rng(proof_seed))


def test_groth16_crs_and_proof_equal_jax():
    jp, tp = RecordingPairing(), RecordingPairing()
    jprover, jcrs, jproof = _groth16(JG, JT, JP.SUBGROUP, JRng, jp, 111, 222)
    tprover, tcrs, tproof = _groth16(TG, TT, TP.SUBGROUP, TRng, tp, 111, 222)
    assert (tprover.n, tprover.l, tprover.m) == (jprover.n, jprover.l, jprover.m)
    assert [c.e for c in tprover.h.coeffs] == [c.e for c in jprover.h.coeffs]
    for name in G16_CRS_FIELDS:
        assert as_ints(getattr(tcrs, name)) == as_ints(getattr(jcrs, name)), name
    assert as_ints(tp.calls) == as_ints(jp.calls) == as_ints([(jcrs.g1_alpha, jcrs.g2_beta)])
    for name in ("A", "B", "C"):
        assert as_ints(getattr(tproof, name)) == as_ints(getattr(jproof, name)), name
    assert [x.e for x in tprover.wires.statement().to_dense()] == [1, 3, 35]


def test_pinocchio_crs_and_proof_equal_jax():
    jprover, jcrs, jproof = _pinocchio(JPin, JT, JP.SUBGROUP, JRng, 111, 222)
    tprover, tcrs, tproof = _pinocchio(TPin, TT, TP.SUBGROUP, TRng, 111, 222)
    assert tprover.max_degree == jprover.max_degree
    assert as_ints(tcrs.ek) == as_ints(jcrs.ek)
    assert as_ints(tcrs.vk) == as_ints(jcrs.vk)
    for name in ("v_mid_s", "g1_w_mid_s", "g2_w_mid_s", "y_mid_s", "h_s", "alpha_v_mid_s",
                 "alpha_w_mid_s", "alpha_y_mid_s", "beta_vwy_mid_s"):
        assert as_ints(getattr(tproof, name)) == as_ints(getattr(jproof, name)), name


@pytest.mark.slow
def test_groth16_verifies_and_rejects():
    jprover, jcrs, _ = _groth16(JG, JT, JP.SUBGROUP, JRng, JPairing(), 111, 222)
    tpairing = TPairing()
    tprover, tcrs, tproof = _groth16(TG, TT, TP.SUBGROUP, TRng, tpairing, 111, 222)
    assert as_ints(tcrs.gt_alpha_beta) == as_ints(jcrs.gt_alpha_beta)
    verifier = TG.Verifier(tpairing)
    assert verifier.verify(tproof, tcrs, tprover.wires.statement())
    assert not verifier.verify(tproof, tcrs, TVec.from_dense(TP.SUBGROUP, [1, 4, 35]))


@pytest.mark.slow
def test_pinocchio_verifies_and_rejects():
    tprover, tcrs, tproof = _pinocchio(TPin, TT, TP.SUBGROUP, TRng, 111, 222)
    verifier = TPin.Verifier()
    assert verifier.verify(tproof, tcrs, tprover.witness.io())
    assert not verifier.verify(tproof, tcrs, TVec.from_dense(TP.SUBGROUP, [1, 4, 35]))
    # the JAX package's verifier agrees on the JAX package's proof
    jprover, jcrs, jproof = _pinocchio(JPin, JT, JP.SUBGROUP, JRng, 111, 222)
    assert JPin.Verifier().verify(jproof, jcrs, jprover.witness.io())
    assert not JPin.Verifier().verify(jproof, jcrs, JVec.from_dense(JP.SUBGROUP, [1, 4, 35]))
