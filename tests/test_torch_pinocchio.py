"""The port's Pinocchio (zk_toolkit_tpu_torch/protocols/pinocchio_device.py,
plain versions on the CPU) on the flagship circuit (x * x * x) + x + 5 == 35
with x = 3, the trapdoor and deltas of tests/test_pinocchio_device.py:

- the nine proof elements equal their trapdoor scalars times the G1 / G2
  generators, the scalars recomputed here from the trapdoor and the witness
  through the JAX package's NTT domain and host tier;
- the device verifier (five rows of three pairs, one batched pairing
  product) accepts the proof (test_prove_and_verify) and rejects a wrong
  statement (test_wrong_io_rejected), the cases of the JAX package's
  tests/test_pinocchio_device.py;
- the CRS's evaluation key equals the trapdoor multiples; the entry points
  default to the card.

Tolerance: exact equality.
"""

from __future__ import annotations

import pytest
import torch

from zk_toolkit_tpu.curves.bls12_381 import params
from zk_toolkit_tpu.ops.ntt import fr_domain as j_fr_domain
from zk_toolkit_tpu.utils import host_curve as JHC
from zk_toolkit_tpu_torch import bench as TB
from zk_toolkit_tpu_torch.curves.bls12_381 import params as TP
from zk_toolkit_tpu_torch.protocols import groth16_device as TGD
from zk_toolkit_tpu_torch.protocols import pinocchio_device as TPD
from zk_toolkit_tpu_torch.snark import term as TT

R, Q = params.R, params.Q
EXPR = "(x * x * x) + x + 5 == 35"
TRAPDOOR = dict(r_v=3, r_w=5, alpha_v=7, alpha_w=11, alpha_y=13, beta=17, gamma=19, s=23456789)
DELTAS = (424243, 535354)
G1 = (TP.G1_X, TP.G1_Y)
G2 = ((TP.G2_X0, TP.G2_X1), (TP.G2_Y0, TP.G2_Y1))


def _witness_map():
    f = TP.SUBGROUP
    return {TT.One(): f.elem(1), TT.Var("x"): f.elem(3), TT.Out(): f.elem(35),
            TT.TmpVar(1): f.elem(9), TT.TmpVar(2): f.elem(27), TT.TmpVar(3): f.elem(8),
            TT.TmpVar(4): f.elem(35)}


@pytest.fixture(scope="module")
def setup():
    mat = TGD.CircuitMatrices.from_expr(EXPR, device="cpu")
    crs = TPD.DevicePinocchioCRS.from_trapdoor(mat, **TRAPDOOR, device="cpu")
    prover = TPD.DevicePinocchioProver(mat, _witness_map(), device="cpu")
    proof = prover.prove_with_deltas(crs, *DELTAS)
    return mat, crs, prover, proof


def _qap_at_s(mat, s):
    """v_i(s), w_i(s), y_i(s) and t(s) over the JAX package's NTT domain."""
    n = mat.n_pad
    w = j_fr_domain(n).w
    t_s = (pow(s, n, R) - 1) % R
    lag, wj = [], 1
    for _ in range(n):
        lag.append(t_s * wj % R * pow((s - wj) % R, -1, R) % R * pow(n, -1, R) % R)
        wj = wj * w % R
    cols = [[0] * (mat.m + 1) for _ in range(3)]
    for j, cons in enumerate(mat.tmpl.constraints):
        for col, side in zip(cols, (cons.a, cons.b, cons.c)):
            for idx, coeff in side:
                col[idx] = (col[idx] + coeff.e * lag[j]) % R
    return cols, t_s


def _want_scalars(mat, wires, dv, dy, r_v, r_w, alpha_v, alpha_w, alpha_y, beta, gamma, s):
    (vs, ws, ys), t_s = _qap_at_s(mat, s)
    r_y = r_v * r_w % R
    mid = range(mat.l + 1, mat.m + 1)
    v, w, y = (sum(wires[i] * col[i] for i in mid) % R for col in (vs, ws, ys))
    a, b, c = (sum(x * k for x, k in zip(wires, col)) % R for col in (vs, ws, ys))
    t = r_y * t_s % R
    return {
        "v_mid_s": dv * t + r_v * v, "g1_w_mid_s": r_w * w, "g2_w_mid_s": r_w * w,
        "y_mid_s": dy * t + r_y * y,
        "h_s": (a * b - c) * pow(t_s, -1, R) + dv * r_w * b - dy,
        "alpha_v_mid_s": alpha_v * (dv * t + r_v * v), "alpha_w_mid_s": alpha_w * r_w * w,
        "alpha_y_mid_s": alpha_y * (dy * t + r_y * y),
        "beta_vwy_mid_s": beta * ((dv + dy) * t + r_v * v + r_w * w + r_y * y),
    }


def test_proof_matches_trapdoor_multiples(setup):
    mat, _, prover, proof = setup
    want = {k: v % R for k, v in _want_scalars(mat, prover.wires, *DELTAS, **TRAPDOOR).items()}
    assert TB.pinocchio_trapdoor_scalars(mat, prover.wires, *DELTAS, **TRAPDOOR) == want
    f1, f2 = JHC.FpHost(Q), JHC.Fp2Host(Q)
    for name, k in want.items():
        if name in TB.PINOCCHIO_G2:
            assert TB.g2_affine(getattr(proof, name)) == JHC.jac_to_affine(
                f2, JHC.jac_mul(f2, JHC.from_affine(f2, G2), k)), name
        else:
            assert TB.g1_affine(getattr(proof, name)) == JHC.jac_to_affine(
                f1, JHC.jac_mul(f1, JHC.from_affine(f1, G1), k)), name
    TB.check_pinocchio_proof(prover, proof, DELTAS, TRAPDOOR)
    swapped = TPD.DeviceProof(**{**proof.__dict__, "v_mid_s": proof.y_mid_s})
    with pytest.raises(RuntimeError, match="v_mid_s differs"):
        TB.check_pinocchio_proof(prover, swapped, DELTAS, TRAPDOOR)


def test_crs_keys_are_trapdoor_multiples(setup):
    mat, crs, _, _ = setup
    (vs, _, _), t_s = _qap_at_s(mat, TRAPDOOR["s"])
    r_y = TRAPDOOR["r_v"] * TRAPDOOR["r_w"] % R
    mid = range(mat.l + 1, mat.m + 1)
    f1 = JHC.FpHost(Q)
    g = JHC.from_affine(f1, G1)
    got = [TB.g1_affine(tuple(c[i:i + 1] for c in crs.ek["vk_mid"])) for i in range(len(mid))]
    assert got == [JHC.jac_to_affine(f1, JHC.jac_mul(f1, g, TRAPDOOR["r_v"] * vs[i] % R))
                   for i in mid]
    assert TB.g1_affine(crs.vk["t"]) == JHC.jac_to_affine(f1, JHC.jac_mul(f1, g, r_y * t_s % R))
    assert crs.ek["si"][0].shape == (mat.n_pad, 2, 24)


def test_prove_and_verify(setup):
    _, crs, prover, proof = setup
    assert TPD.DevicePinocchioVerifier().verify(proof, crs, prover.statement())


def test_wrong_io_rejected(setup):
    _, crs, prover, proof = setup
    assert not TPD.DevicePinocchioVerifier().verify(proof, crs, TB.tampered(prover.statement()))


def test_entry_points_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    mat = setup[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPD.DevicePinocchioCRS.from_trapdoor(mat, **TRAPDOOR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPD.DevicePinocchioProver(mat, _witness_map())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.bench_pinocchio(log2_n=1)
