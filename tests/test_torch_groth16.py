"""The port's Groth16 prove (zk_toolkit_tpu_torch/protocols/groth16_device.py,
plain versions on the CPU) on the flagship circuit (x * x * x) + x + 5 == 35
with x = 3, the trapdoor and (r, s) = (4242, 5353) of
tests/test_groth16_device.py:

- CircuitMatrices, the host-mode DeviceCRS and h_coeffs_core equal the JAX
  package's, limb for limb (the JAX prove_core and MSM are never compiled);
- A, B, C equal the multiples of the generators that the trapdoor fixes,
  recomputed here from the JAX package's host tier;
- host_oracle_verify accepts the proof and rejects a tampered statement;
- a prove on crs_from_jax of the JAX package's CRS equals the prove on the
  port's own CRS;
- synthetic_r1cs, matrices_from_jax, the CRS's point modes and the entry
  points' default device;
- the device verifier (DeviceGroth16Verifier, the batched pairing product)
  on the JAX package's CRS (crs_from_jax) agrees with the JAX package's
  host_oracle_verify: it accepts the proof and rejects a tampered
  statement;
- save_crs / load_crs: a CRS saved by either package loads in the other
  with equal limbs, and a loaded CRS verifies the proof.

Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu.curves.bls12_381 import params
from zk_toolkit_tpu.protocols import groth16_device as JGD
from zk_toolkit_tpu.snark import term as JT
from zk_toolkit_tpu.snark.synthetic import synthetic_r1cs as j_synthetic_r1cs
from zk_toolkit_tpu.utils import host_curve as JHC
from zk_toolkit_tpu_torch import bench as TB
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.curves.bls12_381 import params as TP
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.protocols import groth16_device as TGD
from zk_toolkit_tpu_torch.snark import term as TT
from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs as t_synthetic_r1cs
from zk_toolkit_tpu_torch.utils import serialize as TS

R, Q = params.R, params.Q
EXPR = "(x * x * x) + x + 5 == 35"
TRAPDOOR = dict(tau=12345, alpha=777, beta=888, gamma=999, delta=111213)
RS = (4242, 5353)


def _witness_map(T, f):
    """The flagship witness over either package's terms T and field f."""
    return {T.One(): f.elem(1), T.Var("x"): f.elem(3), T.Out(): f.elem(35),
            T.TmpVar(1): f.elem(9), T.TmpVar(2): f.elem(27), T.TmpVar(3): f.elem(8),
            T.TmpVar(4): f.elem(35)}


@pytest.fixture(scope="module")
def flagship():
    jmat = JGD.CircuitMatrices.from_expr(EXPR)
    jcrs = JGD.DeviceCRS.from_trapdoor(jmat, point_mode="host", **TRAPDOOR)
    mat = TGD.CircuitMatrices.from_expr(EXPR, device="cpu")
    crs = TGD.DeviceCRS.from_trapdoor(mat, point_mode="host", device="cpu", **TRAPDOOR)
    prover = TGD.DeviceGroth16Prover(mat, _witness_map(TT, TP.SUBGROUP), device="cpu")
    proof = prover.prove_with_rs(crs, *RS)
    return dict(jmat=jmat, jcrs=jcrs, mat=mat, crs=crs, prover=prover, proof=proof)


def test_circuit_matrices_match_jax(flagship):
    jmat, mat = flagship["jmat"], flagship["mat"]
    assert (mat.n, mat.n_pad, mat.m, mat.l, mat.kmax) == (5, 8, 6, 2, 2)
    assert (mat.n, mat.n_pad, mat.m, mat.l, mat.kmax) == (
        jmat.n, jmat.n_pad, jmat.m, jmat.l, jmat.kmax)
    for name in convert.MATRIX_ARRAYS:
        got, want = getattr(mat, name), getattr(jmat, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)


@pytest.mark.parametrize("name", convert.CRS_POINTS)
def test_host_crs_matches_jax(flagship, name):
    for got, want in zip(getattr(flagship["crs"], name), getattr(flagship["jcrs"], name)):
        np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


def test_h_coeffs_core_matches_jax(flagship):
    jprover = JGD.DeviceGroth16Prover(flagship["jmat"], _witness_map(JT, params.SUBGROUP))
    want = JGD.h_coeffs_core(flagship["jmat"], jprover.w_mont)
    np.testing.assert_array_equal(convert.limbs_to_jax(flagship["prover"].h_coeffs_mont()),
                                  np.asarray(want))
    np.testing.assert_array_equal(convert.limbs_to_jax(flagship["prover"].w_mont),
                                  np.asarray(jprover.w_mont))


def _trapdoor_points(mat, wires, r, s, tau, alpha, beta, gamma, delta):
    """A, B, C from the trapdoor, as tests/test_groth16_device.py computes
    the scalars, through the JAX package's host tier."""
    from zk_toolkit_tpu.ops.ntt import fr_domain

    n = mat.n_pad
    w_root = fr_domain(n).w
    t_tau = (pow(tau, n, R) - 1) % R
    lag, wj = [], 1
    for _ in range(n):
        lag.append(t_tau * wj % R * pow((tau - wj) % R, -1, R) % R * pow(n, -1, R) % R)
        wj = wj * w_root % R
    u, v, w = ([0] * (mat.m + 1) for _ in range(3))
    for j, cons in enumerate(mat.tmpl.constraints):
        for acc, side in ((u, cons.a), (v, cons.b), (w, cons.c)):
            for idx, coeff in side:
                acc[idx] = (acc[idx] + coeff.e * lag[j]) % R
    ua, va, wa = (sum(a * x for a, x in zip(wires, col)) % R for col in (u, v, w))
    h_tau = (ua * va - wa) * pow(t_tau, -1, R) % R
    a_s = (alpha + ua + r * delta) % R
    b_s = (beta + va + s * delta) % R
    uvw_wit = sum(wires[i] * ((beta * u[i] + alpha * v[i] + w[i]) % R)
                  for i in range(mat.l + 1, mat.m + 1)) % R * pow(delta, -1, R) % R
    c_s = (uvw_wit + h_tau * t_tau % R * pow(delta, -1, R) + s * a_s + r * b_s
           - r * s % R * delta) % R
    f1, f2 = JHC.FpHost(Q), JHC.Fp2Host(Q)
    g1 = JHC.from_affine(f1, (TP.G1_X, TP.G1_Y))
    g2 = JHC.from_affine(f2, ((TP.G2_X0, TP.G2_X1), (TP.G2_Y0, TP.G2_Y1)))
    return tuple(JHC.jac_to_affine(f, JHC.jac_mul(f, g, k))
                 for f, g, k in ((f1, g1, a_s), (f2, g2, b_s), (f1, g1, c_s)))


def test_proof_matches_trapdoor_multiples(flagship):
    want = _trapdoor_points(flagship["mat"], flagship["prover"].wires, *RS, **TRAPDOOR)
    assert TB.proof_affine(flagship["proof"]) == want
    assert TB.trapdoor_proof(flagship["mat"], flagship["prover"].wires, *RS, **TRAPDOOR) == want
    assert all(t.shape[0] == 1 for t in flagship["proof"].a + flagship["proof"].c)
    assert flagship["proof"].b[0].shape == (1, 2, TL.field_spec(Q).K)


def test_host_oracle_verify_agrees(flagship):
    crs, prover, proof = flagship["crs"], flagship["prover"], flagship["proof"]
    assert TGD.host_oracle_verify(crs, proof, prover.statement())
    bad = list(prover.statement())
    bad[-1] = (bad[-1] + 1) % R
    assert not TGD.host_oracle_verify(crs, proof, bad)


def test_check_proof_refuses_a_wrong_proof(flagship):
    proof = flagship["proof"]
    swapped = TGD.DeviceProof(a=proof.c, b=proof.b, c=proof.a)
    with pytest.raises(RuntimeError, match="differs from the trapdoor"):
        TB.check_proof(flagship["crs"], flagship["prover"], swapped, *RS, trapdoor=TRAPDOOR)


def test_prove_on_jax_crs_equals_prove_on_own_crs(flagship):
    mat = convert.matrices_from_jax(flagship["jmat"], flagship["mat"].tmpl, "cpu")
    crs = convert.crs_from_jax(flagship["jcrs"], mat, "cpu")
    prover = TGD.DeviceGroth16Prover(mat, _witness_map(TT, TP.SUBGROUP), device="cpu")
    proof = prover.prove_with_rs(crs, *RS)
    for got, want in zip(proof.a + proof.b + proof.c,
                         flagship["proof"].a + flagship["proof"].b + flagship["proof"].c):
        assert torch.equal(got, want)


def test_matrices_from_jax_equal_the_ports_own(flagship):
    mat = convert.matrices_from_jax(flagship["jmat"], flagship["mat"].tmpl, "cpu")
    for name in convert.MATRIX_ARRAYS:
        assert torch.equal(getattr(mat, name), getattr(flagship["mat"], name))
    with pytest.raises(ValueError):
        bad = type("M", (), {n: getattr(flagship["jmat"], n) for n in convert.MATRIX_ARRAYS})
        bad.a_idx = bad.a_idx.astype(np.int64)
        convert.matrices_from_jax(bad, flagship["mat"].tmpl, "cpu")


def test_crs_refuses_an_unknown_point_mode(flagship):
    with pytest.raises(ValueError, match="point_mode"):
        TGD.DeviceCRS.from_trapdoor(flagship["mat"], point_mode="scan", device="cpu", **TRAPDOOR)


@pytest.mark.parametrize("n", [2, 16, 33])
def test_synthetic_r1cs_matches_jax(n):
    jtmpl, jwit = j_synthetic_r1cs(params.SUBGROUP, n, seed=2)
    ttmpl, twit = t_synthetic_r1cs(TP.SUBGROUP, n, seed=2)
    jmat = JGD.CircuitMatrices.from_tmpl(jtmpl)
    tmat = TGD.CircuitMatrices.from_tmpl(ttmpl, device="cpu")
    assert (tmat.n, tmat.n_pad, tmat.m, tmat.l, tmat.kmax) == (
        jmat.n, jmat.n_pad, jmat.m, jmat.l, jmat.kmax)
    for name in convert.MATRIX_ARRAYS:
        np.testing.assert_array_equal(
            getattr(tmat, name).numpy().astype(getattr(jmat, name).dtype), getattr(jmat, name))
    assert sorted(v.e for v in twit.values()) == sorted(v.e for v in jwit.values())
    prover = TGD.DeviceGroth16Prover(tmat, twit, device="cpu")      # validates the R1CS
    assert prover.statement()[0] == 1


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGD.CircuitMatrices.from_expr(EXPR)
    mat = TGD.CircuitMatrices.from_expr(EXPR, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGD.DeviceCRS.from_trapdoor(mat, point_mode="host", **TRAPDOOR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGD.DeviceCRS.generate(mat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGD.DeviceGroth16Prover(mat, _witness_map(TT, TP.SUBGROUP))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.bench_groth16(log2_n=1)


def _jax_affine(aff) -> tuple:
    """An affine (x, y, inf) tuple of the port as the JAX package's arrays."""
    return tuple(jnp.asarray(t.numpy() if t.dtype == torch.bool else convert.limbs_to_jax(t))
                 for t in aff)


@pytest.mark.parametrize("tamper", [False, True], ids=["statement", "tampered"])
def test_device_verifier_agrees_with_jax_host_oracle(flagship, tamper):
    mat = convert.matrices_from_jax(flagship["jmat"], flagship["mat"].tmpl, "cpu")
    crs = convert.crs_from_jax(flagship["jcrs"], mat, "cpu")
    proof, stmt = flagship["proof"], flagship["prover"].statement()
    if tamper:
        stmt = TB.tampered(stmt)
    got = TGD.DeviceGroth16Verifier().verify(proof, crs, stmt)
    jproof = JGD.DeviceProof(a=_jax_affine(proof.a), b=_jax_affine(proof.b),
                             c=_jax_affine(proof.c))
    assert got is (not tamper)
    assert got == JGD.host_oracle_verify(flagship["jcrs"], jproof, stmt)


def test_crs_saved_by_jax_loads_in_the_port(flagship, tmp_path):
    from zk_toolkit_tpu.utils.serialize import save_crs as j_save_crs

    path = str(tmp_path / "crs.npz")
    j_save_crs(path, flagship["jcrs"])
    crs = TS.load_crs(path, flagship["mat"], device="cpu")
    assert crs.mat is flagship["mat"]
    for name in convert.CRS_POINTS:
        for got, want in zip(getattr(crs, name), getattr(flagship["jcrs"], name)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(convert.limbs_to_jax(got), np.asarray(want))


def test_crs_saved_by_the_port_loads_in_jax(flagship, tmp_path):
    from zk_toolkit_tpu.utils.serialize import load_crs as j_load_crs

    path = str(tmp_path / "crs.npz")
    TS.save_crs(path, flagship["crs"])
    assert sorted(np.load(path).files) == sorted(
        f"{name}.{i}" for name in convert.CRS_POINTS for i in range(3))
    jcrs = j_load_crs(path, flagship["jmat"])
    for name in convert.CRS_POINTS:
        for got, want in zip(getattr(jcrs, name), getattr(flagship["crs"], name)):
            assert np.asarray(got).dtype == np.uint32
            np.testing.assert_array_equal(np.asarray(got), convert.limbs_to_jax(want))


def test_loaded_crs_verifies(flagship, tmp_path):
    path = str(tmp_path / "crs.npz")
    TS.save_crs(path, flagship["crs"])
    crs = TS.load_crs(path, flagship["mat"], device="cpu")
    for name in convert.CRS_POINTS:
        assert all(torch.equal(g, w) for g, w in zip(getattr(crs, name),
                                                     getattr(flagship["crs"], name)))
    assert TGD.DeviceGroth16Verifier().verify(flagship["proof"], crs,
                                              flagship["prover"].statement())
    with pytest.raises(ValueError, match="limb values"):
        bad = dict(np.load(path))
        bad["g1_xt.0"] = bad["g1_xt.0"] | (1 << 16)
        np.savez(path, **bad)
        TS.load_crs(path, flagship["mat"], device="cpu")


def test_load_crs_defaults_to_the_card(flagship, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    path = str(tmp_path / "crs.npz")
    TS.save_crs(path, flagship["crs"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.load_crs(path, flagship["mat"])
