"""The port's sharded layer (zk_toolkit_tpu_torch/parallel/) on gloo worlds
of CPU ranks, started by parallel.mesh.World (spawned processes, one pool
per world size in this file), mirroring tests/test_parallel.py:

- MSM: the naive, Pippenger and explicit sharded MSMs at worlds 2 and 4
  against the host oracle, the explicit one over 18 points at world 3;
  the explicit MSM's local phase makes 0 collectives and its fold one
  all_gather per coordinate (mesh.counts; the JAX test reads the HLO);
- against the JAX package directly, with no compile of a sharded module:
  sharded_ntt's _split, _mid_table and _coset_table arrays byte for byte,
  ops/ntt.dit_rows on a [3, 2^4, 16] batch run eagerly, ops/curve_ops.
  scan_fold on 5 secp256k1 points limb for limb in Jacobian form;
- NTT: the sharded NTT and INTT at 2^12 rows equal the single-device
  transforms; a transform is exactly 3 all_to_alls and nothing else;
  sharded_h_from_evs equals h_coset_then_coeffs; (slow) the 2^16 transform;
- the collectives themselves: all_reduce of arange(64); the sharded field
  multiply;
- IPA at n = 8: accept and reject equal the JAX package's host IPA on the
  same challenges; (slow) at tests/test_parallel.py's n = 32, equal to the
  port's DeviceBulletproofs too;
- (slow) the sharded Groth16 prove at 16 constraints equal to prove_with_rs
  after to_affine and accepted by host_oracle_verify; the batched pairing
  product with its rows split over the ranks; weak_scaling's JSON;
- refusals: "cuda" without a card, a world of more than one rank outside
  a World, a non-power-of-two IPA or NTT world, a wire count that does not
  split; a rank's exception re-raised by World.run.

Every comparison is exact (modular arithmetic; points compared in affine
form where the sharded sum adds partials in another order). The rank
functions are module-level (a World pickles them); the JAX package is
imported only inside the tests that compare with it, so the ranks, which
import this module, never load JAX.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import pytest
import torch

from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import ntt as NTT
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.parallel import mesh as MS
from zk_toolkit_tpu_torch.parallel import sharded_ipa as SI
from zk_toolkit_tpu_torch.parallel import sharded_msm as SM
from zk_toolkit_tpu_torch.parallel import sharded_ntt as SN
from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD

SECP = L.field_spec(secp256k1.P)
FR = L.field_spec(NTT.R)


@pytest.fixture(scope="module")
def world2():
    with MS.World(2, "cpu") as w:
        yield w


@pytest.fixture(scope="module")
def world3():
    with MS.World(3, "cpu") as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with MS.World(4, "cpu") as w:
        yield w


def _world(request, d: int) -> MS.World:
    return request.getfixturevalue(f"world{d}")


# -- MSM ----------------------------------------------------------------------------

def _msm_case(n: int, seed: int):
    """tests/test_parallel.py's case: n random secp256k1 points and 256-bit
    scalars from random.seed(seed), and the host sum."""
    random.seed(seed)
    pts = [secp256k1.g() * random.randrange(1, secp256k1.N) for _ in range(n)]
    ks = [random.randrange(0, secp256k1.N) for _ in range(n)]
    want = secp256k1.infinity()
    for p, k in zip(pts, ks):
        want = want + p * k
    return C.pack_points(pts, SECP, "cpu"), C.pack_scalars(ks, 256, "cpu"), (want.x.e, want.y.e)


_MSMS = {"naive": (SM.sharded_msm, {}), "pippenger": (SM.sharded_msm_pippenger, {"c": 4}),
         "explicit": (SM.sharded_msm_explicit, {"c": 4})}


def _msm_rank(mesh, which: str, n: int, seed: int):
    pts, sc, _ = _msm_case(n, seed)
    fn, kw = _MSMS[which]
    res = fn(FqOps(SECP), pts, sc, 256, mesh, **kw)
    return C.unpack_points(tuple(a[None] for a in res), SECP)[0], dict(mesh.counts)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("which, n, seed", [("naive", 16, 11), ("pippenger", 16, 12),
                                            ("explicit", 24, 14)])
def test_sharded_msm_matches_host_oracle(request, d, which, n, seed):
    got, counts = _world(request, d).run(_msm_rank, which, n, seed)
    assert got == _msm_case(n, seed)[2]
    assert counts == {"all_gather": 3}


def test_sharded_msm_explicit_nonpow2_world(world3):
    """18 points over 3 ranks (padded to 18, 6 a rank): the fold takes any
    world size."""
    got, counts = world3.run(_msm_rank, "explicit", 18, 15)
    assert got == _msm_case(18, 15)[2]
    assert counts == {"all_gather": 3}


def _phases_rank(mesh):
    pts, sc, _ = _msm_case(16, 16)
    ops = FqOps(SECP)
    part = SM.local_phase(ops, pts, sc[:, :2], 32, mesh, c=4)
    local = dict(mesh.counts)
    SM.gather_fold(ops, part, mesh)
    return local, dict(mesh.counts)


def test_sharded_msm_local_phase_collective_free(world4):
    local, total = world4.run(_phases_rank)
    assert local == {}
    assert total == {"all_gather": 3}


# -- against the JAX package, no compile ----------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_ntt_tables_match_jax(d):
    from zk_toolkit_tpu.parallel import sharded_ntt as JSN

    n = 1 << 12
    n1, n2 = SN._split(n, d)
    assert (n1, n2) == JSN._split(n, d)
    pairs = [(SN._mid_table(n, n1, inv, fold), JSN._mid_table(n, n1, inv, fold))
             for inv, fold in ((False, False), (True, True), (True, False))]
    pairs += [(SN._coset_table(n, n1, False), JSN._coset_table(n, n1, False)),
              (SN._coset_table(n, n2, True), JSN._coset_table(n, n2, True))]
    for got, want in pairs:
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_dit_rows_matches_jax(inverse):
    import jax.numpy as jnp

    from zk_toolkit_tpu.ops import ntt as JN

    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 16, size=(3, 16, FR.K), dtype=np.uint32)
    x[..., -1] &= 0x3FFF                                 # canonical: < 2^254 < r
    want = np.asarray(JN.dit_rows(JN.fr_domain(16), jnp.asarray(x), inverse))
    got = NTT.dit_rows(NTT.fr_domain(16, "cpu"), torch.from_numpy(x.astype(np.int32)), inverse)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_scan_fold_matches_jax():
    """5 rows P, -P, infinity, Q, Q: every case of the complete add (P + -P
    to infinity, infinity as either operand, the doubling Q + Q)."""
    import jax.numpy as jnp

    from zk_toolkit_tpu.ops import curve_ops as JC
    from zk_toolkit_tpu.ops import limbs as JL
    from zk_toolkit_tpu.ops.field_ops import FqOps as JFqOps

    random.seed(5)
    p, q = (secp256k1.g() * random.randrange(1, secp256k1.N) for _ in range(2))
    rows = [p, (p.x.e, (-p.y.e) % secp256k1.P), None, q, q]
    pts = C.pack_points(rows, SECP, "cpu")
    want = JC.scan_fold(JFqOps(JL.field_spec(secp256k1.P)),
                        tuple(jnp.asarray(a.numpy().astype(np.uint32)) for a in pts))
    got = C.scan_fold(FqOps(SECP), pts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


# -- NTT ---------------------------------------------------------------------------------

def _fr_rows(n: int, seed: int, batch: tuple = ()) -> torch.Tensor:
    raw = np.random.default_rng(seed).integers(0, 1 << 16, size=batch + (n, FR.K), dtype=np.int64)
    raw[..., -1] &= 0x3FFF                               # canonical: < 2^254 < r
    return torch.from_numpy(raw.astype(np.int32))


def _ntt_rank(mesh, n: int, seed: int):
    x = _fr_rows(n, seed)
    blk = MS.shard_leading(mesh, x)[None]
    SN._four_step(blk, n, mesh, inverse=False, fold_ninv=False, pre=False, post=False)
    one_transform = dict(mesh.counts)
    return SN.sharded_ntt(x, mesh), SN.sharded_intt(x, mesh), one_transform


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_ntt_matches_single_device(request, d):
    n = 1 << 12
    fwd, inv, counts = _world(request, d).run(_ntt_rank, n, 13)
    x, dom = _fr_rows(n, 13), NTT.fr_domain(n, "cpu")
    assert torch.equal(fwd, NTT.ntt(dom, x))
    assert torch.equal(inv, NTT.intt(dom, x))
    assert counts == {"all_to_all": 3}


def _h_rank(mesh, n: int):
    a, b, c = _fr_rows(n, 29, (3,))
    return SN.sharded_h_from_evs(a, b, c, mesh), dict(mesh.counts)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_h_from_evs(request, d):
    n = 1 << 12
    got, counts = _world(request, d).run(_h_rank, n)
    a, b, c = _fr_rows(n, 29, (3,))
    assert torch.equal(got, NTT.h_coset_then_coeffs(NTT.fr_domain(n, "cpu"), a, b, c))
    assert counts == {"all_to_all": 9, "all_gather": 1}


def _coset_rank(mesh, n: int):
    x = _fr_rows(n, 31)
    return SN.sharded_coset_ntt(x, mesh), SN.sharded_coset_intt(x, mesh)


def test_sharded_coset_transforms(world4):
    n = 1 << 8
    fwd, inv = world4.run(_coset_rank, n)
    x, dom = _fr_rows(n, 31), NTT.fr_domain(n, "cpu")
    assert torch.equal(fwd, NTT.coset_ntt(dom, x))
    assert torch.equal(inv, NTT.coset_intt(dom, x))


@pytest.mark.slow
def test_sharded_ntt_2pow16(world4):
    n = 1 << 16
    fwd, inv, _ = world4.run(_ntt_rank, n, 13)
    x, dom = _fr_rows(n, 13), NTT.fr_domain(n, "cpu")
    assert torch.equal(fwd, NTT.ntt(dom, x))
    assert torch.equal(inv, NTT.intt(dom, x))


# -- collectives and batches ---------------------------------------------------------------

def _all_reduce_rank(mesh):
    x = MS.shard_leading(mesh, torch.arange(64, dtype=torch.int64))
    return mesh.all_reduce(x.sum(0, keepdim=True)).item(), dict(mesh.counts)


@pytest.mark.parametrize("d", [2, 4])
def test_all_reduce(request, d):
    total, counts = _world(request, d).run(_all_reduce_rank)
    assert total == sum(range(64))
    assert counts == {"all_reduce": 1}


def _field_mul_rank(mesh, xs, ys):
    spec = L.field_spec(params.Q)
    a = MS.shard_leading(mesh, L.pack(xs, spec, device="cpu"))
    b = MS.shard_leading(mesh, L.pack(ys, spec, device="cpu"))
    out = mesh.all_gather(L.mont_mul(a, b, spec)).reshape(-1, spec.K)
    return L.unpack(out, spec)


def test_sharded_batch_field_mul(world4):
    random.seed(3)
    xs = [random.randrange(params.Q) for _ in range(64)]
    ys = [random.randrange(params.Q) for _ in range(64)]
    assert world4.run(_field_mul_rank, xs, ys) == [x * y % params.Q for x, y in zip(xs, ys)]


def _rank_id(mesh):
    return mesh.rank, mesh.world, str(mesh.device), mesh.backend


def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise KeyError("rank 1 fails")
    return mesh.rank


def test_world_returns_rank_0_and_reraises(world2):
    assert world2.run(_rank_id) == (0, 2, "cpu", "gloo")
    with pytest.raises(KeyError, match="rank 1 fails") as info:
        world2.run(_raise_on_rank_1)
    assert "rank 1 of 2 raised" in str(info.value.__cause__)
    assert world2.run(_rank_id) == (0, 2, "cpu", "gloo")      # the pool still serves


# -- IPA -----------------------------------------------------------------------------------

def _ipa_case(n: int = 32, seed: int = 21):
    """tests/test_parallel.py's IPA statement: bases, u, a, b, P = g^a h^b
    u^<a,b> and log2(n) challenges from random.seed(seed)."""
    random.seed(seed)
    f_n = secp256k1.curve_group()
    gg = [secp256k1.g() * random.randrange(1, secp256k1.N) for _ in range(n)]
    hh = [secp256k1.g() * random.randrange(1, secp256k1.N) for _ in range(n)]
    u = secp256k1.g() * random.randrange(1, secp256k1.N)
    a = [random.randrange(secp256k1.N) for _ in range(n)]
    b = [random.randrange(secp256k1.N) for _ in range(n)]
    c = sum(x * y for x, y in zip(a, b)) % secp256k1.N
    P = u * f_n.elem(c)
    for gi, ai in zip(gg, a):
        P = P + gi * f_n.elem(ai)
    for hi, bi in zip(hh, b):
        P = P + hi * f_n.elem(bi)
    chal = [random.randrange(1, secp256k1.N) for _ in range(n.bit_length() - 1)]
    return gg, hh, u, P, a, b, chal


def _ipa_args(n: int, perturb: bool):
    gg, hh, u, P, a, b, chal = _ipa_case(n)
    if perturb:
        P = P + secp256k1.g()
    pk = lambda pts: C.pack_points(pts, SECP, "cpu")
    return (n, pk(gg), pk(hh), pk([u]), pk([P]), BD._fr(a, "cpu"), BD._fr(b, "cpu"), chal)


def _ipa_rank(mesh, n: int):
    verdicts = [SI.sharded_ipa(mesh, *_ipa_args(n, perturb)) for perturb in (False, True)]
    return verdicts, dict(mesh.counts)


@functools.lru_cache(maxsize=None)
def _jax_host_ipa(n: int) -> list:
    """[true statement, P + G] verdicts of the JAX package's host IPA on
    the same challenges (a few seconds at n = 8)."""
    from zk_toolkit_tpu.curves import secp256k1 as JS
    from zk_toolkit_tpu.fields.prime_field import PrimeFieldElems
    from zk_toolkit_tpu.protocols import bulletproofs as JB
    from zk_toolkit_tpu.utils.rng import Rng

    class Replay(Rng):
        def __init__(self, values):
            super().__init__(0)
            self.values = list(values)

        def randint(self, lo, hi):
            return self.values.pop(0)

    _, _, _, _, a, b, chal = _ipa_case(n)
    random.seed(21)                                      # _ipa_case's draws, as JAX points
    gg = [JS.g() * random.randrange(1, JS.N) for _ in range(n)]
    hh = [JS.g() * random.randrange(1, JS.N) for _ in range(n)]
    u = JS.g() * random.randrange(1, JS.N)
    elems = lambda xs: PrimeFieldElems([JS.curve_group().elem(x) for x in xs])
    P = u * (sum(x * y for x, y in zip(a, b)) % JS.N)
    for gi, ai in zip(gg, a):
        P = P + gi * ai
    for hi, bi in zip(hh, b):
        P = P + hi * bi
    return [JB.Bulletproofs(Replay(chal)).inner_product_argument(
        n, JS.AffinePoints(gg), JS.AffinePoints(hh), u, host_P, elems(a), elems(b))
        for host_P in (P, P + JS.g())]


@functools.lru_cache(maxsize=None)
def _device_ipa(n: int) -> list:
    """The same verdicts from the port's single-device DeviceBulletproofs
    (~40 s each on the CPU at n = 4 to 32: the plain versions' Horner over
    256 one-bit windows dominates)."""
    return [BD.DeviceBulletproofs(list(_ipa_case(n)[-1])).inner_product_argument(
        *_ipa_args(n, perturb)[:-1]) for perturb in (False, True)]


def _check_ipa(world: MS.World, n: int, d: int) -> list:
    verdicts, counts = world.run(_ipa_rank, n)
    assert verdicts == [True, False] == _jax_host_ipa(n)
    rounds = (n // d).bit_length() - 1                   # sharded rounds, then the tail
    assert counts == {"all_gather": 2 * (2 * rounds + 1)}
    return verdicts


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_ipa(request, d):
    """n = 8: sharded rounds at both worlds, then the replicated tail;
    against the JAX package's host IPA."""
    _check_ipa(_world(request, d), 8, d)


@pytest.mark.slow
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_ipa_n32(request, d):
    """tests/test_parallel.py's n = 32, against the JAX package's host IPA
    and the port's DeviceBulletproofs."""
    assert _check_ipa(_world(request, d), 32, d) == _device_ipa(32)


# -- refusals --------------------------------------------------------------------------------

def test_make_mesh_refuses_what_it_cannot_serve():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MS.make_mesh(2, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MS.World(2, "cuda")
    with pytest.raises(ValueError, match="runs in 2 processes"):
        MS.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="takes the gloo backend"):
        MS.make_mesh(1, device="cpu", backend="nccl")


def test_world_of_one_in_process():
    with MS.make_mesh(1, "cpu") as mesh:
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        pts, sc, want = _msm_case(8, 17)
        res = SM.sharded_msm_explicit(FqOps(SECP), pts, sc, 256, mesh, c=4)
        assert C.unpack_points(tuple(a[None] for a in res), SECP)[0] == want
    assert not torch.distributed.is_initialized()


def _ipa_world3_rank(mesh):
    SI.sharded_ipa(mesh, *_ipa_args(4, False))


def _ntt_world3_rank(mesh):
    SN.sharded_ntt(_fr_rows(64, 1), mesh)


def _prove_unsplit_wires_rank(mesh):
    from zk_toolkit_tpu_torch.parallel.sharded_groth16 import sharded_prove
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    tmpl, wit = synthetic_r1cs(params.SUBGROUP, 16, seed=7)   # 18 wires
    sharded_prove(mesh, GD.CircuitMatrices.from_tmpl(tmpl, "cpu"), None, [0] * 18, 11, 13)


def test_sharded_refusals(world3, world4):
    with pytest.raises(ValueError, match="power-of-two n and mesh size"):
        world3.run(_ipa_world3_rank)
    with pytest.raises(ValueError, match="d \\| n1 and d \\| n2"):
        world3.run(_ntt_world3_rank)
    with pytest.raises(ValueError, match="18 wires do not split over 4 ranks"):
        world4.run(_prove_unsplit_wires_rank)


# -- slow: the prove, the pairing product, weak_scaling -----------------------------------------

def _groth16_case():
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark.synthetic import synthetic_r1cs

    tmpl, wit = synthetic_r1cs(params.SUBGROUP, 16, seed=7, pad_wires_to=8)
    mat = GD.CircuitMatrices.from_tmpl(tmpl, "cpu")
    crs = GD.DeviceCRS.from_trapdoor(mat, tau=5, alpha=6, beta=7, gamma=8, delta=9,
                                     point_mode="host", device="cpu")
    return mat, crs, GD.DeviceGroth16Prover(mat, wit, "cpu")


def _prove_rank(mesh, r: int, s: int):
    from zk_toolkit_tpu_torch.parallel.sharded_groth16 import sharded_prove

    mat, crs, prover = _groth16_case()
    proof = sharded_prove(mesh, mat, crs, prover.wires, r, s)
    return proof, dict(mesh.counts)


@pytest.mark.slow
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_groth16_prove(request, d):
    """Both worlds take the four-step quotient (n_pad = 16 >= d^2)."""
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD

    proof, counts = _world(request, d).run(_prove_rank, 11, 13)
    assert counts == {"all_to_all": 9, "all_gather": 2}
    mat, crs, prover = _groth16_case()
    ref = prover.prove_with_rs(crs, 11, 13)
    for got, want in zip(proof.a + proof.b + proof.c, ref.a + ref.b + ref.c):
        assert torch.equal(got, want)
    assert GD.host_oracle_verify(crs, proof, prover.statement())


def _pairing_case():
    """8 rows e(aG1, bG2) e(-(ab)G1, G2) == 1, row 5 corrupted, from
    random.seed(41): packed affine [8, 2] pairs and the expected verdicts."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
    from zk_toolkit_tpu_torch.ops import pairing_ops as PO

    spec = L.field_spec(params.Q)
    random.seed(41)
    b = 8
    p_rows, q_rows, expect = [], [], []
    for i in range(b):
        a_s, b_s = random.randrange(1, 1 << 30), random.randrange(1, 1 << 30)
        p2 = g1.g() * ((-(a_s * b_s) + (7 if i == 5 else 0)) % params.R)
        p_rows += [g1.g() * a_s, p2]
        q_rows += [g2.g() * b_s, g2.g()]
        expect.append(i != 5)
    pa = tuple(a.reshape((b, 2) + a.shape[1:]) for a in PO.pack_g1_affine(p_rows, spec, "cpu"))
    qa = tuple(a.reshape((b, 2) + a.shape[1:]) for a in PO.pack_g2_affine(q_rows, spec, "cpu"))
    return pa, qa, expect


def _pairing_rank(mesh):
    from zk_toolkit_tpu_torch.ops import pairing_ops as PO

    pa, qa, _ = _pairing_case()
    ok = PO.pairing_product_is_one(PO.bls_pairing_ops(), MS.shard_leading(mesh, pa),
                                   MS.shard_leading(mesh, qa))
    return mesh.all_gather(ok).reshape(-1).tolist()


@pytest.mark.slow
def test_sharded_batch_pairing_product(world4):
    from zk_toolkit_tpu_torch.ops import pairing_ops as PO

    pa, qa, expect = _pairing_case()
    want = PO.pairing_product_is_one(PO.bls_pairing_ops(), pa, qa).tolist()
    assert want == expect
    assert world4.run(_pairing_rank) == want


@pytest.mark.slow
def test_weak_scaling_prints_checked_json(capsys):
    import json

    from zk_toolkit_tpu_torch.parallel import weak_scaling

    assert weak_scaling.main(["--device", "cpu", "--world", "2", "--msm-local", "8",
                              "--ntt-local", "16", "--prove-n", "16"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["worlds"] == [1, 2]
    for d in ("1", "2"):
        assert out["msm"][d]["correct_vs_host_oracle"]
        assert out["msm"][d]["collectives_per_run"] == {"all_gather": 3.0}
        assert out["ntt"][d]["collectives_per_run"] == {"all_to_all": 3.0, "all_gather": 1.0}
        assert out["groth16_prove"][d]["verified_host_oracle"]
