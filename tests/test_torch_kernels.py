"""The port's kernels B1 (mont_mul, and its static-exponent chain), B2
(point_add), B3 (point_double).

The tests marked `cuda` need the card: each kernel against its plain
PyTorch version on the same inputs on the card, bit for bit (tolerance 0:
integer arithmetic), at batches that are not a multiple of the block size
(1, 255, 257, 513, 1025), on the corner residues and on every case class
of the complete addition; then the MSM through the kernels against the
plain MSM and the host oracle; then the pairing path: Fq12 products,
inverses and Frobenius maps at the verify's and bench_pairing's stacks,
pairing_e against the host optimal-ate, and the Groth16 verify; then the
secp256k1 tier at K = 16: msm_pippenger_many and the ECDSA batch functions
on the card against the same calls on CPU tensors; then mont_pow_dynamic
against its plain version; then the sharded layer's explicit MSM on a
world of one over NCCL against msm_pippenger. This file imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The unmarked tests check on the CPU the layout logic the kernels rely on.
"""

from __future__ import annotations

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from zk_toolkit_tpu_torch import _build
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_kernels as CK
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as M
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.protocols.groth16_device import fixed_base_g1
from zk_toolkit_tpu_torch.utils import host_curve as HC
from zk_toolkit_tpu_torch.utils import samples as S

SECP256K1_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
Q25519 = 2**255 - 19
BATCHES = (1, 255, 257, 513, 1025)
FIELDS = [params.Q, params.R, SECP256K1_P, Q25519]
FIELD_IDS = ["fq", "fr", "secp256k1", "q25519"]
# Unreduced corner values B1 takes at q25519: the Ed25519 decode reads y
# from the bytes of an encoding, so a rejected row can hold y in [q, 2^255).
ABOVE_P = {Q25519: (Q25519, Q25519 + 1, 2**255 - 1)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernels.py")
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- on the CPU: the views the kernels read --------------------------------------

def test_as_rows_keeps_strided_views_and_copies_misaligned_ones():
    buf = torch.zeros(2, 64, 72, dtype=torch.int32)
    even_y = buf[:, 0::2, 24:48]                 # an up-sweep operand
    r = CK.as_rows(even_y, 24)
    assert r.data_ptr() == even_y.data_ptr() and r.stride() == (144, 1)
    bcast = torch.zeros(24, dtype=torch.int32).expand(5, 24)
    assert CK.as_rows(bcast, 24).stride() == (0, 1)
    odd = torch.zeros(10, 26, dtype=torch.int32)[:, 1:25]   # row stride 26
    r = CK.as_rows(odd, 24)
    assert r.is_contiguous() and torch.equal(r, odd)
    with pytest.raises(ValueError):
        CK.as_rows(torch.zeros(3, 24, dtype=torch.int64), 24)


def test_launch_refuses_cpu_operands():
    spec = L.field_spec(params.Q)
    a = torch.zeros(4, 24, dtype=torch.int32)
    with pytest.raises(ValueError, match="on CUDA"):
        _build.check_view(a, spec.K)


def test_build_key_changes_with_the_sources(tmp_path, monkeypatch):
    before = _build.lib_path("point_add")
    assert before.startswith(_build.BUILD_DIR) and before.endswith(".so")
    src = tmp_path / "csrc"
    src.mkdir()
    for f in ["point_add.cu"] + [os.path.basename(h) for h in glob.glob(f"{_build.CSRC}/*.cuh")]:
        shutil.copy(f"{_build.CSRC}/{f}", src / f)
    monkeypatch.setattr(_build, "CSRC", str(src))
    assert _build.lib_path("point_add") == before
    (src / "field.cuh").write_text(open(src / "field.cuh").read() + "\n// changed\n")
    assert _build.lib_path("point_add") != before


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116point_add_kernelILi8EEEvN3zkt5ViewsILi9EEExNS1_7ModulusIXT_EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116point_add_kernelILi8EEEvN3zkt5ViewsILi9EEExNS1_7ModulusIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 560 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116point_add_kernelILi12EEEvN3zkt5ViewsILi9EEExNS1_7ModulusIXT_EEE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116point_add_kernelILi12EEEvN3zkt5ViewsILi9EEExNS1_7ModulusIXT_EEE
    16 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 576 bytes cumulative stack size
"""


def test_ptxas_report_is_parsed_per_instantiation():
    assert _build.parse_ptxas(PTXAS_LOG) == {
        8: {"stack_bytes": 0, "spill_bytes": 0, "registers": 96},
        12: {"stack_bytes": 16, "spill_bytes": 40, "registers": 128},
    }


def test_ptxas_report_of_one_entry_of_a_library():
    """mont_mul.cu holds two entries: each is read under its own name."""
    log = PTXAS_LOG.replace("116point_add_kernelILi8", "115mont_pow_kernelILi8")
    assert _build.parse_ptxas(log, "mont_pow_kernel") == {
        8: {"stack_bytes": 0, "spill_bytes": 0, "registers": 96}}
    assert _build.parse_ptxas(log, "point_add_kernel") == {
        12: {"stack_bytes": 16, "spill_bytes": 40, "registers": 128}}
    assert _build.ENTRIES["mont_pow"] == "mont_mul"


def test_plain_wrappers_never_launch_on_cpu():
    spec = L.field_spec(params.Q)
    ops = FqOps(spec)
    counts = (L._mont_mul_fused.launches, CK.point_add_fused.launches,
              CK.point_double_fused.launches)
    p, q = S.point_pairs(np.random.default_rng(1), 8, "cpu")
    C.point_add(ops, p, q)
    C.point_double(ops, p)
    ops.mul(p[0], q[0])
    assert counts == (L._mont_mul_fused.launches, CK.point_add_fused.launches,
                      CK.point_double_fused.launches)


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("p", FIELDS, ids=FIELD_IDS)
def test_mont_mul_kernel_matches_plain(card, p):
    spec = L.field_spec(p)
    rng = np.random.default_rng(5)
    for n in BATCHES:
        a, b = S.corner_pairs(rng, n, spec, card, above_p=ABOVE_P.get(p, ()))
        before = L._mont_mul_fused.launches
        got = L.mont_mul(a, b, spec)
        assert L._mont_mul_fused.launches == before + 1
        assert torch.equal(got, L.mont_mul_plain(a, b, spec)), n


@pytest.mark.cuda
@pytest.mark.parametrize("p", FIELDS, ids=FIELD_IDS)
def test_mont_pow_chain_kernel_matches_plain_chain(card, p):
    """B1's chain entry against the plain chain of products: p - 2, a short
    exponent and one of 402 bits (two launches), zero rows included, and at
    q25519 the Ed25519 square root's (q+3)/8; one launch per 384 exponent
    bits."""
    spec = L.field_spec(p)
    rng = np.random.default_rng(13)
    long_exp = (1,) + tuple(int(b) for b in rng.integers(0, 2, 401))
    extra = (tuple(int(b) for b in bin((p + 3) // 8)[2:]),) if p == Q25519 else ()
    for n in BATCHES:
        a = S.chain_inputs(rng, n, spec, card)
        for bits in (spec.p_minus_2_bits, (1, 0, 1), long_exp) + extra:
            before = L._mont_mul_fused.launches
            got = L.mont_pow_static(a, bits, spec)
            assert L._mont_mul_fused.launches == before + len(L.exp_chunks(bits))
            assert torch.equal(got, L.mont_pow_static_plain(a, bits, spec)), (n, len(bits))


@pytest.mark.cuda
def test_inverse_is_one_chain_launch_and_the_plain_one_none(card):
    spec = L.field_spec(params.Q)
    a = S.chain_inputs(np.random.default_rng(14), 257, spec, card)
    before = L._mont_mul_fused.launches
    want = FqOps(spec, plain=True).inv(a)
    assert L._mont_mul_fused.launches == before
    assert torch.equal(FqOps(spec).inv(a), want)
    assert L._mont_mul_fused.launches == before + 1


@pytest.mark.cuda
def test_point_kernels_match_plain_on_every_case_class(card):
    spec = L.field_spec(params.Q)
    ops, plain = FqOps(spec), FqOps(spec, plain=True)
    rng = np.random.default_rng(6)
    for n in BATCHES:
        p, q = S.point_pairs(rng, n, card)
        _equal(C.point_add(ops, p, q), C._point_add_formula(plain, p, q))
        _equal(C.point_double(ops, p), C._point_double_formula(plain, p))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 2, 8])
def test_r_fold_doubling_kernel_matches_r_plain_doublings(card, r):
    spec = L.field_spec(params.Q)
    plain = FqOps(spec, plain=True)
    rng = np.random.default_rng(10 + r)
    for n in BATCHES:
        p, _ = S.point_pairs(rng, n, card)
        before = CK.point_double_fused.launches
        got = C.point_double_n(FqOps(spec), p, r)
        assert CK.point_double_fused.launches == before + 1
        _equal(got, C.point_double_n(plain, p, r))


def _triples_k16(rng, n, spec, dev):
    """P, Q rows of random canonical (x, y, z) over a 256-bit field (the
    kernels' formulas do not need a curve point): row % 6 is 0 P == Q
    (another representative), 1 P == -Q, 2 P = inf, 3 Q = inf, 4 both
    inf, 5 generic."""
    mul = lambda a, b: L.mont_mul_plain(a, b, spec)
    p = tuple(S.random_field(rng, n, spec, dev) for _ in range(3))
    q = tuple(S.random_field(rng, n, spec, dev) for _ in range(3))
    lam = S.random_field(rng, n, spec, dev)
    l2 = mul(lam, lam)
    same = (mul(p[0], l2), mul(p[1], mul(l2, lam)), mul(p[2], lam))
    case = (torch.arange(n, device=dev) % 6)[:, None]
    q = tuple(torch.where(case <= 1, s_, q_) for s_, q_ in zip(same, q))
    q = (q[0], torch.where(case == 1, L.neg_mod(q[1], spec), q[1]), q[2])
    zero = torch.zeros_like(p[2])
    p = (p[0], p[1], torch.where((case == 2) | (case == 4), zero, p[2]))
    q = (q[0], q[1], torch.where((case == 3) | (case == 4), zero, q[2]))
    return p, q


@pytest.mark.cuda
@pytest.mark.parametrize("p", [params.R, SECP256K1_P], ids=["fr", "secp256k1"])
def test_point_kernels_k16_build_matches_plain(card, p):
    """B2 and B3 at K = 16 (the N = 8 instantiation, CIOS products) against
    their plain versions."""
    spec = L.field_spec(p)
    plain = FqOps(spec, plain=True)
    rng = np.random.default_rng(12)
    for n in BATCHES:
        pp, qq = _triples_k16(rng, n, spec, card)
        _equal(CK.point_add_fused(pp, qq, spec), C._point_add_formula(plain, pp, qq))
        _equal(CK.point_double_n_fused(pp, spec, 2), C.point_double_n(plain, pp, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(64, 8), (257, 4)])
def test_msm_on_card_matches_plain_and_host_oracle(card, n, c):
    spec = L.field_spec(params.Q)
    rng = np.random.default_rng(n)
    ks = [int(x) for x in rng.integers(1, 1 << 62, n)]
    ks[3] = ks[2]
    affs = [HC.g1_mul_affine(k) for k in ks]
    sc = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    sc[:, 15] &= 0x7FFF
    scalars = torch.from_numpy(sc.astype(np.int32)).to(card)
    pts = C.pack_points(affs, spec, device=card)
    before = CK.point_add_fused.launches
    got = M.msm_pippenger(FqOps(spec), pts, scalars, 255, c=c)
    assert CK.point_add_fused.launches > before
    _equal(got, M.msm_pippenger(FqOps(spec, plain=True), pts, scalars, 255, c=c))
    k_limbs = np.array([[k >> (16 * i) & 0xFFFF for i in range(16)] for k in ks], dtype=np.uint32)
    want = HC.g1_mul_affine(HC._limb_dot_mod_r(k_limbs, sc, 255))
    assert C.unpack_points(tuple(a[None] for a in got), spec)[0] == want


@pytest.mark.cuda
def test_fixed_base_g1_on_card_matches_host(card):
    ks = [0, 1, 5, params.R - 1, params.R, 2**256 - 1]
    limbs = np.array([[k >> (16 * i) & 0xFFFF for i in range(16)] for k in ks], dtype=np.int32)
    pts = fixed_base_g1(torch.from_numpy(limbs).to(card))
    assert C.unpack_points(pts, L.field_spec(params.Q)) == [HC.g1_mul_affine(k) for k in ks]


@pytest.mark.cuda
@pytest.mark.parametrize("n", BATCHES[:3])
def test_fq2_ops_on_card_match_plain(card, n):
    """Fq2 mul/sq/inv on the card (B1 and its chain) against Fq2Ops over
    the plain FqOps on the same card tensors; zero, one and u among the
    rows."""
    from zk_toolkit_tpu_torch.ops.tower_ops import Fq2Ops

    spec = L.field_spec(params.Q)
    rng = np.random.default_rng(n)
    a = S.random_field(rng, 2 * n, spec, card).view(n, 2, spec.K)
    b = S.random_field(rng, 2 * n, spec, card).view(n, 2, spec.K)
    e2, plain = Fq2Ops(FqOps(spec)), Fq2Ops(FqOps(spec, plain=True))
    a[0] = 0
    if n > 2:
        a[1] = e2.one_like(a[1])
        a[2, 0], a[2, 1] = 0, a[1, 0]
    before = L._mont_mul_fused.launches
    _equal((e2.mul(a, b), e2.sq(a), e2.inv(a)), (plain.mul(a, b), plain.sq(a), plain.inv(a)))
    assert L._mont_mul_fused.launches - before == 1 + 1 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1024])
def test_ntt_on_card_matches_plain(card, n):
    """The four transforms and the coset quotient on the card (products on
    B1) against the same functions on the CPU."""
    from zk_toolkit_tpu_torch.ops import ntt as N

    spec = L.field_spec(params.R)
    rng = np.random.default_rng(n)
    xs = [S.random_field(rng, n, spec, card) for _ in range(3)]
    dev_dom, cpu_dom = N.fr_domain(n, card), N.fr_domain(n, "cpu")
    for fn in (N.ntt, N.intt, N.coset_ntt, N.coset_intt):
        assert torch.equal(fn(dev_dom, xs[0]).cpu(), fn(cpu_dom, xs[0].cpu()))
    assert torch.equal(N.h_coset_then_coeffs(dev_dom, *xs).cpu(),
                       N.h_coset_then_coeffs(cpu_dom, *(x.cpu() for x in xs)))


@pytest.mark.cuda
def test_groth16_flagship_on_card_matches_trapdoor(card):
    """The flagship circuit proved on the card (host-mode CRS): A, B, C are
    the trapdoor's multiples of the generators, and B1, B2, B3 all ran."""
    from zk_toolkit_tpu_torch import bench as B
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark import term as T

    f = params.SUBGROUP
    wm = {T.One(): f.elem(1), T.Var("x"): f.elem(3), T.Out(): f.elem(35),
          T.TmpVar(1): f.elem(9), T.TmpVar(2): f.elem(27), T.TmpVar(3): f.elem(8),
          T.TmpVar(4): f.elem(35)}
    trapdoor = dict(tau=12345, alpha=777, beta=888, gamma=999, delta=111213)
    mat = GD.CircuitMatrices.from_expr("(x * x * x) + x + 5 == 35", device=card)
    crs = GD.DeviceCRS.from_trapdoor(mat, point_mode="host", device=card, **trapdoor)
    prover = GD.DeviceGroth16Prover(mat, wm, device=card)
    counts = [L._mont_mul_fused.launches, CK.point_add_fused.launches,
              CK.point_double_fused.launches]
    proof = prover.prove_with_rs(crs, 4242, 5353)
    after = [L._mont_mul_fused.launches, CK.point_add_fused.launches,
             CK.point_double_fused.launches]
    assert all(a > b for a, b in zip(after, counts))
    assert B.proof_affine(proof) == B.trapdoor_proof(mat, prover.wires, 4242, 5353, **trapdoor)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(1, 4), (256,)], ids=["verify_1x4", "pairing_256"])
def test_fq12_stack_on_card_matches_plain(card, lead):
    """Fq12 mul/sq/inv and frobenius on the card against the same ops over
    the plain FqOps, at the verify's [1, 4] and bench_pairing's [256]
    batches: an Fq12 product is one B1 launch over 54 stacked rows."""
    from zk_toolkit_tpu_torch.ops import pairing_ops as P

    spec = L.field_spec(params.Q)
    rng = np.random.default_rng(sum(lead))
    n = int(np.prod(lead))
    a = S.random_field(rng, 12 * n, spec, card).view(lead + (2, 3, 2, spec.K))
    b = S.random_field(rng, 12 * n, spec, card).view(lead + (2, 3, 2, spec.K))
    a.view(-1, 12, spec.K)[0] = 0
    po, plain = P.bls_pairing_ops(), P.bls_pairing_ops(plain=True)
    launches = []
    before = L._mont_mul_fused.launches
    got = po.e12.mul(a, b)
    launches.append(L._mont_mul_fused.launches - before)
    _equal((got, po.e12.sq(a), po.e12.inv(a)),
           (plain.e12.mul(a, b), plain.e12.sq(a), plain.e12.inv(a)))
    for q in (1, 2, 3):
        _equal((po.frobenius(a, q),), (plain.frobenius(a, q),))
    assert launches == [1]


@pytest.mark.cuda
def test_pairing_e_on_card_matches_host(card):
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
    from zk_toolkit_tpu_torch.curves.bls12_381.optimal_ate import OptimalAtePairing
    from zk_toolkit_tpu_torch.ops import pairing_ops as P
    from zk_toolkit_tpu_torch.ops.tower_ops import unpack_fq12

    ops = P.bls_pairing_ops()
    spec = ops.f.spec
    ps = [g1.g(), g1.g() * 7, g1.g() * 123456789, g1.infinity()]
    qs = [g2.g(), g2.g() * 11, g2.g() * 987654321, g2.g()]
    got = unpack_fq12(P.pairing_e(ops, P.pack_g1_affine(ps, spec, card),
                                  P.pack_g2_affine(qs, spec, card)), spec)
    pair = OptimalAtePairing()
    assert got == [pair.e(p, q).e for p, q in zip(ps, qs)]


@pytest.mark.cuda
def test_groth16_verify_on_card_accepts_and_rejects(card):
    """The flagship proof verified on the card: accepted, a tampered
    statement rejected, and B1, B2, B3 all ran inside one verify."""
    from zk_toolkit_tpu_torch import bench as B
    from zk_toolkit_tpu_torch.protocols import groth16_device as GD
    from zk_toolkit_tpu_torch.snark import term as T

    f = params.SUBGROUP
    wm = {T.One(): f.elem(1), T.Var("x"): f.elem(3), T.Out(): f.elem(35),
          T.TmpVar(1): f.elem(9), T.TmpVar(2): f.elem(27), T.TmpVar(3): f.elem(8),
          T.TmpVar(4): f.elem(35)}
    trapdoor = dict(tau=12345, alpha=777, beta=888, gamma=999, delta=111213)
    mat = GD.CircuitMatrices.from_expr("(x * x * x) + x + 5 == 35", device=card)
    crs = GD.DeviceCRS.from_trapdoor(mat, point_mode="host", device=card, **trapdoor)
    prover = GD.DeviceGroth16Prover(mat, wm, device=card)
    proof = prover.prove_with_rs(crs, 4242, 5353)
    verifier = GD.DeviceGroth16Verifier()
    counts = [L._mont_mul_fused.launches, CK.point_add_fused.launches,
              CK.point_double_fused.launches]
    assert verifier.verify(proof, crs, prover.statement())
    after = [L._mont_mul_fused.launches, CK.point_add_fused.launches,
             CK.point_double_fused.launches]
    assert all(a > b for a, b in zip(after, counts))
    assert not verifier.verify(proof, crs, B.tampered(prover.statement()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(5, 2), (64, None)])
def test_msm_many_on_card_matches_cpu_plain(card, n, c):
    """msm_pippenger_many over two secp256k1 streams on the card (B1-B3 at
    K = 16) against the same call on CPU tensors, limb for limb."""
    from zk_toolkit_tpu_torch.curves import secp256k1

    spec = L.field_spec(secp256k1.P)
    rng = np.random.default_rng(70 + n)
    ks = [int(x) for x in rng.integers(1, 1 << 62, 2 * n)]
    ks[1] = 0                                            # an infinity base
    affs = HC.multi_mul(HC.FpHost(secp256k1.P), (secp256k1.GX, secp256k1.GY), ks)
    pts = tuple(a.view(2, n, 16) for a in C.pack_points(affs, spec, device="cpu"))
    sc = torch.from_numpy(rng.integers(0, 1 << 16, size=(2, n, 16)).astype(np.int32))
    sc[0, 2] = 0                                         # a zero scalar row
    want = M.msm_pippenger_many(FqOps(spec), pts, sc, 256, c=c)
    before = CK.point_add_fused.launches
    got = M.msm_pippenger_many(FqOps(spec), tuple(a.to(card) for a in pts), sc.to(card), 256, c=c)
    assert CK.point_add_fused.launches > before
    _equal(tuple(g.cpu() for g in got), want)


@pytest.mark.cuda
def test_ecdsa_verify_on_card_matches_cpu_plain(card):
    """ecdsa_sign_batch and ecdsa_verify_batch on the card against the same
    calls on CPU tensors: 8 signatures, rows 0-4 made bad (bench's
    ECDSA_BAD_ROWS); equal (r, s) limbs and equal masks."""
    from zk_toolkit_tpu_torch import bench as B
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG

    privs, ks, digests = B.ecdsa_inputs(8)
    out = {}
    for dev in (card, torch.device("cpu")):
        d, k = (C.pack_scalars(v, 256, device=dev) for v in (privs, ks))
        pub = SIG.ecdsa_keygen_batch(d)
        r, s, ok = SIG.ecdsa_sign_batch(d, k, digests)
        mask = SIG.ecdsa_verify_batch(*B.ecdsa_bad_batch(r, s, pub, digests))
        out[dev.type] = [t.cpu() for t in (*pub, r, s, ok, mask)]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g, w)
    assert out["cuda"][-1].tolist() == [False] * 5 + [True] * 3


@pytest.mark.cuda
def test_ed25519_on_card_matches_host_engine_and_cpu_plain(card):
    """ed25519_sign_batch on the card equals the host Ed25519Sha512 byte for
    byte (6 rows of 96-byte messages); ed25519_verify_batch on the card and
    on CPU tensors gives the same mask on bench's bad batch (rows 0-4 of
    ED25519_BAD_ROWS rejected); decode_points on the card equals the CPU
    decode limb for limb, with y >= q and non-square rows among them."""
    from zk_toolkit_tpu_torch import bench as B
    from zk_toolkit_tpu_torch.ops import edwards_ops as E
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG
    from zk_toolkit_tpu_torch.signatures.ed25519 import Ed25519Sha512

    eng = Ed25519Sha512()
    prv, msgs = B.ed25519_inputs(6)
    sigs = SIG.ed25519_sign_batch(prv, msgs, card)
    for i in range(6):
        assert bytes(sigs[i]) == eng.sign(msgs[i].tobytes(), prv[i].tobytes())
    pubs = np.stack([np.frombuffer(eng.gen_pub_key(k.tobytes()), dtype=np.uint8) for k in prv])
    bad = B.ed25519_bad_batch(sigs, pubs, msgs)
    want = [False] * 5 + [True]
    assert SIG.ed25519_verify_batch(*bad, device=card).tolist() == want
    assert SIG.ed25519_verify_batch(*bad, device="cpu").tolist() == want
    encs = np.concatenate([bad[0][:, :32], bad[1]])
    got, ok = E.decode_points(encs, card)
    want_pt, want_ok = E.decode_points(encs, "cpu")
    assert torch.equal(ok.cpu(), want_ok)
    _equal(tuple(g.cpu() for g in got), want_pt)


@pytest.mark.cuda
def test_bls_verify_on_card_matches_cpu_plain(card):
    """bls_verify_batch on the card and on CPU tensors over bench's bad batch
    of 5 rows (rows 0-3 of BLS_BAD_ROWS rejected): the same mask."""
    from zk_toolkit_tpu_torch import bench as B
    from zk_toolkit_tpu_torch.ops import signature_ops as SIG

    bad = B.bls_bad_batch(*B.bls_inputs(5))
    want = [False] * 4 + [True]
    assert SIG.bls_verify_batch(*bad, device=card).tolist() == want
    assert SIG.bls_verify_batch(*bad, device="cpu").tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("p, rows, nbits", [(params.R, 257, 255), (params.Q, 130, 381)],
                         ids=["fr", "fq"])
def test_mont_pow_dynamic_on_card_matches_plain(card, p, rows, nbits):
    """mont_pow_dynamic (one B1 launch for the reduction, then one stacked
    [2, B, K] launch per exponent bit) against its plain version on the
    card, rows in [p, 2^(16K)) and exponents 0, 1, p - 1, p - 2 included,
    and sampled rows against Python's pow."""
    from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

    spec = L.field_spec(p)
    rng = np.random.default_rng(rows)
    full = 1 << (16 * spec.K)
    xs = [int.from_bytes(rng.bytes(2 * spec.K), "little") % p for _ in range(rows - 3)]
    xs += [p, p + 1, full - 1]
    es = [int.from_bytes(rng.bytes(48), "little") % (1 << nbits) for _ in range(rows - 4)]
    es += [0, 1, p - 1, p - 2]
    a = torch.from_numpy(ints_to_array(xs, spec.K).astype(np.int32)).to(card)
    e = torch.from_numpy(ints_to_array(es, (nbits + 15) // 16).astype(np.int32)).to(card)
    before = L._mont_mul_fused.launches
    got = L.mont_pow_dynamic(a, e, spec, nbits)
    assert L._mont_mul_fused.launches - before == 1 + nbits
    _equal((got,), (L.mont_pow_dynamic_plain(a, e, spec, nbits),))
    r_inv = pow(full, -1, p)
    vals = L.unpack(got[-8:], spec, mont=False)
    for x, k, v in zip(xs[-8:], es[-8:], vals):
        assert v == pow(x * r_inv, k, p) * full % p


@pytest.mark.cuda
def test_sharded_msm_explicit_on_nccl_world_of_one(card):
    """parallel/: a world of one over NCCL on the card (make_mesh in this
    process), the explicit sharded MSM at 2^12 points equal to msm_pippenger
    in affine, with one all_gather per coordinate and the kernels launched."""
    from zk_toolkit_tpu_torch.bench import msm_inputs
    from zk_toolkit_tpu_torch.parallel.mesh import make_mesh
    from zk_toolkit_tpu_torch.parallel.sharded_msm import sharded_msm_explicit

    spec = L.field_spec(params.Q)
    ops = FqOps(spec)
    _, _, base, sc = msm_inputs(1 << 12, card)
    pts = fixed_base_g1(base)
    with make_mesh(1, "cuda") as mesh:
        assert (mesh.world, mesh.backend, mesh.device) == (1, "nccl", torch.device("cuda", 0))
        before = CK.point_add_fused.launches
        got = sharded_msm_explicit(ops, pts, sc, 255, mesh)
        assert CK.point_add_fused.launches > before
        assert mesh.counts == {"all_gather": 3}
    want = M.msm_pippenger(ops, pts, sc, 255)
    assert (C.unpack_points(tuple(a[None] for a in got), spec)
            == C.unpack_points(tuple(a[None] for a in want), spec))
