"""Device Groth16 on BLS12-381 (the port of
zk_toolkit_tpu/protocols/groth16_device.py).

The prove is three sparse mat-vecs over Fr -> the coset quotient chain of
seven NTTs (ops/ntt.py) -> four G1 MSMs and one G2 MSM (ops/msm.py) ->
randomizer scalar multiplications and point adds (ops/curve_ops.py) ->
affine A, B, C. The verify is one statement MSM, then the four pairings
e(-A, B) e(alpha, beta) e(L, gamma) e(C, delta) as one batched Miller
product with one shared final exponentiation (ops/pairing_ops.py), read
back to the host once. The QAP domain is H = <w_n>, n the constraint
count padded to a power of two, so proofs check against the Groth16
equation, and with the trapdoor known, A, B, C are fixed multiples of the
generators.

On a card every Fr and Fq product runs on kernel B1, every G1 add and
doubling on B2/B3; G2 runs the formulas over Fq2Ops. Entry points take
`device="cuda"` and raise without a card; pass device="cpu" to run the
plain versions. The CRS's Lagrange values run on the port's copy of the
JAX package's native host engine (native/), in Python without g++ (the
same ints); its scalars are packed in Python, which an H100 host measured
as fast as the native packing at 2^16 scalars (PERF.md). The fixed-base
window tables persist on disk (fixed_base.build_table_cached, keys
bls12_381_g1 / bls12_381_g2, the JAX package's file format).

Trapdoor (tau, alpha, beta, gamma, delta) and randomness (r, s) are
injectable for reproducible differential tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2, params
from zk_toolkit_tpu_torch.native import engine
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import fixed_base as FB
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as MSM
from zk_toolkit_tpu_torch.ops import ntt as NTT
from zk_toolkit_tpu_torch.ops import pairing_ops as PO
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.ops.tower_ops import Fq2Ops
from zk_toolkit_tpu_torch.snark import gate as gate_mod
from zk_toolkit_tpu_torch.snark.equation_parser import EquationParser
from zk_toolkit_tpu_torch.snark.r1cs import R1CS, R1CSTmpl
from zk_toolkit_tpu_torch.utils import host_curve as HC
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array
from zk_toolkit_tpu_torch.utils.rng import Rng

R = params.R
FR_BITS = 256  # scalar limb width for MSM digit extraction (16 limbs)
FB_WINDOW = 8  # fixed-base window bits (table = 32 windows x 256 entries)


def _fq_ops() -> FqOps:
    return FqOps(L.field_spec(params.Q))


def _e2() -> Fq2Ops:
    return Fq2Ops(_fq_ops())


def _fr_spec():
    return L.field_spec(R)


# -- circuit matrices ----------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class CircuitMatrices:
    """Host-frontend R1CS lowered to padded-row device tensors.

    a_idx/b_idx/c_idx: int32 [n_pad, kmax] wire indices (0 for padding),
    a_val/...: int32 [n_pad, kmax, K] Montgomery coefficients (0 for
    padding; the JAX package's uint32 limbs, bit for bit). Padded
    constraint rows are all zero: 0 * 0 = 0 holds for any witness.
    """

    n: int          # real constraint count
    n_pad: int      # power-of-two NTT domain size
    m: int          # last wire index (witness length - 1)
    l: int          # last statement index
    kmax: int
    a_idx: torch.Tensor
    b_idx: torch.Tensor
    c_idx: torch.Tensor
    a_val: torch.Tensor
    b_val: torch.Tensor
    c_val: torch.Tensor
    tmpl: object    # host R1CSTmpl (witness binding, CRS, oracle tests)

    @staticmethod
    def from_expr(expr: str, device="cuda") -> "CircuitMatrices":
        f = params.SUBGROUP
        eq = EquationParser.parse(f, expr)
        gates = gate_mod.build(f, eq)
        return CircuitMatrices.from_tmpl(R1CSTmpl(f, gates), device)

    @staticmethod
    def from_tmpl(tmpl, device="cuda") -> "CircuitMatrices":
        dev = resolve_device(device)
        spec = _fr_spec()
        n = len(tmpl.constraints)
        n_pad = max(2, 1 << (n - 1).bit_length())
        rows = [[list(cons.a), list(cons.b), list(cons.c)] for cons in tmpl.constraints]
        kmax = max((len(side) for row in rows for side in row), default=1) or 1
        idx = np.zeros((3, n_pad, kmax), dtype=np.int32)
        val = np.zeros((3, n_pad, kmax, spec.K), dtype=np.uint32)
        where, coeffs = [], []
        for j, row in enumerate(rows):
            for s, side in enumerate(row):
                for k, (i, coeff) in enumerate(side):
                    idx[s, j, k] = i
                    where.append((s, j, k))
                    coeffs.append(coeff.e * spec.r_mod_p % R)
        if where:
            s_, j_, k_ = np.asarray(where).T
            val[s_, j_, k_] = ints_to_array(coeffs, spec.K)
        t_idx = torch.from_numpy(idx).to(dev)
        t_val = torch.from_numpy(val.astype(np.int32)).to(dev)
        return CircuitMatrices(
            n=n, n_pad=n_pad, m=len(tmpl.witness) - 1, l=tmpl.mid_beg - 1, kmax=kmax,
            a_idx=t_idx[0], b_idx=t_idx[1], c_idx=t_idx[2],
            a_val=t_val[0], b_val=t_val[1], c_val=t_val[2],
            tmpl=tmpl,
        )


def spmv(idx, val, w_mont, spec):
    """Padded-row sparse matrix * witness over Fr:
    out[j] = sum_k val[j, k] * w[idx[j, k]]. One gather, one stacked
    Montgomery product (one B1 launch on a card) and a pairwise fold over
    the nnz axis."""
    gathered = w_mont[idx.long()]                     # [n, kmax, K]
    prods = L.mont_mul(val, gathered, spec)
    kmax = prods.shape[1]
    while kmax > 1:
        half = kmax // 2
        lo = prods[:, :half]
        hi = prods[:, half:2 * half]
        rest = prods[:, 2 * half:]
        prods = torch.cat([L.add_mod(lo, hi, spec), rest], dim=1)
        kmax = prods.shape[1]
    return prods[:, 0]


# -- device point helpers -------------------------------------------------------

def _tile_point(pt, n):
    return tuple(a.expand((n,) + a.shape[1:]) for a in pt)


@functools.lru_cache(maxsize=None)
def _g1_base(device: str):
    return C.pack_points([(params.G1_X, params.G1_Y)], _fq_ops().spec, device=device)


@functools.lru_cache(maxsize=None)
def _g1_table(device: str):
    return FB.build_table_cached(_fq_ops(), _g1_base(device), FR_BITS, FB_WINDOW,
                                 key="bls12_381_g1")


def fixed_base_g1(scalars_plain: torch.Tensor):
    """[k_i * G1] batched: windowed table gathers + a log-depth add tree,
    on the device of `scalars_plain` (int32 [B, 16] plain limbs)."""
    return FB.scalar_mul_fixed(
        _fq_ops(), _g1_table(str(scalars_plain.device)), scalars_plain, FB_WINDOW
    )


@functools.lru_cache(maxsize=None)
def _g2_base(device: str):
    xq, yq, _ = PO.pack_g2_affine([g2.g()], _fq_ops().spec, device=device)
    return (xq, yq, _e2().one_like(xq))


@functools.lru_cache(maxsize=None)
def _g2_table(device: str):
    return FB.build_table_cached(_e2(), _g2_base(device), FR_BITS, FB_WINDOW,
                                 key="bls12_381_g2")


def fixed_base_g2(scalars_plain: torch.Tensor):
    """[k_i * G2] batched, as fixed_base_g1, over Fq2Ops."""
    return FB.scalar_mul_fixed(
        _e2(), _g2_table(str(scalars_plain.device)), scalars_plain, FB_WINDOW
    )


def _pack_fr_plain(xs, device) -> torch.Tensor:
    return C.pack_scalars([int(x) % R for x in xs], FR_BITS, device)


def lagrange_at(n_pad: int, x: int, w_root: int, native: bool = True):
    """([L_j(x) for j < n_pad], t(x)) over the domain of n_pad roots of
    unity (w_root the primitive one), L_j(x) = (x^n - 1) w^j / (n (x - w^j)),
    t(x) = x^n - 1: on the native engine (one power table, one batched
    inversion, two batched products, as the JAX package) or, without g++ or
    with native=False, in Python bigints; the same ints."""
    t_x = (pow(x, n_pad, R) - 1) % R
    n_inv = pow(n_pad, -1, R)
    eng = engine(R) if native else None
    if eng is not None:
        wj_t = eng.pow_table(w_root, n_pad)
        x_arr = np.repeat(eng.from_ints([x]), n_pad, axis=0)
        den_inv = eng.inv(eng.sub(x_arr, wj_t))
        coef = eng.from_ints([t_x * n_inv % R])
        return eng.to_ints(eng.mul(eng.mul_scalar(wj_t, coef), den_inv)), t_x
    lag, wj = [], 1
    for _ in range(n_pad):
        lag.append(t_x * wj % R * pow((x - wj) % R, -1, R) % R * n_inv % R)
        wj = wj * w_root % R
    return lag, t_x


def qap_at(mat: CircuitMatrices, x: int, w_root: int):
    """(u_i(x), v_i(x), w_i(x) per wire, t(x)): the QAP's wire polynomials
    over the domain of n_pad roots of unity, evaluated at x through the
    Lagrange basis (lagrange_at); O(n) host work."""
    lag, t_x = lagrange_at(mat.n_pad, x, w_root)
    u, v, w = ([0] * (mat.m + 1) for _ in range(3))
    for j, cons in enumerate(mat.tmpl.constraints):
        for acc, side in ((u, cons.a), (v, cons.b), (w, cons.c)):
            for idx, coeff in side:
                acc[idx] = (acc[idx] + coeff.e * lag[j]) % R
    return u, v, w, t_x


# -- CRS -------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class DeviceCRS:
    """Groth16 CRS over the NTT domain, every group element on the device:
    uvw_stmt = (beta*u_i + alpha*v_i + w_i)/gamma for statement wires,
    uvw_wit = .../delta for witness wires, xt = tau^k t(tau)/delta. The
    pairing e(alpha, beta) is not stored: the verifiers recompute it."""

    mat: CircuitMatrices
    g1_alpha: tuple
    g1_beta: tuple
    g1_delta: tuple
    g2_beta: tuple
    g2_gamma: tuple
    g2_delta: tuple
    g1_u: tuple        # [m+1] u_i(tau) in G1
    g1_v: tuple        # [m+1] v_i(tau) in G1
    g2_v: tuple        # [m+1] v_i(tau) in G2
    g1_uvw_stmt: tuple  # [l+1]
    g1_uvw_wit: tuple   # [m-l]
    g1_xt: tuple        # [n_pad-1] tau^k t(tau)/delta

    @staticmethod
    def generate(mat: CircuitMatrices, rng: Rng | None = None, device="cuda") -> "DeviceCRS":
        rng = rng or Rng()
        f = params.SUBGROUP
        tau = f.rand_elem(True, rng).e
        alpha = f.rand_elem(True, rng).e
        beta = f.rand_elem(True, rng).e
        gamma = f.rand_elem(True, rng).e
        delta = f.rand_elem(True, rng).e
        return DeviceCRS.from_trapdoor(mat, tau, alpha, beta, gamma, delta, device=device)

    @staticmethod
    def from_trapdoor(mat, tau, alpha, beta, gamma, delta, point_mode: str = "table",
                      device="cuda") -> "DeviceCRS":
        """point_mode selects how the CRS group elements are made:
        - "table": windowed fixed-base tables on the device (the G2 table
          is built with the Fq2 formulas);
        - "host": host bigint scalar multiplications, the oracle path (the
          JAX package's "scan" mode, which only its multi-chip dry run
          uses, is not ported)."""
        dev = resolve_device(device)
        if point_mode not in ("table", "host"):
            raise ValueError(f"point_mode must be 'table' or 'host', not {point_mode!r}")
        n_pad, m, l = mat.n_pad, mat.m, mat.l
        w_root = NTT.fr_domain(n_pad, dev).w
        u, v, w, t_tau = qap_at(mat, tau, w_root)
        gamma_inv = pow(gamma, -1, R)
        delta_inv = pow(delta, -1, R)
        uvw = [(beta * u[i] + alpha * v[i] + w[i]) % R for i in range(m + 1)]
        uvw_stmt = [x * gamma_inv % R for x in uvw[: l + 1]]
        uvw_wit = [x * delta_inv % R for x in uvw[l + 1:]]
        xt = []
        cur = t_tau * delta_inv % R
        for _ in range(n_pad - 1):
            xt.append(cur)
            cur = cur * tau % R

        g1_scalars = [alpha, beta, delta] + u + v + uvw_stmt + uvw_wit + xt
        g2_scalars = [beta, gamma, delta] + v
        if point_mode == "host":
            spec = _fq_ops().spec
            g1_pts = tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in HC.pack_g1_jac(
                HC.multi_mul(HC.FpHost(params.Q), (params.G1_X, params.G1_Y),
                             [int(s) % R for s in g1_scalars]), spec))
            g2_pts = tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in HC.pack_g2_jac(
                HC.multi_mul(HC.Fp2Host(params.Q), HC.G2_AFFINE,
                             [int(s) % R for s in g2_scalars]), spec))
        else:
            g1_pts = fixed_base_g1(_pack_fr_plain(g1_scalars, dev))
            g2_pts = fixed_base_g2(_pack_fr_plain(g2_scalars, dev))

        def sl(pts, a, b):
            return tuple(x[a:b] for x in pts)

        o = 3
        s0 = o + 2 * (m + 1)
        return DeviceCRS(
            mat=mat,
            g1_alpha=sl(g1_pts, 0, 1), g1_beta=sl(g1_pts, 1, 2), g1_delta=sl(g1_pts, 2, 3),
            g2_beta=sl(g2_pts, 0, 1), g2_gamma=sl(g2_pts, 1, 2), g2_delta=sl(g2_pts, 2, 3),
            g1_u=sl(g1_pts, o, o + m + 1),
            g1_v=sl(g1_pts, o + m + 1, s0),
            g2_v=sl(g2_pts, 3, 3 + m + 1),
            g1_uvw_stmt=sl(g1_pts, s0, s0 + l + 1),
            g1_uvw_wit=sl(g1_pts, s0 + l + 1, s0 + m + 1),
            g1_xt=sl(g1_pts, s0 + m + 1, s0 + m + 1 + len(xt)),
        )


def _g2_to_affine(p_jac):
    return C.to_affine(_e2(), p_jac)


# -- prover ----------------------------------------------------------------------

@dataclasses.dataclass
class DeviceProof:
    a: tuple   # G1 affine (x, y, inf), batch 1
    b: tuple   # G2 affine
    c: tuple   # G1 affine


def h_coeffs_core(mat: CircuitMatrices, w_mont, spans=None):
    """Quotient polynomial h over the NTT domain (Montgomery limbs).
    `spans` (utils.profiling.Spans) times `spmv` and `ntt`, and inside the
    NTT its products and additions apart."""
    span = spans.span if spans is not None else contextlib.nullcontext
    spec = _fr_spec()
    dom = NTT.fr_domain(mat.n_pad, w_mont.device)
    with span("spmv"):
        a_ev = spmv(mat.a_idx, mat.a_val, w_mont, spec)
        b_ev = spmv(mat.b_idx, mat.b_val, w_mont, spec)
        c_ev = spmv(mat.c_idx, mat.c_val, w_mont, spec)
    with span("ntt"):
        return NTT.h_coset_then_coeffs(dom, a_ev, b_ev, c_ev, spans)


def prove_core(mat: CircuitMatrices, crs: DeviceCRS, w_mont, w_plain,
               r: int, s: int, spans=None):
    """The prove body: the affine (A, B, C) tuples. `spans` times its
    stages: spmv, ntt (with ntt_b1 and ntt_addsub inside it), h_from_mont,
    the five MSMs, the G1 and G2 scalar_mul calls, the point adds and the
    three to_affine."""
    span = spans.span if spans is not None else contextlib.nullcontext
    fq = _fq_ops()
    e2 = _e2()
    fr = _fr_spec()
    dev = w_plain.device

    h_mont = h_coeffs_core(mat, w_mont, spans)
    with span("h_from_mont"):
        h_plain = L.from_mont(h_mont, fr)[: mat.n_pad - 1]

    with span("msm_g1_u"):
        sum_a = MSM.msm_pippenger(fq, crs.g1_u, w_plain, FR_BITS)
    with span("msm_g2_v"):
        sum_b2 = MSM.msm_pippenger(e2, crs.g2_v, w_plain, FR_BITS)
    with span("msm_g1_v"):
        sum_b1 = MSM.msm_pippenger(fq, crs.g1_v, w_plain, FR_BITS)
    wit_plain = w_plain[mat.l + 1:]
    with span("msm_g1_uvw_wit"):
        c_sum = MSM.msm_pippenger(fq, crs.g1_uvw_wit, wit_plain, FR_BITS)
    with span("msm_g1_xt"):
        ht = MSM.msm_pippenger(fq, crs.g1_xt, h_plain, FR_BITS)

    # single-point randomizer multiplies, the three G1 ones in one batch
    rs = r * s % R
    with span("scalar_mul_g1"):
        d1 = _tile_point(crs.g1_delta, 3)
        d1_muls = C.scalar_mul(fq, d1, _pack_fr_plain([r, s, rs], dev), FR_BITS)
    d1_r = tuple(x[0:1] for x in d1_muls)
    d1_s = tuple(x[1:2] for x in d1_muls)
    d1_rs = tuple(x[2:3] for x in d1_muls)
    with span("scalar_mul_g2"):
        d2_s = C.scalar_mul(e2, crs.g2_delta, _pack_fr_plain([s], dev), FR_BITS)

    def b1(p):
        return tuple(x[None] for x in p)

    with span("point_add"):
        A = C.point_add(fq, C.point_add(fq, crs.g1_alpha, b1(sum_a)), d1_r)
        B2 = C.point_add(e2, C.point_add(e2, crs.g2_beta, b1(sum_b2)), d2_s)
        B1 = C.point_add(fq, C.point_add(fq, crs.g1_beta, b1(sum_b1)), d1_s)

    with span("scalar_mul_g1"):
        a_s = C.scalar_mul(fq, A, _pack_fr_plain([s], dev), FR_BITS)
        b1_r = C.scalar_mul(fq, B1, _pack_fr_plain([r], dev), FR_BITS)
    with span("point_add"):
        Cpt = C.point_add(fq, b1(c_sum), b1(ht))
        Cpt = C.point_add(fq, Cpt, a_s)
        Cpt = C.point_add(fq, Cpt, b1_r)
        Cpt = C.point_add(fq, Cpt, C.point_neg(fq, d1_rs))

    with span("to_affine"):
        return C.to_affine(fq, A), _g2_to_affine(B2), C.to_affine(fq, Cpt)


class DeviceGroth16Prover:
    """prove() follows the Groth16 prover: A = alpha + sum a_i u_i(tau) +
    r*delta, B = beta + sum a_i v_i(tau) + s*delta (G2, plus a G1 copy),
    C = sum_wit a_i uvw_i + h(tau)t(tau)/delta + sA + rB_1 - rs*delta."""

    def __init__(self, mat: CircuitMatrices, witness_map: dict, device="cuda"):
        dev = resolve_device(device)
        f = params.SUBGROUP
        r1cs = R1CS.from_tmpl(f, mat.tmpl, witness_map)
        r1cs.validate()
        self.mat = mat
        self.wires = [r1cs.witness.get(i).e for i in range(mat.m + 1)]
        self.w_mont = L.pack(self.wires, _fr_spec(), mont=True, device=dev)
        self.w_plain = _pack_fr_plain(self.wires, dev)

    def statement(self) -> list[int]:
        return self.wires[: self.mat.l + 1]

    def prove(self, crs: DeviceCRS, rng: Rng | None = None) -> DeviceProof:
        rng = rng or Rng()
        f = params.SUBGROUP
        r = f.rand_elem(True, rng).e
        s = f.rand_elem(True, rng).e
        return self.prove_with_rs(crs, r, s)

    def h_coeffs_mont(self):
        return h_coeffs_core(self.mat, self.w_mont)

    def prove_with_rs(self, crs: DeviceCRS, r: int, s: int, spans=None) -> DeviceProof:
        a, b, c = prove_core(self.mat, crs, self.w_mont, self.w_plain, r, s, spans)
        return DeviceProof(a=a, b=b, c=c)


# -- host verification oracle ----------------------------------------------------

def host_oracle_verify(crs: DeviceCRS, proof: DeviceProof, statement) -> bool:
    """Host-tier verification: e(A, B) == e(alpha, beta) * e(L_stmt, gamma)
    * e(C, delta) with the object-tier Tate pairing
    (curves/bls12_381/pairing.py) and raw-int Jacobian math
    (utils/host_curve.py), an implementation independent of every device
    kernel. Four pairings of pure Python."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import tower
    from zk_toolkit_tpu_torch.curves.bls12_381.pairing import Pairing

    spec = _fq_ops().spec
    F1, F2 = HC.FpHost(params.Q), HC.Fp2Host(params.Q)

    def is_inf(aff):
        return bool(aff[2].reshape(-1)[0])

    def g1_obj_affine(aff):
        if is_inf(aff):
            return g1.infinity()
        return g1.point(L.unpack(aff[0], spec)[0], L.unpack(aff[1], spec)[0])

    def fq2(pair):
        return tower.Fq2(tower.fq1(pair[1]), tower.fq1(pair[0]))

    def g2_obj_affine(aff):
        if is_inf(aff):
            return g2.infinity()
        return g2.point(fq2(L.unpack(aff[0], spec)), fq2(L.unpack(aff[1], spec)))

    def g1_obj_jac(pt):
        aff = HC.jac_to_affine(F1, tuple(L.unpack(a, spec)[0] for a in pt))
        return g1.infinity() if aff is None else g1.point(*aff)

    def g2_obj_jac(pt):
        x, y, z = (L.unpack(a, spec) for a in pt)
        aff = HC.jac_to_affine(F2, ((x[0], x[1]), (y[0], y[1]), (z[0], z[1])))
        if aff is None:
            return g2.infinity()
        return g2.point(fq2(aff[0]), fq2(aff[1]))

    # L_stmt = sum stmt_i * uvw_stmt_i (host Jacobian MSM over the short
    # statement prefix, wires 0..l)
    sx, sy, sz = (L.unpack(a, spec) for a in crs.g1_uvw_stmt)
    acc = (1, 1, 0)
    for xi, yi, zi, si in zip(sx, sy, sz, statement):
        k = int(si) % R
        if k:
            acc = HC.jac_add(F1, acc, HC.jac_mul(F1, (xi, yi, zi), k))
    l_aff = HC.jac_to_affine(F1, acc)
    l_obj = g1.infinity() if l_aff is None else g1.point(*l_aff)

    pr = Pairing()
    lhs = pr.tate(g1_obj_affine(proof.a), g2_obj_affine(proof.b))
    rhs = (
        pr.tate(g1_obj_jac(crs.g1_alpha), g2_obj_jac(crs.g2_beta))
        * pr.tate(l_obj, g2_obj_jac(crs.g2_gamma))
        * pr.tate(g1_obj_affine(proof.c), g2_obj_jac(crs.g2_delta))
    )
    return lhs == rhs


# -- verifier --------------------------------------------------------------------

def verify_core(crs: DeviceCRS, proof_a, proof_b, proof_c, stmt_plain):
    """The verify body: tensors in, bool [1] on the device out. The
    statement MSM runs on B2/B3, the pairing product's products on B1."""
    fq = _fq_ops()
    po = PO.bls_pairing_ops()
    L_pt = MSM.msm_pippenger(fq, crs.g1_uvw_stmt, stmt_plain, FR_BITS)

    ax, ay, ainf = proof_a
    neg_a = (ax, fq.neg(ay), ainf)
    alpha_aff = C.to_affine(fq, crs.g1_alpha)
    l_aff = C.to_affine(fq, tuple(x[None] for x in L_pt))
    beta_aff = _g2_to_affine(crs.g2_beta)
    gamma_aff = _g2_to_affine(crs.g2_gamma)
    delta_aff = _g2_to_affine(crs.g2_delta)

    def cat(parts):
        return tuple(torch.cat([p[i] for p in parts])[None] for i in range(3))

    p_b = cat([neg_a, alpha_aff, l_aff, proof_c])
    q_b = cat([proof_b, beta_aff, gamma_aff, delta_aff])
    return PO.pairing_product_is_one(po, p_b, q_b)


class DeviceGroth16Verifier:
    """e(A, B) == e(alpha, beta) * e(L_stmt, gamma) * e(C, delta), checked
    as one batched Miller product e(-A,B) e(alpha,beta) e(L,gamma) e(C,delta)
    == 1 with a single shared final exponentiation, on the CRS's device."""

    def verify(self, proof: DeviceProof, crs: DeviceCRS, statement: list[int]) -> bool:
        stmt_plain = _pack_fr_plain(statement, crs.g1_alpha[0].device)
        ok = verify_core(crs, proof.a, proof.b, proof.c, stmt_plain)
        return bool(ok[0])
