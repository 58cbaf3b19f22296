"""Batched BLS12-381 optimal-ate pairing on the device (the port of
zk_toolkit_tpu/ops/pairing_ops.py).

Equal, limb for limb, to the JAX package and, in value, to the host oracle
(curves/bls12_381/optimal_ate.py):
- the Miller loop runs over the 63 bits of |u| = 0xd201000000010000 after
  the leading one, a Python loop over static bits: a doubling step every
  bit, an addition step only on the 5 set bits (the JAX package's scan
  computes the addition step every bit and discards it by a select on the
  bit, so the values are the same);
- lines are computed on the sextic twist with T in Jacobian coordinates
  over Fq2, with the JAX package's scale factors (2YZ^3 for a tangent,
  Z*mu for a chord), which the final exponentiation erases;
- the final exponentiation is the conj * inv and Frobenius easy part, then
  the 3(q^4 - q^2 + 1)/r hard part from five u-exponentiations, each a
  square per bit of |u| and a multiply per set bit.

Everything is batched over the leading axes: one `pairing_e` call computes
B pairings, `pairing_product_is_one` B products of J pairings with one
final exponentiation per product. Each Fq12 product is one launch of kernel
B1 over 54 stacked Fq rows per element (ops/tower_ops.py); the additions,
subtractions and negations are the plain add_mod / sub_mod / neg_mod.

Every tensor that reaches B1 is canonical (below p): the Frobenius tables
are reduced Montgomery constants, the zeros of `sparse_line` and the
Montgomery ones of `one_like` are canonical, and every sum goes through
add_mod.

The naive Weil and Tate pairings (an r - 1 bit Miller loop with affine
lines and vertical denominators in Fq12, then a full final power) are here
too, batched, for parity with the host tier's `Pairing`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.curves.bls12_381.optimal_ate import GAMMA, miller_bits
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops.tower_ops import make_tower
from zk_toolkit_tpu_torch.utils.bigint import int_to_limbs


def _mont_np(v: int, spec) -> np.ndarray:
    return np.asarray(int_to_limbs(v * spec.r_mod_p % spec.p, spec.K), dtype=np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class BlsPairingOps:
    """The tower ops and constant tables of the batched pairing. plain=True
    runs the plain version of every product and inverse on any device (the
    reference the kernels are held against)."""

    plain: bool = False

    def __post_init__(self):
        f, e2, e6, e12 = make_tower(params.Q, plain=self.plain)
        object.__setattr__(self, "f", f)
        object.__setattr__(self, "e2", e2)
        object.__setattr__(self, "e6", e6)
        object.__setattr__(self, "e12", e12)
        # Miller-loop bits of |u|, MSB first, leading 1 dropped.
        object.__setattr__(self, "u_bits", tuple(miller_bits()))

    @functools.lru_cache(maxsize=None)
    def gamma(self, power: int, device: str) -> torch.Tensor:
        """Frobenius constants gamma[power][i] = xi^(i (q^power - 1) / 6),
        Montgomery, in the Fq12 coefficient layout [2 (w_j), 3 (v_k), 2 (u),
        K] with omega-degree i = j + 2k (optimal_ate.fq12_from_omega); cached
        per device."""
        spec = self.f.spec
        t = np.zeros((2, 3, 2, spec.K), dtype=np.int32)
        for j in range(2):
            for k in range(3):
                g = GAMMA[power][j + 2 * k]
                t[j, k, 0] = _mont_np(g.u0.e, spec)
                t[j, k, 1] = _mont_np(g.u1.e, spec)
        return torch.from_numpy(t).to(device)

    # -- Fq12 helpers ---------------------------------------------------------

    def fq2_conj_all(self, a):
        """Conjugate every Fq2 coefficient of an Fq12: negate the u1 slot."""
        return torch.stack([a[..., 0, :], self.f.neg(a[..., 1, :])], -2)

    def frobenius(self, a, power: int):
        """a^(q^power), power in 1..3: coefficient-wise Fq2 conjugation (odd
        powers), then one stacked Fq2 product with the gamma table (its
        broadcast over the batch is copied into rows before the launch)."""
        assert power in (1, 2, 3)
        if power % 2 == 1:
            a = self.fq2_conj_all(a)
        g = self.gamma(power, str(a.device))
        # e2.mul consumes [..., 2, K]; the (2, 3) structure axes broadcast.
        return self.e2.mul(a, g.expand(a.shape))

    @staticmethod
    def sparse_line(c0, c2, c3):
        """The sparse twist line c0 + c2*omega^2 + c3*omega^3 as a full Fq12
        tensor [..., 2, 3, 2, K] (zeros elsewhere)."""
        z = torch.zeros_like(c0)
        w0 = torch.stack([c0, c2, z], -3)
        w1 = torch.stack([z, c3, z], -3)
        return torch.stack([w0, w1], -4)

    # -- Miller loop ------------------------------------------------------------

    def _dbl_step(self, t, xp3, yp):
        """Tangent line at Jacobian T (Fq2), scaled by 2YZ^3:
        c0 = 3X^3 - 2Y^2, c2 = -3X^2 Z^2 xP, c3 = 2YZ^3 yP. Returns (2T, l)."""
        e2 = self.e2
        x, y, z = t
        x2 = e2.sq(x)
        y2 = e2.sq(y)
        z2 = e2.sq(z)
        x3 = e2.mul(x2, x)
        z3 = e2.mul(z2, z)
        c0 = e2.sub(e2.add(e2.dbl(x3), x3), e2.dbl(y2))
        c2 = e2.neg(e2.mul_fq1(e2.mul(x2, z2), xp3))
        c3 = e2.mul_fq1(e2.dbl(e2.mul(y, z3)), yp)
        return C.point_double(e2, t), self.sparse_line(c0, c2, c3)

    def _add_step(self, t, q_aff, xp, yp):
        """Chord line through Jacobian T and affine Q, scaled by Z*mu:
        theta = Y - yQ Z^3, mu = X - xQ Z^2;
        c0 = theta xQ - yQ Z mu, c2 = -theta xP, c3 = Z mu yP."""
        e2 = self.e2
        x, y, z = t
        xq, yq, _ = q_aff
        z2 = e2.sq(z)
        z3 = e2.mul(z2, z)
        theta = e2.sub(y, e2.mul(yq, z3))
        mu = e2.sub(x, e2.mul(xq, z2))
        zmu = e2.mul(z, mu)
        c0 = e2.sub(e2.mul(theta, xq), e2.mul(yq, zmu))
        c2 = e2.neg(e2.mul_fq1(theta, xp))
        c3 = e2.mul_fq1(zmu, yp)
        return C.point_add_mixed(e2, t, q_aff), self.sparse_line(c0, c2, c3)

    def miller_loop(self, p_aff, q_aff):
        """f_{|u|,Q}(phi(P)), conjugated for the negative BLS parameter.

        p_aff: (xp, yp, p_inf) base-field affine G1: xp/yp int32 [..., K]
               Montgomery, p_inf bool [...].
        q_aff: (xq, yq, q_inf) Fq2 affine G2: int32 [..., 2, K].
        Returns Fq12 int32 [..., 2, 3, 2, K]; 1 where P or Q is infinity."""
        f_ops, e2, e12 = self.f, self.e2, self.e12
        xp, yp, p_inf = p_aff
        xq, yq, q_inf = q_aff
        xp3 = f_ops.add(f_ops.dbl(xp), xp)

        one = e2.one_like(xq)
        t = (xq, yq, e2.select(q_inf, e2.zero_like(one), one))
        f = e12.one_like(xp.new_zeros(xp.shape[:-1] + (2, 3, 2, xp.shape[-1])))
        for bit in self.u_bits:
            t, l = self._dbl_step(t, xp3, yp)
            f = e12.mul(e12.sq(f), l)
            if bit:
                t, l = self._add_step(t, q_aff, xp, yp)
                f = e12.mul(f, l)
        f = self.conj12(f)  # z -> -z for the negative BLS u
        # Degenerate inputs: e(inf, Q) = e(P, inf) = 1.
        return e12.select(p_inf | q_inf, e12.one_like(f), f)

    # -- final exponentiation ---------------------------------------------------

    def conj12(self, a):
        """Fq12 conjugation z -> -z: negate the w1 half."""
        return torch.stack([a[..., 0, :, :, :], self.e6.neg(a[..., 1, :, :, :])], -4)

    def pow_u(self, a):
        """a^u for the negative BLS parameter u (cyclotomic a only: the
        inverse is the conjugate): a square per bit of |u|, a multiply per
        set bit, then the conjugate."""
        e12 = self.e12
        acc = a
        for bit in self.u_bits:
            acc = e12.sq(acc)
            if bit:
                acc = e12.mul(acc, a)
        return self.conj12(acc)

    def final_exp(self, f):
        """f^(3 (q^12 - 1) / r), the cubed final exponentiation (host parity:
        optimal_ate.final_exp), from the same building blocks as the JAX
        package's."""
        e12 = self.e12
        m = e12.mul(self.conj12(f), e12.inv(f))              # f^(q^6-1)
        m = e12.mul(self.frobenius(m, 2), m)                 # ^(q^2+1): cyclotomic
        # hard part: (u-1)^2 (u+q) (u^2+q^2-1) + 3
        a = e12.mul(self.pow_u(m), self.conj12(m))           # m^(u-1)
        a = e12.mul(self.pow_u(a), self.conj12(a))           # ^(u-1) again
        b = e12.mul(self.pow_u(a), self.frobenius(a, 1))     # a^(u+q)
        c = e12.mul(self.pow_u(self.pow_u(b)), self.frobenius(b, 2))
        c = e12.mul(c, self.conj12(b))                       # b^(u^2+q^2-1)
        return e12.mul(c, e12.mul(e12.sq(m), m))             # * m^3


@functools.lru_cache(maxsize=None)
def bls_pairing_ops(plain: bool = False) -> BlsPairingOps:
    return BlsPairingOps(plain)


def pairing_e(ops: BlsPairingOps, p_aff, q_aff):
    """Batched pairing e(P, Q)^3 (see optimal_ate.py's normalization): one
    Miller loop and one final exponentiation over the batch."""
    return ops.final_exp(miller_only(ops, p_aff, q_aff))


def miller_only(ops: BlsPairingOps, p_aff, q_aff):
    """The batched Miller loop alone (no final exponentiation)."""
    return ops.miller_loop(p_aff, q_aff)


def gt_mul(ops: BlsPairingOps, a, b):
    """Product of two batched Fq12 (GT) values."""
    return ops.e12.mul(a, b)


def _fold_pair_axis(ops: BlsPairingOps, f):
    """Reduce the pair axis (axis 1) of Miller outputs with log-depth Fq12
    multiplications."""
    j = f.shape[1]
    while j > 1:
        half = j // 2
        if j % 2 == 1:
            rest = ops.e12.mul(f[:, :half], f[:, half:2 * half])
            f = torch.cat([rest, f[:, 2 * half:]], 1)
        else:
            f = ops.e12.mul(f[:, :half], f[:, half:])
        j = f.shape[1]
    return f[:, 0]


def _is_gt_one(ops: BlsPairingOps, gt):
    return (gt == ops.e12.one_like(gt)).flatten(1).all(1)


def pairing_product_is_one(ops: BlsPairingOps, p_affs, q_affs):
    """For each batch row, is prod_j e(P_j, Q_j) == 1? p_affs / q_affs carry
    a pair axis after the batch axis: [B, J, ...]. The J Miller loops run
    in one batch and each row's product shares ONE final exponentiation.
    Returns bool [B] on the device (no host read)."""
    f = ops.miller_loop(p_affs, q_affs)  # [B, J, 2, 3, 2, K]
    gt = ops.final_exp(_fold_pair_axis(ops, f))
    return _is_gt_one(ops, gt)


# -- naive Weil/Tate pairing (host-tier parity, batched) --------------------------
#
# The host tier's Pairing (curves/bls12_381/pairing.py) runs an r-1-bit
# Miller loop with affine chord/tangent lines and vertical-line denominators,
# all in Fq12, then weil = M(p,q)/M(q,p) and tate = M(p,q)^((q^12-1)/r). This
# is its batched counterpart, equal to it in value.

@functools.lru_cache(maxsize=None)
def _naive_consts(device: str):
    """(w_inv, wz_inv, r-1 bits, (q^12-1)/r bits) for the naive loops; the
    untwist constants reproduce G12Point.from_g2 (curves/bls12_381/g12.py)."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import pairing as HP
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq2, Fq6, Fq12
    from zk_toolkit_tpu_torch.ops.tower_ops import pack_fq12

    spec = bls_pairing_ops().f.spec
    root = Fq6(Fq2.zero(), Fq2.one(), Fq2.zero())
    w_inv = Fq12(Fq6.zero(), root).inv()
    wz_inv = Fq12(root, Fq6.zero()).inv()
    r1_bits = tuple(1 if b else 0 for b in HP._miller_bits())
    tate_exp = (params.Q ** 12 - 1) // params.R
    tate_bits = tuple(int(b) for b in bin(tate_exp)[2:])
    return (pack_fq12([w_inv], spec, device), pack_fq12([wz_inv], spec, device),
            r1_bits, tate_bits)


def embed_g1_fq12(ops: BlsPairingOps, p_aff):
    """G1 affine (Montgomery Fq) -> Fq12-embedded (x12, y12)
    (G12Point.from_g1)."""
    xp, yp, _ = p_aff

    def emb(a):
        out = a.new_zeros(a.shape[:-1] + (2, 3, 2, a.shape[-1]))
        out[..., 0, 0, 0, :] = a
        return out

    return emb(xp), emb(yp)


def untwist_g2_fq12(ops: BlsPairingOps, q_aff):
    """G2 affine (Fq2) -> Fq12 untwist: x * w^-1, y * (w z)^-1
    (G12Point.from_g2)."""
    xq, yq, _ = q_aff
    w_inv, wz_inv, _, _ = _naive_consts(str(xq.device))

    def emb2(a):
        out = a.new_zeros(a.shape[:-2] + (2, 3, 2, a.shape[-1]))
        out[..., 0, 0, :, :] = a
        return out

    e12 = ops.e12
    x12, y12 = emb2(xq), emb2(yq)
    return (e12.mul(x12, w_inv[0].expand(x12.shape)),
            e12.mul(y12, wz_inv[0].expand(y12.shape)))


def naive_miller(ops: BlsPairingOps, xp12, yp12, xq12, yq12):
    """f_{r-1, P}(Q): Miller loop over the bits of r-1 (MSB dropped) with
    affine chord/tangent slopes and vertical-line denominators, everything
    in Fq12 (the host tier's Pairing._miller). The add step runs on set
    bits only (the JAX package computes it every bit and selects).

    Inputs are Fq12-embedded affine coordinates (embed_g1_fq12 /
    untwist_g2_fq12), so the same loop serves both the G1 x G2 and G2 x G1
    directions. Assumes order-r non-infinity inputs: for those the
    degenerate tangent/vertical branches of the host RationalFunction are
    unreachable inside this loop."""
    e12, f_ = ops.e12, ops.f
    _, _, r1_bits, _ = _naive_consts(str(xp12.device))

    def sub12(a, b):
        return f_.sub(a, b)

    def line_eval(xv, yv, lam):
        # -slope*xq + yq - yv + slope*xv
        return sub12(sub12(yq12, yv), e12.mul(lam, sub12(xq12, xv)))

    f = e12.one_like(xp12)
    xv, yv = xp12, yp12
    for bit in r1_bits:
        # double: tangent at v, vertical at 2v
        sq = e12.sq(xv)
        lam = e12.mul(f_.add(f_.dbl(sq), sq), e12.inv(f_.dbl(yv)))
        x2 = sub12(e12.sq(lam), f_.dbl(xv))
        y2 = sub12(e12.mul(lam, sub12(xv, x2)), yv)
        g_num = line_eval(xv, yv, lam)
        g_den = sub12(xq12, x2)
        f = e12.mul(e12.mul(e12.sq(f), g_num), e12.inv(g_den))
        xv, yv = x2, y2
        if bit:
            # add: chord through (2v, p), vertical at 2v + p
            lam2 = e12.mul(sub12(yp12, y2), e12.inv(sub12(xp12, x2)))
            x3 = sub12(sub12(e12.sq(lam2), x2), xp12)
            y3 = sub12(e12.mul(lam2, sub12(x2, x3)), y2)
            g_num2 = line_eval(x2, y2, lam2)
            g_den2 = sub12(xq12, x3)
            f = e12.mul(e12.mul(f, g_num2), e12.inv(g_den2))
            xv, yv = x3, y3
    return f


def _tate_pow(ops: BlsPairingOps, a):
    """a^((q^12-1)/r) by square-and-multiply over the static ~4314-bit
    exponent (no cyclotomic shortcuts, for parity with the host tier)."""
    e12 = ops.e12
    _, _, _, tate_bits = _naive_consts(str(a.device))
    acc = e12.one_like(a)
    for bit in tate_bits:
        acc = e12.sq(acc)
        if bit:
            acc = e12.mul(acc, a)
    return acc


def pairing_tate(ops: BlsPairingOps, p_aff, q_aff):
    """Batched Tate pairing Miller(p, q)^((q^12-1)/r), equal to the host
    tier's Pairing.tate. Returns Fq12 int32 [B, 2, 3, 2, K]."""
    xp12, yp12 = embed_g1_fq12(ops, p_aff)
    xq12, yq12 = untwist_g2_fq12(ops, q_aff)
    return _tate_pow(ops, naive_miller(ops, xp12, yp12, xq12, yq12))


def _div12(ops: BlsPairingOps, a, b):
    return ops.e12.mul(a, ops.e12.inv(b))


def pairing_weil(ops: BlsPairingOps, p_aff, q_aff):
    """Batched Weil pairing Miller(p, q) / Miller(q, p), equal to the host
    tier's Pairing.weil."""
    xp12, yp12 = embed_g1_fq12(ops, p_aff)
    xq12, yq12 = untwist_g2_fq12(ops, q_aff)
    num = naive_miller(ops, xp12, yp12, xq12, yq12)
    den = naive_miller(ops, xq12, yq12, xp12, yp12)
    return _div12(ops, num, den)


# -- host conversions ----------------------------------------------------------

def pack_g1_affine(pts, spec, device="cuda") -> tuple:
    """Host G1 affine points -> (x, y, inf): int32 [n, K] Montgomery tensors
    and bool [n] on `device`."""
    from zk_toolkit_tpu_torch import resolve_device

    n = len(pts)
    xs = np.zeros((n, spec.K), dtype=np.int32)
    ys = np.zeros((n, spec.K), dtype=np.int32)
    inf = np.zeros((n,), dtype=bool)
    for i, pt in enumerate(pts):
        if pt.is_zero():
            inf[i] = True
        else:
            xs[i] = _mont_np(pt.x.e, spec)
            ys[i] = _mont_np(pt.y.e, spec)
    dev = resolve_device(device)
    return (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev),
            torch.from_numpy(inf).to(dev))


def pack_g2_affine(pts, spec, device="cuda") -> tuple:
    """Host G2 affine points (curves/bls12_381 AffinePoint over Fq2) ->
    (x, y, inf): int32 [n, 2, K] Montgomery tensors and bool [n] on
    `device`."""
    from zk_toolkit_tpu_torch import resolve_device

    n = len(pts)
    xs = np.zeros((n, 2, spec.K), dtype=np.int32)
    ys = np.zeros((n, 2, spec.K), dtype=np.int32)
    inf = np.zeros((n,), dtype=bool)
    for i, pt in enumerate(pts):
        if pt.is_zero():
            inf[i] = True
        else:
            xs[i, 0] = _mont_np(pt.x.u0.e, spec)
            xs[i, 1] = _mont_np(pt.x.u1.e, spec)
            ys[i, 0] = _mont_np(pt.y.u0.e, spec)
            ys[i, 1] = _mont_np(pt.y.u1.e, spec)
    dev = resolve_device(device)
    return (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev),
            torch.from_numpy(inf).to(dev))
