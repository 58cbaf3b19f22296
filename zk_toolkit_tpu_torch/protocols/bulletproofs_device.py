"""Bulletproofs on a device: the range proof and the inner-product argument
with every vector operation batched (the port of
zk_toolkit_tpu/protocols/bulletproofs_device.py).

Mirrors the host tier (protocols/bulletproofs.py) round for round: the same
interactive model with injected challenges and randomness, so host and
device transcripts replay identically; the host class is the oracle.

Device mapping, over secp256k1 at K = 16 limbs:
- field vectors (a, b, l, r, y^n, 2^n): Montgomery limb tensors mod the
  group order n; products on kernel B1, tree sums of plain add_mod;
- commitments (A, S, T1, T2, L_j, R_j): Pippenger MSMs (ops/msm.py), L and
  R of a round as one msm_pippenger_many over two streams;
- basis folds g' = g_lo^(x^-1) g_hi^x, h' = h_lo^x h_hi^(x^-1): one
  2n-point scalar_mul and one n-point add per round, on kernels B2/B3.

Each jitted function of the JAX package is an eager function here with the
same operations in the same order, so the points' Jacobian limbs equal the
JAX package's. Every scalar the kernels see is reduced mod n and every
coordinate mod p: `_fr` and `pack_scalars` reduce their ints first.
"""

from __future__ import annotations

import torch

from zk_toolkit_tpu_torch.curves import secp256k1
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as MSM
from zk_toolkit_tpu_torch.ops.field_ops import FqOps

N_ORDER = secp256k1.N
_P_OPS = FqOps(L.field_spec(secp256k1.P))
_N_SPEC = L.field_spec(N_ORDER)


def _fr(xs, device="cuda") -> torch.Tensor:
    """ints -> Montgomery Fr(n) limbs [len(xs), K] on `device`."""
    return L.pack([int(x) % N_ORDER for x in xs], _N_SPEC, mont=True, device=device)


def _fr_plain(mont: torch.Tensor) -> torch.Tensor:
    return L.from_mont(mont, _N_SPEC)


def _tree_sum_fr(vals: torch.Tensor) -> torch.Tensor:
    """Field tree sum over axis 0 (any length): halves added pairwise, an
    odd element carried to the next level."""
    n = vals.shape[0]
    while n > 1:
        half = n // 2
        lo, hi, rest = vals[:half], vals[half:2 * half], vals[2 * half:]
        vals = torch.cat([L.add_mod(lo, hi, _N_SPEC), rest], dim=0)
        n = vals.shape[0]
    return vals[0]


def _inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tree_sum_fr(L.mont_mul(a, b, _N_SPEC))


def _msm(pts, scalars_mont: torch.Tensor):
    return MSM.msm_pippenger(_P_OPS, pts, _fr_plain(scalars_mont), 256)


def _single_mul(pt, scalar_int: int):
    s = C.pack_scalars([scalar_int % N_ORDER], 256, device=pt[0].device)
    return C.scalar_mul(_P_OPS, pt, s, 256)


def _fold_points(bases, xs):
    """base' = base_lo * x_lo + base_hi * x_hi for each base (a point tuple
    [n]) and its (x_lo, x_hi) ints in xs: one scalar_mul over the stack
    [lo of every base, hi of every base], one point_add of the lo half and
    the hi half (the JAX package's stacking order). Returns one point tuple
    [n/2] per base."""
    half = bases[0][0].shape[0] // 2
    dev = bases[0][0].device
    stacked = tuple(torch.cat([b[i][:half] for b in bases] + [b[i][half:] for b in bases], dim=0)
                    for i in range(3))
    ks = [x for x_lo, _ in xs for x in [x_lo] * half] + [x for _, x_hi in xs for x in [x_hi] * half]
    muls = C.scalar_mul(_P_OPS, stacked, C.pack_scalars([k % N_ORDER for k in ks], 256, device=dev),
                        256)
    m = len(bases) * half
    out = C.point_add(_P_OPS, tuple(t[:m] for t in muls), tuple(t[m:] for t in muls))
    return [tuple(t[j * half:(j + 1) * half] for t in out) for j in range(len(bases))]


def _fold_scalars(v: torch.Tensor, x_lo: int, x_hi: int) -> torch.Tensor:
    """v' = v_lo * x_lo + v_hi * x_hi over Montgomery Fr(n) rows."""
    half = v.shape[0] // 2
    xl = _fr([x_lo], v.device)[0].expand(v[:half].shape)
    xh = _fr([x_hi], v.device)[0].expand(v[:half].shape)
    return L.add_mod(L.mont_mul(v[:half], xl, _N_SPEC), L.mont_mul(v[half:], xh, _N_SPEC),
                     _N_SPEC)


def _points_equal(p, q) -> bool:
    ax, ay, ainf = C.to_affine(_P_OPS, p)
    bx, by, binf = C.to_affine(_P_OPS, q)
    return bool(torch.equal(ax, bx) and torch.equal(ay, by) and torch.equal(ainf, binf))


def _ipa_round(gg, hh, a, b, P, u, x: int, x_inv: int):
    """One halving round of the inner-product argument at challenge x:
    the cross inner products, L and R as one msm_pippenger_many over two
    (n+1)-point streams, the g/h basis folds as one 2n-point scalar_mul,
    P' = P + L*x^2 + R*x^-2, and the a/b scalar folds. Returns
    (gg', hh', a', b', P')."""
    half = a.shape[0] // 2
    dev = a.device
    g_lo, g_hi = tuple(t[:half] for t in gg), tuple(t[half:] for t in gg)
    h_lo, h_hi = tuple(t[:half] for t in hh), tuple(t[half:] for t in hh)

    cl = _tree_sum_fr(L.mont_mul(a[:half], b[half:], _N_SPEC))
    cr = _tree_sum_fr(L.mont_mul(a[half:], b[:half], _N_SPEC))

    # L and R as one batched MSM: bases [2, n+1], scalars [2, n+1]
    pts2 = tuple(torch.stack([torch.cat([ghi, hlo, up], dim=0), torch.cat([glo, hhi, up], dim=0)])
                 for glo, ghi, hlo, hhi, up in zip(g_lo, g_hi, h_lo, h_hi, u))
    scal2 = _fr_plain(torch.stack([torch.cat([a[:half], b[half:], cl[None]], dim=0),
                                   torch.cat([a[half:], b[:half], cr[None]], dim=0)]))
    lr = MSM.msm_pippenger_many(_P_OPS, pts2, scal2, 256)             # [2, K]

    gg2, hh2 = _fold_points((gg, hh), ((x_inv, x), (x, x_inv)))

    # P' = P + L*x^2 + R*x^-2
    x_m, xi_m = _fr([x, x_inv], dev)
    psc = _fr_plain(torch.stack([L.mont_mul(x_m, x_m, _N_SPEC), L.mont_mul(xi_m, xi_m, _N_SPEC)]))
    pm = C.scalar_mul(_P_OPS, lr, psc, 256)
    P2 = C.point_add(_P_OPS, C.point_add(_P_OPS, P, tuple(t[:1] for t in pm)),
                     tuple(t[1:] for t in pm))

    # scalar folds a' = a_lo*x + a_hi*x^-1, b' = b_lo*x^-1 + b_hi*x
    return gg2, hh2, _fold_scalars(a, x, x_inv), _fold_scalars(b, x_inv, x), P2


def _ipa_final(gg, hh, a, b, P, u) -> bool:
    """n == 1 terminal check: P == g*a + h*b + u*<a,b>."""
    c = _tree_sum_fr(L.mont_mul(a, b, _N_SPEC))
    pts = tuple(torch.cat([g, h, up], dim=0) for g, h, up in zip(gg, hh, u))
    scal = _fr_plain(torch.cat([a, b, c[None]], dim=0))
    muls = C.scalar_mul(_P_OPS, pts, scal, 256)
    rhs = C.point_add(
        _P_OPS,
        C.point_add(_P_OPS, tuple(t[:1] for t in muls), tuple(t[1:2] for t in muls)),
        tuple(t[2:] for t in muls))
    return _points_equal(P, rhs)


def _one(pt):
    """A point with no batch axis (an MSM result) as a batch of one."""
    return tuple(t[None] for t in pt)


class DeviceBulletproofs:
    """Interactive-model Bulletproofs with injected challenges and
    randomness (lists of ints consumed in transcript order), mirroring the
    host flow. Points are Jacobian tuples of int32 [.., 16] Montgomery limbs
    (ops/curve_ops.pack_points), scalar vectors Montgomery Fr(n) limbs
    (`_fr`), all on one device: the card unless the caller packed them on
    the CPU."""

    def __init__(self, challenges: list[int], randomness: list[int] | None = None):
        self._challenges = list(challenges)
        self._randomness = list(randomness or [])

    def _challenge(self) -> int:
        return self._challenges.pop(0) % N_ORDER

    def _rand(self) -> int:
        return self._randomness.pop(0) % N_ORDER

    def inner_product_argument(self, n, gg, hh, u, P, a, b) -> bool:
        """P == g^a h^b u^<a,b> (reference bulletproofs.rs:19-55). gg/hh:
        point tuples [n]; u/P: [1]; a/b: Montgomery Fr [n, K]. One
        `_ipa_round` per halving, then the terminal check."""
        while n > 1:
            x = self._challenge()
            gg, hh, a, b, P = _ipa_round(gg, hh, a, b, P, u, x, pow(x, -1, N_ORDER))
            n //= 2
        return _ipa_final(gg, hh, a, b, P, u)

    def range_proof(self, n, V, aL_bits: list[int], gamma: int, g, h, gg, hh,
                    use_inner_product_argument: bool) -> bool:
        """Range proof (reference bulletproofs.rs:58-147). V/g/h: points
        [1]; gg/hh: [n]; aL_bits host ints (the witness bit vector); gamma
        and the randomness injected."""
        dev = gg[0].device
        fr = lambda xs: _fr(xs, dev)
        add = lambda x, y: L.add_mod(x, y, _N_SPEC)
        mul = lambda x, y: L.mont_mul(x, y, _N_SPEC)
        one_n = [1] * n
        two_n = [pow(2, i, N_ORDER) for i in range(n)]
        aL = fr(aL_bits)
        aR = L.sub_mod(aL, fr(one_n), _N_SPEC)

        alpha = self._rand()
        A = C.point_add(_P_OPS, _single_mul(h, alpha),
                        C.point_add(_P_OPS, _one(_msm(gg, aL)), _one(_msm(hh, aR))))
        sL = fr([self._rand() for _ in range(n)])
        sR = fr([self._rand() for _ in range(n)])
        rho = self._rand()
        S = C.point_add(_P_OPS, _single_mul(h, rho),
                        C.point_add(_P_OPS, _one(_msm(gg, sL)), _one(_msm(hh, sR))))
        y = self._challenge()
        z = self._challenge()
        y_n = fr([pow(y, i, N_ORDER) for i in range(n)])
        z_m = fr([z] * n)
        z_sq = z * z % N_ORDER

        l0 = L.sub_mod(aL, z_m, _N_SPEC)
        l1 = sL
        r0 = add(mul(y_n, add(aR, z_m)), fr([t * z_sq % N_ORDER for t in two_n]))
        r1 = mul(y_n, sR)

        def to_int(mont_scalar):
            return L.unpack(mont_scalar[None], _N_SPEC)[0]

        t0 = to_int(_inner_product(l0, r0))
        t1 = (to_int(_inner_product(l1, r0)) + to_int(_inner_product(l0, r1))) % N_ORDER
        t2 = to_int(_inner_product(l1, r1))

        tau1, tau2 = self._rand(), self._rand()
        T1 = C.point_add(_P_OPS, _single_mul(g, t1), _single_mul(h, tau1))
        T2 = C.point_add(_P_OPS, _single_mul(g, t2), _single_mul(h, tau2))

        x = self._challenge()
        x_sq = x * x % N_ORDER
        t_hat = (t0 + t1 * x + t2 * x_sq) % N_ORDER
        tau_x = (tau2 * x_sq + tau1 * x + z_sq * gamma) % N_ORDER
        mu = (alpha + rho * x) % N_ORDER

        # (64): h'_i = h_i ^ (y^-i)
        y_inv = pow(y, -1, N_ORDER)
        y_inv_pows = C.pack_scalars([pow(y_inv, i, N_ORDER) for i in range(n)], 256, device=dev)
        hhp = C.scalar_mul(_P_OPS, hh, y_inv_pows, 256)

        # (65): g^t_hat h^tau_x == V^(z^2) g^delta(y,z) T1^x T2^(x^2)
        sum_y = sum(pow(y, i, N_ORDER) for i in range(n)) % N_ORDER
        sum_2 = sum(two_n) % N_ORDER
        delta = ((z - z_sq) * sum_y - pow(z, 3, N_ORDER) * sum_2) % N_ORDER
        lhs65 = C.point_add(_P_OPS, _single_mul(g, t_hat), _single_mul(h, tau_x))
        rhs65 = C.point_add(
            _P_OPS,
            C.point_add(_P_OPS, _single_mul(V, z_sq), _single_mul(g, delta)),
            C.point_add(_P_OPS, _single_mul(T1, x), _single_mul(T2, x_sq)))
        if not _points_equal(lhs65, rhs65):
            return False

        x_m = fr([x])[0]
        l_vec = add(l0, mul(l1, x_m.expand(l1.shape)))
        r_vec = add(r0, mul(r1, x_m.expand(r1.shape)))

        # P = A S^x g^(-z) (h')^(z y^n + z^2 2^n)  (66)
        hp_exp = add(mul(y_n, fr([z] * n)), fr([t * z_sq % N_ORDER for t in two_n]))
        neg_z = fr([(-z) % N_ORDER] * n)
        P = C.point_add(
            _P_OPS,
            C.point_add(_P_OPS, A, _single_mul(S, x)),
            C.point_add(_P_OPS, _one(_msm(gg, neg_z)), _one(_msm(hhp, hp_exp))))
        if not use_inner_product_argument:
            # (66)-(68) direct: P == g^l h'^r and t_hat == <l, r>
            rhs = C.point_add(
                _P_OPS,
                C.point_add(_P_OPS, _single_mul(h, mu), _one(_msm(gg, l_vec))),
                _one(_msm(hhp, r_vec)))
            if not _points_equal(P, rhs):
                return False
            return to_int(_inner_product(l_vec, r_vec)) == t_hat

        # IPA delegation: u = g * (random k), P' = P h^(-mu) u^<l,r>
        u_pt = _single_mul(g, self._rand())
        P_prime = C.point_add(
            _P_OPS,
            C.point_add(_P_OPS, P, _single_mul(h, (-mu) % N_ORDER)),
            _single_mul(u_pt, to_int(_inner_product(l_vec, r_vec))))
        return self.inner_product_argument(n, gg, hhp, u_pt, P_prime, l_vec, r_vec)

