"""Host-side (raw Python int) Jacobian curve arithmetic: the oracle the
device path is checked against, and the CRS's "host" point mode (the
port's own copy of zk_toolkit_tpu/utils/host_curve.py).

Inversion-free Jacobian formulas (dbl-2009-l / add-2007-bl, the same as
ops/curve_ops.py) over bare values, with one modular inverse per
jac_to_affine. Field protocol: mul/sq/add/sub/dbl/inv/is_zero over raw
values, int for a prime field (FpHost: BLS12-381 G1, secp256k1) and
(u0, u1) int pairs for Fq2 (G2, Fp2Host, u^2 = -1). Points are (x, y, z)
triples; z == 0 means infinity.
"""

from __future__ import annotations

import numpy as np

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.utils.bigint import int_to_limbs


class FpHost:
    """Raw-int arithmetic mod p."""

    def __init__(self, p: int):
        self.p = p
        self.zero = 0
        self.one = 1

    def mul(self, a, b):
        return a * b % self.p

    def sq(self, a):
        return a * a % self.p

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def dbl(self, a):
        return 2 * a % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def is_zero(self, a):
        return a == 0


class Fp2Host:
    """(u0, u1) pairs over Fq with u^2 = -1 (BLS12-381 Fq2)."""

    def __init__(self, p: int):
        self.p = p
        self.zero = (0, 0)
        self.one = (1, 0)

    def mul(self, a, b):
        p = self.p
        a0, a1 = a
        b0, b1 = b
        return ((a0 * b0 - a1 * b1) % p, (a0 * b1 + a1 * b0) % p)

    def sq(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def dbl(self, a):
        p = self.p
        return (2 * a[0] % p, 2 * a[1] % p)

    def inv(self, a):
        p = self.p
        a0, a1 = a
        d = pow(a0 * a0 + a1 * a1, -1, p)
        return (a0 * d % p, -a1 * d % p)

    def is_zero(self, a):
        return a == (0, 0)


def jac_double(F, pt):
    x, y, z = pt
    if F.is_zero(z) or F.is_zero(y):
        return (F.one, F.one, F.zero)
    a = F.sq(x)
    b = F.sq(y)
    c = F.sq(b)
    d = F.dbl(F.sub(F.sub(F.sq(F.add(x, b)), a), c))
    e = F.add(F.dbl(a), a)
    f = F.sq(e)
    x3 = F.sub(f, F.dbl(d))
    c8 = F.dbl(F.dbl(F.dbl(c)))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.dbl(F.mul(y, z))
    return (x3, y3, z3)


def jac_add(F, p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if F.is_zero(z1):
        return p2
    if F.is_zero(z2):
        return p1
    z1z1 = F.sq(z1)
    z2z2 = F.sq(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(F.mul(y1, z2), z2z2)
    s2 = F.mul(F.mul(y2, z1), z1z1)
    h = F.sub(u2, u1)
    r = F.dbl(F.sub(s2, s1))
    if F.is_zero(h):
        if F.is_zero(r):
            return jac_double(F, p1)
        return (F.one, F.one, F.zero)
    i = F.sq(F.dbl(h))
    j = F.mul(h, i)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.sq(r), j), F.dbl(v))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.dbl(F.mul(s1, j)))
    z3 = F.mul(F.dbl(F.mul(z1, z2)), h)
    return (x3, y3, z3)


def jac_mul(F, pt, k: int):
    """k * P, left-to-right double-and-add over raw values."""
    acc = (F.one, F.one, F.zero)
    if k == 0 or F.is_zero(pt[2]):
        return acc
    for bit in bin(k)[2:]:
        acc = jac_double(F, acc)
        if bit == "1":
            acc = jac_add(F, acc, pt)
    return acc


def jac_to_affine(F, pt):
    """(x, y) or None (infinity) — one inverse total."""
    x, y, z = pt
    if F.is_zero(z):
        return None
    zi = F.inv(z)
    zi2 = F.sq(zi)
    return (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))


def from_affine(F, xy):
    if xy is None:
        return (F.one, F.one, F.zero)
    return (xy[0], xy[1], F.one)


def multi_mul(F, base_affine, scalars):
    """[k * G for k in scalars] as affine tuples (None = infinity)."""
    base = from_affine(F, base_affine)
    return [jac_to_affine(F, jac_mul(F, base, int(k))) for k in scalars]


G2_AFFINE = ((params.G2_X0, params.G2_X1), (params.G2_Y0, params.G2_Y1))


def g1_mul_affine(k: int):
    """k * G1 as an affine (x, y) int pair, or None."""
    F = FpHost(params.Q)
    g = from_affine(F, (params.G1_X, params.G1_Y))
    return jac_to_affine(F, jac_mul(F, g, k))


def affine_ints(pt):
    """(x, y) ints, or None for infinity, of a point given as an (x, y) int
    pair, None, or a host AffinePoint over a prime field (secp256k1,
    BLS12-381 G1: anything with is_zero() and PrimeFieldElem x, y)."""
    if pt is None or isinstance(pt, tuple):
        return pt
    return None if pt.is_zero() else (pt.x.e, pt.y.e)


def pack_g1_jac(affs, spec) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Points of a base-field curve (BLS12-381 G1 at K = 24, secp256k1 at
    K = 16), each as affine_ints takes it -> host Jacobian tuple (x, y, z)
    uint32[N, K], Montgomery form, infinity = (1, 1, 0).
    ops/curve_ops.pack_points moves it onto a device."""
    n = len(affs)
    xs = np.zeros((n, spec.K), dtype=np.uint32)
    ys = np.zeros((n, spec.K), dtype=np.uint32)
    zs = np.zeros((n, spec.K), dtype=np.uint32)
    one = int_to_limbs(spec.r_mod_p, spec.K)
    for i, a in enumerate(map(affine_ints, affs)):
        if a is None:
            xs[i] = one
            ys[i] = one
        else:
            xs[i] = int_to_limbs(a[0] * spec.r_mod_p % spec.p, spec.K)
            ys[i] = int_to_limbs(a[1] * spec.r_mod_p % spec.p, spec.K)
            zs[i] = one
    return (xs, ys, zs)


def pack_g2_jac(affs, spec) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Affine ((x0, x1), (y0, y1))/None list -> host Jacobian tuple with the
    Fq2 structure axis, uint32[N, 2, K] each, Montgomery form, infinity =
    (1, 1, 0)."""
    n = len(affs)
    xs = np.zeros((n, 2, spec.K), dtype=np.uint32)
    ys = np.zeros((n, 2, spec.K), dtype=np.uint32)
    zs = np.zeros((n, 2, spec.K), dtype=np.uint32)
    one = int_to_limbs(spec.r_mod_p, spec.K)
    for i, a in enumerate(affs):
        if a is None:
            xs[i, 0] = one
            ys[i, 0] = one
        else:
            (x0, x1), (y0, y1) = a
            xs[i, 0] = int_to_limbs(x0 * spec.r_mod_p % spec.p, spec.K)
            xs[i, 1] = int_to_limbs(x1 * spec.r_mod_p % spec.p, spec.K)
            ys[i, 0] = int_to_limbs(y0 * spec.r_mod_p % spec.p, spec.K)
            ys[i, 1] = int_to_limbs(y1 * spec.r_mod_p % spec.p, spec.K)
            zs[i, 0] = one
    return (xs, ys, zs)


def _limb_dot_mod_r(a_np: np.ndarray, b_np: np.ndarray, nbits_b: int) -> int:
    """sum_i int(a_i) * (int(b_i) mod 2^nbits_b)  mod r, computed from the
    16-bit limb matrices with ONE uint64 matmul: sum_i a_i b_i =
    sum_{j,l} 2^(16(j+l)) * (A^T B)[j,l]. Products < 2^32 and N <= 2^20 keep
    every accumulation below 2^52 — exact in uint64. This is the known-dlog
    check: with P_i = a_i * G, sum_i b_i P_i = (this value) * G."""
    a = np.asarray(a_np).astype(np.uint64)
    b = np.asarray(b_np).astype(np.uint64).copy()
    if a.shape[0] > 1 << 20:
        raise ValueError("uint64 accumulation is exact only up to 2^20 rows")
    top, rem = divmod(nbits_b, 16)
    if rem and b.shape[1] > top:
        b[:, top] &= (1 << rem) - 1
    if b.shape[1] > top + (1 if rem else 0):
        b[:, top + (1 if rem else 0):] = 0
    m = a.T @ b
    total = 0
    for j in range(m.shape[0]):
        for l in range(m.shape[1]):
            total += int(m[j, l]) << (16 * (j + l))
    return total % params.R
