"""Optimal-ate pairing for BLS12-381 (host tier) — the mcl-equivalent fast path.

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/optimal_ate.py;
the port imports nothing of the JAX package.)

The reference's accelerated backend calls herumi/mcl's `pairing()` which is an
optimal ate pairing (reference mcl/pairing.rs:9-18, Miller loop + final
exponentiation in C++). This module is the host oracle for the batched device
equivalent (ops/pairing_ops.py): a short Miller loop over the 64-bit BLS
parameter |u| = 0xd201000000010000 with lines computed on the sextic twist,
followed by the cyclotomic final exponentiation.

Normalization: `e(P, Q)` here returns the standard optimal-ate value raised to
the fixed power 3 — the hard part of the final exponentiation uses the exact
integer identity 3*(q^4 - q^2 + 1)/r = (u-1)^2 * (u+q) * (u^2 + q^2 - 1) + 3
(checked at import), which computes f^(3h) with three u-exponentiations
instead of a 4314-bit square-and-multiply. Since gcd(3, r) = 1, x^3 = y^3 in
the order-r group GT iff x = y, so every protocol pairing-product equation is
unchanged. The device tier reproduces this bit-exactly.

Math background (all standard):
- Fq12 viewed as Fq2[w]/(w^6 - xi), xi = 1 + u. Our nested tower
  Fq12 = Fq6[z]/(z^2 - w), Fq6 = Fq2[w]/(w^3 - xi) maps to the omega basis by
  omega = z: coefficient of omega^(j + 2k) lives at (w_j, v_k).
- BLS12-381's twist E': y^2 = x^3 + 4*xi over Fq2 is M-type; G1 points embed
  into E'(Fq12) via phi(x, y) = (x*omega^2, y*omega^3), so the whole Miller
  loop runs on the twist with line coefficients in Fq2.
- Line through T (doubling) or T,Q (addition) evaluated at phi(P) is sparse in
  the omega basis: c0 + c2*omega^2 + c3*omega^3. Scaling a line by any Fq2
  factor is erased by the (q^6-1) easy part of the final exponentiation, which
  is what lets the Jacobian device version avoid inversions.
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.curves.bls12_381.pairing import GTPoint
from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq1, Fq2, Fq6, Fq12, fq1
from zk_toolkit_tpu_torch.curves.weierstrass import AffinePoint

Q = params.Q
R = params.R
X = params.BLS_X  # |u|; u itself is negative (params.BLS_X_IS_NEGATIVE)


def miller_bits() -> list[int]:
    """MSB-first bits of |u| with the leading 1 dropped (63 iterations,
    5 addition steps)."""
    bits = [int(b) for b in bin(X)[2:]]
    return bits[1:]


# -- omega-basis view of Fq12 -------------------------------------------------

def fq12_from_omega(c: list[Fq2]) -> Fq12:
    """[c0..c5] coefficients of omega^i -> nested-tower Fq12.
    omega^(j+2k) <-> (w_j, v_k)."""
    w0 = Fq6(c[4], c[2], c[0])
    w1 = Fq6(c[5], c[3], c[1])
    return Fq12(w1, w0)


def fq12_to_omega(f: Fq12) -> list[Fq2]:
    return [f.w0.v0, f.w1.v0, f.w0.v1, f.w1.v1, f.w0.v2, f.w1.v2]


def _fq2_pow(base: Fq2, exp: int) -> Fq2:
    acc = Fq2.one()
    b = base
    while exp:
        if exp & 1:
            acc = acc * b
        b = b * b
        exp >>= 1
    return acc


XI = Fq2(fq1(1), fq1(1))  # 1 + u

assert Q % 6 == 1, "BLS12-381 q = 1 mod 6 (needed for Frobenius constants)"

#: gamma[p][i] = xi^(i * (q^p - 1) / 6): Frobenius twist constants for
#: f -> f^(q^p) in the omega basis, p = 1, 2, 3.
GAMMA: dict[int, list[Fq2]] = {}
for _p in (1, 2, 3):
    _e = (Q**_p - 1) // 6
    GAMMA[_p] = [_fq2_pow(XI, i * _e) for i in range(6)]

# The exact integer identity behind the fast hard part (u = -X):
_U = -X
_H = (Q**4 - Q**2 + 1) // R
assert (Q**4 - Q**2 + 1) % R == 0
assert 3 * _H == (_U - 1) ** 2 * (_U + Q) * (_U**2 + Q**2 - 1) + 3


def frobenius(f: Fq12, power: int) -> Fq12:
    """f^(q^power) for power in 1..3 via conjugation + gamma constants."""
    assert power in (1, 2, 3)
    cs = fq12_to_omega(f)
    out = []
    for i, c in enumerate(cs):
        if power % 2 == 1:
            c = c.conjugate()
        out.append(c * GAMMA[power][i])
    return fq12_from_omega(out)


# -- Miller loop on the twist --------------------------------------------------

def _dbl_step(t: AffinePoint, xp: Fq2, yp: Fq2) -> tuple[AffinePoint, Fq12]:
    """Tangent line at T on the twist, evaluated at phi(P); returns (2T, l)."""
    lam = (t.x.sq() * 3) / (t.y * 2)
    c0 = lam * t.x - t.y
    c2 = -(lam * xp)
    t2 = t.double()
    z = Fq2.zero()
    return t2, fq12_from_omega([c0, z, c2, yp, z, z])


def _add_step(t: AffinePoint, q: AffinePoint, xp: Fq2, yp: Fq2) -> tuple[AffinePoint, Fq12]:
    """Chord line through T and Q, evaluated at phi(P); returns (T+Q, l)."""
    lam = (t.y - q.y) / (t.x - q.x)
    c0 = lam * q.x - q.y
    c2 = -(lam * xp)
    z = Fq2.zero()
    return t + q, fq12_from_omega([c0, z, c2, yp, z, z])


def miller_loop(p: AffinePoint, q: AffinePoint) -> Fq12:
    """f_{|u|, Q}(phi(P)) on the twist; conjugated at the end because the BLS
    parameter u is negative (conjugation differs from inversion by a factor
    killed by the final exponentiation since r | q^6 + 1)."""
    f = Fq12.one()
    t = q
    xp = Fq2(fq1(0), p.x)
    yp = Fq2(fq1(0), p.y)
    for bit in miller_bits():
        t, l = _dbl_step(t, xp, yp)
        f = f.sq() * l
        if bit:
            t, l = _add_step(t, q, xp, yp)
            f = f * l
    return f.conjugate()


# -- final exponentiation ------------------------------------------------------

def easy_part(f: Fq12) -> Fq12:
    """f^((q^6 - 1)(q^2 + 1)): lands in the cyclotomic subgroup, where
    inversion = conjugation."""
    m = f.conjugate() * f.inv()        # f^(q^6 - 1)
    return frobenius(m, 2) * m         # ^(q^2 + 1)


def _pow_u(f: Fq12) -> Fq12:
    """f^u for the (negative) BLS parameter u: pow by |u| then conjugate.
    Valid only for cyclotomic f (inverse = conjugate)."""
    acc = f
    for bit in miller_bits():
        acc = acc.sq()
        if bit:
            acc = acc * f
    return acc.conjugate()


def hard_part_x3(m: Fq12) -> Fq12:
    """m^(3 * (q^4 - q^2 + 1) / r) via the addition-chain identity
    (u-1)^2 (u+q) (u^2+q^2-1) + 3, for cyclotomic m."""
    um = _pow_u(m)
    a = um * m.conjugate()             # m^(u-1)
    ua = _pow_u(a)
    a = ua * a.conjugate()             # m^((u-1)^2)
    b = _pow_u(a) * frobenius(a, 1)    # a^(u+q)
    c = _pow_u(_pow_u(b)) * frobenius(b, 2) * b.conjugate()   # b^(u^2+q^2-1)
    return c * m.sq() * m              # * m^3


def final_exp(f: Fq12) -> Fq12:
    """f^(3 * (q^12 - 1) / r) — the cubed standard final exponentiation."""
    return hard_part_x3(easy_part(f))


class OptimalAtePairing:
    """Drop-in bilinear pairing with the same protocol-facing shape as
    `Pairing` (curves/bls12_381/pairing.py) but ~50x less work: 63-iteration
    Miller loop vs 255, and a 3-u-exponentiation hard part vs a 4314-bit pow.
    Returns the standard optimal-ate value cubed (see module docstring)."""

    def e(self, p1: AffinePoint, p2: AffinePoint) -> GTPoint:
        """p1 in G1 (Fq coords), p2 in G2 (Fq2 coords)."""
        if p1.is_zero() or p2.is_zero():
            return GTPoint(Fq12.one())
        return GTPoint(final_exp(miller_loop(p1, p2)))
