"""BLS12-381 G2: E'(Fq2): y^2 = x^3 + 4(1 + u).

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/g2.py;
the port imports nothing of the JAX package.)

Parity: reference curves/bls12_381/g2_point.rs — generator constants
(:36-46), `is_on_curve` with b = four.reduce() (:76-81), and the
`hash_to_g2point` placeholder (g2 * scalar from BE message bytes, :83-88 —
explicitly not a real hash-to-curve in the reference; `hash_to_g2point_swu`
below is the proper mcl-equivalent).
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq2, fq1_from_u8_slice
from zk_toolkit_tpu_torch.curves.weierstrass import WeierstrassCurve, AffinePoint

# Generator coordinates; x = x0 + x1*u, y = y0 + y1*u (g2_point.rs:36-46).
G2X1 = "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049334cf11213945d57e5ac7d055d042b7e"
G2X0 = "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8"
G2Y1 = "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab3f370d275cec1da1aaa9075ff05f79be"
G2Y0 = "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c923ac9cc3baca289e193548608b82801"

CURVE = WeierstrassCurve(
    a=Fq2.zero(),
    b=Fq2.from_int(4).reduce(),  # 4 * (1 + u)
    zero=Fq2.zero(),
    one=Fq2.one(),
    order=params.R,
    name="bls12_381_g2",
)

G2Point = AffinePoint


def g() -> AffinePoint:
    x = Fq2(fq1_from_u8_slice(G2X1), fq1_from_u8_slice(G2X0))
    y = Fq2(fq1_from_u8_slice(G2Y1), fq1_from_u8_slice(G2Y0))
    return CURVE.point(x, y)


def point(x: Fq2, y: Fq2) -> AffinePoint:
    return CURVE.point(x, y)


def infinity() -> AffinePoint:
    return CURVE.infinity()


def is_on_curve(x: Fq2, y: Fq2) -> bool:
    return CURVE.is_on_curve(x, y)


def hash_to_g2point(buf: bytes) -> AffinePoint:
    """Reference-parity placeholder: g2 * (BE int of message mod r)
    (g2_point.rs:83-88). Kept for bit-exact compatibility."""
    n = int.from_bytes(bytes(buf), "big") % params.R
    return g() * n


def hash_to_g2point_swu(buf: bytes, dst: bytes = b"ZK_TOOLKIT_TPU_BLS_SIG_V1") -> AffinePoint:
    """Proper hash-to-G2 (the mcl `hash_and_map` equivalent,
    reference: mcl/mcl_g2.rs:41-46): hash-and-check with SHA-256 counter mode.

    Deterministic try-and-increment: derive Fq2 x-candidates from
    SHA-256(dst || counter || msg) until x^3 + b is a square in Fq2, then
    clear the cofactor. Not constant-time (signing hashes are public inputs).
    """
    from zk_toolkit_tpu_torch.hashers.sha256 import Sha256
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import fq1

    q = params.Q
    # G2 cofactor (standard BLS12-381 value)
    h2 = int(
        "5d543a95414e7f1091d50792876a202cd91de4547085abaa68a205b2e5a7ddfa"
        "628f1cb4d9e82ef21537e293a6691ae1616ec6e786f0c70cf1c38e31c7238e5",
        16,
    )
    ctr = 0
    while True:
        seed = Sha256.get_digest(dst + ctr.to_bytes(4, "big") + bytes(buf))
        seed2 = Sha256.get_digest(seed)
        # build two Fq coordinates from 64 bytes of hash output each
        c0 = int.from_bytes(seed + seed2, "big") % q
        seed3 = Sha256.get_digest(seed2)
        seed4 = Sha256.get_digest(seed3)
        c1 = int.from_bytes(seed3 + seed4, "big") % q
        x = Fq2(fq1(c1), fq1(c0))
        rhs = x * x * x + CURVE.b
        y = _fq2_sqrt(rhs)
        if y is not None:
            p = CURVE.point(x, y) * h2  # clear cofactor into the r-subgroup
            if not p.is_zero():
                return p
        ctr += 1


def _fq2_sqrt(a: Fq2) -> Fq2 | None:
    """Square root in Fq2 via the norm/trace method (complex method for
    q = 3 mod 4): sqrt(a0 + a1 u) from sqrt of the norm in Fq."""
    from zk_toolkit_tpu_torch.curves.bls12_381.tower import fq1

    q = params.Q
    a0, a1 = a.u0.e, a.u1.e
    if a1 == 0:
        s = _fq_sqrt(a0)
        if s is not None:
            return Fq2(fq1(0), fq1(s))
        # a0 is a non-residue: sqrt(a0) = sqrt(-a0) * u since u^2 = -1
        s = _fq_sqrt((-a0) % q)
        if s is None:
            return None
        return Fq2(fq1(s), fq1(0))
    norm = (a0 * a0 + a1 * a1) % q
    n = _fq_sqrt(norm)
    if n is None:
        return None
    inv2 = pow(2, -1, q)
    x0 = (a0 + n) % q * inv2 % q
    s0 = _fq_sqrt(x0)
    if s0 is None:
        x0 = (a0 - n) % q * inv2 % q
        s0 = _fq_sqrt(x0)
        if s0 is None:
            return None
    # y = s0 + (a1 / (2 s0)) u
    y1 = a1 * pow(2 * s0 % q, -1, q) % q
    return Fq2(fq1(y1), fq1(s0))


def _fq_sqrt(a: int) -> int | None:
    """Square root mod q (q = 3 mod 4): a^((q+1)/4)."""
    q = params.Q
    a %= q
    if a == 0:
        return 0
    s = pow(a, (q + 1) // 4, q)
    return s if s * s % q == a else None
