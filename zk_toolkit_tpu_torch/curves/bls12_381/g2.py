"""BLS12-381 G2: E'(Fq2): y^2 = x^3 + 4(1 + u).

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/g2.py;
the port imports nothing of the JAX package.)

Parity: reference curves/bls12_381/g2_point.rs — generator constants
(:36-46), `is_on_curve` with b = four.reduce() (:76-81), and the
`hash_to_g2point` placeholder (g2 * scalar from BE message bytes, :83-88 —
explicitly not a real hash-to-curve in the reference). The JAX package's
`hash_to_g2point_swu` needs its hashers, which the port has not taken yet.
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
