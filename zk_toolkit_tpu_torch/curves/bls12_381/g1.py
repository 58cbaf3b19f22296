"""BLS12-381 G1: E(Fq): y^2 = x^3 + 4.

(The port's own copy of zk_toolkit_tpu/curves/bls12_381/g1.py;
the port imports nothing of the JAX package.)

Parity: reference curves/bls12_381/g1_point.rs — generator (:38-47),
affine add + double-and-add mul via the shared Weierstrass law,
`get_random_point` (:83-89), subgroup order as scalar group (:91-94).
"""

from __future__ import annotations

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.curves.bls12_381.tower import Fq1, fq1
from zk_toolkit_tpu_torch.curves.weierstrass import WeierstrassCurve, AffinePoint
from zk_toolkit_tpu_torch.utils.rng import Rng, GLOBAL_RNG

GX = int(
    "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb",
    16,
)
GY = int(
    "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
    "d03cc744a2888ae40caa232946c5e7e1",
    16,
)

CURVE = WeierstrassCurve(
    a=params.BASE_PRIME_FIELD.zero(),
    b=params.BASE_PRIME_FIELD.elem(4),
    zero=params.BASE_PRIME_FIELD.zero(),
    one=params.BASE_PRIME_FIELD.one(),
    order=params.R,
    name="bls12_381_g1",
)

G1Point = AffinePoint  # points are generic affine points on CURVE


def g() -> AffinePoint:
    return CURVE.point(fq1(GX), fq1(GY))


def point(x: int | Fq1, y: int | Fq1) -> AffinePoint:
    return CURVE.point(params.BASE_PRIME_FIELD.elem(x), params.BASE_PRIME_FIELD.elem(y))


def infinity() -> AffinePoint:
    return CURVE.infinity()


def get_random_point(rng: Rng | None = None) -> AffinePoint:
    """g * uniform scalar in [0, r) (g1_point.rs:83-89)."""
    rng = rng or GLOBAL_RNG
    return g() * rng.randint(0, params.R - 1)
