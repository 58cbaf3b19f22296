"""BLS12-381 parameters: base field modulus Q, subgroup order R, the field
objects of the host tier, the BLS parameter x, and the G1 and G2
generators as plain ints (E: y^2 = x^3 + 4 over Fq, E': y^2 = x^3 +
4(1 + u) over Fq2), and the accessors base_prime_field, subgroup and
embedding_degree. The same values as
zk_toolkit_tpu/curves/bls12_381/{params,g1,g2}.py."""

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField

#: Base field modulus q (381 bits)
Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
#: Subgroup order r (255 bits); 2-adicity 32 (r - 1 = 2^32 * odd), which is
#: what makes radix-2 NTT over Fr possible for the QAP pipeline.
R = int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16)

EMBEDDING_DEGREE = 12

#: BLS parameter x (the curve was generated from x = -0xd201000000010000);
#: the optimal-ate Miller loop and final exponentiation run over |x|.
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

BASE_PRIME_FIELD = PrimeField(Q)
SUBGROUP = PrimeField(R)

#: G1 generator, affine
G1_X = int(
    "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb",
    16,
)
G1_Y = int(
    "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
    "d03cc744a2888ae40caa232946c5e7e1",
    16,
)

#: G2 generator, affine: x = G2_X0 + G2_X1 u, y = G2_Y0 + G2_Y1 u
G2_X0 = int(
    "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8", 16)
G2_X1 = int(
    "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049334cf11213945d57e5ac7d055d042b7e", 16)
G2_Y0 = int(
    "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c923ac9cc3baca289e193548608b82801", 16)
G2_Y1 = int(
    "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab3f370d275cec1da1aaa9075ff05f79be", 16)


def base_prime_field() -> PrimeField:
    return BASE_PRIME_FIELD


def subgroup() -> PrimeField:
    return SUBGROUP


def embedding_degree() -> int:
    return EMBEDDING_DEGREE
