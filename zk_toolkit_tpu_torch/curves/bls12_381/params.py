"""BLS12-381 constants as plain ints: base field modulus Q, subgroup order
R, and the G1 generator's affine coordinates (E: y^2 = x^3 + 4 over Fq).
The same values as zk_toolkit_tpu/curves/bls12_381/{params,g1}.py."""

#: Base field modulus q (381 bits)
Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
#: Subgroup order r (255 bits)
R = int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001", 16)

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
