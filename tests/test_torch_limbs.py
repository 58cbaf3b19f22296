"""The port's field layer (zk_toolkit_tpu_torch/ops/limbs.py, plain
versions on the CPU) against the JAX package's ops/limbs.py (XLA-CPU path),
bit for bit, for the Fq, Fr and secp256k1 moduli.

Inputs are numpy-seeded random rows plus the adversarial corner residues of
tests/test_pallas_parity.py (field boundaries, saturated limbs). The JAX
reference runs once per modulus on all rows (one compile per function); the
port runs on batches of 1, 255 and 257 rows cut from them. Tolerance:
exact equality of every limb.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_toolkit_tpu.curves import secp256k1
from zk_toolkit_tpu.curves.bls12_381 import params
from zk_toolkit_tpu.ops import limbs as JL
from zk_toolkit_tpu_torch import convert
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

MODULI = {
    "bls12_381_fq": params.Q,
    "bls12_381_fr": params.R,
    "secp256k1_p": secp256k1.P,
}
BATCHES = (1, 255, 257)


def _corner_values(p: int, k: int) -> list[int]:
    vals = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    sat = int("ffff" * k, 16)
    vals += [sat % p, (sat >> 16) % p, (1 << (16 * (k - 1))) % p]
    return vals


def _rows(p: int, seed: int):
    """uint32 [513, K] pair (a, b): corner x corner pairs, then random."""
    k = JL.field_spec(p).K
    rng = np.random.default_rng(seed)
    corners = _corner_values(p, k)
    pairs = [(x, y) for x in corners for y in corners]
    n = sum(BATCHES)
    a = [x for x, _ in pairs]
    b = [y for _, y in pairs]
    while len(a) < n:
        a.append(int.from_bytes(rng.bytes(2 * k), "little") % p)
        b.append(int.from_bytes(rng.bytes(2 * k), "little") % p)
    perm = rng.permutation(n)   # spread the corners over every batch
    a = [a[i] for i in perm]
    b = [b[i] for i in perm]
    return ints_to_array(a, k), ints_to_array(b, k)


def _batches(a: np.ndarray):
    lo = 0
    for n in BATCHES:
        yield lo, lo + n
        lo += n


UNARY = {
    "mont_sq": (lambda a, s: JL.mont_sq(a, s), TL.mont_sq),
    "to_mont": (lambda a, s: JL.to_mont(a, s), TL.to_mont),
    "from_mont": (lambda a, s: JL.from_mont(a, s), TL.from_mont),
    "neg_mod": (lambda a, s: JL.neg_mod(a, s), TL.neg_mod),
    "mont_inv": (lambda a, s: JL.mont_inv(a, s), TL.mont_inv),
}
BINARY = {
    "mont_mul": (lambda a, b, s: JL.mont_mul(a, b, s), TL.mont_mul),
    "add_mod": (lambda a, b, s: JL.add_mod(a, b, s), TL.add_mod),
    "sub_mod": (lambda a, b, s: JL.sub_mod(a, b, s), TL.sub_mod),
}


@pytest.mark.parametrize("fn", sorted(BINARY))
@pytest.mark.parametrize("name", sorted(MODULI))
def test_binary_ops_match_jax(name, fn):
    p = MODULI[name]
    jspec, tspec = JL.field_spec(p), TL.field_spec(p)
    a, b = _rows(p, seed=11)
    jfn, tfn = BINARY[fn]
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), jspec))
    for lo, hi in _batches(a):
        got = tfn(convert.limbs_from_jax(a[lo:hi], "cpu"),
                  convert.limbs_from_jax(b[lo:hi], "cpu"), tspec)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(convert.limbs_to_jax(got), want[lo:hi])


@pytest.mark.parametrize("fn", sorted(UNARY))
@pytest.mark.parametrize("name", sorted(MODULI))
def test_unary_ops_match_jax(name, fn):
    p = MODULI[name]
    jspec, tspec = JL.field_spec(p), TL.field_spec(p)
    a, _ = _rows(p, seed=12)
    jfn, tfn = UNARY[fn]
    want = np.asarray(jfn(jnp.asarray(a), jspec))
    for lo, hi in _batches(a):
        got = tfn(convert.limbs_from_jax(a[lo:hi], "cpu"), tspec)
        np.testing.assert_array_equal(convert.limbs_to_jax(got), want[lo:hi])


def test_neg_of_zero_is_zero():
    spec = TL.field_spec(params.Q)
    z = torch.zeros(3, spec.K, dtype=torch.int32)
    assert torch.equal(TL.neg_mod(z, spec), z)


def test_mont_inv_round_trip_host_oracle():
    """x * x^-1 == 1 through the port alone, against Python ints."""
    spec = TL.field_spec(params.Q)
    xs = [3, params.Q - 1, 2**200 + 7]
    xm = TL.pack(xs, spec, device="cpu")
    inv = TL.unpack(TL.mont_inv(xm, spec), spec)
    assert inv == [pow(x, -1, params.Q) for x in xs]


def test_mont_pow_static_plain_matches_jax_short_exponent():
    """One short exponent on Fq (one JAX compile): the plain chain against
    the JAX package's lax.scan chain, zero and p - 1 rows included."""
    p = params.Q
    jspec, tspec = JL.field_spec(p), TL.field_spec(p)
    a, _ = _rows(p, seed=13)
    a = a[:8]
    bits = (1, 0, 1, 1)
    want = np.asarray(JL.mont_pow_static(jnp.asarray(a), bits, jspec))
    got = TL.mont_pow_static_plain(convert.limbs_from_jax(a, "cpu"), bits, tspec)
    np.testing.assert_array_equal(convert.limbs_to_jax(got), want)


@pytest.mark.parametrize("name", ["bls12_381_fq", "bls12_381_fr"])
def test_mont_inv_plain_is_python_pow_in_montgomery_form(name):
    """a^(p-2) through the plain chain against Python's pow, as Montgomery
    limbs: x R -> x^(p-2) R mod p, zero -> zero."""
    p = MODULI[name]
    spec = TL.field_spec(p)
    rng = np.random.default_rng(14)
    xs = [0, 1, p - 1] + [int.from_bytes(rng.bytes(2 * spec.K), "little") % p for _ in range(5)]
    r = 1 << (16 * spec.K)
    xm = torch.from_numpy(ints_to_array([x * r % p for x in xs], spec.K).astype(np.int32))
    want = ints_to_array([pow(x, p - 2, p) * r % p for x in xs], spec.K)
    for fn in (TL.mont_inv_plain, lambda a, s: TL.mont_pow_static_plain(a, s.p_minus_2_bits, s)):
        np.testing.assert_array_equal(convert.limbs_to_jax(fn(xm, spec)), want)


def test_explicit_mul_runs_one_product_per_bit_and_set_bit():
    """mont_pow_static with an explicit multiply runs exactly that chain:
    one square per bit and one product per set bit, no launch."""
    spec = TL.field_spec(params.Q)
    a, _ = _rows(params.Q, seed=15)
    x = convert.limbs_from_jax(a[:4], "cpu")
    bits = (1, 0, 0, 1, 1, 0, 1)
    calls = []

    def mul(u, v):
        calls.append(1)
        return TL.mont_mul_plain(u, v, spec)

    got = TL.mont_pow_static(x, bits, spec, mul=mul)
    assert len(calls) == len(bits) + sum(bits)
    assert torch.equal(got, TL.mont_pow_static_plain(x, bits, spec))


def _chunks_value(chunks) -> tuple[int, int]:
    """(exponent, bit count) that a run of chain launches computes."""
    e = n = 0
    for words, nbits in chunks:
        assert len(words) == TL.EXP_CHUNK_BITS // 32 and 1 <= nbits <= TL.EXP_CHUNK_BITS
        chunk = sum(w << (32 * (len(words) - 1 - i)) for i, w in enumerate(words))
        assert chunk % (1 << (TL.EXP_CHUNK_BITS - nbits)) == 0   # zeros after the last bit
        e = (e << nbits) | (chunk >> (TL.EXP_CHUNK_BITS - nbits))
        n += nbits
    return e, n


@pytest.mark.parametrize("nbits", [1, 3, 255, 381, 384, 385, 769, 800])
def test_exp_chunks_split_an_exponent_into_launches_of_384_bits(nbits):
    rng = np.random.default_rng(nbits)
    bits = tuple(int(b) for b in rng.integers(0, 2, nbits))
    chunks = TL.exp_chunks(bits)
    assert len(chunks) == -(-nbits // TL.EXP_CHUNK_BITS)
    assert [n for _, n in chunks[:-1]] == [TL.EXP_CHUNK_BITS] * (len(chunks) - 1)
    assert _chunks_value(chunks) == (int("".join(map(str, bits)), 2), nbits)


def test_fermat_exponents_are_one_launch_and_no_exponent_none():
    for name in ("bls12_381_fq", "bls12_381_fr", "secp256k1_p"):
        p = MODULI[name]
        chunks = TL.exp_chunks(TL.field_spec(p).p_minus_2_bits)
        assert len(chunks) == 1 and _chunks_value(chunks) == (p - 2, p.bit_length())
    assert TL.exp_chunks(()) == ()


def test_cuda_entry_points_raise_without_a_card():
    """Entry points default to the card and never fall back silently."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = TL.field_spec(params.Q)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.pack([1, 2], spec)


def test_ints_to_array_equals_int_to_limbs_and_refuses_what_does_not_fit():
    from zk_toolkit_tpu_torch.utils.bigint import int_to_limbs

    rng = np.random.default_rng(5)
    xs = [0, 1, (1 << 256) - 1] + [int(rng.integers(0, 1 << 62)) ** 4 for _ in range(20)]
    arr = ints_to_array(xs, 16)
    assert arr.dtype == np.uint32 and arr.shape == (len(xs), 16)
    assert arr.tolist() == [int_to_limbs(x, 16) for x in xs]
    assert ints_to_array([], 16).shape == (0, 16)
    for bad in (1 << 256, -1):
        with pytest.raises(ValueError):
            ints_to_array([bad], 16)
