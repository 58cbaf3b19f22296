"""Bulletproofs on the CPU (plain versions): the port's device class
against the JAX package, with the same injected challenges and randomness.

- the port's host Bulletproofs (protocols/bulletproofs.py) against the JAX
  package's on the same Rng seed: the IPA, the range proof in both modes,
  a bad witness, and the Fiat-Shamir transcript;
- `_tree_sum_fr` and `_fold_scalars` against the JAX package's, limb for
  limb (their CPU compile is seconds);
- DeviceBulletproofs.inner_product_argument at n = 4: accepts the true
  statement and rejects P + G, as the JAX package's host Bulletproofs does
  on the same challenges;
- DeviceBulletproofs.range_proof at n = 8 in both modes, and with a
  flipped witness bit and with v >= 2^8: the same booleans as the JAX
  package's host Bulletproofs replaying the same challenges and randomness
  (the host draws them from one stream, in transcript order);
- one `_ipa_round` at n = 4 against the JAX package's `_ipa_round`, limb
  for limb (marked slow: its CPU compile takes minutes).

Tolerance: exact equality (integer limbs, booleans).
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import jax.numpy as jnp

from zk_toolkit_tpu.curves import secp256k1 as JS
from zk_toolkit_tpu.fields.prime_field import PrimeFieldElems as JElems
from zk_toolkit_tpu.protocols import bulletproofs as JB
from zk_toolkit_tpu.protocols import bulletproofs_device as JBD
from zk_toolkit_tpu.utils.rng import Rng as JRng
from zk_toolkit_tpu_torch import bench, convert
from zk_toolkit_tpu_torch.curves import secp256k1 as TS
from zk_toolkit_tpu_torch.ops import curve_ops as TC
from zk_toolkit_tpu_torch.ops import limbs as TL
from zk_toolkit_tpu_torch.protocols import bulletproofs as TB
from zk_toolkit_tpu_torch.protocols import bulletproofs_device as BD
from zk_toolkit_tpu_torch.utils.rng import Rng

N = TS.N
SPEC = TL.field_spec(TS.P)


class _Replay(JRng):
    """An Rng whose draws are a given list, in order (the host tier draws
    every challenge and random value through randint)."""

    def __init__(self, values):
        super().__init__(0)
        self.values = list(values)

    def randint(self, lo, hi):
        v = self.values.pop(0)
        assert lo <= v <= hi
        return v


def _pts(points):
    return TC.pack_points(points, SPEC, device="cpu")


def _jelems(xs):
    return JElems([JS.curve_group().elem(x) for x in xs])


# -- host copies ---------------------------------------------------------------

def _host_statement(mod, n: int, seed: int):
    f_n = mod.secp256k1.curve_group()
    r = (JRng if mod is JB else Rng)(seed)
    gg = mod.secp256k1.AffinePoints.rand_points(n, True, r)
    hh = mod.secp256k1.AffinePoints.rand_points(n, True, r)
    u = mod.secp256k1.rand_point(True, r)
    a = f_n.rand_elems(n, False, r)
    b = f_n.rand_elems(n, False, r)
    P = (gg * a).sum() + (hh * b).sum() + u * (a * b).sum()
    return gg, hh, u, P, a, b


@pytest.mark.parametrize("fiat_shamir", [False, True])
def test_host_bulletproofs_match_jax(fiat_shamir):
    n = 4
    outs = []
    for mod, rng_cls in ((JB, JRng), (TB, Rng)):
        gg, hh, u, P, a, b = _host_statement(mod, n, seed=21)
        bp = mod.Bulletproofs(rng_cls(22), fiat_shamir)
        ipa = bp.inner_product_argument(n, gg, hh, u, P, a, b)
        ipa_bad = mod.Bulletproofs(rng_cls(22), fiat_shamir).inner_product_argument(
            n, gg, hh, u, P + mod.secp256k1.g(), a, b)
        f_n = mod.secp256k1.curve_group()
        v, gamma = 11, f_n.elem(12345)
        g, h = mod.secp256k1.g(), mod.secp256k1.g() * 99
        V = h * gamma + g * v
        bits = [(v >> i) & 1 for i in range(n)]
        rp = []
        for use, flip in ((False, 0), (True, 0), (False, 1)):
            wit = mod.PrimeFieldElems([f_n.elem(x) for x in [bits[0] ^ flip] + bits[1:]])
            rp.append(mod.Bulletproofs(rng_cls(23), fiat_shamir).range_proof(
                n, V, wit, gamma, g, h, gg, hh, use))
        state = bp.transcript.state if fiat_shamir else None
        outs.append((ipa, ipa_bad, rp, state))
    assert outs[0] == outs[1]
    assert outs[1][0] and not outs[1][1] and outs[1][2] == [True, True, False]



# -- cheap device functions against the JAX package's -----------------------------

def test_tree_sum_and_fold_scalars_match_jax():
    rng = np.random.default_rng(50)
    for n in (1, 5, 8):
        xs = [int.from_bytes(rng.bytes(32), "little") % N for _ in range(n)]
        jv = JBD._fr(xs)
        tv = BD._fr(xs, "cpu")
        np.testing.assert_array_equal(convert.limbs_to_jax(tv), np.asarray(jv))
        np.testing.assert_array_equal(convert.limbs_to_jax(BD._tree_sum_fr(tv)),
                                      np.asarray(JBD._tree_sum_fr(jv)))
        if n % 2 == 0:
            x = xs[0] or 3
            got = BD._fold_scalars(tv, x, pow(x, -1, N))
            np.testing.assert_array_equal(convert.limbs_to_jax(got),
                                          np.asarray(JBD._fold_scalars(jv, x, pow(x, -1, N))))


# -- the device class on the CPU ---------------------------------------------------

def _ipa_statement(n: int, seed: int):
    """Bases, u, a, b, P = g^a h^b u^<a,b> and log2(n) challenges from
    random.Random(seed), as JAX host points."""
    rng = random.Random(seed)
    gg = [JS.g() * rng.randrange(1, N) for _ in range(n)]
    hh = [JS.g() * rng.randrange(1, N) for _ in range(n)]
    u = JS.g() * rng.randrange(1, N)
    a = [rng.randrange(N) for _ in range(n)]
    b = [rng.randrange(N) for _ in range(n)]
    P = u * (sum(x * y for x, y in zip(a, b)) % N)
    for gi, ai in zip(gg, a):
        P = P + gi * ai
    for hi, bi in zip(hh, b):
        P = P + hi * bi
    chal = [rng.randrange(1, N) for _ in range(n.bit_length() - 1)]
    return gg, hh, u, a, b, P, chal


@pytest.mark.parametrize("perturb", [False, True], ids=["true", "P+G"])
def test_ipa_matches_jax_host(perturb):
    n = 4
    gg, hh, u, a, b, P, chal = _ipa_statement(n, seed=11)
    if perturb:
        P = P + JS.g()
    want = JB.Bulletproofs(_Replay(chal)).inner_product_argument(
        n, JS.AffinePoints(gg), JS.AffinePoints(hh), u, P, _jelems(a), _jelems(b))
    got = BD.DeviceBulletproofs(chal).inner_product_argument(
        n, _pts(gg), _pts(hh), _pts([u]), _pts([P]), BD._fr(a, "cpu"), BD._fr(b, "cpu"))
    assert got == want == (not perturb)


def _host_draws(n: int, chal, rand, use_ipa: bool):
    """The host range proof's randint stream for the device's challenge and
    randomness lists: alpha, sL, sR, rho, y, z, tau1, tau2, x, then (IPA
    mode) u's scalar and the round challenges."""
    seq = [rand[0], *rand[1:1 + 2 * n], rand[1 + 2 * n], chal[0], chal[1],
           rand[2 + 2 * n], rand[3 + 2 * n], chal[2]]
    return seq + ([rand[4 + 2 * n], *chal[3:]] if use_ipa else [])


@pytest.mark.parametrize("case", ["direct", "ipa", "flipped_bit", "v_above_2^n"])
def test_range_proof_matches_jax_host(case):
    n = 8
    v = 300 if case == "v_above_2^n" else 157
    rng = random.Random(3)
    gamma = rng.randrange(1, N)
    h = JS.g() * rng.randrange(1, N)
    gg = [JS.g() * rng.randrange(1, N) for _ in range(n)]
    hh = [JS.g() * rng.randrange(1, N) for _ in range(n)]
    g = JS.g()        # u = g * k on the device, G * k on the host: the same point
    V = h * gamma + g * v
    bits = [(v >> i) & 1 for i in range(n)]
    if case == "flipped_bit":
        bits[0] ^= 1
    chal = [rng.randrange(1, N) for _ in range(3 + 3)]
    rand = [rng.randrange(1, N) for _ in range(2 * n + 5)]
    use_ipa = case == "ipa"
    want = JB.Bulletproofs(_Replay(_host_draws(n, chal, rand, use_ipa))).range_proof(
        n, V, _jelems(bits), JS.curve_group().elem(gamma), g, h, JS.AffinePoints(gg),
        JS.AffinePoints(hh), use_ipa)
    got = BD.DeviceBulletproofs(chal, rand).range_proof(
        n, _pts([V]), bits, gamma, _pts([g]), _pts([h]), _pts(gg), _pts(hh), use_ipa)
    assert got == want == (case in ("direct", "ipa"))


def test_benches_default_to_the_card():
    for f in (bench.bench_ipa, bench.bench_range_proof, bench.bench_ecdsa):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            f()


@pytest.mark.slow
def test_ipa_round_matches_jax_limb_for_limb():
    n = 4
    gg, hh, u, a, b, P, chal = _ipa_statement(n, seed=13)
    from zk_toolkit_tpu.ops import curve_ops as JC

    jspec = JBD._P_OPS.spec
    x = chal[0]
    xi = pow(x, -1, N)
    jout = JBD._ipa_round(JC.pack_points(gg, jspec), JC.pack_points(hh, jspec), JBD._fr(a),
                          JBD._fr(b), JC.pack_points([P], jspec), JC.pack_points([u], jspec),
                          JBD._fr([x])[0], JBD._fr([xi])[0])
    tout = BD._ipa_round(_pts(gg), _pts(hh), BD._fr(a, "cpu"), BD._fr(b, "cpu"), _pts([P]),
                         _pts([u]), x, xi)
    gg2, hh2, a2, b2, P2 = tout
    for t, j in zip((*gg2, *hh2, a2, b2, *P2),
                    (*jout[0], *jout[1], jout[2], jout[3], *jout[4])):
        np.testing.assert_array_equal(convert.limbs_to_jax(t), np.asarray(j))
