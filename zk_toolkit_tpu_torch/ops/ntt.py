"""Radix-2 NTT/INTT over BLS12-381 Fr on the device (the port of
zk_toolkit_tpu/ops/ntt.py, with its row-batched `dit_rows`, the local
transform of the four-step sharded NTT in parallel/sharded_ntt.py).

The Groth16 prove works in evaluation form over H = <w_n>, n a power of
two (Fr has 2-adicity 32); t(x) = x^n - 1 is the constant g^n - 1 on the
coset gH, so dividing by it is one multiplication by a constant there.

An evaluation or coefficient vector is an int32 [n, K] Montgomery tensor,
K = 16. A butterfly stage is one stacked Montgomery product (kernel B1 on a
card, the twiddle row broadcast over the blocks) and one add_mod and one
sub_mod, the plain PyTorch versions on every device. The operations and
their order are the JAX package's, so the limbs are its limbs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device
from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.utils.bigint import ints_to_array

#: Smallest generator of Fr*; the 2^32-th root of unity and every domain
#: root derive from it.
FR_GENERATOR = 7

R = params.R


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclasses.dataclass(frozen=True, eq=False)
class NttDomain:
    """Tables of a size-n (power of two) evaluation domain over Fr, as
    tensors on `device`: per-stage twiddles of the forward and inverse DIT
    butterflies, the bit-reversal permutation, n^-1, the coset-shift powers
    of FR_GENERATOR and (g^n - 1)^-1."""

    n: int
    device: torch.device

    def __post_init__(self):
        n = self.n
        if n < 2 or n & (n - 1):
            raise ValueError("domain size must be a power of 2")
        log_n = n.bit_length() - 1
        if log_n > 32:
            raise ValueError("Fr 2-adicity is 32")
        spec = L.field_spec(R)
        dev = self.device

        def mont(vals):
            arr = ints_to_array([v * spec.r_mod_p % R for v in vals], spec.K)
            return torch.from_numpy(arr.astype(np.int32)).to(dev)

        def powers(base, count):
            out, cur = [], 1
            for _ in range(count):
                out.append(cur)
                cur = cur * base % R
            return out

        w = pow(FR_GENERATOR, (R - 1) >> log_n, R)   # primitive n-th root
        w_inv = pow(w, -1, R)

        def stage_tables(root):
            return tuple(mont(powers(pow(root, n >> s, R), 1 << (s - 1)))
                         for s in range(1, log_n + 1))

        g = FR_GENERATOR
        t_coset = (pow(g, n, R) - 1) % R   # t(x) = x^n - 1 on the coset gH
        set_ = functools.partial(object.__setattr__, self)
        set_("spec", spec)
        set_("log_n", log_n)
        set_("w", w)
        set_("twiddles", stage_tables(w))
        set_("inv_twiddles", stage_tables(w_inv))
        set_("bitrev", torch.from_numpy(_bit_reverse_perm(n)).to(dev))
        set_("n_inv_mont", mont([pow(n, -1, R)])[0])
        set_("coset_pows", mont(powers(g, n)))
        set_("coset_pows_inv", mont(powers(pow(g, -1, R), n)))
        set_("t_coset_inv_mont", mont([pow(t_coset, -1, R)])[0])


@functools.lru_cache(maxsize=None)
def _domain(n: int, device: torch.device) -> NttDomain:
    return NttDomain(n, device)


def fr_domain(n: int, device="cuda") -> NttDomain:
    """The size-n domain with its tables on `device` (cached)."""
    return _domain(n, resolve_device(device))


def _dit(dom: NttDomain, x, tables, spans=None):
    """Iterative decimation-in-time butterflies; bit-reversed input ->
    natural-order output. `spans` times the products (`ntt_b1`) and the
    additions (`ntt_addsub`) apart."""
    span = spans.span if spans is not None else contextlib.nullcontext
    spec = dom.spec
    n = dom.n
    x = x[dom.bitrev]
    for s in range(1, dom.log_n + 1):
        half = 1 << (s - 1)
        m = 1 << s
        x = x.reshape(n // m, m, spec.K)
        u = x[:, :half]
        with span("ntt_b1"):
            v = L.mont_mul(x[:, half:], tables[s - 1][None], spec)
        with span("ntt_addsub"):
            x = torch.cat([L.add_mod(u, v, spec), L.sub_mod(u, v, spec)], dim=1)
    return x.reshape(n, spec.K)


def dit_rows(dom: NttDomain, x, inverse: bool = False):
    """Row-batched DIT butterflies: transform axis -2 of x [..., n, K] for
    every row of the leading axes in one pass, natural order in and out
    (the bit reversal inside), no 1/n. The local transform of the four-step
    sharded NTT (parallel/sharded_ntt.py); the operations and their order
    are the JAX package's."""
    spec = dom.spec
    n = dom.n
    if x.shape[-2] != n:
        raise ValueError(f"dit_rows over a size-{n} domain got rows of {x.shape[-2]}")
    tables = dom.inv_twiddles if inverse else dom.twiddles
    lead = tuple(x.shape[:-2])
    x = x.index_select(-2, dom.bitrev)
    for s in range(1, dom.log_n + 1):
        half = 1 << (s - 1)
        m = 1 << s
        x = x.reshape(lead + (n // m, m, spec.K))
        u = x[..., :half, :]
        v = L.mont_mul(x[..., half:, :], tables[s - 1], spec)
        x = torch.cat([L.add_mod(u, v, spec), L.sub_mod(u, v, spec)], dim=-2)
    return x.reshape(lead + (n, spec.K))


def ntt(dom: NttDomain, coeffs, spans=None):
    """Coefficients (little-endian degree order) -> evaluations at
    w^0..w^(n-1)."""
    return _dit(dom, coeffs, dom.twiddles, spans)


def intt(dom: NttDomain, evals, spans=None):
    """Evaluations -> coefficients."""
    x = _dit(dom, evals, dom.inv_twiddles, spans)
    return L.mont_mul(x, dom.n_inv_mont[None], dom.spec)


def coset_ntt(dom: NttDomain, coeffs, spans=None):
    """Evaluations at g*w^j (coset gH): scale coefficient i by g^i, then NTT."""
    scaled = L.mont_mul(coeffs, dom.coset_pows, dom.spec)
    return _dit(dom, scaled, dom.twiddles, spans)


def coset_intt(dom: NttDomain, evals, spans=None):
    x = _dit(dom, evals, dom.inv_twiddles, spans)
    x = L.mont_mul(x, dom.n_inv_mont[None], dom.spec)
    return L.mont_mul(x, dom.coset_pows_inv, dom.spec)


def h_coset_then_coeffs(dom: NttDomain, a_ev, b_ev, c_ev, spans=None):
    """h coefficients from A/B/C evaluations over H:
    h(g w^j) = (A*B - C)(g w^j) * (g^n - 1)^-1, then coset-INTT. Seven
    transforms."""
    spec = dom.spec
    ac = intt(dom, a_ev, spans)
    bc = intt(dom, b_ev, spans)
    cc = intt(dom, c_ev, spans)
    a_cs = coset_ntt(dom, ac, spans)
    b_cs = coset_ntt(dom, bc, spans)
    c_cs = coset_ntt(dom, cc, spans)
    ab = L.mont_mul(a_cs, b_cs, spec)
    num = L.sub_mod(ab, c_cs, spec)
    h_cs = L.mont_mul(num, dom.t_coset_inv_mont[None], spec)
    return coset_intt(dom, h_cs, spans)
