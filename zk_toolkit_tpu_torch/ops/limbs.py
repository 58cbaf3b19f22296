"""Batched multi-precision modular arithmetic: 16-bit limbs, Montgomery
form (the port of zk_toolkit_tpu/ops/limbs.py).

Layout contract, shared with the JAX package so results compare limb for
limb: a field element is a little-endian vector of K 16-bit limbs, batched
as [..., K]; K = 24 for BLS12-381 Fq, 16 for Fr and secp256k1. The port
stores limbs as torch.int32 (values < 2^16, so the sign bit is never set);
torch.uint32 has no CPU add or shift.

Two implementations of every Montgomery product and static-exponent chain:

- kernel B1 (csrc/mont_mul.cu), which `mont_mul` launches for every CUDA
  tensor, at every batch size, and whose chain entry `mont_pow_static` and
  `mont_inv` launch once per 384 exponent bits;
- the plain PyTorch versions (`mont_mul_plain`, `mont_pow_static_plain`,
  `mont_inv_plain`), in int64, which the wrappers run for CPU tensors only,
  and which the tests and chip_smoke.py hold the kernel against. A limb
  product reaches 2^32 - 2^17 + 1, so the plain version never computes in
  int32.

The plain versions compute the same integer functions as the JAX package
on every input whose limbs are < 2^16, canonical or not:
  mont_mul: T = (a*b + m*p) / R, m = a*b*(-p^-1) mod R;  T >= p ? T - p : T
  add_mod:  s = a + b;  (s >= p ? s - p : s) mod R
  sub_mod:  a >= b ? a - b : (a - b + p) mod R
  neg_mod:  a == 0 ? 0 : (p - a) mod R
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from zk_toolkit_tpu_torch.utils.bigint import (LIMB_BITS, LIMB_MASK, int_to_limbs, ints_to_array,
                                              num_limbs)

MASK = LIMB_MASK


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static per-field constants (precomputed on host)."""

    p: int
    K: int
    nbits: int
    n0inv: int           # -p^-1 mod 2^16
    r_mod_p: int         # R mod p,  R = 2^(16K)
    r2_mod_p: int        # R^2 mod p
    p_minus_2_bits: tuple  # MSB-first bits of p-2 (for Fermat inverse)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return np.asarray(int_to_limbs(self.p, self.K), dtype=np.uint32)

    @functools.cached_property
    def nprime(self) -> int:
        """-p^-1 mod R (the full-width Montgomery constant)."""
        r = 1 << (LIMB_BITS * self.K)
        return (-pow(self.p, -1, r)) % r

    @functools.cached_property
    def p_words32(self) -> tuple:
        """p as K/2 little-endian 32-bit words (the kernels' radix)."""
        return tuple((self.p >> (32 * i)) & 0xFFFFFFFF for i in range(self.K // 2))

    @functools.cached_property
    def n0inv32(self) -> int:
        """-p^-1 mod 2^32."""
        return (-pow(self.p, -1, 1 << 32)) % (1 << 32)


@functools.lru_cache(maxsize=None)
def field_spec(p: int) -> FieldSpec:
    if p % 2 == 0:
        raise ValueError("Montgomery arithmetic requires an odd modulus")
    nbits = p.bit_length()
    k = num_limbs(nbits)
    r = 1 << (LIMB_BITS * k)
    n0inv = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    e = p - 2
    bits = tuple(int(b) for b in bin(e)[2:]) if e > 0 else (0,)
    return FieldSpec(
        p=p,
        K=k,
        nbits=nbits,
        n0inv=n0inv,
        r_mod_p=r % p,
        r2_mod_p=(r * r) % p,
        p_minus_2_bits=bits,
    )


@functools.lru_cache(maxsize=None)
def const_limbs(value: int, k: int, device: str, dtype=torch.int32) -> torch.Tensor:
    """A constant limb vector [k] on `device` (cached)."""
    return torch.tensor(int_to_limbs(value, k), dtype=dtype, device=device)


def _dev(t: torch.Tensor) -> str:
    return str(t.device)


# -- plain PyTorch versions ---------------------------------------------------
#
# Inside, limbs are int64 and limb-major: [n, B] with B the flattened batch,
# so a limb is one contiguous row. A limb product is < 2^32 and a column of a
# schoolbook product adds at most K of them, < 2^37.

def _limb_major(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.reshape(-1, k).T.contiguous().long()


def _batch_major(t: torch.Tensor, shape) -> torch.Tensor:
    return t.T.int().reshape(shape)


def _col(value: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """Constant limb vector as an int64 [n, 1] column."""
    return const_limbs(value, n, _dev(like), torch.int64)[:, None]


def _norm(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate int64 limb-major columns [n, B]: limbs 0..n-2 end in
    [0, 2^16), the top limb keeps the rest (it may exceed 2^16 or be
    negative). The value sum_i t_i 2^(16 i) is unchanged.

    Whole-array passes repeat until no carry is left; each moves every
    carry one limb up. Random limbs settle in 3-4 passes, a run of 0xFFFF
    (or, borrowing, 0) limbs takes one pass per limb. A pass is a few large
    ops, where a sweep up the limbs is three small ops per limb."""
    while True:
        hi = t[:-1] >> LIMB_BITS
        if not bool(hi.any()):
            return t
        lo = t & MASK
        lo[-1] = t[-1]
        lo[1:] += hi
        t = lo


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[K, B] x [K, B] -> [2K, B], out[c] = sum_{i+j=c} a_i b_j, carry-free:
    K shifted rows added in float64 (exact: every partial sum is an integer
    below 2^53)."""
    k, n = a.shape
    af, bf = a.double(), b.double()
    out = torch.zeros(2 * k, n, dtype=torch.float64, device=a.device)
    for i in range(k):
        out[i:i + k].addcmul_(af[i].expand(k, n), bf)
    return out.long()


@functools.lru_cache(maxsize=None)
def _toeplitz(value: int, k: int, device: str) -> torch.Tensor:
    """[2K, K] float64 matrix of a constant: T @ x gives the columns of
    value * x (exact, as in _cols)."""
    b = torch.tensor(int_to_limbs(value, k), dtype=torch.float64)
    t = torch.zeros(2 * k, k, dtype=torch.float64)
    for i in range(k):
        t[i:i + k, i] = b
    return t.to(device)


def _cols_const(a: torch.Tensor, value: int) -> torch.Tensor:
    """Columns of value * a for a constant `value` of K limbs: [2K, B]."""
    return (_toeplitz(value, a.shape[0], _dev(a)) @ a.double()).long()


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of limb-major [K, B] operands as 2K normalized limbs."""
    return _norm(_cols(a, b))


def mont_redc(t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery reduction of a limb-major [2K, B] value t < R^2 (a
    mul_wide product): T = (t + m*p) / R with m = t*(-p^-1) mod R, then
    T - p where T >= p. Returns [K, B]."""
    k = spec.K
    lo = t[:k]                                           # t mod R
    m = _norm(_cols_const(lo, spec.nprime)[:k])
    m[-1] &= MASK                                        # t*(-p^-1) mod R
    mp = _norm(_cols_const(m, spec.p))                   # m*p, 2K limbs
    # The low halves of t and m*p sum to 0 or exactly R (they cancel mod
    # R), so the division by R carries 1 iff t mod R != 0.
    big = F.pad(t[k:] + mp[k:], (0, 0, 0, 1))
    big[0] += (lo != 0).any(0).long()
    big = _norm(big)                                     # T, K+1 limbs
    d = _norm(big - _col(spec.p, k + 1, big))
    return torch.where(d[-1] >= 0, d, big)[:k]


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, plain PyTorch (any device)."""
    a, b = torch.broadcast_tensors(a, b)
    prod = mul_wide(_limb_major(a, spec.K), _limb_major(b, spec.K))
    return _batch_major(mont_redc(prod, spec), a.shape)


def add_mod(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    k = spec.K
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    s = F.pad(_limb_major(a, k) + _limb_major(b, k), (0, 0, 0, 1))  # K+1 limbs
    d = _norm(s - _col(spec.p, k + 1, s))
    out = torch.where(d[-1] >= 0, d, _norm(s))[:k]
    return _batch_major(out, shape)


def sub_mod(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    k = spec.K
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    d = _norm(_limb_major(a, k) - _limb_major(b, k))
    borrow = d[-1] < 0
    wrapped = _norm(d + _col(spec.p, k, d))
    out = torch.where(borrow, wrapped, d)
    out[-1] &= MASK
    return _batch_major(out, shape)


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Shift limbs toward higher index by d (zeros fill the low limbs)."""
    return F.pad(x, (d, 0))[..., :x.shape[-1]]


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """a - b over normalized limbs [..., K] (no modulus): (diff mod
    2^(16K), borrow 0/1), as the JAX package computes them. The borrow into
    limb i+1 is B[i] = (a < b)[i] | ((a == b)[i] & B[i-1]), an associative
    prefix solved in ceil(log2 K) shift rounds, so there is no host sync."""
    a, b = torch.broadcast_tensors(a, b)
    g = (a < b).int()
    p = (a == b).int()
    d = 1
    while d < a.shape[-1]:
        g = g | (p & _shift_up(g, d))
        p = p & _shift_up(p, d)
        d *= 2
    diff = (a - b - _shift_up(g, 1)) & MASK
    return diff, g[..., -1]


def neg_mod(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    k = spec.K
    A = _limb_major(a, k)
    d = _norm(_col(spec.p, k, A) - A)
    d[-1] &= MASK
    # p - 0 = p must wrap to 0
    d = torch.where((A == 0).all(0), 0, d)
    return _batch_major(d, a.shape)


# -- kernel B1 ----------------------------------------------------------------

def _mont_mul_fused(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Kernel B1 (csrc/mont_mul.cu) on CUDA tensors: broadcast, flatten the
    leading axes, launch one thread per element. Raises on anything the
    kernel does not take; never falls back."""
    from zk_toolkit_tpu_torch import _build
    from zk_toolkit_tpu_torch.ops.curve_kernels import as_rows

    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    af, bf = as_rows(a, spec.K), as_rows(b, spec.K)
    out = torch.empty(af.shape, dtype=torch.int32, device=af.device)
    _build.launch("mont_mul", spec, (af, bf, out), out.shape[0])
    _mont_mul_fused.launches += 1
    return out.reshape(shape)


_mont_mul_fused.launches = 0


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p: kernel B1 for CUDA tensors at
    every batch size, the plain version for CPU tensors."""
    if a.is_cuda or b.is_cuda:
        return _mont_mul_fused(a, b, spec)
    return mont_mul_plain(a, b, spec)


def mont_sq(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return mont_mul(a, a, spec)


def to_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a -> a*R mod p (multiply by R^2 then REDC)."""
    return mont_mul(a, const_limbs(spec.r2_mod_p, spec.K, _dev(a)), spec)


def from_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a*R -> a mod p: the REDC of the bare value, i.e. a Montgomery
    product with the plain integer 1."""
    return mont_mul(a, const_limbs(1, spec.K, _dev(a)), spec)


EXP_CHUNK_BITS = 384   # exponent bits one chain launch takes (csrc/mont_mul.cu)


@functools.lru_cache(maxsize=None)
def exp_chunks(exp_bits: tuple) -> tuple:
    """The chain kernel's launches for a static exponent given MSB-first:
    per launch of at most EXP_CHUNK_BITS bits, (words, bit count), with the
    chunk's bits packed MSB-first into EXP_CHUNK_BITS / 32 words (bit 31 of
    the first word is the chunk's first bit, zeros after its last). Each
    launch after the first continues from the previous accumulator."""
    out = []
    for lo in range(0, len(exp_bits), EXP_CHUNK_BITS):
        chunk = exp_bits[lo:lo + EXP_CHUNK_BITS]
        words = [0] * (EXP_CHUNK_BITS // 32)
        for j, bit in enumerate(chunk):
            if bit:
                words[j // 32] |= 1 << (31 - j % 32)
        out.append((tuple(words), len(chunk)))
    return tuple(out)


def _mont_pow_fused(a: torch.Tensor, exp_bits: tuple, spec: FieldSpec) -> torch.Tensor:
    """Kernel B1's chain entry (zkt_mont_pow) on a CUDA tensor: a^e in
    Montgomery form, one launch per EXP_CHUNK_BITS bits of e, each counted
    in _mont_mul_fused.launches. Raises on anything the kernel does not
    take; never falls back."""
    from zk_toolkit_tpu_torch import _build
    from zk_toolkit_tpu_torch.ops.curve_kernels import as_rows

    af = as_rows(a, spec.K)
    acc = const_limbs(spec.r_mod_p, spec.K, _dev(a)).expand(af.shape)
    for words, nbits in exp_chunks(tuple(exp_bits)):
        out = torch.empty(af.shape, dtype=torch.int32, device=af.device)
        _build.launch("mont_pow", spec, (af, acc, out), out.shape[0], nbits, words)
        _mont_mul_fused.launches += 1
        acc = out
    return acc.reshape(a.shape)


def mont_pow_static_plain(a: torch.Tensor, exp_bits: tuple, spec: FieldSpec,
                          mul=None) -> torch.Tensor:
    """a^e in Montgomery form, e a static integer given MSB-first as
    exp_bits, from R mod p: one squaring per bit and one multiply per set
    bit (the JAX package's lax.scan computes the multiply for every bit and
    selects; the values are the same). `mul(x, y)` is the product,
    mont_mul_plain by default."""
    if mul is None:
        mul = functools.partial(mont_mul_plain, spec=spec)
    acc = const_limbs(spec.r_mod_p, spec.K, _dev(a)).expand(a.shape)
    for bit in exp_bits:
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, a)
    return acc


def mont_pow_static(a: torch.Tensor, exp_bits: tuple, spec: FieldSpec,
                    mul=None) -> torch.Tensor:
    """a^e in Montgomery form (mont_pow_static_plain's function): with an
    explicit `mul`, its chain of products; else the chain kernel on a CUDA
    tensor (one launch per 384 bits of e), the plain version on the CPU.
    Input contract on CUDA, as for the product: a < p."""
    if mul is None and a.is_cuda:
        return _mont_pow_fused(a, exp_bits, spec)
    return mont_pow_static_plain(a, exp_bits, spec, mul)


def mont_inv(a: torch.Tensor, spec: FieldSpec, mul=None) -> torch.Tensor:
    """Batched modular inverse via Fermat: a^(p-2). Maps Montgomery form to
    Montgomery form. Inverse of zero returns zero (callers guard)."""
    return mont_pow_static(a, spec.p_minus_2_bits, spec, mul)


def mont_inv_plain(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """mont_inv through plain products only (any device)."""
    return mont_pow_static_plain(a, spec.p_minus_2_bits, spec)


def mont_pow_dynamic(a: torch.Tensor, exp_limbs: torch.Tensor, spec: FieldSpec,
                     exp_bits_count: int, mul=None) -> torch.Tensor:
    """a^e in Montgomery form for per-row exponents: exp_limbs int32
    [..., E] plain 16-bit limbs, read LSB-first over exp_bits_count bits.
    From acc = R mod p and base = a, each bit takes acc * base where the bit
    is set and squares base, as the JAX package's scan does; the product and
    the square of a bit are one [2, ..., K] stacked call of `mul` (one B1
    launch on a card; mont_mul by default, the plain product on the CPU).

    `a` is reduced first, as the product of R mod p (left) and a (right),
    so every product's left operand is canonical (the 12-word B1 product is
    exact only then) for rows in [p, 2^(16K)) too; the JAX package's result
    is the same canonical value, its accumulator being canonical throughout.
    1 + exp_bits_count calls of `mul`."""
    if mul is None:
        mul = functools.partial(mont_mul, spec=spec)
    one = const_limbs(spec.r_mod_p, spec.K, _dev(a)).expand(a.shape)
    base = mul(one, a)
    acc = one
    for i in range(exp_bits_count):
        bit = (exp_limbs[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1
        prod = mul(torch.stack((acc, base)), torch.stack((base, base)))
        acc = torch.where((bit == 1)[..., None], prod[0], acc)
        base = prod[1]
    return acc


def mont_pow_dynamic_plain(a: torch.Tensor, exp_limbs: torch.Tensor, spec: FieldSpec,
                           exp_bits_count: int) -> torch.Tensor:
    """mont_pow_dynamic through plain products only (any device)."""
    return mont_pow_dynamic(a, exp_limbs, spec, exp_bits_count,
                            functools.partial(mont_mul_plain, spec=spec))


# -- host conversion helpers ----------------------------------------------------

def pack(xs, spec: FieldSpec, mont: bool = True, device="cuda") -> torch.Tensor:
    """List of Python ints -> int32 [N, K] tensor (optionally to Montgomery
    form) on `device`."""
    from zk_toolkit_tpu_torch import resolve_device

    arr = ints_to_array([x % spec.p for x in xs], spec.K).astype(np.int32)
    out = torch.from_numpy(arr).to(resolve_device(device))
    return to_mont(out, spec) if mont else out


def unpack(a: torch.Tensor, spec: FieldSpec, mont: bool = True) -> list[int]:
    """Tensor -> list of Python ints (converting out of Montgomery)."""
    if mont:
        a = from_mont(a, spec)
    arr = a.cpu().numpy().astype(np.uint64).reshape(-1, spec.K)
    out = []
    for row in arr:
        v = 0
        for i in range(spec.K - 1, -1, -1):
            v = (v << LIMB_BITS) | int(row[i])
        out.append(v)
    return out
