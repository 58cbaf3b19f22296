// Field primitives shared by the three kernels (mont_mul.cu, point_add.cu,
// point_double.cu): Montgomery multiply and square, add, subtract, double,
// zero test and select over N 32-bit words, plus the loads and stores of
// the package's tensor layout.
//
// Layout contract (ops/limbs.py): a field element is K = 2N little-endian
// 16-bit limbs, one per int32 lane, rows of an int32 [rows, K] view whose
// limb stride is 1 and whose row stride is a multiple of 4 (16-byte rows,
// checked by the Python wrapper). Inside a kernel two limbs pack into one
// 32-bit word, so a 384-bit Fq element is 12 words in registers and a
// word product is one 32x32->64 multiply instead of four 16x16 ones.
//
// Arithmetic: every add, subtract and word product is an inline-PTX carry
// chain (ptx.cuh): add.cc/addc, sub.cc/subc, mad.lo.cc/madc.hi.cc. A
// Montgomery row adds x*y into the accumulator as two chains, the even
// words of x and the odd ones, whose (lo, hi) pairs land on disjoint words,
// so a word product costs two multiply-adds and nothing else.
//
// Contract: the functions compute ops/limbs.py's integer functions
//   mont_mul: T = (a*b + m*p) / 2^(32N), m = a*b*(-p^-1) mod 2^(32N);
//             out = T >= p ? T - p : T            (T < 2^(32N) + p)
//   mont_sq:  mont_mul(a, a)
//   add:      s = a + b; out = (s >= p ? s - p : s) mod 2^(32N)
//   sub:      out = a >= b ? a - b : (a - b + p) mod 2^(32N)
// with no lazy reduction: each output is reduced by one conditional
// subtract exactly as the reference reduces it. Word-serial Montgomery,
// the squaring's separate reduction and the reference's limb-serial REDC
// all compute the same m, the unique one mod 2^(32N), so the same T.
// - N = 8 (Fr, secp256k1): bit for bit on any input whose limbs are
//   < 2^16, canonical or not.
// - N = 12 (BLS12-381 Fq): mont_sq, add and sub as for N = 8; mont_mul bit
//   for bit when a < p, which canonical kernel inputs give every call (all
//   outputs are canonical then). It needs 2p < 2^384; the launchers refuse
//   a 12-word modulus without that spare bit (modulus_fits).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace zkt {

template <int N>
struct Modulus {
  uint32_t p[N];
  uint32_t n0;  // -p^-1 mod 2^32
};

// One int32 [rows, K] view: base pointer and row stride in elements.
template <int V>
struct Views {
  int* ptr[V];
  long long stride[V];
};

template <int N>
__device__ __forceinline__ void load(uint32_t w[N], const int* row) {
  const int4* q = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    int4 v = q[i];
    w[2 * i] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    w[2 * i + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

template <int N>
__device__ __forceinline__ void store(int* row, const uint32_t w[N]) {
  int4* q = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    int4 v;
    v.x = (int)(w[2 * i] & 0xFFFFu);
    v.y = (int)(w[2 * i] >> 16);
    v.z = (int)(w[2 * i + 1] & 0xFFFFu);
    v.w = (int)(w[2 * i + 1] >> 16);
    q[i] = v;
  }
}

template <int N>
__device__ __forceinline__ void copy(uint32_t r[N], const uint32_t a[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = a[i];
}

template <int N>
__device__ __forceinline__ bool is_zero(const uint32_t a[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

// r = (T >= p ? T - p : T) for T = hi * 2^(32N) + t, hi small.
template <int N>
__device__ __forceinline__ void cond_sub(uint32_t r[N], const uint32_t t[N],
                                         uint32_t hi, const Modulus<N>& M) {
  uint32_t d[N];
  d[0] = ptx::sub_cc(t[0], M.p[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = ptx::subc_cc(t[i], M.p[i]);
  const bool ge = (int32_t)ptx::subc(hi, 0) >= 0;  // hi - borrow >= 0
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = ge ? d[i] : t[i];
}

// t[0..N+1] += x * y over the even words of x (pairs at words j, j+1 for
// even j): one carry chain through t[N+1].
template <int N>
__device__ __forceinline__ void mac_even(uint32_t t[N + 2], const uint32_t x[N],
                                         uint32_t y) {
  t[0] = ptx::mad_lo_cc(x[0], y, t[0]);
  t[1] = ptx::madc_hi_cc(x[0], y, t[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    t[j] = ptx::madc_lo_cc(x[j], y, t[j]);
    t[j + 1] = ptx::madc_hi_cc(x[j], y, t[j + 1]);
  }
  t[N] = ptx::addc_cc(t[N], 0);
  t[N + 1] = ptx::addc(t[N + 1], 0);
}

// t[1..N+1] += x * y over the odd words of x (pairs at words j, j+1 for odd
// j, the last at N - 1, N): one carry chain through t[N+1].
template <int N>
__device__ __forceinline__ void mac_odd(uint32_t t[N + 2], const uint32_t x[N],
                                        uint32_t y) {
  t[1] = ptx::mad_lo_cc(x[1], y, t[1]);
  t[2] = ptx::madc_hi_cc(x[1], y, t[2]);
#pragma unroll
  for (int j = 3; j < N; j += 2) {
    t[j] = ptx::madc_lo_cc(x[j], y, t[j]);
    t[j + 1] = ptx::madc_hi_cc(x[j], y, t[j + 1]);
  }
  t[N + 1] = ptx::addc(t[N + 1], 0);
}

// One reduction round: t = (t + m*p) / 2^32 with m = t[0] * n0, so the low
// word cancels. Between rounds t < 2^(32N) + p, so nothing carries out of
// t[N+1].
template <int N>
__device__ __forceinline__ void redc_round(uint32_t t[N + 2],
                                           const Modulus<N>& M) {
  const uint32_t m = t[0] * M.n0;
  mac_even<N>(t, M.p, m);
  mac_odd<N>(t, M.p, m);
#pragma unroll
  for (int j = 0; j <= N; ++j) t[j] = t[j + 1];
  t[N + 1] = 0;
}

// Montgomery product a*b*2^(-32N) mod p (CIOS: per word of b, one product
// row then one reduction round, each as two carry chains, even and odd
// words of the multiplicand, so every 32x32->64 word product is two
// multiply-adds and no separate add). Exact on every input and for every
// odd p < 2^(32N), secp256k1's included. The accumulator shifts by one word
// a round, which moves its (lo, hi) register pairs: the aligned version
// below avoids those moves where the modulus allows it. r may alias a or b.
template <int N>
__device__ __forceinline__ void mont_mul_cios(uint32_t r[N], const uint32_t a[N],
                                              const uint32_t b[N],
                                              const Modulus<N>& M) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mac_even<N>(t, a, b[i]);
    mac_odd<N>(t, a, b[i]);
    redc_round<N>(t, M);
  }
  cond_sub<N>(r, t, t[N], M);
}

// -- pair-aligned Montgomery (even/odd accumulators) ---------------------------
//
// ptxas fuses a mad.lo.cc / madc.hi.cc pair into one IMAD.WIDE whose 64-bit
// addend and result are an aligned register pair. So the accumulator is
// split in two arrays whose pairs never move: `ev` holds the words at
// positions 0..N-1 (pairs at even positions), `od[k]` the word at position
// k+1 (pairs at odd positions). A round's division by 2^32 then swaps the
// arrays' roles: the odd one becomes the even one as it stands, and the
// even one becomes the odd one shifted down by two words, a shift that the
// next round's first chain does as it adds (madc_odd_rshift). Each chain
// carries only inside its own array; a carry out of the top of `od` is
// dropped, which is exact while the value stays below 2^(32(N+1)).

// acc += x_even * y (pairs at words j, j+1 of acc for even j); carry in CC.
template <int N>
__device__ __forceinline__ void cmad_even(uint32_t acc[N], const uint32_t x[N],
                                          uint32_t y) {
  acc[0] = ptx::mad_lo_cc(x[0], y, acc[0]);
  acc[1] = ptx::madc_hi_cc(x[0], y, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(x[j], y, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(x[j], y, acc[j + 1]);
  }
}

// acc += x_odd * y (x[j+1] at words j, j+1 of acc for even j); carry in CC.
template <int N>
__device__ __forceinline__ void cmad_odd(uint32_t acc[N], const uint32_t x[N],
                                         uint32_t y) {
  acc[0] = ptx::mad_lo_cc(x[1], y, acc[0]);
  acc[1] = ptx::madc_hi_cc(x[1], y, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(x[j + 1], y, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(x[j + 1], y, acc[j + 1]);
  }
}

// acc[j] = x_odd[j] * y + acc[j+2] (acc shifted down two words, zeros in
// at the top), with the carry in CC taken in at word 0; no carry out.
template <int N>
__device__ __forceinline__ void madc_odd_rshift(uint32_t acc[N],
                                                const uint32_t x[N],
                                                uint32_t y) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    acc[j] = ptx::madc_lo_cc(x[j + 1], y, acc[j + 2]);
    acc[j + 1] = ptx::madc_hi_cc(x[j + 1], y, acc[j + 3]);
  }
  acc[N - 2] = ptx::madc_lo_cc(x[N - 1], y, 0);
  acc[N - 1] = ptx::madc_hi(x[N - 1], y, 0);
}

// The reduction of one round: m = ev[0] * n0, (ev, od) += m*p, so that
// ev[0] becomes 0.
template <int N>
__device__ __forceinline__ void redc_aligned(uint32_t ev[N], uint32_t od[N],
                                             const Modulus<N>& M) {
  const uint32_t m = ev[0] * M.n0;
  cmad_odd<N>(od, M.p, m);
  cmad_even<N>(ev, M.p, m);
  od[N - 1] = ptx::addc(od[N - 1], 0);
}

// One CIOS round after the first: fold the division by 2^32 into (ev, od)
// (ev is the previous round's od, od its ev), add a*bi, reduce.
template <int N>
__device__ __forceinline__ void mul_round(uint32_t ev[N], uint32_t od[N],
                                          const uint32_t a[N], uint32_t bi,
                                          const Modulus<N>& M) {
  ev[0] = ptx::add_cc(ev[0], od[1]);
  madc_odd_rshift<N>(od, a, bi);
  cmad_even<N>(ev, a, bi);
  od[N - 1] = ptx::addc(od[N - 1], 0);
  redc_aligned<N>(ev, od, M);
}

// u = (ev + od * 2^32) / 2^32 after a last round that left ev[0] = 0 (the
// arrays are passed in their last roles); u < 2^(32N) with carry out.
template <int N>
__device__ __forceinline__ void merge_aligned(uint32_t u[N], const uint32_t ev[N],
                                              const uint32_t od[N]) {
  u[0] = ptx::add_cc(od[0], ev[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) u[k] = ptx::addc_cc(od[k], ev[k + 1]);
  u[N - 1] = ptx::addc(od[N - 1], 0);
}

// Montgomery product with pair-aligned accumulators. Exact (equal to
// mont_mul_cios) when a < p and 2p < 2^(32N): the value then stays below
// 2p * 2^32 <= 2^(32(N+1)) and below 2p after each round.
template <int N>
__device__ __forceinline__ void mont_mul_aligned(uint32_t r[N], const uint32_t a[N],
                                                 const uint32_t b[N],
                                                 const Modulus<N>& M) {
  uint32_t ev[N], od[N];
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    ev[j] = a[j] * b[0];
    ev[j + 1] = __umulhi(a[j], b[0]);
    od[j] = a[j + 1] * b[0];
    od[j + 1] = __umulhi(a[j + 1], b[0]);
  }
  redc_aligned<N>(ev, od, M);
#pragma unroll
  for (int i = 1; i < N; i += 2) {
    mul_round<N>(od, ev, a, b[i], M);
    if (i + 1 < N) mul_round<N>(ev, od, a, b[i + 1], M);
  }
  uint32_t u[N];
  merge_aligned<N>(u, od, ev);
  cond_sub<N>(r, u, 0, M);
}

// Montgomery square with pair-aligned accumulators, equal to mont_mul(a, a)
// word for word on every input and every odd p < 2^(32N). The cross
// products a_i a_j (i < j) go to two wide arrays, E (pairs at even
// positions) and O (O[k] at position k+1), row by row, one chain into each;
// merged, doubled and with the diagonal added they are the 2N words of
// a^2 = H * 2^(32N) + L. N aligned reduction rounds on L give
// U = (L + m*p) / 2^(32N), with the m of mont_mul (it depends only on
// a^2 mod 2^(32N)), and U + H is mont_mul's T. 2 N(N+1)/2 + 2 N^2
// multiply-adds against mont_mul's 4 N^2. r may alias a.
template <int N>
__device__ __forceinline__ void mont_sq_aligned(uint32_t r[N], const uint32_t a[N],
                                                const Modulus<N>& M) {
  uint32_t E[2 * N], O[2 * N - 1];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) E[k] = 0;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) O[k] = 0;
  // Row i: j - i odd lands at odd positions i+j (O pairs at index i+j-1),
  // j - i even at even positions (E pairs at i+j). Each chain carries into
  // the word after its last pair, which is fresh or holds only the previous
  // row's carry.
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    O[2 * i] = ptx::mad_lo_cc(a[i], a[i + 1], O[2 * i]);
    O[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i + 1], O[2 * i + 1]);
    int last = i + 1;
#pragma unroll
    for (int j = i + 3; j < N; j += 2) {
      O[i + j - 1] = ptx::madc_lo_cc(a[i], a[j], O[i + j - 1]);
      O[i + j] = ptx::madc_hi_cc(a[i], a[j], O[i + j]);
      last = j;
    }
    O[i + last + 1] = ptx::addc(O[i + last + 1], 0);
    if (i + 2 < N) {
      E[2 * i + 2] = ptx::mad_lo_cc(a[i], a[i + 2], E[2 * i + 2]);
      E[2 * i + 3] = ptx::madc_hi_cc(a[i], a[i + 2], E[2 * i + 3]);
      last = i + 2;
#pragma unroll
      for (int j = i + 4; j < N; j += 2) {
        E[i + j] = ptx::madc_lo_cc(a[i], a[j], E[i + j]);
        E[i + j + 1] = ptx::madc_hi_cc(a[i], a[j], E[i + j + 1]);
        last = j;
      }
      E[i + last + 2] = ptx::addc(E[i + last + 2], 0);
    }
  }
  // W = E + O * 2^32 (the cross sum, < 2^(64N-1)), doubled, plus diagonal.
  uint32_t w[2 * N];
  w[0] = E[0];
  w[1] = ptx::add_cc(E[1], O[0]);
#pragma unroll
  for (int k = 2; k < 2 * N - 1; ++k) w[k] = ptx::addc_cc(E[k], O[k - 1]);
  w[2 * N - 1] = ptx::addc(E[2 * N - 1], O[2 * N - 2]);
#pragma unroll
  for (int k = 2 * N - 1; k > 0; --k) w[k] = (w[k] << 1) | (w[k - 1] >> 31);
  w[0] <<= 1;
  w[0] = ptx::mad_lo_cc(a[0], a[0], w[0]);
  w[1] = ptx::madc_hi_cc(a[0], a[0], w[1]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) {
    w[2 * i] = ptx::madc_lo_cc(a[i], a[i], w[2 * i]);
    w[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i], w[2 * i + 1]);
  }
  w[2 * N - 2] = ptx::madc_lo_cc(a[N - 1], a[N - 1], w[2 * N - 2]);
  w[2 * N - 1] = ptx::madc_hi(a[N - 1], a[N - 1], w[2 * N - 1]);
  // U = REDC(L): the value stays below 2^(32N) + p between rounds.
  uint32_t ev[N], od[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ev[k] = w[k];
    od[k] = 0;
  }
  redc_aligned<N>(ev, od, M);
#pragma unroll
  for (int i = 1; i < N; i += 2) {
    od[0] = ptx::add_cc(od[0], ev[1]);
    madc_odd_rshift<N>(ev, M.p, od[0] * M.n0);
    cmad_even<N>(od, M.p, od[0] * M.n0);
    ev[N - 1] = ptx::addc(ev[N - 1], 0);
    if (i + 1 < N) {
      ev[0] = ptx::add_cc(ev[0], od[1]);
      madc_odd_rshift<N>(od, M.p, ev[0] * M.n0);
      cmad_even<N>(ev, M.p, ev[0] * M.n0);
      od[N - 1] = ptx::addc(od[N - 1], 0);
    }
  }
  uint32_t u[N];
  merge_aligned<N>(u, od, ev);
  // T = U + H.
  u[0] = ptx::add_cc(u[0], w[N]);
#pragma unroll
  for (int k = 1; k < N; ++k) u[k] = ptx::addc_cc(u[k], w[N + k]);
  cond_sub<N>(r, u, ptx::addc(0, 0), M);
}

// The products the kernels call. N = 12 (BLS12-381 Fq, p < 2^381) multiplies
// with the aligned accumulators, N = 8 (Fr, secp256k1, which has no spare
// bit) with CIOS; both square with mont_sq_aligned.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t r[N], const uint32_t a[N],
                                         const uint32_t b[N],
                                         const Modulus<N>& M) {
  if constexpr (N == 12)
    mont_mul_aligned<N>(r, a, b, M);
  else
    mont_mul_cios<N>(r, a, b, M);
}

template <int N>
__device__ __forceinline__ void mont_sq(uint32_t r[N], const uint32_t a[N],
                                       const Modulus<N>& M) {
  mont_sq_aligned<N>(r, a, M);
}

template <int N>
__device__ __forceinline__ void add(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N], const Modulus<N>& M) {
  uint32_t s[N];
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) s[i] = ptx::addc_cc(a[i], b[i]);
  cond_sub<N>(r, s, ptx::addc(0, 0), M);
}

template <int N>
__device__ __forceinline__ void sub(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N], const Modulus<N>& M) {
  uint32_t d[N], q[N];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = ptx::subc_cc(a[i], b[i]);
  const uint32_t mask = ptx::subc(0, 0);  // all ones after a borrow
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = M.p[i] & mask;
  r[0] = ptx::add_cc(d[0], q[0]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) r[i] = ptx::addc_cc(d[i], q[i]);
  r[N - 1] = ptx::addc(d[N - 1], q[N - 1]);
}

template <int N>
__device__ __forceinline__ void dbl(uint32_t r[N], const uint32_t a[N],
                                    const Modulus<N>& M) {
  add<N>(r, a, a, M);
}

// Copies the host-side modulus words into the by-value kernel parameter.
template <int N>
inline Modulus<N> make_modulus(const unsigned* p_words, unsigned n0) {
  Modulus<N> m;
  for (int i = 0; i < N; ++i) m.p[i] = p_words[i];
  m.n0 = n0;
  return m;
}

// `args` holds the V base pointers, then the V row strides (in elements).
// The 12-word products need a spare top bit in p (mont_mul_aligned).
inline bool modulus_fits(int n_words, const unsigned* p_words) {
  return n_words != 12 || (p_words[11] >> 31) == 0;
}

template <int V>
inline Views<V> make_views(const long long* args) {
  Views<V> v;
  for (int i = 0; i < V; ++i) {
    v.ptr[i] = reinterpret_cast<int*>(args[i]);
    v.stride[i] = args[V + i];
  }
  return v;
}

constexpr int kThreads = 128;

inline unsigned grid_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace zkt

// Every library exports the same launcher signature (see _build.py):
//   int zkt_<kernel>(int n_words, const long long* args, long long n,
//                    const unsigned* p_words, unsigned n0, int reps,
//                    void* stream)
// returning cudaGetLastError() of the launch (cudaErrorInvalidValue for an
// argument it does not take), and this error-string helper.
extern "C" const char* zkt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
