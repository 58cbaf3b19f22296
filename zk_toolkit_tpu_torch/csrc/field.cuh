// Field primitives shared by the three kernels (mont_mul.cu, point_add.cu,
// point_double.cu): Montgomery multiply, add, subtract, double, zero test and
// select over N 32-bit words, plus the loads and stores of the package's
// tensor layout.
//
// Layout contract (ops/limbs.py): a field element is K = 2N little-endian
// 16-bit limbs, one per int32 lane, rows of an int32 [rows, K] view whose
// limb stride is 1 and whose row stride is a multiple of 4 (16-byte rows,
// checked by the Python wrapper). Inside a kernel two limbs pack into one
// 32-bit word, so a 384-bit Fq element is 12 words in registers and a
// word product is one 32x32->64 multiply instead of four 16x16 ones.
//
// Every function reproduces ops/limbs.py bit for bit on any input whose
// limbs are < 2^16, canonical or not:
//   mont_mul: T = (a*b + m*p) / 2^(32N), m = a*b*(-p^-1) mod 2^(32N);
//             out = T >= p ? T - p : T            (T < 2^(32N) + p)
//   add:      s = a + b; out = (s >= p ? s - p : s) mod 2^(32N)
//   sub:      out = a >= b ? a - b : (a - b + p) mod 2^(32N)
// Word-serial Montgomery (CIOS) and limb-serial REDC compute the same m, so
// the same T.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

// r = (T >= p ? T - p : T) over N words plus the top word `hi` of T.
template <int N>
__device__ __forceinline__ void cond_sub(uint32_t r[N], const uint32_t t[N],
                                         uint32_t hi, const Modulus<N>& M) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t s = (uint64_t)t[i] - M.p[i] - borrow;
    d[i] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = hi >= borrow;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = ge ? d[i] : t[i];
}

// Montgomery product a*b*2^(-32N) mod p (CIOS). r may alias a or b.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t r[N], const uint32_t a[N],
                                         const uint32_t b[N],
                                         const Modulus<N>& M) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * M.n0;
    s = (uint64_t)m * M.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * M.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  cond_sub<N>(r, t, t[N], M);
}

template <int N>
__device__ __forceinline__ void add(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N], const Modulus<N>& M) {
  uint32_t s[N];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  cond_sub<N>(r, s, c, M);
}

template <int N>
__device__ __forceinline__ void sub(uint32_t r[N], const uint32_t a[N],
                                    const uint32_t b[N], const Modulus<N>& M) {
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)d[i] + (borrow ? M.p[i] : 0u) + c;
    r[i] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
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

template <int V>
inline Views<V> make_views(const long long* ptrs, const long long* strides) {
  Views<V> v;
  for (int i = 0; i < V; ++i) {
    v.ptr[i] = reinterpret_cast<int*>(ptrs[i]);
    v.stride[i] = strides[i];
  }
  return v;
}

constexpr int kThreads = 128;

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace zkt

// Every library exports the same launcher signature (see _build.py):
//   int zkt_<kernel>(int n_words, const long long* ptrs,
//                    const long long* strides, long long n,
//                    const unsigned* p_words, unsigned n0, void* stream)
// returning cudaGetLastError() of the launch, and this error-string helper.
extern "C" const char* zkt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
