// Kernel B2: batched complete Jacobian addition on y^2 = x^3 + b.
//
// Replaces the Pallas kernel zk_toolkit_tpu/ops/curve_kernels.py:152
// `_point_add_call` (wrapper `point_add_fused` :286). That kernel evaluates
// add-2007-bl AND dbl-2009-l on every lane and then selects (P = Q takes
// the doubling, Q = inf takes P, P = inf takes Q), because a TPU vector
// unit cannot branch per lane. Here one thread owns one pair and branches:
// an infinity operand costs two loads and three stores, the doubling is
// computed only for the pairs that need it (re-reading P from memory), and
// P = -Q falls out of the generic formula as Z3 = 0, as before. The
// outputs are the limbs the select chain of ops/curve_ops.py gives.
//
// What bounds it on an H100: per generic pair 9 x 4K bytes (864 B at
// K = 24: 258 ps at 3.35 TB/s) against 16 Montgomery products of
// K^2 = 576 32-bit multiply-add slots each (9216, 552 ps at 16.7 T IMAD/s):
// the multiplies bound it. Every intermediate stays in registers, as the
// Pallas kernel kept them in VMEM: six coordinate loads, three stores.
#include "curve.cuh"

namespace {

// views: x1, y1, z1, x2, y2, z2, x3, y3, z3
template <int N>
__global__ void __launch_bounds__(zkt::kThreads)
    point_add_kernel(zkt::Views<9> v, long long n, zkt::Modulus<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* p1[3] = {v.ptr[0] + i * v.stride[0], v.ptr[1] + i * v.stride[1],
                      v.ptr[2] + i * v.stride[2]};
  const int* p2[3] = {v.ptr[3] + i * v.stride[3], v.ptr[4] + i * v.stride[4],
                      v.ptr[5] + i * v.stride[5]};
  int* out[3] = {v.ptr[6] + i * v.stride[6], v.ptr[7] + i * v.stride[7],
                 v.ptr[8] + i * v.stride[8]};
  uint32_t x3[N], y3[N], z3[N];
  uint32_t z1[N], z2[N];
  zkt::load<N>(z1, p1[2]);
  zkt::load<N>(z2, p2[2]);
  if (zkt::is_zero<N>(z1) || zkt::is_zero<N>(z2)) {
    // P = inf gives Q (also when both are inf); else Q = inf gives P.
    const int* const* src = zkt::is_zero<N>(z1) ? p2 : p1;
    zkt::load<N>(x3, src[0]);
    zkt::load<N>(y3, src[1]);
    zkt::load<N>(z3, src[2]);
  } else {
    uint32_t u1[N], s1[N], zz[N], h[N], r[N], t[N], w[N];
    zkt::mont_mul<N>(zz, z1, z2, M);       // zz = z1*z2
    zkt::mont_mul<N>(t, z2, z2, M);        // z2z2
    zkt::load<N>(w, p1[0]);
    zkt::mont_mul<N>(u1, w, t, M);         // u1 = x1*z2z2
    zkt::load<N>(w, p1[1]);
    zkt::mont_mul<N>(w, w, z2, M);
    zkt::mont_mul<N>(s1, w, t, M);         // s1 = y1*z2*z2z2
    zkt::mont_mul<N>(t, z1, z1, M);        // z1z1
    zkt::load<N>(w, p2[0]);
    zkt::mont_mul<N>(h, w, t, M);          // u2 = x2*z1z1
    zkt::sub<N>(h, h, u1, M);              // h = u2 - u1
    zkt::load<N>(w, p2[1]);
    zkt::mont_mul<N>(w, w, z1, M);
    zkt::mont_mul<N>(r, w, t, M);          // s2 = y2*z1*z1z1
    zkt::sub<N>(r, r, s1, M);
    zkt::dbl<N>(r, r, M);                  // r = 2(s2 - s1)
    if (zkt::is_zero<N>(h) && zkt::is_zero<N>(r)) {
      // P = Q: the doubling of P.
      zkt::load<N>(x3, p1[0]);
      zkt::load<N>(y3, p1[1]);
      zkt::jac_double<N>(x3, y3, z3, x3, y3, z1, M);
    } else {
      zkt::dbl<N>(t, h, M);
      zkt::mont_mul<N>(t, t, t, M);        // i = (2h)^2
      zkt::mont_mul<N>(w, u1, t, M);       // v = u1*i
      zkt::mont_mul<N>(t, h, t, M);        // j = h*i
      zkt::mont_mul<N>(x3, r, r, M);       // rr
      zkt::sub<N>(x3, x3, t, M);
      zkt::dbl<N>(u1, w, M);
      zkt::sub<N>(x3, x3, u1, M);          // x3 = rr - j - 2v
      zkt::sub<N>(w, w, x3, M);
      zkt::mont_mul<N>(y3, r, w, M);       // r*(v - x3)
      zkt::mont_mul<N>(t, s1, t, M);
      zkt::dbl<N>(t, t, M);
      zkt::sub<N>(y3, y3, t, M);           // y3 = r(v - x3) - 2 s1 j
      zkt::mont_mul<N>(z3, h, zz, M);
      zkt::dbl<N>(z3, z3, M);              // z3 = 2 h zz
    }
  }
  zkt::store<N>(out[0], x3);
  zkt::store<N>(out[1], y3);
  zkt::store<N>(out[2], z3);
}

template <int N>
int launch(const long long* ptrs, const long long* strides, long long n,
           const unsigned* p_words, unsigned n0, cudaStream_t stream) {
  point_add_kernel<N><<<zkt::grid_for(n), zkt::kThreads, 0, stream>>>(
      zkt::make_views<9>(ptrs, strides), n,
      zkt::make_modulus<N>(p_words, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkt_point_add(int n_words, const long long* ptrs,
                             const long long* strides, long long n,
                             const unsigned* p_words, unsigned n0,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 8:
      return launch<8>(ptrs, strides, n, p_words, n0, s);
    case 12:
      return launch<12>(ptrs, strides, n, p_words, n0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
