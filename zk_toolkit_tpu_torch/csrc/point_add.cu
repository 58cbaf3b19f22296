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
// K = 24: 258 ps at 3.35 TB/s) against 12 Montgomery products of K^2 = 576
// 32-bit multiply-adds and 4 squares of K(K+2)/4 + K^2/2 = 444 (8688, 520 ps
// at 16.7 T IMAD/s): the multiplies bound it. The design is for issue rate
// and latency hiding:
// - every word product is one IMAD.WIDE in a carry chain on a register
//   pair that never moves (field.cuh's aligned accumulators), and the four
//   squares (z1^2, z2^2, (2h)^2, r^2) use the squaring;
// - the formula is ordered so that at most six field elements are live,
//   each output coordinate is stored as soon as it is final, and P is
//   re-read for the rare doubling instead of being held, so the kernel
//   fits the register budget of kMinBlocks blocks of kThreads per SM
//   (65536 / (kThreads * kMinBlocks) = 170 registers a thread) with no
//   stack or spill; 12 resident warps per SM cover the multiply chains. At
//   4 blocks (128 registers) ptxas spills the squaring's wide accumulators.
#include "curve.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;  // 12 warps per SM, at most 170 registers

// views: x1, y1, z1, x2, y2, z2, x3, y3, z3
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    point_add_kernel(zkt::Views<9> v, long long n, zkt::Modulus<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto in = [&](int k) -> const int* { return v.ptr[k] + i * v.stride[k]; };
  auto out = [&](int k) -> int* { return v.ptr[6 + k] + i * v.stride[6 + k]; };
  uint32_t z1[N], z2[N];
  zkt::load<N>(z1, in(2));
  zkt::load<N>(z2, in(5));
  const bool inf1 = zkt::is_zero<N>(z1), inf2 = zkt::is_zero<N>(z2);
  if (inf1 || inf2) {
    // P = inf gives Q (also when both are inf); else Q = inf gives P.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t w[N];
      zkt::load<N>(w, inf1 ? in(3 + k) : in(k));
      zkt::store<N>(out(k), w);
    }
    return;
  }
  uint32_t zz[N], u1[N], s1[N], t[N], w[N], h[N], r[N];
  zkt::mont_mul<N>(zz, z1, z2, M);         // zz = z1*z2
  zkt::mont_sq<N>(t, z2, M);               // z2z2
  zkt::load<N>(w, in(0));
  zkt::mont_mul<N>(u1, w, t, M);           // u1 = x1*z2z2
  zkt::load<N>(w, in(1));
  zkt::mont_mul<N>(w, w, z2, M);
  zkt::mont_mul<N>(s1, w, t, M);           // s1 = y1*z2*z2z2
  zkt::mont_sq<N>(t, z1, M);               // z1z1
  zkt::load<N>(w, in(4));
  zkt::mont_mul<N>(w, w, z1, M);
  zkt::mont_mul<N>(r, w, t, M);            // s2 = y2*z1*z1z1
  zkt::sub<N>(r, r, s1, M);
  zkt::dbl<N>(r, r, M);                    // r = 2(s2 - s1)
  zkt::load<N>(w, in(3));
  zkt::mont_mul<N>(h, w, t, M);            // u2 = x2*z1z1
  zkt::sub<N>(h, h, u1, M);                // h = u2 - u1
  if (zkt::is_zero<N>(h) && zkt::is_zero<N>(r)) {
    // P = Q: the doubling of P.
    zkt::load<N>(t, in(0));
    zkt::load<N>(w, in(1));
    zkt::load<N>(z1, in(2));
    zkt::jac_double<N>(t, w, z1, t, w, z1, M);
    zkt::store<N>(out(0), t);
    zkt::store<N>(out(1), w);
    zkt::store<N>(out(2), z1);
    return;
  }
  zkt::mont_mul<N>(zz, h, zz, M);
  zkt::dbl<N>(zz, zz, M);                  // z3 = 2 h zz
  zkt::store<N>(out(2), zz);
  zkt::dbl<N>(t, h, M);
  zkt::mont_sq<N>(t, t, M);                // i = (2h)^2
  zkt::mont_mul<N>(w, u1, t, M);           // v = u1*i
  zkt::mont_mul<N>(t, h, t, M);            // j = h*i
  zkt::mont_sq<N>(h, r, M);                // rr
  zkt::sub<N>(h, h, t, M);
  zkt::dbl<N>(u1, w, M);
  zkt::sub<N>(h, h, u1, M);                // x3 = rr - j - 2v
  zkt::store<N>(out(0), h);
  zkt::sub<N>(w, w, h, M);
  zkt::mont_mul<N>(w, r, w, M);            // r*(v - x3)
  zkt::mont_mul<N>(t, s1, t, M);
  zkt::dbl<N>(t, t, M);
  zkt::sub<N>(w, w, t, M);                 // y3 = r(v - x3) - 2 s1 j
  zkt::store<N>(out(1), w);
}

template <int N>
int launch(const long long* args, long long n, const unsigned* p_words,
           unsigned n0, cudaStream_t stream) {
  point_add_kernel<N><<<zkt::grid_for(n, kThreads), kThreads, 0, stream>>>(
      zkt::make_views<9>(args), n, zkt::make_modulus<N>(p_words, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkt_point_add(int n_words, const long long* args, long long n,
                             const unsigned* p_words, unsigned n0, int reps,
                             void* stream) {
  if (reps != 1) return (int)cudaErrorInvalidValue;
  if (!zkt::modulus_fits(n_words, p_words)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 8:
      return launch<8>(args, n, p_words, n0, s);
    case 12:
      return launch<12>(args, n, p_words, n0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
