// Kernel B3: batched r-fold Jacobian doubling, dbl-2009-l with a = 0:
// 2^r * P per point, r >= 1.
//
// Replaces the Pallas kernel zk_toolkit_tpu/ops/curve_kernels.py:227
// `_point_double_call` (wrapper `point_double_fused` :292), which runs the
// formula once on [K, block] VMEM tiles so that no intermediate goes back
// to HBM; r = 1 is exactly its function. Here one thread owns one point,
// doubles it r times in registers and stores once: three coordinate loads,
// three stores, whatever r.
//
// What bounds it on an H100: per point and doubling 2 Montgomery products
// of K^2 = 576 32-bit multiply-adds and 5 squares of K(K+2)/4 + K^2/2 = 444
// (3372, 202 ps at 16.7 T IMAD/s), against 6 x 4K bytes per point (576 B
// at K = 24: 172 ps at 3.35 TB/s) whatever r: the multiplies bound it. The
// main path calls it on tiny batches, a chain of c doublings of one point
// per window in the Horner combine and the fixed-base table, so the cost
// is one launch and then the latency of r dependent doublings in one
// thread. The r-fold launch replaces r launches by one; the squaring core
// shortens each doubling.
#include "curve.cuh"

namespace {

// views: x1, y1, z1, x3, y3, z3
template <int N>
__global__ void __launch_bounds__(zkt::kThreads)
    point_double_kernel(zkt::Views<6> v, long long n, int reps,
                        zkt::Modulus<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N], z[N];
  zkt::load<N>(x, v.ptr[0] + i * v.stride[0]);
  zkt::load<N>(y, v.ptr[1] + i * v.stride[1]);
  zkt::load<N>(z, v.ptr[2] + i * v.stride[2]);
#pragma unroll 1
  for (int k = 0; k < reps; ++k) zkt::jac_double<N>(x, y, z, x, y, z, M);
  zkt::store<N>(v.ptr[3] + i * v.stride[3], x);
  zkt::store<N>(v.ptr[4] + i * v.stride[4], y);
  zkt::store<N>(v.ptr[5] + i * v.stride[5], z);
}

template <int N>
int launch(const long long* args, long long n, const unsigned* p_words,
           unsigned n0, int reps, cudaStream_t stream) {
  point_double_kernel<N><<<zkt::grid_for(n), zkt::kThreads, 0, stream>>>(
      zkt::make_views<6>(args), n, reps, zkt::make_modulus<N>(p_words, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkt_point_double(int n_words, const long long* args,
                                long long n, const unsigned* p_words,
                                unsigned n0, int reps, void* stream) {
  if (reps < 1) return (int)cudaErrorInvalidValue;
  if (!zkt::modulus_fits(n_words, p_words)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 8:
      return launch<8>(args, n, p_words, n0, reps, s);
    case 12:
      return launch<12>(args, n, p_words, n0, reps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
