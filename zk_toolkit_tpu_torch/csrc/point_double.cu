// Kernel B3: batched Jacobian doubling, dbl-2009-l with a = 0.
//
// Replaces the Pallas kernel zk_toolkit_tpu/ops/curve_kernels.py:227
// `_point_double_call` (wrapper `point_double_fused` :292), which runs the
// formula on [K, block] VMEM tiles so that no intermediate goes back to
// HBM. Here one thread owns one point and keeps every intermediate in
// registers: three coordinate loads, three stores.
//
// What bounds it on an H100: per point 6 x 4K bytes (576 B at K = 24:
// 172 ps at 3.35 TB/s) against 7 Montgomery products of K^2 = 576 32-bit
// multiply-add slots each (4032, 241 ps at 16.7 T IMAD/s): the multiplies
// bound it. The main path calls it on tiny batches (one point per window
// in the Horner combine and the 255*T step), where the launch is the cost;
// one launch per doubling keeps that to the minimum the host loop allows.
#include "curve.cuh"

namespace {

// views: x1, y1, z1, x3, y3, z3
template <int N>
__global__ void __launch_bounds__(zkt::kThreads)
    point_double_kernel(zkt::Views<6> v, long long n, zkt::Modulus<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N], z[N];
  zkt::load<N>(x, v.ptr[0] + i * v.stride[0]);
  zkt::load<N>(y, v.ptr[1] + i * v.stride[1]);
  zkt::load<N>(z, v.ptr[2] + i * v.stride[2]);
  zkt::jac_double<N>(x, y, z, x, y, z, M);
  zkt::store<N>(v.ptr[3] + i * v.stride[3], x);
  zkt::store<N>(v.ptr[4] + i * v.stride[4], y);
  zkt::store<N>(v.ptr[5] + i * v.stride[5], z);
}

template <int N>
int launch(const long long* ptrs, const long long* strides, long long n,
           const unsigned* p_words, unsigned n0, cudaStream_t stream) {
  point_double_kernel<N><<<zkt::grid_for(n), zkt::kThreads, 0, stream>>>(
      zkt::make_views<6>(ptrs, strides), n,
      zkt::make_modulus<N>(p_words, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkt_point_double(int n_words, const long long* ptrs,
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
