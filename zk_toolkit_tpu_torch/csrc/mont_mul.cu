// Kernel B1: batched Montgomery product a*b*R^-1 mod p, R = 2^(16K).
//
// Replaces the Pallas kernel zk_toolkit_tpu/ops/limbs.py:315
// `_mont_mul_kernel` (wrapper `_mont_mul_fused` :383). That kernel runs K
// carry-free 16-bit schoolbook rows and K lazily-carried REDC rounds on
// [K, block] VMEM tiles, because the TPU vector unit has no wide integer
// multiply. Here one thread owns one element: the K 16-bit limbs are packed
// into K/2 32-bit words in registers, and the product and reduction run as
// word-serial Montgomery (CIOS) with 32x32->64 multiplies, K^2/2 of them.
//
// The Montgomery core it calls (field.cuh) is the carry-chain one shared
// with B2 and B3; the kernel's design, batch and wrapper are as first
// written.
//
// What bounds it on an H100: per element it reads 2 x 4K bytes and writes
// 4K bytes (288 B at K = 24: 86 ps at 3.35 TB/s), and it issues K^2/2 wide
// multiplies, each two 32-bit multiply-add slots, K^2 = 576 in all (34 ps
// at 16.7 T IMAD/s). So the limb layout's bytes bound it, not the
// arithmetic: half of every int32 lane is zero. The design reads and writes
// each element once with 16-byte vector accesses and keeps every
// intermediate in registers; a denser layout is the way past this bound.
#include "field.cuh"

namespace {

// views: a, b, out
template <int N>
__global__ void __launch_bounds__(zkt::kThreads)
    mont_mul_kernel(zkt::Views<3> v, long long n, zkt::Modulus<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[N], b[N], r[N];
  zkt::load<N>(a, v.ptr[0] + i * v.stride[0]);
  zkt::load<N>(b, v.ptr[1] + i * v.stride[1]);
  zkt::mont_mul<N>(r, a, b, M);
  zkt::store<N>(v.ptr[2] + i * v.stride[2], r);
}

template <int N>
int launch(const long long* args, long long n, const unsigned* p_words,
           unsigned n0, cudaStream_t stream) {
  mont_mul_kernel<N><<<zkt::grid_for(n), zkt::kThreads, 0, stream>>>(
      zkt::make_views<3>(args), n, zkt::make_modulus<N>(p_words, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkt_mont_mul(int n_words, const long long* args, long long n,
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
