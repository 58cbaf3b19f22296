// Kernel B1: batched Montgomery arithmetic, R = 2^(16K). Two entries:
//   zkt_mont_mul  the product a*b*R^-1 mod p, one launch per product;
//   zkt_mont_pow  a whole static-exponent chain acc^(2^L) * a^e in
//                 Montgomery form, L <= 384 bits of e in one launch.
//
// Replaces the Pallas kernel zk_toolkit_tpu/ops/limbs.py:315
// `_mont_mul_kernel` (wrapper `_mont_mul_fused` :383). That kernel runs K
// carry-free 16-bit schoolbook rows and K lazily-carried REDC rounds on
// [K, block] VMEM tiles, because the TPU vector unit has no wide integer
// multiply; the JAX package runs `mont_pow_static` (:448) as one lax.scan
// program over it. Here one thread owns one element: the K 16-bit limbs
// are packed into N = K/2 32-bit words in registers, and the products are
// field.cuh's carry-chain Montgomery core, shared with B2 and B3.
//
// The product: per element it reads 2 x 4K bytes and writes 4K bytes (288 B
// at K = 24: 86 ps at 3.35 TB/s) for 2N^2 word products (576 multiply-adds,
// 34 ps at 16.7 T IMAD/s), so the layout's bytes bound it (half of every
// int32 lane is zero): each element is read and written once, 16 bytes a
// thread per access, with every intermediate in registers.
//
// The chain (mont_pow_static, mont_inv): the same work as one product
// launch per square and per multiply of the exponent, 610 launches for an
// Fq inverse, but with the accumulator and the base held in registers from
// the first bit to the last. So it reads a and acc once and writes once,
// and what bounds it is operations (8192 Fq inverses: 2.47e9 multiply-adds)
// and, at the batches the main path gives it (8192 and 1 elements), the
// latency of one thread's 610 dependent products, since one element per
// thread cannot fill the card's 528 schedulers. The squares are field.cuh's
// mont_sq (3/4 of a product's multiply-adds). The exponent is a by-value
// kernel parameter, left-justified in 12 words (no host-to-device copy);
// a longer exponent runs as consecutive launches, each continuing from the
// previous accumulator. All threads share the exponent, so the branch on a
// bit never diverges.
//
// Exactness: the chain computes the step-by-step chain of products
// sq(acc), mul(acc, a) bit for bit, because mont_sq equals mont_mul(x, x)
// on every input and, for N = 12, mont_mul is exact while its left operand
// is below p: the accumulator is that operand, it starts canonical (R mod p
// or a previous chain's output) and every product's output is canonical.
// The base a is only ever the right operand, which may be any value of
// limbs < 2^16; the stated contract stays a < p, as for the product (the
// callers give the kernels' canonical outputs). a = 0 gives 0 after its
// first set bit.
//
// Grid: the block size follows n (threads_for): the largest of 128, 64 and
// 32 threads that still gives every SM a block, so 8192 elements run as
// 256 blocks of one warp on all 132 SMs instead of 64 blocks of four warps
// on half of them.
#include "field.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kExpWords = 12;  // 384 exponent bits a launch

// One launch's exponent bits, MSB-first: bit 31 of w[0] is the first.
struct Exponent {
  uint32_t w[kExpWords];
};

// views: a, b, out
template <int N>
__global__ void __launch_bounds__(kMaxThreads)
    mont_mul_kernel(zkt::Views<3> v, long long n, zkt::Modulus<N> M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[N], b[N], r[N];
  zkt::load<N>(a, v.ptr[0] + i * v.stride[0]);
  zkt::load<N>(b, v.ptr[1] + i * v.stride[1]);
  zkt::mont_mul<N>(r, a, b, M);
  zkt::store<N>(v.ptr[2] + i * v.stride[2], r);
}

// views: a, acc (the accumulator to continue from), out. Per bit of e, one
// square of acc and, for a set bit, acc = acc * a. The exponent words shift
// through registers (constant indices only, so no local-memory copy).
template <int N>
__global__ void __launch_bounds__(kMaxThreads)
    mont_pow_kernel(zkt::Views<3> v, long long n, zkt::Modulus<N> M,
                    Exponent e, int nbits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[N], acc[N], w[kExpWords];
  zkt::load<N>(a, v.ptr[0] + i * v.stride[0]);
  zkt::load<N>(acc, v.ptr[1] + i * v.stride[1]);
#pragma unroll
  for (int k = 0; k < kExpWords; ++k) w[k] = e.w[k];
#pragma unroll 1
  for (int left = nbits; left > 0; left -= 32) {
    uint32_t cur = w[0];
#pragma unroll
    for (int k = 0; k + 1 < kExpWords; ++k) w[k] = w[k + 1];
    const int m = left < 32 ? left : 32;
#pragma unroll 1
    for (int j = 0; j < m; ++j, cur <<= 1) {
      zkt::mont_sq<N>(acc, acc, M);
      if (cur >> 31) zkt::mont_mul<N>(acc, acc, a, M);
    }
  }
  zkt::store<N>(v.ptr[2] + i * v.stride[2], acc);
}

// The SMs of the current device, read once per process.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms > 0 ? sms : 1;
}

// Threads per block for n rows: the largest of 128, 64 and 32 that still
// gives every SM a block.
int threads_for(long long n) {
  const long long sms = sm_count();
  int t = kMaxThreads;
  while (t > 32 && (n + t - 1) / t < sms) t /= 2;
  return t;
}

template <int N>
int launch_mul(const long long* args, long long n, const unsigned* p_words,
               unsigned n0, cudaStream_t stream) {
  const int t = threads_for(n);
  mont_mul_kernel<N><<<zkt::grid_for(n, t), t, 0, stream>>>(
      zkt::make_views<3>(args), n, zkt::make_modulus<N>(p_words, n0));
  return (int)cudaGetLastError();
}

template <int N>
int launch_pow(const long long* args, long long n, const unsigned* p_words,
               unsigned n0, int nbits, cudaStream_t stream) {
  Exponent e;
  for (int k = 0; k < kExpWords; ++k) e.w[k] = (uint32_t)args[6 + k];
  const int t = threads_for(n);
  mont_pow_kernel<N><<<zkt::grid_for(n, t), t, 0, stream>>>(
      zkt::make_views<3>(args), n, zkt::make_modulus<N>(p_words, n0), e,
      nbits);
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
      return launch_mul<8>(args, n, p_words, n0, s);
    case 12:
      return launch_mul<12>(args, n, p_words, n0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The shared signature, extended: `reps` is the number of exponent bits,
// 1 to 384, and `args` holds after the 3 pointers and 3 strides the 12
// exponent words (MSB-first, as in Exponent).
extern "C" int zkt_mont_pow(int n_words, const long long* args, long long n,
                            const unsigned* p_words, unsigned n0, int reps,
                            void* stream) {
  if (reps < 1 || reps > 32 * kExpWords) return (int)cudaErrorInvalidValue;
  if (!zkt::modulus_fits(n_words, p_words)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 8:
      return launch_pow<8>(args, n, p_words, n0, reps, s);
    case 12:
      return launch_pow<12>(args, n, p_words, n0, reps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
