// Bulk uniform variates of jax.random's threefry key schedule:
// out[i] = bitcast((b >> 9) | 0x3F800000) - 1, b = y1 ^ y2 with
// (y1, y2) = threefry2x32(k1, k2, hi(i), lo(i)), i the row-major flat index.
//
// Replaces: jax.random.uniform (jax/_src/prng.py threefry2x32 and
// _threefry_random_bits_partitionable, jax/_src/random.py _uniform), which
// XLA compiles on the TPU; there is no Pallas kernel for it. The engine draws
// [4, N] variates per bounce iteration and [N] hero channels per sample
// (pathtracing_spectrum_tpu/engine.py:564, :735-737).
//
// What bounds it on the card: integer throughput. Each element costs 20
// rounds of add/rotate/xor plus the key injections (~130 32-bit integer
// operations) and writes 4 bytes; at N = 4 x 262,144 that is ~1.4e8
// operations and 4 MB of stores, a few microseconds either way.
//
// Design: one thread per element, the two key words as kernel arguments,
// uint32_t arithmetic (wrap-around adds, rotates with funnel shifts). Integer
// arithmetic is exact, so the result equals the plain version
// (ops/rng.py, uniform_ref) bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define PTS_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r);  \
  x1 ^= x0;

__global__ void __launch_bounds__(kThreads)
threefry_uniform_kernel(uint32_t k1, uint32_t k2, long long n,
                        float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const uint32_t ks0 = k1, ks1 = k2, ks2 = k1 ^ k2 ^ 0x1BD11BDAu;
  const unsigned long long count = static_cast<unsigned long long>(i);
  uint32_t x0 = static_cast<uint32_t>(count >> 32);
  uint32_t x1 = static_cast<uint32_t>(count);
  x0 += ks0;
  x1 += ks1;
  PTS_ROUND(13) PTS_ROUND(15) PTS_ROUND(26) PTS_ROUND(6)
  x0 += ks1;
  x1 += ks2 + 1u;
  PTS_ROUND(17) PTS_ROUND(29) PTS_ROUND(16) PTS_ROUND(24)
  x0 += ks2;
  x1 += ks0 + 2u;
  PTS_ROUND(13) PTS_ROUND(15) PTS_ROUND(26) PTS_ROUND(6)
  x0 += ks0;
  x1 += ks1 + 3u;
  PTS_ROUND(17) PTS_ROUND(29) PTS_ROUND(16) PTS_ROUND(24)
  x0 += ks1;
  x1 += ks2 + 4u;
  PTS_ROUND(13) PTS_ROUND(15) PTS_ROUND(26) PTS_ROUND(6)
  x0 += ks2;
  x1 += ks0 + 5u;
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  out[i] = __uint_as_float(bits) - 1.0f;
}

#undef PTS_ROUND

}  // namespace

extern "C" int pts_threefry_uniform(uint32_t k1, uint32_t k2, long long n,
                                    void* out, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    threefry_uniform_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        k1, k2, n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
