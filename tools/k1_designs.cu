// Designs of K1 (the dense closest-hit sweep) that were measured against
// the port's kernel and left out; tools/k1_designs.py builds this file and
// times each design against pathtracing_spectrum_tpu_torch/csrc/
// intersect_dense.cu on the same rays. Every design computes the kernel's
// function bit for bit (the tool checks it): only the evaluation order of
// the predicate and the launch shape differ.
//
//   design 0: branch-free predicate (tri_hit.cuh), 256 threads, 1 ray each
//   design 1: lazy predicate, 128 threads, 4 rays each
//   design 2: lazy predicate, 256 threads, 1 ray each
//   design 3: the division for every pair, the hit point and the same-side
//             terms only for a t that would win; 256 threads, 1 ray each
//
// "Lazy": the division only where rd.n != 0, and the hit point and the
// same-side terms only for a pair whose t is non-negative and would win.

#include <cuda_runtime.h>

#include "../pathtracing_spectrum_tpu_torch/csrc/tri_hit.cuh"

namespace {

using pts::Ray;
using pts::dot3;

__device__ __forceinline__ void inside_update(const Ray& ray, const float* r,
                                              float t, int idx, float& bt,
                                              int& bi, float& b2, float& b3) {
  const float px = __fadd_rn(ray.ox, __fmul_rn(t, ray.dx));
  const float py = __fadd_rn(ray.oy, __fmul_rn(t, ray.dy));
  const float pz = __fadd_rn(ray.oz, __fmul_rn(t, ray.dz));
  const float s1 = __fsub_rn(dot3(px, py, pz, r[3], r[4], r[5]), r[13]);
  const float s2 = __fsub_rn(dot3(px, py, pz, r[6], r[7], r[8]), r[14]);
  const float s3 = __fsub_rn(dot3(px, py, pz, r[9], r[10], r[11]), r[15]);
  if (s1 >= 0.f && s2 >= 0.f && s3 >= 0.f) {
    bt = t;
    bi = idx;
    b2 = s2;
    b3 = s3;
  }
}

template <int kPredicate>   // 0 branch-free, 1 lazy, 3 division for all
__device__ __forceinline__ void update(const Ray& ray, const float* r,
                                       int idx, float& bt, int& bi,
                                       float& b2, float& b3) {
  if (kPredicate == 0) {
    pts::tri_update(ray, r, idx, bt, bi, b2, b3);
    return;
  }
  const float denom = dot3(ray.dx, ray.dy, ray.dz, r[0], r[1], r[2]);
  if (kPredicate == 1 && denom == 0.f) return;
  const float ro_n = dot3(ray.ox, ray.oy, ray.oz, r[0], r[1], r[2]);
  const float safe = denom == 0.f ? 1.f : denom;
  const float t = __fdiv_rn(__fsub_rn(r[12], ro_n), safe);
  if (denom != 0.f && t >= 0.f && t < bt)
    inside_update(ray, r, t, idx, bt, bi, b2, b3);
}

template <int kThreads, int kRays, int kPredicate>
__global__ void __launch_bounds__(kThreads)
sweep(const float* __restrict__ rox, const float* __restrict__ roy,
      const float* __restrict__ roz, const float* __restrict__ rdx,
      const float* __restrict__ rdy, const float* __restrict__ rdz,
      const float4* __restrict__ tri, int n, int t_count,
      bool* __restrict__ hit_out, float* __restrict__ t_out,
      int* __restrict__ idx_out, float* __restrict__ s2_out,
      float* __restrict__ s3_out) {
  constexpr int kTileRows = 512;
  __shared__ float4 s_tri[kTileRows * 4];
  const int base = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  Ray ray[kRays];
  float bt[kRays], b2[kRays], b3[kRays];
  int bi[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = base + r * kThreads;
    ray[r] = i < n ? Ray{rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]}
                   : Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    bt[r] = pts::kBig;
    bi[r] = 0;
    b2[r] = b3[r] = 0.f;
  }
  for (int tile = 0; tile < t_count; tile += kTileRows) {
    const int rows = min(kTileRows, t_count - tile);
    if (tile > 0) __syncthreads();
    for (int k = threadIdx.x; k < rows * 4; k += kThreads)
      s_tri[k] = tri[static_cast<size_t>(tile) * 4 + k];
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float4 a = s_tri[4 * j], b = s_tri[4 * j + 1];
      const float4 c = s_tri[4 * j + 2], d = s_tri[4 * j + 3];
      const float row[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                             c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        update<kPredicate>(ray[r], row, tile + j, bt[r], bi[r], b2[r], b3[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = base + r * kThreads;
    if (i < n) {
      hit_out[i] = bt[r] < pts::kBig;
      t_out[i] = bt[r];
      idx_out[i] = bi[r];
      s2_out[i] = b2[r];
      s3_out[i] = b3[r];
    }
  }
}

template <int kThreads, int kRays, int kPredicate>
void launch(void* const* a, int n, int t_count, cudaStream_t s) {
  constexpr int kPerBlock = kThreads * kRays;
  sweep<kThreads, kRays, kPredicate>
      <<<(n + kPerBlock - 1) / kPerBlock, kThreads, 0, s>>>(
          static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
          static_cast<const float*>(a[2]), static_cast<const float*>(a[3]),
          static_cast<const float*>(a[4]), static_cast<const float*>(a[5]),
          static_cast<const float4*>(a[6]), n, t_count,
          static_cast<bool*>(a[7]), static_cast<float*>(a[8]),
          static_cast<int*>(a[9]), static_cast<float*>(a[10]),
          static_cast<float*>(a[11]));
}

}  // namespace

// a: the six ray planes, the [T, 16] table, then hit, t, idx, s2, s3
extern "C" int k1_design(int design, void* const* a, int n, int t_count,
                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 0: launch<256, 1, 0>(a, n, t_count, s); break;
    case 1: launch<128, 4, 1>(a, n, t_count, s); break;
    case 2: launch<256, 1, 1>(a, n, t_count, s); break;
    case 3: launch<256, 1, 3>(a, n, t_count, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
