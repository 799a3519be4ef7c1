// Dense closest-hit sweep: N rays against all T rows of a packed [T, 16]
// triangle table (n | K1 | K2 | K3 | c0 c1 c2 c3).
//
// Replaces: pathtracing_spectrum_tpu/ops/intersect_pallas.py, _kernel
// (launched by intersect_dense_pallas_soa), the TPU's dense sweep.
//
// Function: t = (c0 - ro.n) / (rd.n), p = ro + t*rd, s_i = p.K_i - c_i;
// valid iff rd.n != 0, t >= 0 and s1, s2, s3 >= 0. The minimum t wins, the
// lowest index wins a tie, zero rows never hit. Outputs are [N] planes:
// hit (t < BIG), t, idx, and the winner's s2/s3 (the barycentric
// numerators, which the TPU kernel returns as zeros).
//
// What bounds it on the card: arithmetic. Each ray-triangle test is ~30
// float operations plus one IEEE division, against 24 bytes of ray read
// and 17 bytes written per ray; at the main path (T = 36) the rays are
// read once and the table is a few hundred bytes, so device memory is not
// the limit. The division (a multi-instruction IEEE sequence) dominates.
//
// Design: one thread per ray keeps (best t, best idx, s2, s3) in registers
// and loops over the triangles in ascending index with a strict `<`, which
// gives the lowest-index tie rule by construction. The table is staged
// through shared memory in tiles of TILE rows; every thread of a warp reads
// the same row at the same time, a broadcast. The per-triangle test is the
// shared predicate of tri_hit.cuh (also used by K3 and K4), written in the
// operation order of the plain torch version (ops/intersect.py) with
// round-to-nearest intrinsics, and the file is built with --fmad=false: no
// multiply-add contraction, so the kernel agrees with the plain version bit
// for bit. Contraction is the known way grazing-edge validity flips;
// turning it on is a later performance change, made against the agreement
// gate.

#include <cuda_runtime.h>

#include "tri_hit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // triangle rows per shared-memory tile (16 KB)

__global__ void __launch_bounds__(kThreads)
intersect_dense_kernel(const float* __restrict__ rox,
                       const float* __restrict__ roy,
                       const float* __restrict__ roz,
                       const float* __restrict__ rdx,
                       const float* __restrict__ rdy,
                       const float* __restrict__ rdz,
                       const float* __restrict__ tri, int n, int t_count,
                       bool* __restrict__ hit_out, float* __restrict__ t_out,
                       int* __restrict__ idx_out, float* __restrict__ s2_out,
                       float* __restrict__ s3_out) {
  __shared__ float s_tri[kTile * 16];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  pts::Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) ray = {rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]};
  float best_t = pts::kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;

  for (int base = 0; base < t_count; base += kTile) {
    const int rows = min(kTile, t_count - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < rows * 16; k += blockDim.x)
      s_tri[k] = tri[static_cast<size_t>(base) * 16 + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < rows; ++j)
      pts::tri_update(ray, s_tri + j * 16, base + j, best_t, best_i, best_s2,
                      best_s3);
  }
  if (active) {
    hit_out[i] = best_t < pts::kBig;
    t_out[i] = best_t;
    idx_out[i] = best_i;
    s2_out[i] = best_s2;
    s3_out[i] = best_s3;
  }
}

}  // namespace

extern "C" int pts_intersect_dense(const void* rox, const void* roy,
                                   const void* roz, const void* rdx,
                                   const void* rdy, const void* rdz,
                                   const void* tri, int n, int t_count,
                                   void* hit, void* t, void* idx, void* s2,
                                   void* s3, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    intersect_dense_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rox), static_cast<const float*>(roy),
        static_cast<const float*>(roz), static_cast<const float*>(rdx),
        static_cast<const float*>(rdy), static_cast<const float*>(rdz),
        static_cast<const float*>(tri), n, t_count, static_cast<bool*>(hit),
        static_cast<float*>(t), static_cast<int*>(idx),
        static_cast<float*>(s2), static_cast<float*>(s3));
  }
  return static_cast<int>(cudaGetLastError());
}
