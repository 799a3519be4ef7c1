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
// What bounds it on the card: instruction issue. A pair costs 36 float
// operations and one IEEE division (a multi-instruction sequence), about
// 65 instructions in all, and --fmad=false keeps every multiply and add a
// separate instruction; each ray reads 24 bytes and writes 17, and at the
// main path (T = 36) the table is 2.3 KB, so device memory is not the
// limit.
//
// Design:
// - One thread per ray, in blocks of kThreads, keeps (best t, best idx, s2,
//   s3) in registers and sweeps the rows in ascending index. The predicate
//   is the shared branch-free one of tri_hit.cuh, the plain version's
//   expressions in its order (ops/intersect.py::intersect_dense_ref), built
//   with --fmad=false, so the kernel agrees with it bit for bit; in
//   ascending order its tie rule keeps the lowest index.
// - The table is staged in shared memory as float4s, once per block when it
//   fits in one tile of kTileRows rows (the main path's 36 rows: one load,
//   one barrier); a larger table goes through in tiles. Every thread of a
//   warp reads the same row at once, a broadcast.
// - Measured on the card and left out (PERF.md): a lazy predicate (the
//   division only where rd.n != 0, the hit point and the same-side terms
//   only for a t that would win) and two to four rays per thread. The
//   threads of a warp take the lazy branches apart on bounce rays, so both
//   ran slower there, up to four times on a 2,000-row table.

#include <cuda_runtime.h>

#include "tri_hit.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = 512;   // rows per shared-memory tile (32 KB)

__global__ void __launch_bounds__(kThreads)
intersect_dense_kernel(const float* __restrict__ rox,
                       const float* __restrict__ roy,
                       const float* __restrict__ roz,
                       const float* __restrict__ rdx,
                       const float* __restrict__ rdy,
                       const float* __restrict__ rdz,
                       const float4* __restrict__ tri, int n, int t_count,
                       bool* __restrict__ hit_out, float* __restrict__ t_out,
                       int* __restrict__ idx_out, float* __restrict__ s2_out,
                       float* __restrict__ s3_out) {
  __shared__ float4 s_tri[kTileRows * 4];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // a ray past the end gets a zero direction, which never hits
  const pts::Ray ray = i < n ? pts::Ray{rox[i], roy[i], roz[i],
                                        rdx[i], rdy[i], rdz[i]}
                             : pts::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float best_t = pts::kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;

  for (int tile = 0; tile < t_count; tile += kTileRows) {
    const int rows = min(kTileRows, t_count - tile);
    if (tile > 0) __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < rows * 4; k += kThreads)
      s_tri[k] = tri[static_cast<size_t>(tile) * 4 + k];
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float4 a = s_tri[4 * j], b = s_tri[4 * j + 1];
      const float4 c = s_tri[4 * j + 2], d = s_tri[4 * j + 3];
      const float row[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                             c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
      pts::tri_update(ray, row, tile + j, best_t, best_i, best_s2, best_s3);
    }
  }
  if (i < n) {
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
        static_cast<const float4*>(tri), n, t_count, static_cast<bool*>(hit),
        static_cast<float*>(t), static_cast<int*>(idx),
        static_cast<float*>(s2), static_cast<float*>(s3));
  }
  return static_cast<int>(cudaGetLastError());
}
