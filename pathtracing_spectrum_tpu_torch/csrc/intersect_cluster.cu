// Cluster-culled closest hit (K4): N rays against the BVH-ordered [T, 16]
// triangle table, swept cluster by cluster, each cluster a run of 128 rows
// with its AABB in cluster_aabbs [C, 8] (min3, max3, pad2).
//
// Replaces: pathtracing_spectrum_tpu/ops/intersect_pallas.py,
// _cluster_kernel and _cluster_group (launched by
// intersect_clustered_pallas_soa), the TPU's cluster-culled dense sweep.
//
// Function: the result of K1 (intersect_dense.cu) over the same table:
// the minimum t wins, the lowest index wins a tie, hit = t < BIG, and the
// winner's s2/s3 come back with it.
//
// Design: one thread per ray, 128 rays a block, clusters swept in
// ascending order. Each ray tests the cluster's box against its running
// best t (tri_hit.cuh, box_hit, with the 1e-4 relative margin);
// __syncthreads_or decides whether any ray of the block needs the
// cluster. If one does, the block stages the cluster's 128 x 16 floats
// (8 KB) into shared memory, one 16-byte load per thread and row quarter,
// and the rays that need it sweep its rows with the shared predicate and a
// strict `<`. Ascending clusters and ascending rows give the lowest index
// on a tie. The TPU kernel's extra cull by groups of 8 clusters is left
// out: it saves box tests, not sweeps. Parked rays (rd = 0 on all axes)
// never need a cluster. With the shared predicate and --fmad=false the
// kernel equals its plain version (ops/intersect_cluster_cuda.py,
// intersect_cluster_ref) bit for bit.
//
// What bounds it on the card: the rows swept. A block sweeps a cluster
// when any of its 128 rays needs it, so the work follows the coherence of
// the block's rays (the engine's bounce-ray reorder groups them by
// direction octant and origin cell); every ray also pays C box tests, 405
// at 52k triangles. Staging is 8 KB per swept cluster from L2.

#include <cuda_runtime.h>

#include "tri_hit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCluster = 128;   // triangle rows per cluster AABB

__global__ void __launch_bounds__(kThreads)
intersect_cluster_kernel(const float* __restrict__ rox,
                         const float* __restrict__ roy,
                         const float* __restrict__ roz,
                         const float* __restrict__ rdx,
                         const float* __restrict__ rdy,
                         const float* __restrict__ rdz,
                         const float4* __restrict__ tri,
                         const float* __restrict__ aabbs, int n, int t_count,
                         int n_clusters, bool* __restrict__ hit_out,
                         float* __restrict__ t_out,
                         int* __restrict__ idx_out,
                         float* __restrict__ s2_out,
                         float* __restrict__ s3_out) {
  __shared__ float4 s_tri[kCluster * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  pts::Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < n) ray = {rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]};
  // rays past the end, and parked rays, take part in the block's barriers
  // but need no cluster
  const bool live = i < n && (ray.dx != 0.f || ray.dy != 0.f ||
                              ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  float best_t = pts::kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;

  for (int c = 0; c < n_clusters; ++c) {
    const int base = c * kCluster;
    const int rows = min(kCluster, t_count - base);
    if (rows <= 0) break;
    const float* box = aabbs + 8 * static_cast<size_t>(c);
    const float lo[3] = {__ldg(box), __ldg(box + 1), __ldg(box + 2)};
    const float hi[3] = {__ldg(box + 3), __ldg(box + 4), __ldg(box + 5)};
    const bool need = live && pts::box_hit(ray, slab, lo, hi, best_t);
    // also the barrier after the previous sweep, before s_tri is rewritten
    if (!__syncthreads_or(need)) continue;
    for (int k = threadIdx.x; k < rows * 4; k += blockDim.x)
      s_tri[k] = __ldg(tri + 4 * static_cast<size_t>(base) + k);
    __syncthreads();
    if (need) {
      for (int j = 0; j < rows; ++j)
        pts::tri_update(ray, reinterpret_cast<const float*>(s_tri + 4 * j),
                        base + j, best_t, best_i, best_s2, best_s3);
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

extern "C" int pts_intersect_cluster(const void* rox, const void* roy,
                                     const void* roz, const void* rdx,
                                     const void* rdy, const void* rdz,
                                     const void* tri, const void* aabbs,
                                     int n, int t_count, void* hit, void* t,
                                     void* idx, void* s2, void* s3,
                                     void* stream) {
  if (n > 0) {
    const int n_clusters = (t_count + kCluster - 1) / kCluster;
    const int blocks = (n + kThreads - 1) / kThreads;
    intersect_cluster_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rox), static_cast<const float*>(roy),
        static_cast<const float*>(roz), static_cast<const float*>(rdx),
        static_cast<const float*>(rdy), static_cast<const float*>(rdz),
        static_cast<const float4*>(tri), static_cast<const float*>(aabbs), n,
        t_count, n_clusters, static_cast<bool*>(hit),
        static_cast<float*>(t), static_cast<int*>(idx),
        static_cast<float*>(s2), static_cast<float*>(s3));
  }
  return static_cast<int>(cudaGetLastError());
}
