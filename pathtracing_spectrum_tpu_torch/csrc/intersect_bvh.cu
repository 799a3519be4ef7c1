// Hierarchical closest hit (K3): N rays against the BVH-ordered [T, 16]
// triangle table through the flat skip-link BVH that Scene.compile builds
// (bvh_node_min/max [NN, 3], bvh_node_skip/first/count [NN]).
//
// Replaces: pathtracing_spectrum_tpu/ops/intersect_shortlist.py, _sl_kernel
// (launched by intersect_shortlist_pallas_soa), and
// pathtracing_spectrum_tpu/ops/intersect_worklist.py, _wl_kernel (launched
// by intersect_worklist_pallas_soa). The two TPU kernels compute one
// function, the closest hit with the dense sweep's selection; they differ
// only in how the TPU grid and its SMEM scalar prefetch are laid out
// (per-block group shortlists against a pooled worklist). A per-ray
// traversal on the card has neither constraint, so one kernel serves both.
//
// Function: the result of K1 (intersect_dense.cu) over the same table:
// the minimum t wins, the lowest index wins a tie, hit = t < BIG, and the
// winner's s2/s3 come back with it.
//
// Design: one thread per ray walks the tree without a stack. At node i it
// tests the box (tri_hit.cuh, box_hit): a box that is missed, or whose
// entry lies beyond the running best t (with the 1e-4 relative margin of
// the JAX package's ray_exit_caps/tighten_caps), goes to skip[i]; an
// internal node that is hit goes to i + 1; a leaf tests its count rows
// first .. first+count-1 in ascending index with a strict `<`, then goes
// to skip[i]. Leaf ranges ascend in node order and the walk only moves
// forward, so the lowest index wins a tie by construction. The leaf loop
// runs to count, not to a fixed leaf size, so the one-node passthrough BVH
// of compile(build_bvh=False) (a +-inf box with count = T) reduces the
// kernel to the dense sweep. Parked rays (rd = 0 on all axes) miss without
// walking. Node arrays and triangle rows are read through the read-only
// cache (__ldg; ~36 B a node, 1.1 MB of nodes and 3.3 MB of rows at 52k
// triangles, resident in the 50 MB L2). The predicate and the box test are
// the shared ones of tri_hit.cuh, built with --fmad=false, so the kernel
// equals its plain version (ops/bvh.py, intersect_bvh_ref) bit for bit.
//
// What bounds it on the card: not FLOPs or bandwidth but divergence (the
// threads of a warp walk different paths and run different leaf loops)
// and the latency of dependent node loads (the next node is known only
// after this one is read). Ordered near-first traversal, wider trees and
// ray sorting are later work; the engine's bounce-ray reorder already
// groups rays by direction octant and origin cell.

#include <cuda_runtime.h>

#include "tri_hit.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
intersect_bvh_kernel(const float* __restrict__ rox,
                     const float* __restrict__ roy,
                     const float* __restrict__ roz,
                     const float* __restrict__ rdx,
                     const float* __restrict__ rdy,
                     const float* __restrict__ rdz,
                     const float4* __restrict__ tri,
                     const float* __restrict__ node_min,
                     const float* __restrict__ node_max,
                     const int* __restrict__ node_skip,
                     const int* __restrict__ node_first,
                     const int* __restrict__ node_count, int n, int n_nodes,
                     bool* __restrict__ hit_out, float* __restrict__ t_out,
                     int* __restrict__ idx_out, float* __restrict__ s2_out,
                     float* __restrict__ s3_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const pts::Ray ray{rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]};
  float best_t = pts::kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;

  if (ray.dx != 0.f || ray.dy != 0.f || ray.dz != 0.f) {
    const pts::Slab slab = pts::slab_setup(ray);
    int node = 0;
    while (node < n_nodes) {
      const float* bmin = node_min + 3 * static_cast<size_t>(node);
      const float* bmax = node_max + 3 * static_cast<size_t>(node);
      const float lo[3] = {__ldg(bmin), __ldg(bmin + 1), __ldg(bmin + 2)};
      const float hi[3] = {__ldg(bmax), __ldg(bmax + 1), __ldg(bmax + 2)};
      if (!pts::box_hit(ray, slab, lo, hi, best_t)) {
        node = __ldg(node_skip + node);
        continue;
      }
      const int count = __ldg(node_count + node);
      if (count == 0) {  // internal node: descend
        ++node;
        continue;
      }
      const int first = __ldg(node_first + node);
      for (int k = 0; k < count; ++k) {
        const float4* src = tri + 4 * static_cast<size_t>(first + k);
        const float4 a = __ldg(src), b = __ldg(src + 1);
        const float4 c = __ldg(src + 2), d = __ldg(src + 3);
        const float r[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                             c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
        pts::tri_update(ray, r, first + k, best_t, best_i, best_s2, best_s3);
      }
      node = __ldg(node_skip + node);
    }
  }
  hit_out[i] = best_t < pts::kBig;
  t_out[i] = best_t;
  idx_out[i] = best_i;
  s2_out[i] = best_s2;
  s3_out[i] = best_s3;
}

}  // namespace

extern "C" int pts_intersect_bvh(const void* rox, const void* roy,
                                 const void* roz, const void* rdx,
                                 const void* rdy, const void* rdz,
                                 const void* tri, const void* node_min,
                                 const void* node_max, const void* node_skip,
                                 const void* node_first,
                                 const void* node_count, int n, int n_nodes,
                                 void* hit, void* t, void* idx, void* s2,
                                 void* s3, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    intersect_bvh_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rox), static_cast<const float*>(roy),
        static_cast<const float*>(roz), static_cast<const float*>(rdx),
        static_cast<const float*>(rdy), static_cast<const float*>(rdz),
        static_cast<const float4*>(tri), static_cast<const float*>(node_min),
        static_cast<const float*>(node_max),
        static_cast<const int*>(node_skip),
        static_cast<const int*>(node_first),
        static_cast<const int*>(node_count), n, n_nodes,
        static_cast<bool*>(hit), static_cast<float*>(t),
        static_cast<int*>(idx), static_cast<float*>(s2),
        static_cast<float*>(s3));
  }
  return static_cast<int>(cudaGetLastError());
}
