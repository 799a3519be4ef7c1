// Hierarchical closest hit (K3): N rays against the BVH-ordered [T, 16]
// triangle table through the scene's BVH, walked near child first.
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
// Node records (ops/intersect_hier_cuda.py, pack_bvh, built once per
// scene from the skip-link arrays of Scene.compile): 64 bytes, four
// float4s, per internal node, holding BOTH children's boxes and references:
//   q0 = L.lo.xyz, L.hi.x   q1 = L.hi.yz, R.lo.xy
//   q2 = R.lo.z, R.hi.xyz   q3 = L.word, R.word, L.count, R.count (ints)
// A reference with count < 0 is an internal node (word = its record); one
// with count >= 0 is a leaf of rows word .. word+count-1. Record 0 holds
// the root in its left slot.
//
// What bounds it on the card: not FLOPs or bandwidth but the latency of
// dependent node loads (the next node is known only after this one is
// read) and divergence (the threads of a warp walk different paths and
// run different leaf loops). The skip-link walk this design replaced paid
// eight 4-byte loads from five arrays per node, and its fixed left-first
// order often found a far hit first, so the cull by the running best
// pruned little.
//
// Design: one thread per ray, a short per-thread stack.
// - One record fetch (four 16-byte loads through the read-only cache)
//   tests both children of a node. When both boxes are entered, the ray
//   descends into the nearer one (by entry distance; the left one on a
//   tie) and pushes the other with its entry distance; one entered box is
//   descended into; none pops. A leaf's rows are tested with the
//   predicate of tri_hit.cuh, then the walk pops.
// - A pop drops entries whose entry distance now lies beyond the relaxed
//   running best: the box test against the smaller best, without a reload.
// - Leaves no longer come in ascending index, so a row wins when its t is
//   smaller, or equal at a lower index (tri_hit.cuh), and every cull is
//   inclusive (entry <= relax(best t)): a box that holds a tie is never
//   culled. The result is K1's function, bit for bit, and equals the plain
//   skip-link walk ops/bvh.py::intersect_bvh_ref. The box test and the
//   predicate are the shared ones of tri_hit.cuh, built with --fmad=false.
// - The stack holds at most one entry per internal node on the path from
//   the root, so its depth is the tree's, measured at packing; the SAH
//   builder sets no depth limit. Up to kLocalStack entries it lives in
//   local memory; a deeper tree gets a [3, depth, N] scratch stack in
//   device memory from the wrapper. No tree is refused.
// - Parked rays (rd = 0 on all axes) miss without walking. The one-node
//   passthrough BVH of compile(build_bvh=False) is a root leaf of all T
//   rows: the kernel reduces to the dense sweep.
// - A counting build (kCount) also writes each ray's box and triangle
//   tests, the data-dependent work its bound is computed from.

#include <cuda_runtime.h>

#include "tri_hit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLocalStack = 64;   // ops/intersect_hier_cuda.py, LOCAL_STACK

struct LocalStack {
  int word[kLocalStack], count[kLocalStack];
  float near[kLocalStack];
  __device__ LocalStack(int*, int, int) {}
  __device__ void put(int k, int w, int c, float e) {
    word[k] = w;
    count[k] = c;
    near[k] = e;
  }
  __device__ void get(int k, int& w, int& c, float& e) const {
    w = word[k];
    c = count[k];
    e = near[k];
  }
};

// entry k of ray i at base[(3k + f) * n + i]: neighbouring rays'
// entries are neighbours, as local memory interleaves them
struct GlobalStack {
  int* base;
  size_t n;
  __device__ GlobalStack(int* scratch, int i, int n_rays)
      : base(scratch + i), n(static_cast<size_t>(n_rays)) {}
  __device__ void put(int k, int w, int c, float e) {
    base[(3 * static_cast<size_t>(k)) * n] = w;
    base[(3 * static_cast<size_t>(k) + 1) * n] = c;
    base[(3 * static_cast<size_t>(k) + 2) * n] = __float_as_int(e);
  }
  __device__ void get(int k, int& w, int& c, float& e) const {
    w = base[(3 * static_cast<size_t>(k)) * n];
    c = base[(3 * static_cast<size_t>(k) + 1) * n];
    e = __int_as_float(base[(3 * static_cast<size_t>(k) + 2) * n]);
  }
};

template <typename Stack, bool kCount>
__global__ void __launch_bounds__(kThreads)
intersect_bvh_kernel(const float* __restrict__ rox,
                     const float* __restrict__ roy,
                     const float* __restrict__ roz,
                     const float* __restrict__ rdx,
                     const float* __restrict__ rdy,
                     const float* __restrict__ rdz,
                     const float4* __restrict__ tri,
                     const float4* __restrict__ rec, int n,
                     int* __restrict__ scratch, int* __restrict__ counts,
                     bool* __restrict__ hit_out, float* __restrict__ t_out,
                     int* __restrict__ idx_out, float* __restrict__ s2_out,
                     float* __restrict__ s3_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const pts::Ray ray{rox[i], roy[i], roz[i], rdx[i], rdy[i], rdz[i]};
  float best_t = pts::kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;
  int boxes = 0, tris = 0;

  if (ray.dx != 0.f || ray.dy != 0.f || ray.dz != 0.f) {
    const pts::Slab slab = pts::slab_setup(ray);
    Stack stack(scratch, i, n);
    int sp = 0;
    // pop the next entry still worth entering; false when none is left
    auto pop = [&](int& w, int& c) {
      while (sp > 0) {
        float e;
        stack.get(--sp, w, c, e);
        if (e <= pts::relax(best_t)) return true;
      }
      return false;
    };

    // the root, in the left slot of record 0
    const float4 h0 = __ldg(rec), h1 = __ldg(rec + 1), h3 = __ldg(rec + 3);
    const float root_lo[3] = {h0.x, h0.y, h0.z};
    const float root_hi[3] = {h0.w, h1.x, h1.y};
    float near;
    bool live = pts::box_enter(ray, slab, root_lo, root_hi, best_t, near);
    if (kCount) ++boxes;
    int word = __float_as_int(h3.x), count = __float_as_int(h3.z);
    while (live) {
      // descend through internal nodes, the nearer child first
      while (count < 0) {
        const float4* q = rec + 4 * static_cast<size_t>(word);
        const float4 q0 = __ldg(q), q1 = __ldg(q + 1);
        const float4 q2 = __ldg(q + 2), q3 = __ldg(q + 3);
        const float l_lo[3] = {q0.x, q0.y, q0.z};
        const float l_hi[3] = {q0.w, q1.x, q1.y};
        const float r_lo[3] = {q1.z, q1.w, q2.x};
        const float r_hi[3] = {q2.y, q2.z, q2.w};
        float near_l, near_r;
        const bool hl = pts::box_enter(ray, slab, l_lo, l_hi, best_t, near_l);
        const bool hr = pts::box_enter(ray, slab, r_lo, r_hi, best_t, near_r);
        if (kCount) boxes += 2;
        const int wl = __float_as_int(q3.x), wr = __float_as_int(q3.y);
        const int cl = __float_as_int(q3.z), cr = __float_as_int(q3.w);
        if (hl && hr) {
          if (near_r < near_l) {
            stack.put(sp++, wl, cl, near_l);
            word = wr;
            count = cr;
          } else {
            stack.put(sp++, wr, cr, near_r);
            word = wl;
            count = cl;
          }
        } else if (hl) {
          word = wl;
          count = cl;
        } else if (hr) {
          word = wr;
          count = cr;
        } else if (!pop(word, count)) {
          live = false;
          break;
        }
      }
      if (!live) break;
      // a leaf: its rows, in ascending index, with the ordered tie rule
      for (int k = 0; k < count; ++k) {
        const float4* src = tri + 4 * static_cast<size_t>(word + k);
        const float4 a = __ldg(src), b = __ldg(src + 1);
        const float4 c = __ldg(src + 2), d = __ldg(src + 3);
        const float r[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                             c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
        pts::tri_update(ray, r, word + k, best_t, best_i, best_s2, best_s3);
      }
      if (kCount) tris += count;
      live = pop(word, count);
    }
  }
  hit_out[i] = best_t < pts::kBig;
  t_out[i] = best_t;
  idx_out[i] = best_i;
  s2_out[i] = best_s2;
  s3_out[i] = best_s3;
  if (kCount) {
    counts[i] = boxes;
    counts[static_cast<size_t>(n) + i] = tris;
  }
}

template <typename Stack, bool kCount>
void launch(const float* const* planes, const float4* tri, const float4* rec,
            int n, int* scratch, int* counts, void* const* out,
            cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_bvh_kernel<Stack, kCount><<<blocks, kThreads, 0, stream>>>(
      planes[0], planes[1], planes[2], planes[3], planes[4], planes[5], tri,
      rec, n, scratch, counts, static_cast<bool*>(out[0]),
      static_cast<float*>(out[1]), static_cast<int*>(out[2]),
      static_cast<float*>(out[3]), static_cast<float*>(out[4]));
}

}  // namespace

// depth: the stack entries the tree needs (pack_bvh); above kLocalStack,
// `scratch` must hold 3 * depth * n ints. `counts`, when not null, takes
// [2, n] ints: each ray's box tests, then its triangle tests.
extern "C" int pts_intersect_bvh(const void* rox, const void* roy,
                                 const void* roz, const void* rdx,
                                 const void* rdy, const void* rdz,
                                 const void* tri, const void* rec, int n,
                                 int depth, void* scratch, void* counts,
                                 void* hit, void* t, void* idx, void* s2,
                                 void* s3, void* stream) {
  const bool global = depth > kLocalStack;
  if (global && scratch == nullptr) return cudaErrorInvalidValue;
  if (n > 0) {
    const float* planes[6] = {
        static_cast<const float*>(rox), static_cast<const float*>(roy),
        static_cast<const float*>(roz), static_cast<const float*>(rdx),
        static_cast<const float*>(rdy), static_cast<const float*>(rdz)};
    void* out[5] = {hit, t, idx, s2, s3};
    const auto* tri4 = static_cast<const float4*>(tri);
    const auto* rec4 = static_cast<const float4*>(rec);
    auto* stack = static_cast<int*>(scratch);
    auto* cnt = static_cast<int*>(counts);
    auto s = static_cast<cudaStream_t>(stream);
    if (global) {
      if (cnt) launch<GlobalStack, true>(planes, tri4, rec4, n, stack, cnt, out, s);
      else launch<GlobalStack, false>(planes, tri4, rec4, n, stack, cnt, out, s);
    } else {
      if (cnt) launch<LocalStack, true>(planes, tri4, rec4, n, stack, cnt, out, s);
      else launch<LocalStack, false>(planes, tri4, rec4, n, stack, cnt, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
