// Cluster-culled closest hit (K4): N rays against the BVH-ordered [T, 16]
// triangle table, swept cluster by cluster, each cluster a run of 128 rows
// with its AABB in cluster_aabbs [C, 8] (min3, max3, pad2), each run of 8
// clusters under one group box [G, 8] (ops/intersect_cluster_cuda.py,
// pack_clusters, built once per scene).
//
// Replaces: pathtracing_spectrum_tpu/ops/intersect_pallas.py,
// _cluster_kernel and _cluster_group (launched by
// intersect_clustered_pallas_soa), the TPU's cluster-culled dense sweep,
// which culls a 1,024-ray block first per group of 8 clusters, then per
// cluster.
//
// Function: the result of K1 (intersect_dense.cu) over the same table:
// the minimum t wins, the lowest index wins a tie, hit = t < BIG, and the
// winner's s2/s3 come back with it.
//
// What bounds it on the card: issuing the row tests of the clusters the
// warps sweep, ~75 instructions each (tri_hit.cuh, no multiply-add
// contraction), and the latency of the longest warps. A needed cluster
// costs 128 row tests per ray that needs it, however few of them hit, so
// the kernel does ~100x the triangle tests of K3's walk on the same rays.
// The box tests (~40 instructions each) come second. Bytes do not bind:
// the rays are read once and the 3.3 MB table of the 52k terrain sits in
// the 50 MB L2. The design this one replaced voted per 128-ray block with
// a block barrier per cluster, tested all C cluster boxes per ray in index
// order and swept a cluster's rows per lane whenever one lane of the warp
// needed it: its longest warp on the terrain's bounce-2 rays swept 23,040
// rows, one dependent row test after another (PERF.md).
// tools/k4_designs.cu keeps it, with a counting build, beside the steps
// between the two and the variants measured against this one.
//
// Design: one thread per ray, 128 threads a block, and each warp of 32
// rays works alone: no block barrier anywhere. The launch bound names one
// block an SM, so ptxas may take the ~115 registers the sweep wants (16
// warps an SM); left to itself it capped the kernel at 72 and spilled,
// 9% slower on the terrain primaries (3.5% faster on the textured rays).
// - Collect. The warp tests the G group boxes in order (each box read as
//   two broadcast float4 loads); for a group one of its rays enters
//   (__any_sync), it tests the group's 8 cluster boxes and lists each
//   cluster one of its rays enters, keyed by the smallest entry distance
//   (box_enter's near) over those rays (__reduce_min_sync on the float's
//   order-preserving bits) with the cluster index below it: a 64-bit key,
//   in a per-warp list in shared memory (kListMax entries).
// - Sort. The warp sorts its list by key with a bitonic sort in shared
//   memory (__syncwarp between stages): nearest cluster first.
// - Sweep. For each listed cluster in that order, every ray re-tests its
//   box against its current best t, inclusively (near <= relax(best t));
//   the cluster is skipped when no ray of the warp still needs it. When k
//   rays need it and k passes of ceil(rows / 32) steps cost less than one
//   pass over the rows, the warp takes the rays one at a time and its 32
//   lanes test that ray's rows side by side (each lane its own rows, read
//   as coalesced float4 loads), then reduce to the least (t, idx) with
//   shuffles. This keeps a warp with one far-reaching ray from sweeping
//   every row of every cluster that ray enters. Otherwise each lane that
//   needs the cluster tests every row for its own ray, the rows staged
//   kStage at a time in the warp's shared memory by coalesced float4 loads
//   and read back as broadcasts (measured faster than broadcast loads
//   through L1/L2, whose latency the longest warps wait on). Either way a
//   row wins on a smaller t or an equal t at a lower index (tri_update's
//   order-free rule), so neither the order of the clusters nor the split
//   of the rows can change the winner: the result is the plain version's
//   bit for bit (shared predicate, --fmad=false).
// - A list that cannot take a group's 8 clusters is sorted and swept first
//   (a window); collection then resumes, culling against the improved
//   best t. So any C works with a list of kListMax entries.
// - Parked rays (rd = 0 on all axes) and rays past the end vote no and
//   need no cluster. Clusters at or beyond ceil(T / 128) (the padding of
//   the last group) are never listed.
// - A counting build (kCount) writes per ray its box tests (group,
//   cluster and re-test), its warp's row-test steps (a pass over the rows
//   counts the rows, a side-by-side pass ceil(rows / 32) per ray) and the
//   clusters its warp swept: the data-dependent work the time follows.

#include <cuda_runtime.h>

#include "tri_hit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 128;    // triangle rows per cluster AABB
constexpr int kGroup = 8;        // clusters per group box
// entries of a warp's cluster list (ops/intersect_cluster_cuda.py,
// LIST_CAPACITY)
constexpr int kListMax = 512;
// rows a warp stages at a time for a pass over a cluster's rows
constexpr int kStage = 32;
constexpr unsigned kAll = 0xffffffffu;
// a lane's (t, idx) before it meets a valid row: FLT_MAX lies above any t
// that can win (every t that wins is below kBig), INT_MAX above any row
constexpr float kNoHit = 3.40282347e38f;
constexpr int kNoRow = 0x7fffffff;

// Bits of a float whose unsigned order is the float order (NaN aside).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Box r of a [rows, 8] table read as two float4s: (lo.xyz, hi.x),
// (hi.yz, pad).
__device__ __forceinline__ bool enter_box(const pts::Ray& ray,
                                          const pts::Slab& slab,
                                          const float4* __restrict__ table,
                                          int r, float best_t, float& near) {
  const float4 a = __ldg(table + 2 * static_cast<size_t>(r));
  const float4 b = __ldg(table + 2 * static_cast<size_t>(r) + 1);
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  return pts::box_enter(ray, slab, lo, hi, best_t, near);
}

struct Row {
  float v[16];
  __device__ operator const float*() const { return v; }
};

// Row j of the packed table from `src`, four float4 loads.
__device__ __forceinline__ Row load_row(const float4* __restrict__ src,
                                        int j) {
  const float4 a = __ldg(src + 4 * j), b = __ldg(src + 4 * j + 1);
  const float4 c = __ldg(src + 4 * j + 2), d = __ldg(src + 4 * j + 3);
  return Row{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
              c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w}};
}

// Row j of rows staged in shared memory.
__device__ __forceinline__ Row shared_row(const float4* s, int j) {
  const float4 a = s[4 * j], b = s[4 * j + 1], c = s[4 * j + 2],
               d = s[4 * j + 3];
  return Row{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
              c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w}};
}

// The least (t, idx) over the warp, with its s2/s3, on every lane: the
// order-free form of the tie rule (a smaller t, or an equal t at a lower
// index).
__device__ __forceinline__ void warp_lexmin(float& t, int& idx, float& s2,
                                            float& s3) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kAll, t, off);
    const int oi = __shfl_xor_sync(kAll, idx, off);
    const float o2 = __shfl_xor_sync(kAll, s2, off);
    const float o3 = __shfl_xor_sync(kAll, s3, off);
    if (ot < t || (ot == t && oi < idx)) {
      t = ot;
      idx = oi;
      s2 = o2;
      s3 = o3;
    }
  }
}

// Ascending bitonic sort of list[0, p), p a power of two, by one warp.
__device__ __forceinline__ void warp_sort(unsigned long long* list, int p,
                                          int lane) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = lane; q < p / 2; q += 32) {
        const int a = ((q & ~(j - 1)) << 1) | (q & (j - 1));   // bit j clear
        const int b = a + j;
        const unsigned long long x = list[a], y = list[b];
        if ((x > y) == ((a & k) == 0)) {
          list[a] = y;
          list[b] = x;
        }
      }
      __syncwarp();
    }
  }
}

// The kernel's arguments (pts_intersect_cluster says what each holds).
struct Args {
  const float* planes[6];   // ox, oy, oz, dx, dy, dz
  const float4* tri;
  const float4* boxes;
  const float4* groups;
  int n, t_count, n_groups;
  int* counts;
  bool* hit;
  float* t;
  int* idx;
  float* s2;
  float* s3;
};

// Sort list[0, len) ascending, padded to a power of two with ~0.
__device__ __forceinline__ void sort_list(unsigned long long* list, int len,
                                          int lane) {
  int p = 1;
  while (p < len) p <<= 1;
  for (int k = len + lane; k < p; k += 32) list[k] = ~0ull;
  __syncwarp();
  warp_sort(list, p, lane);
}

// Collect: the clusters one of the warp's rays enters, group by group, in
// `list`; a full window is handed to sweep(len) first. Returns the length
// of the last window.
template <bool kCount, typename Sweep>
__device__ __forceinline__ int collect(const Args& a, const pts::Ray& ray,
                                       const pts::Slab& slab, bool live,
                                       const float& best_t,
                                       unsigned long long* list, int lane,
                                       int& n_boxes, Sweep&& sweep) {
  const int n_clusters = (a.t_count + kCluster - 1) / kCluster;
  int len = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    float near;
    const bool in_group = live && enter_box(ray, slab, a.groups, g, best_t,
                                            near);
    if (kCount && live) ++n_boxes;
    if (!__any_sync(kAll, in_group)) continue;
    if (len + kGroup > kListMax) {   // a full window: sweep it first
      sweep(len);
      len = 0;
    }
    const int last = min(kGroup, n_clusters - g * kGroup);
    for (int m = 0; m < last; ++m) {
      const int c = g * kGroup + m;
      const bool in_cluster = live && enter_box(ray, slab, a.boxes, c,
                                                best_t, near);
      if (kCount && live) ++n_boxes;
      const unsigned key = __reduce_min_sync(
          kAll, in_cluster ? ordered(near) : 0xffffffffu);
      if (__any_sync(kAll, in_cluster)) {
        if (lane == 0)
          list[len] = (static_cast<unsigned long long>(key) << 32) |
                      static_cast<unsigned>(c);
        ++len;
      }
    }
  }
  return len;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 1) intersect_cluster_kernel(Args a) {
  __shared__ unsigned long long s_list[kWarps][kListMax];
  __shared__ float4 s_rows[kWarps][4 * kStage];
  unsigned long long* list = s_list[threadIdx.x / 32];
  float4* stage = s_rows[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const pts::Ray ray =
      i < a.n ? pts::Ray{a.planes[0][i], a.planes[1][i], a.planes[2][i],
                         a.planes[3][i], a.planes[4][i], a.planes[5][i]}
              : pts::Ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const bool live = i < a.n && (ray.dx != 0.f || ray.dy != 0.f ||
                                ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  float best_t = pts::kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;
  int n_boxes = 0, n_rows = 0, n_swept = 0;

  // sort list[0, len) and sweep its clusters, nearest first
  auto sweep = [&](int len) {
    sort_list(list, len, lane);
    for (int e = 0; e < len; ++e) {
      const int c = static_cast<int>(list[e] & 0xffffffffu);
      float near;
      const bool need =
          live && enter_box(ray, slab, a.boxes, c, best_t, near);
      if (kCount && live) ++n_boxes;
      const unsigned needs = __ballot_sync(kAll, need);
      if (!needs) continue;
      const int base = c * kCluster;
      const int rows = min(kCluster, a.t_count - base);
      const float4* src = a.tri + 4 * static_cast<size_t>(base);
      const int steps = (rows + 31) / 32;
      const int k = __popc(needs);
      if (k * (steps + 1) <= rows) {
        // few rays need it: for each, the 32 lanes test its rows
        for (unsigned m = needs; m; m &= m - 1) {
          const int owner = __ffs(m) - 1;
          const pts::Ray r{__shfl_sync(kAll, ray.ox, owner),
                           __shfl_sync(kAll, ray.oy, owner),
                           __shfl_sync(kAll, ray.oz, owner),
                           __shfl_sync(kAll, ray.dx, owner),
                           __shfl_sync(kAll, ray.dy, owner),
                           __shfl_sync(kAll, ray.dz, owner)};
          float t = kNoHit, s2 = 0.f, s3 = 0.f;
          int idx = kNoRow;
          // not unrolled: unrolled 4 it measured slower (tools/k4_designs)
#pragma unroll 1
          for (int j = lane; j < rows; j += 32) {
            float tj, s2j, s3j;
            if (pts::tri_hit(r, load_row(src, j), tj, s2j, s3j) && tj < t) {
              t = tj;
              idx = base + j;
              s2 = s2j;
              s3 = s3j;
            }
          }
          warp_lexmin(t, idx, s2, s3);
          if (lane == owner &&
              (t < best_t || (t == best_t && idx < best_i))) {
            best_t = t;
            best_i = idx;
            best_s2 = s2;
            best_s3 = s3;
          }
        }
        if (kCount) n_rows += k * steps;
      } else {
        // most rays need it: each lane tests every row for its own ray,
        // the rows staged kStage at a time in the warp's shared memory
        for (int c0 = 0; c0 < rows; c0 += kStage) {
          const int chunk = min(kStage, rows - c0);
          __syncwarp();   // every lane is done with the last chunk
          for (int q = lane; q < 4 * chunk; q += 32)
            stage[q] = __ldg(src + 4 * c0 + q);
          __syncwarp();
          if (need) {
#pragma unroll 2
            for (int j = 0; j < chunk; ++j)
              pts::tri_update(ray, shared_row(stage, j), base + c0 + j,
                              best_t, best_i, best_s2, best_s3);
          }
        }
        if (kCount) n_rows += rows;
      }
      if (kCount) ++n_swept;
    }
    __syncwarp();   // every lane has read the list before it is refilled
  };

  const int len = collect<kCount>(a, ray, slab, live, best_t, list, lane,
                                  n_boxes, sweep);
  if (len > 0) sweep(len);

  if (i < a.n) {
    a.hit[i] = best_t < pts::kBig;
    a.t[i] = best_t;
    a.idx[i] = best_i;
    a.s2[i] = best_s2;
    a.s3[i] = best_s3;
    if (kCount) {
      a.counts[i] = n_boxes;
      a.counts[static_cast<size_t>(a.n) + i] = n_rows;
      a.counts[2 * static_cast<size_t>(a.n) + i] = n_swept;
    }
  }
}

}  // namespace

// boxes: the [C, 8] cluster table and groups the [G, 8] group boxes, both
// 16-byte aligned. `counts`, when not null, takes [3, n] ints: each ray's
// box tests, its warp's row-test steps, its warp's swept clusters.
extern "C" int pts_intersect_cluster(const void* rox, const void* roy,
                                     const void* roz, const void* rdx,
                                     const void* rdy, const void* rdz,
                                     const void* tri, const void* boxes,
                                     const void* groups, int n, int t_count,
                                     int n_groups, void* counts, void* hit,
                                     void* t,
                                     void* idx, void* s2, void* s3,
                                     void* stream) {
  if (n > 0) {
    const Args a{{static_cast<const float*>(rox),
                  static_cast<const float*>(roy),
                  static_cast<const float*>(roz),
                  static_cast<const float*>(rdx),
                  static_cast<const float*>(rdy),
                  static_cast<const float*>(rdz)},
                 static_cast<const float4*>(tri),
                 static_cast<const float4*>(boxes),
                 static_cast<const float4*>(groups), n, t_count, n_groups,
                 static_cast<int*>(counts), static_cast<bool*>(hit),
                 static_cast<float*>(t), static_cast<int*>(idx),
                 static_cast<float*>(s2), static_cast<float*>(s3)};
    const int blocks = (n + kThreads - 1) / kThreads;
    auto s = static_cast<cudaStream_t>(stream);
    if (a.counts)
      intersect_cluster_kernel<true><<<blocks, kThreads, 0, s>>>(a);
    else
      intersect_cluster_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
