// Designs of K4 (the cluster-culled closest hit) that the port's kernel
// (pathtracing_spectrum_tpu_torch/csrc/intersect_cluster.cu) is measured
// against; tools/k4_designs.py builds this file and runs each design
// beside the port's kernel on the same rays. Every design computes the
// kernel's function bit for bit (the tool checks it); they differ in who
// votes, what is culled first and in which order the clusters are swept,
// one step at a time:
//
//   design 0: the design the port's kernel replaced. 128-ray blocks vote
//             with __syncthreads_or on each of the C cluster boxes in
//             index order and stage a needed cluster's rows in shared
//             memory; a warp sweeps them when one of its rays needs them.
//   design 1: each warp votes alone (__any_sync), no block barrier; the C
//             cluster boxes in index order, rows read as broadcast float4
//             loads.
//   design 2: design 1 after the group-of-8 pre-cull: a cluster box is
//             tested only in a group one of the warp's rays enters.
//   design 3: design 2 with the clusters a warp enters listed, sorted and
//             swept nearest first, each re-tested before its sweep.
//   design 4: design 3 with a cluster few of the warp's rays need swept
//             side by side: a ray at a time, its rows across the lanes.
//   (port):   design 4 with the rows of a pass over a cluster staged 32
//             at a time in the warp's shared memory.
//
// and variants of the port, each one change: design 5 a list of 128
// entries, 6 one warp a block, 7 four warps to 32 rays (each a quarter of
// every cluster's rows, one block barrier per swept cluster), 8 at most
// 64 registers, 9 and 10 64 and 128 rows staged at a time, 11 and 12 the
// side-by-side and the staged loops unrolled 4.
//
// Each design has a counting build that writes, per ray, its box tests,
// its warp's row-test steps (designs 0-3 sweep every cluster's rows one
// after another, each lane for its own ray; design 7 counts its first
// warp's quarter) and the clusters its warp swept, as the port's kernel
// does.

#include <cuda_runtime.h>

#include "../pathtracing_spectrum_tpu_torch/csrc/tri_hit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCluster = 128;
constexpr int kGroup = 8;
constexpr int kListMax = 512;
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const float* planes[6];
  const float4* tri;
  const float4* boxes;    // [C, 8] as float4 pairs
  const float4* groups;   // [G, 8] as float4 pairs
  int n, t_count, n_groups;
  int* counts;            // [3, n] or null
  bool* hit;
  float* t;
  int* idx;
  float* s2;
  float* s3;
};

__device__ __forceinline__ pts::Ray load_ray(const Args& a, int i) {
  if (i >= a.n) return {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  return {a.planes[0][i], a.planes[1][i], a.planes[2][i],
          a.planes[3][i], a.planes[4][i], a.planes[5][i]};
}

__device__ __forceinline__ bool enter_box(const pts::Ray& ray,
                                          const pts::Slab& slab,
                                          const float4* table, int r,
                                          float best_t) {
  const float4 a = __ldg(table + 2 * static_cast<size_t>(r));
  const float4 b = __ldg(table + 2 * static_cast<size_t>(r) + 1);
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  return pts::box_hit(ray, slab, lo, hi, best_t);
}

__device__ __forceinline__ void row_update(const pts::Ray& ray,
                                           const float4* src, int idx,
                                           float& bt, int& bi, float& b2,
                                           float& b3) {
  const float4 a = src[0], b = src[1], c = src[2], d = src[3];
  const float r[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                       c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
  pts::tri_update(ray, r, idx, bt, bi, b2, b3);
}

__device__ __forceinline__ void store(const Args& a, int i, float bt, int bi,
                                      float b2, float b3, int boxes,
                                      int rows, int swept) {
  if (i >= a.n) return;
  a.hit[i] = bt < pts::kBig;
  a.t[i] = bt;
  a.idx[i] = bi;
  a.s2[i] = b2;
  a.s3[i] = b3;
  if (a.counts) {
    a.counts[i] = boxes;
    a.counts[static_cast<size_t>(a.n) + i] = rows;
    a.counts[2 * static_cast<size_t>(a.n) + i] = swept;
  }
}

// design 0: block vote, staged rows, cluster boxes in index order
__global__ void __launch_bounds__(kThreads) block_vote(Args a) {
  __shared__ float4 s_tri[kCluster * 4];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const pts::Ray ray = load_ray(a, i);
  const bool live = i < a.n && (ray.dx != 0.f || ray.dy != 0.f ||
                                ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  const int n_clusters = (a.t_count + kCluster - 1) / kCluster;
  float bt = pts::kBig, b2 = 0.f, b3 = 0.f;
  int bi = 0, boxes = 0, rows_swept = 0, swept = 0;
  for (int c = 0; c < n_clusters; ++c) {
    const int base = c * kCluster;
    const int rows = min(kCluster, a.t_count - base);
    const bool need = live && enter_box(ray, slab, a.boxes, c, bt);
    if (live) ++boxes;
    if (!__syncthreads_or(need)) continue;
    for (int k = threadIdx.x; k < rows * 4; k += kThreads)
      s_tri[k] = __ldg(a.tri + 4 * static_cast<size_t>(base) + k);
    __syncthreads();
    if (__any_sync(kAll, need)) {
      rows_swept += rows;
      ++swept;
    }
    if (need)
      for (int j = 0; j < rows; ++j)
        row_update(ray, s_tri + 4 * j, base + j, bt, bi, b2, b3);
  }
  store(a, i, bt, bi, b2, b3, boxes, rows_swept, swept);
}

// designs 1 (kGroups false) and 2: warp vote, clusters in index order
template <bool kGroups>
__global__ void __launch_bounds__(kThreads) warp_vote(Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const pts::Ray ray = load_ray(a, i);
  const bool live = i < a.n && (ray.dx != 0.f || ray.dy != 0.f ||
                                ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  const int n_clusters = (a.t_count + kCluster - 1) / kCluster;
  float bt = pts::kBig, b2 = 0.f, b3 = 0.f;
  int bi = 0, boxes = 0, rows_swept = 0, swept = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    if (kGroups) {
      const bool in_group = live && enter_box(ray, slab, a.groups, g, bt);
      if (live) ++boxes;
      if (!__any_sync(kAll, in_group)) continue;
    }
    const int last = min(kGroup, n_clusters - g * kGroup);
    for (int m = 0; m < last; ++m) {
      const int c = g * kGroup + m;
      const bool need = live && enter_box(ray, slab, a.boxes, c, bt);
      if (live) ++boxes;
      if (!__any_sync(kAll, need)) continue;
      const int base = c * kCluster;
      const int rows = min(kCluster, a.t_count - base);
      if (need) {
        const float4* src = a.tri + 4 * static_cast<size_t>(base);
        for (int j = 0; j < rows; ++j) {
          const float4 q[4] = {__ldg(src + 4 * j), __ldg(src + 4 * j + 1),
                               __ldg(src + 4 * j + 2),
                               __ldg(src + 4 * j + 3)};
          row_update(ray, q, base + j, bt, bi, b2, b3);
        }
      }
      rows_swept += rows;
      ++swept;
    }
  }
  store(a, i, bt, bi, b2, b3, boxes, rows_swept, swept);
}

__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool enter_near(const pts::Ray& ray,
                                           const pts::Slab& slab,
                                           const float4* table, int r,
                                           float best_t, float& near) {
  const float4 a = __ldg(table + 2 * static_cast<size_t>(r));
  const float4 b = __ldg(table + 2 * static_cast<size_t>(r) + 1);
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  return pts::box_enter(ray, slab, lo, hi, best_t, near);
}

// design 3: the port's collect, sort and re-test, every sweep a pass over
// the rows by the lanes that need the cluster
__global__ void __launch_bounds__(kThreads) nearest_first(Args a) {
  __shared__ unsigned long long s_list[kThreads / 32][kListMax];
  unsigned long long* list = s_list[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const pts::Ray ray = load_ray(a, i);
  const bool live = i < a.n && (ray.dx != 0.f || ray.dy != 0.f ||
                                ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  const int n_clusters = (a.t_count + kCluster - 1) / kCluster;
  float bt = pts::kBig, b2 = 0.f, b3 = 0.f;
  int bi = 0, boxes = 0, rows_swept = 0, swept = 0;
  auto sweep = [&](int len) {
    int p = 1;
    while (p < len) p <<= 1;
    for (int k = len + lane; k < p; k += 32) list[k] = ~0ull;
    __syncwarp();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = lane; q < p / 2; q += 32) {
          const int x = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const unsigned long long u = list[x], v = list[x + j];
          if ((u > v) == ((x & k) == 0)) {
            list[x] = v;
            list[x + j] = u;
          }
        }
        __syncwarp();
      }
    }
    for (int e = 0; e < len; ++e) {
      const int c = static_cast<int>(list[e] & 0xffffffffu);
      float near;
      const bool need = live && enter_near(ray, slab, a.boxes, c, bt, near);
      if (live) ++boxes;
      if (!__any_sync(kAll, need)) continue;
      const int base = c * kCluster;
      const int rows = min(kCluster, a.t_count - base);
      if (need) {
        const float4* src = a.tri + 4 * static_cast<size_t>(base);
        for (int j = 0; j < rows; ++j) {
          const float4 q[4] = {__ldg(src + 4 * j), __ldg(src + 4 * j + 1),
                               __ldg(src + 4 * j + 2),
                               __ldg(src + 4 * j + 3)};
          row_update(ray, q, base + j, bt, bi, b2, b3);
        }
      }
      rows_swept += rows;
      ++swept;
    }
    __syncwarp();
  };
  int len = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    float near;
    const bool in_group = live && enter_near(ray, slab, a.groups, g, bt,
                                             near);
    if (live) ++boxes;
    if (!__any_sync(kAll, in_group)) continue;
    if (len + kGroup > kListMax) {
      sweep(len);
      len = 0;
    }
    const int last = min(kGroup, n_clusters - g * kGroup);
    for (int m = 0; m < last; ++m) {
      const int c = g * kGroup + m;
      const bool in = live && enter_near(ray, slab, a.boxes, c, bt, near);
      if (live) ++boxes;
      const unsigned key =
          __reduce_min_sync(kAll, in ? ordered(near) : 0xffffffffu);
      if (__any_sync(kAll, in)) {
        if (lane == 0)
          list[len] = (static_cast<unsigned long long>(key) << 32) |
                      static_cast<unsigned>(c);
        ++len;
      }
    }
  }
  if (len > 0) sweep(len);
  store(a, i, bt, bi, b2, b3, boxes, rows_swept, swept);
}

// ---- designs 4-6: where the rows come from, and how many warps a ray has --

constexpr int kSmallList = 128;
constexpr float kNoHit = 3.40282347e38f;
constexpr int kNoRow = 0x7fffffff;

struct Row {
  float v[16];
  __device__ operator const float*() const { return v; }
};

__device__ __forceinline__ Row row_of(const float4* src, int j) {
  const float4 a = src[4 * j], b = src[4 * j + 1];
  const float4 c = src[4 * j + 2], d = src[4 * j + 3];
  return Row{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
              c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w}};
}

__device__ __forceinline__ Row ldg_row(const float4* src, int j) {
  const float4 a = __ldg(src + 4 * j), b = __ldg(src + 4 * j + 1);
  const float4 c = __ldg(src + 4 * j + 2), d = __ldg(src + 4 * j + 3);
  return Row{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
              c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w}};
}

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

__device__ __forceinline__ void warp_sort(unsigned long long* list, int p,
                                          int lane) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = lane; q < p / 2; q += 32) {
        const int x = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const unsigned long long u = list[x], v = list[x + j];
        if ((u > v) == ((x & k) == 0)) {
          list[x] = v;
          list[x + j] = u;
        }
      }
      __syncwarp();
    }
  }
}

// The warp's cluster list (the port's collect): calls sweep(len) on each
// full window and returns the length of the last.
template <int kList, typename Sweep>
__device__ __forceinline__ int collect(const Args& a, const pts::Ray& ray,
                                       const pts::Slab& slab, bool live,
                                       const float& bt,
                                       unsigned long long* list, int lane,
                                       int& boxes, Sweep&& sweep) {
  const int n_clusters = (a.t_count + kCluster - 1) / kCluster;
  int len = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    float near;
    const bool in_group = live && enter_near(ray, slab, a.groups, g, bt,
                                             near);
    if (live) ++boxes;
    if (!__any_sync(kAll, in_group)) continue;
    if (len + kGroup > kList) {
      sweep(len);
      len = 0;
    }
    const int last = min(kGroup, n_clusters - g * kGroup);
    for (int m = 0; m < last; ++m) {
      const int c = g * kGroup + m;
      const bool in = live && enter_near(ray, slab, a.boxes, c, bt, near);
      if (live) ++boxes;
      const unsigned key =
          __reduce_min_sync(kAll, in ? ordered(near) : 0xffffffffu);
      if (__any_sync(kAll, in)) {
        if (lane == 0)
          list[len] = (static_cast<unsigned long long>(key) << 32) |
                      static_cast<unsigned>(c);
        ++len;
      }
    }
  }
  return len;
}

__device__ __forceinline__ void sort_list(unsigned long long* list, int len,
                                          int lane) {
  int p = 1;
  while (p < len) p <<= 1;
  for (int k = len + lane; k < p; k += 32) list[k] = ~0ull;
  __syncwarp();
  warp_sort(list, p, lane);
}

// designs 4, 5, 6 and 8-12: the port's kernel in kBlock-thread blocks with
// a list of kList entries; where the lanes test every row for their own
// rays, the rows staged per warp in shared memory kStage at a time
// (coalesced float4 loads, then broadcast shared loads), or read as
// broadcast global loads when kStage is 0; at least kMinBlocks blocks an
// SM (a cap on registers); the side-by-side loop unrolled 4 (kUnroll) and
// the staged loop kRowUnroll
template <int kBlock, int kList, int kStage, int kMinBlocks, bool kUnroll,
          int kRowUnroll>
__global__ void __launch_bounds__(kBlock, kMinBlocks) staged(Args a) {
  constexpr int kW = kBlock / 32;
  __shared__ unsigned long long s_list[kW][kList];
  __shared__ float4 s_rows[kW][4 * (kStage ? kStage : 1)];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned long long* list = s_list[w];
  float4* stage = s_rows[w];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const pts::Ray ray = load_ray(a, i);
  const bool live = i < a.n && (ray.dx != 0.f || ray.dy != 0.f ||
                                ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  float bt = pts::kBig, b2 = 0.f, b3 = 0.f;
  int bi = 0, boxes = 0, rows_swept = 0, swept = 0;
  auto sweep = [&](int len) {
    sort_list(list, len, lane);
    for (int e = 0; e < len; ++e) {
      const int c = static_cast<int>(list[e] & 0xffffffffu);
      float near;
      const bool need = live && enter_near(ray, slab, a.boxes, c, bt, near);
      if (live) ++boxes;
      const unsigned needs = __ballot_sync(kAll, need);
      if (!needs) continue;
      const int base = c * kCluster;
      const int rows = min(kCluster, a.t_count - base);
      const float4* src = a.tri + 4 * static_cast<size_t>(base);
      const int steps = (rows + 31) / 32;
      const int k = __popc(needs);
      if (k * (steps + 1) <= rows) {
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
#pragma unroll(kUnroll ? 4 : 1)
          for (int j = lane; j < rows; j += 32) {
            float tj, s2j, s3j;
            if (pts::tri_hit(r, ldg_row(src, j), tj, s2j, s3j) && tj < t) {
              t = tj;
              idx = base + j;
              s2 = s2j;
              s3 = s3j;
            }
          }
          warp_lexmin(t, idx, s2, s3);
          if (lane == owner && (t < bt || (t == bt && idx < bi))) {
            bt = t;
            bi = idx;
            b2 = s2;
            b3 = s3;
          }
        }
        rows_swept += k * steps;
      } else if (kStage == 0) {
        if (need) {
#pragma unroll(kRowUnroll)
          for (int j = 0; j < rows; ++j)
            pts::tri_update(ray, ldg_row(src, j), base + j, bt, bi, b2, b3);
        }
        rows_swept += rows;
      } else {
        for (int c0 = 0; c0 < rows; c0 += kStage) {
          const int n_rows = min(kStage, rows - c0);
          __syncwarp();
          for (int q = lane; q < 4 * n_rows; q += 32)
            stage[q] = __ldg(src + 4 * c0 + q);
          __syncwarp();
          if (need) {
#pragma unroll(kRowUnroll)
            for (int j = 0; j < n_rows; ++j)
              pts::tri_update(ray, row_of(stage, j), base + c0 + j, bt, bi,
                              b2, b3);
          }
        }
        rows_swept += rows;
      }
      ++swept;
    }
    __syncwarp();
  };
  const int len = collect<kList>(a, ray, slab, live, bt, list, lane, boxes,
                                 sweep);
  if (len > 0) sweep(len);
  store(a, i, bt, bi, b2, b3, boxes, rows_swept, swept);
}

// design 7: four warps to a warp of 32 rays, each warp a quarter of every
// cluster's rows (rows 32w to 32w + 31), staged as in design 4. Each warp
// collects and sorts the same list and re-tests against the same best t;
// after each swept cluster the four warps' candidates meet in shared
// memory (one block barrier, candidates double-buffered) and every warp
// merges them in the same order, so the four keep one state.
__global__ void __launch_bounds__(128) split4(Args a) {
  __shared__ unsigned long long s_list[4][kSmallList];
  __shared__ float4 s_rows[4][128];
  __shared__ float s_t[2][4][32], s_2[2][4][32], s_3[2][4][32];
  __shared__ int s_i[2][4][32];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned long long* list = s_list[w];
  float4* stage = s_rows[w];
  const int i = blockIdx.x * 32 + lane;
  const pts::Ray ray = load_ray(a, i);
  const bool live = i < a.n && (ray.dx != 0.f || ray.dy != 0.f ||
                                ray.dz != 0.f);
  const pts::Slab slab = pts::slab_setup(ray);
  float bt = pts::kBig, b2 = 0.f, b3 = 0.f;
  int bi = 0, boxes = 0, rows_swept = 0, swept = 0;
  auto sweep = [&](int len) {
    sort_list(list, len, lane);
    for (int e = 0; e < len; ++e) {
      const int c = static_cast<int>(list[e] & 0xffffffffu);
      float near;
      const bool need = live && enter_near(ray, slab, a.boxes, c, bt, near);
      if (live) ++boxes;
      const unsigned needs = __ballot_sync(kAll, need);
      if (!needs) continue;
      const int base = c * kCluster + 32 * w;
      const int rows = max(0, min(32, a.t_count - base));
      const float4* src = a.tri + 4 * static_cast<size_t>(base);
      const int k = __popc(needs);
      float t = kNoHit, s2 = 0.f, s3 = 0.f;
      int idx = kNoRow;
      if (rows > 0 && 2 * k <= rows) {
        Row row{};
        if (lane < rows) row = ldg_row(src, lane);
        for (unsigned m = needs; m; m &= m - 1) {
          const int owner = __ffs(m) - 1;
          const pts::Ray r{__shfl_sync(kAll, ray.ox, owner),
                           __shfl_sync(kAll, ray.oy, owner),
                           __shfl_sync(kAll, ray.oz, owner),
                           __shfl_sync(kAll, ray.dx, owner),
                           __shfl_sync(kAll, ray.dy, owner),
                           __shfl_sync(kAll, ray.dz, owner)};
          float tj, s2j, s3j;
          int ij = kNoRow;
          if (!(lane < rows && pts::tri_hit(r, row, tj, s2j, s3j))) {
            tj = kNoHit;
            s2j = s3j = 0.f;
          } else {
            ij = base + lane;
          }
          warp_lexmin(tj, ij, s2j, s3j);
          if (lane == owner) {
            t = tj;
            idx = ij;
            s2 = s2j;
            s3 = s3j;
          }
        }
        rows_swept += k;
      } else if (rows > 0) {
        __syncwarp();
        for (int q = lane; q < 4 * rows; q += 32)
          stage[q] = __ldg(src + q);
        __syncwarp();
        if (need) {
#pragma unroll 2
          for (int j = 0; j < rows; ++j)
            pts::tri_update(ray, row_of(stage, j), base + j, t, idx, s2, s3);
        }
        rows_swept += rows;
      }
      const int p = swept & 1;
      s_t[p][w][lane] = t;
      s_i[p][w][lane] = idx;
      s_2[p][w][lane] = s2;
      s_3[p][w][lane] = s3;
      __syncthreads();
      for (int q = 0; q < 4; ++q) {
        const float ot = s_t[p][q][lane];
        const int oi = s_i[p][q][lane];
        if (ot < bt || (ot == bt && oi < bi)) {
          bt = ot;
          bi = oi;
          b2 = s_2[p][q][lane];
          b3 = s_3[p][q][lane];
        }
      }
      ++swept;
    }
    __syncwarp();
  };
  const int len = collect<kSmallList>(a, ray, slab, live, bt, list, lane,
                                      boxes, sweep);
  if (len > 0) sweep(len);
  if (w == 0) store(a, i, bt, bi, b2, b3, boxes, rows_swept, swept);
}

}  // namespace

// args: the six ray planes, tri, boxes, groups, counts (or null), hit, t,
// idx, s2, s3, in that order.
extern "C" int k4_design(int design, void* const* args, int n, int t_count,
                         int n_groups, void* stream) {
  Args a;
  for (int k = 0; k < 6; ++k)
    a.planes[k] = static_cast<const float*>(args[k]);
  a.tri = static_cast<const float4*>(args[6]);
  a.boxes = static_cast<const float4*>(args[7]);
  a.groups = static_cast<const float4*>(args[8]);
  a.counts = static_cast<int*>(args[9]);
  a.hit = static_cast<bool*>(args[10]);
  a.t = static_cast<float*>(args[11]);
  a.idx = static_cast<int*>(args[12]);
  a.s2 = static_cast<float*>(args[13]);
  a.s3 = static_cast<float*>(args[14]);
  a.n = n;
  a.t_count = t_count;
  a.n_groups = n_groups;
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    auto s = static_cast<cudaStream_t>(stream);
    if (design == 0) block_vote<<<blocks, kThreads, 0, s>>>(a);
    else if (design == 1) warp_vote<false><<<blocks, kThreads, 0, s>>>(a);
    else if (design == 2) warp_vote<true><<<blocks, kThreads, 0, s>>>(a);
    else if (design == 3) nearest_first<<<blocks, kThreads, 0, s>>>(a);
    else if (design == 4)
      staged<128, 512, 0, 1, false, 2><<<blocks, 128, 0, s>>>(a);
    else if (design == 5)
      staged<128, 128, 32, 1, false, 2><<<blocks, 128, 0, s>>>(a);
    else if (design == 6)
      staged<32, 512, 32, 1, false, 2><<<(n + 31) / 32, 32, 0, s>>>(a);
    else if (design == 7) split4<<<(n + 31) / 32, 128, 0, s>>>(a);
    else if (design == 8)
      staged<128, 512, 32, 8, false, 2><<<blocks, 128, 0, s>>>(a);
    else if (design == 9)
      staged<128, 512, 64, 1, false, 2><<<blocks, 128, 0, s>>>(a);
    else if (design == 10)
      staged<128, 512, 128, 1, false, 2><<<blocks, 128, 0, s>>>(a);
    else if (design == 11)
      staged<128, 512, 32, 1, true, 2><<<blocks, 128, 0, s>>>(a);
    else if (design == 12)
      staged<128, 512, 32, 1, false, 4><<<blocks, 128, 0, s>>>(a);
    else return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
