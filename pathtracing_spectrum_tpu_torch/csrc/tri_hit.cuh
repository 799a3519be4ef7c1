// Shared device code of the closest-hit kernels K1 (intersect_dense.cu),
// K3 (intersect_bvh.cu) and K4 (intersect_cluster.cu): the ray-triangle
// predicate and the culling box test. One definition, so the three kernels
// compute t, s2 and s3 bitwise alike for one (ray, triangle) pair, and all
// of them agree with the plain torch versions (ops/intersect.py, tri_hits
// and box_hits), which write every expression in the same order.
//
// Every step is a round-to-nearest intrinsic and the sources are built with
// --fmad=false: no multiply-add contraction.
//
// The walk of K3 meets rows out of index order, so a row wins when its t is
// smaller, or equal at a lower index: in any order the lowest index wins a
// tie, and in ascending order (K1, K4) this is the strict `<` of the plain
// version.

#pragma once

#include <cuda_runtime.h>

namespace pts {

constexpr float kBig = 3.0e38f;
// float32(1 + 1e-4) and float32(1e-4): the box tests' relative and
// absolute margin (ops/intersect.py, CULL_MARGIN)
constexpr float kOnePlusMargin = 0x1.00068ep+0f;
constexpr float kMargin = 0x1.a36e2ep-14f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  // (ax*bx + ay*by) + az*bz, each step rounded
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// One row of the packed [T, 16] table (n | K1 | K2 | K3 | c0 c1 c2 c3):
// t = (c0 - ro.n) / (rd.n), p = ro + t*rd, s_i = p.K_i - c_i; valid iff
// rd.n != 0, t >= 0 and s1, s2, s3 >= 0. Every term is formed for every
// pair, without a branch: a lazy form (the division only where rd.n != 0,
// p and s_i only for a t that would win) measured slower on the card
// because the threads of a warp take those branches apart (PERF.md).
__device__ __forceinline__ bool tri_hit(const Ray& ray, const float* r,
                                        float& t, float& s2, float& s3) {
  const float denom = dot3(ray.dx, ray.dy, ray.dz, r[0], r[1], r[2]);
  const float ro_n = dot3(ray.ox, ray.oy, ray.oz, r[0], r[1], r[2]);
  const float safe = denom == 0.f ? 1.f : denom;
  t = __fdiv_rn(__fsub_rn(r[12], ro_n), safe);
  const float px = __fadd_rn(ray.ox, __fmul_rn(t, ray.dx));
  const float py = __fadd_rn(ray.oy, __fmul_rn(t, ray.dy));
  const float pz = __fadd_rn(ray.oz, __fmul_rn(t, ray.dz));
  const float s1 = __fsub_rn(dot3(px, py, pz, r[3], r[4], r[5]), r[13]);
  s2 = __fsub_rn(dot3(px, py, pz, r[6], r[7], r[8]), r[14]);
  s3 = __fsub_rn(dot3(px, py, pz, r[9], r[10], r[11]), r[15]);
  return denom != 0.f && t >= 0.f && s1 >= 0.f && s2 >= 0.f && s3 >= 0.f;
}

// Test one row and keep it when it wins: a smaller t, or an equal t at a
// lower index.
__device__ __forceinline__ void tri_update(const Ray& ray, const float* r,
                                           int idx, float& best_t,
                                           int& best_i, float& best_s2,
                                           float& best_s3) {
  float t, s2, s3;
  if (tri_hit(ray, r, t, s2, s3) &&
      (t < best_t || (t == best_t && idx < best_i))) {
    best_t = t;
    best_i = idx;
    best_s2 = s2;
    best_s3 = s3;
  }
}

__device__ __forceinline__ float relax(float t) {
  return __fadd_rn(__fmul_rn(t, kOnePlusMargin), kMargin);
}

// Per-ray constants of the box test: 1/d per axis (1 where d == 0) and
// which axes have d == 0.
struct Slab {
  float inv[3];
  bool zero[3];
};

__device__ __forceinline__ Slab slab_setup(const Ray& ray) {
  const float d[3] = {ray.dx, ray.dy, ray.dz};
  Slab s;
  for (int a = 0; a < 3; ++a) {
    s.zero[a] = d[a] == 0.f;
    s.inv[a] = s.zero[a] ? 1.f : __fdiv_rn(1.f, d[a]);
  }
  return s;
}

// Is the box [lo, hi] worth entering? Its slab interval must overlap
// [0, best_t], each bound widened by relax(), so the few-ulp difference
// between slab and triangle-plane arithmetic never culls the true winner.
// An axis with d == 0 bounds nothing when the origin lies in its slab and
// culls when it does not: (b - o) / 0 is never formed, so there is no
// 0 * inf NaN. Min and max are selects, as the plain version writes them.
// `near` receives the entry distance (K3 orders the children by it).
__device__ __forceinline__ bool box_enter(const Ray& ray, const Slab& s,
                                          const float lo[3],
                                          const float hi[3], float best_t,
                                          float& near) {
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float inf = __int_as_float(0x7f800000);
  float far = 0.f;
  near = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(lo[a], o[a]), s.inv[a]);
    const float t1 = __fmul_rn(__fsub_rn(hi[a], o[a]), s.inv[a]);
    const bool lt = t0 < t1;
    float n_a = lt ? t0 : t1;
    float f_a = lt ? t1 : t0;
    if (s.zero[a]) {
      const bool inside = o[a] >= lo[a] && o[a] <= hi[a];
      n_a = inside ? -inf : inf;
      f_a = inside ? inf : -inf;
    }
    near = a == 0 ? n_a : (near > n_a ? near : n_a);
    far = a == 0 ? f_a : (far < f_a ? far : f_a);
  }
  const float far_r = relax(far);
  return near <= far_r && far_r >= 0.f && near <= relax(best_t);
}

__device__ __forceinline__ bool box_hit(const Ray& ray, const Slab& s,
                                        const float lo[3], const float hi[3],
                                        float best_t) {
  float near;
  return box_enter(ray, s, lo, hi, best_t, near);
}

}  // namespace pts
