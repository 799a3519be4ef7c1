// Binned-SAH BVH builder (host C++), flat skip-link layout in DFS preorder.
//
// A copy of the builder section of the JAX package's native runtime
// (pathtracing_spectrum_tpu/native/src/pts_native.cpp, "Binned-SAH BVH
// builder"), carried into the port because that package's native module
// cannot be imported without jax. The algorithm and the arithmetic are
// unchanged, and ops/bvh.py builds it with the same compiler flags, so the
// two produce the same tree and the same triangle order: node i's children
// start at i+1, skip[i] is the next node when i is missed or finished, and
// every leaf covers a contiguous range of the reordered triangles.
//
// Built with the host compiler (not nvcc) into the port's build/ directory
// at first use and bound with ctypes; plain C ABI.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct BvhHandle {
  std::vector<float> node_min;   // 3 per node
  std::vector<float> node_max;
  std::vector<int32_t> node_skip;
  std::vector<int32_t> node_first;
  std::vector<int32_t> node_count;
  std::vector<int64_t> tri_order;
};

namespace {

struct Builder {
  const float* tmin;
  const float* tmax;
  std::vector<double> cx, cy, cz;  // centroids
  BvhHandle* out;
  std::vector<int64_t>* order;
  int leaf_size;

  static constexpr int kBins = 16;

  int emit(int64_t lo, int64_t hi) {
    float bmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float bmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t i = lo; i < hi; ++i) {
      int64_t t = (*order)[i];
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], tmin[t * 3 + a]);
        bmax[a] = std::max(bmax[a], tmax[t * 3 + a]);
      }
    }
    for (int a = 0; a < 3; ++a)
      if (bmax[a] == bmin[a]) bmax[a] += 1e-3f;  // AABB::Check parity
    int idx = static_cast<int>(out->node_min.size() / 3);
    for (int a = 0; a < 3; ++a) out->node_min.push_back(bmin[a]);
    for (int a = 0; a < 3; ++a) out->node_max.push_back(bmax[a]);
    out->node_skip.push_back(-1);
    out->node_first.push_back(static_cast<int32_t>(lo));
    out->node_count.push_back(0);
    return idx;
  }

  double centroid(int64_t t, int axis) const {
    switch (axis) {
      case 0: return cx[t];
      case 1: return cy[t];
      default: return cz[t];
    }
  }

  void build(int64_t lo, int64_t hi) {
    int idx = emit(lo, hi);
    int64_t n = hi - lo;
    if (n <= leaf_size) {
      out->node_count[idx] = static_cast<int32_t>(n);
      out->node_skip[idx] = static_cast<int32_t>(out->node_min.size() / 3);
      return;
    }

    // binned SAH over the widest centroid axis
    double cmin[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
    double cmax[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
    for (int64_t i = lo; i < hi; ++i) {
      int64_t t = (*order)[i];
      double c[3] = {cx[t], cy[t], cz[t]};
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    int axis = 0;
    double ext = -1.0;
    for (int a = 0; a < 3; ++a) {
      double e = cmax[a] - cmin[a];
      if (e > ext) { ext = e; axis = a; }
    }

    int64_t mid;
    if (ext <= 0.0) {
      mid = lo + n / 2;  // degenerate: median split
    } else {
      // bin triangles
      struct Bin { double bmin[3], bmax[3]; int64_t count = 0; };
      Bin bins[kBins];
      for (Bin& b : bins)
        for (int a = 0; a < 3; ++a) { b.bmin[a] = DBL_MAX; b.bmax[a] = -DBL_MAX; }
      double inv = kBins / ext;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t t = (*order)[i];
        int b = static_cast<int>((centroid(t, axis) - cmin[axis]) * inv);
        b = std::min(std::max(b, 0), kBins - 1);
        bins[b].count++;
        for (int a = 0; a < 3; ++a) {
          bins[b].bmin[a] = std::min(bins[b].bmin[a],
                                     static_cast<double>(tmin[t * 3 + a]));
          bins[b].bmax[a] = std::max(bins[b].bmax[a],
                                     static_cast<double>(tmax[t * 3 + a]));
        }
      }
      // sweep SAH costs
      double larea[kBins], rarea[kBins];
      int64_t lcount[kBins];
      double bmn[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
      double bmx[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
      int64_t cnt = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        if (bins[b].count) {
          for (int a = 0; a < 3; ++a) {
            bmn[a] = std::min(bmn[a], bins[b].bmin[a]);
            bmx[a] = std::max(bmx[a], bins[b].bmax[a]);
          }
        }
        cnt += bins[b].count;
        lcount[b] = cnt;
        double dx = std::max(bmx[0] - bmn[0], 0.0);
        double dy = std::max(bmx[1] - bmn[1], 0.0);
        double dz = std::max(bmx[2] - bmn[2], 0.0);
        larea[b] = cnt ? (dx * dy + dy * dz + dz * dx) : 0.0;
      }
      for (int a = 0; a < 3; ++a) { bmn[a] = DBL_MAX; bmx[a] = -DBL_MAX; }
      for (int b = kBins - 1; b > 0; --b) {
        if (bins[b].count) {
          for (int a = 0; a < 3; ++a) {
            bmn[a] = std::min(bmn[a], bins[b].bmin[a]);
            bmx[a] = std::max(bmx[a], bins[b].bmax[a]);
          }
        }
        double dx = std::max(bmx[0] - bmn[0], 0.0);
        double dy = std::max(bmx[1] - bmn[1], 0.0);
        double dz = std::max(bmx[2] - bmn[2], 0.0);
        rarea[b - 1] = dx * dy + dy * dz + dz * dx;
      }
      int best = -1;
      double best_cost = DBL_MAX;
      for (int b = 0; b < kBins - 1; ++b) {
        int64_t lc = lcount[b], rc = n - lc;
        if (lc == 0 || rc == 0) continue;
        double cost = larea[b] * lc + rarea[b] * rc;
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best < 0) {
        mid = lo + n / 2;
        int64_t* base = order->data();
        std::nth_element(base + lo, base + mid, base + hi,
                         [&](int64_t a, int64_t b) {
                           return centroid(a, axis) < centroid(b, axis);
                         });
      } else {
        double split = cmin[axis] + (best + 1) / inv;
        int64_t* base = order->data();
        int64_t* pmid = std::partition(base + lo, base + hi, [&](int64_t t) {
          return centroid(t, axis) < split;
        });
        mid = pmid - base;
        if (mid == lo || mid == hi) mid = lo + n / 2;  // guard
      }
    }

    build(lo, mid);
    build(mid, hi);
    out->node_skip[idx] = static_cast<int32_t>(out->node_min.size() / 3);
  }
};

}  // namespace

BvhHandle* pts_bvh_build(const float* tri_min, const float* tri_max,
                         int64_t n_tris, int32_t leaf_size) {
  BvhHandle* h = new BvhHandle();
  h->tri_order.resize(static_cast<size_t>(n_tris));
  for (int64_t i = 0; i < n_tris; ++i) h->tri_order[i] = i;
  if (n_tris == 0) return h;

  Builder b;
  b.tmin = tri_min;
  b.tmax = tri_max;
  b.out = h;
  b.order = &h->tri_order;
  b.leaf_size = leaf_size;
  b.cx.resize(static_cast<size_t>(n_tris));
  b.cy.resize(static_cast<size_t>(n_tris));
  b.cz.resize(static_cast<size_t>(n_tris));
  for (int64_t i = 0; i < n_tris; ++i) {
    b.cx[i] = 0.5 * (tri_min[i * 3 + 0] + tri_max[i * 3 + 0]);
    b.cy[i] = 0.5 * (tri_min[i * 3 + 1] + tri_max[i * 3 + 1]);
    b.cz[i] = 0.5 * (tri_min[i * 3 + 2] + tri_max[i * 3 + 2]);
  }
  b.build(0, n_tris);
  return h;
}

int32_t pts_bvh_node_count(BvhHandle* h) {
  return static_cast<int32_t>(h->node_min.size() / 3);
}

void pts_bvh_export(BvhHandle* h, float* node_min, float* node_max,
                    int32_t* skip, int32_t* first, int32_t* count,
                    int64_t* tri_order) {
  std::memcpy(node_min, h->node_min.data(),
              h->node_min.size() * sizeof(float));
  std::memcpy(node_max, h->node_max.data(),
              h->node_max.size() * sizeof(float));
  std::memcpy(skip, h->node_skip.data(),
              h->node_skip.size() * sizeof(int32_t));
  std::memcpy(first, h->node_first.data(),
              h->node_first.size() * sizeof(int32_t));
  std::memcpy(count, h->node_count.data(),
              h->node_count.size() * sizeof(int32_t));
  std::memcpy(tri_order, h->tri_order.data(),
              h->tri_order.size() * sizeof(int64_t));
}

void pts_bvh_free(BvhHandle* h) { delete h; }

}  // extern "C"
