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
// the same row at the same time, a broadcast. Every expression is written
// in the operation order of the plain torch version (ops/intersect.py)
// with round-to-nearest intrinsics (__fmul_rn/__fadd_rn/__fsub_rn
// /__fdiv_rn), and the file is built with --fmad=false: no multiply-add
// contraction, so the kernel agrees with the plain version bit for bit.
// Contraction is the known way grazing-edge validity flips; turning it on
// is a later performance change, made against the agreement gate.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads = 256;
constexpr int kTile = 256;   // triangle rows per shared-memory tile (16 KB)

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  // (ax*bx + ay*by) + az*bz, each step rounded
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

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
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = rox[i]; oy = roy[i]; oz = roz[i];
    dx = rdx[i]; dy = rdy[i]; dz = rdz[i];
  }
  float best_t = kBig, best_s2 = 0.f, best_s3 = 0.f;
  int best_i = 0;

  for (int base = 0; base < t_count; base += kTile) {
    const int rows = min(kTile, t_count - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < rows * 16; k += blockDim.x)
      s_tri[k] = tri[static_cast<size_t>(base) * 16 + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < rows; ++j) {
      const float* r = s_tri + j * 16;
      const float denom = dot3(dx, dy, dz, r[0], r[1], r[2]);
      const float ro_n = dot3(ox, oy, oz, r[0], r[1], r[2]);
      const float safe = denom == 0.f ? 1.f : denom;
      const float t = __fdiv_rn(__fsub_rn(r[12], ro_n), safe);
      const float px = __fadd_rn(ox, __fmul_rn(t, dx));
      const float py = __fadd_rn(oy, __fmul_rn(t, dy));
      const float pz = __fadd_rn(oz, __fmul_rn(t, dz));
      const float s1 = __fsub_rn(dot3(px, py, pz, r[3], r[4], r[5]), r[13]);
      const float s2 = __fsub_rn(dot3(px, py, pz, r[6], r[7], r[8]), r[14]);
      const float s3 = __fsub_rn(dot3(px, py, pz, r[9], r[10], r[11]), r[15]);
      const bool valid = denom != 0.f && t >= 0.f && s1 >= 0.f &&
                         s2 >= 0.f && s3 >= 0.f;
      if (valid && t < best_t) {
        best_t = t;
        best_i = base + j;
        best_s2 = s2;
        best_s3 = s3;
      }
    }
  }
  if (active) {
    hit_out[i] = best_t < kBig;
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
