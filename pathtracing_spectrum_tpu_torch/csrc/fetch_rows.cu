// Per-hit attribute fetch: out[f, i] = (0 <= idx[i] < T) ? table[idx[i], f]
// : 0, written as [F, N] so that every attribute is a contiguous [N] plane
// for the bounce loop.
//
// Replaces: pathtracing_spectrum_tpu/ops/fetch_pallas.py, _fetch_kernel
// (launched by fetch_rows_pallas). The TPU built a one-hot block in VMEM and
// ran an MXU matmul per (ray block, table group), because gathers were slow
// there. On the card the same function is a gather.
//
// What bounds it on the card: device-memory bandwidth. At the main path
// (N = 262,144 rays, F = 31 columns, T = 36 rows) it reads 1 MB of indices
// and writes 32 MB of attributes; the table is 4.5 KB.
//
// Design: one thread per ray. Neighbouring threads take neighbouring i, so
// the index loads and each of the F plane stores coalesce. When the table
// fits in 48 KB it is staged in shared memory once per block (the main
// path's table is 36 x 31 floats); a larger table is read through the
// cache instead. Values are copied, never computed, so the result equals
// the plain version (ops/fetch_cuda.py, fetch_rows_ref) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
fetch_rows_kernel(const int* __restrict__ idx,
                  const float* __restrict__ table, int n, int t_count,
                  int f_count, bool stage, float* __restrict__ out) {
  extern __shared__ float s_table[];
  const float* src = table;
  if (stage) {
    for (int k = threadIdx.x; k < t_count * f_count; k += blockDim.x)
      s_table[k] = table[k];
    __syncthreads();
    src = s_table;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = idx[i];
  if (row >= 0 && row < t_count) {
    const float* r = src + static_cast<size_t>(row) * f_count;
    for (int f = 0; f < f_count; ++f) out[static_cast<size_t>(f) * n + i] = r[f];
  } else {
    for (int f = 0; f < f_count; ++f) out[static_cast<size_t>(f) * n + i] = 0.f;
  }
}

}  // namespace

extern "C" int pts_fetch_rows(const void* idx, const void* table, int n,
                              int t_count, int f_count, void* out,
                              void* stream) {
  if (n > 0 && f_count > 0) {
    const size_t bytes =
        static_cast<size_t>(t_count) * f_count * sizeof(float);
    const bool stage = bytes <= kMaxSharedBytes;
    const int blocks = (n + kThreads - 1) / kThreads;
    fetch_rows_kernel<<<blocks, kThreads, stage ? bytes : 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(table), n,
        t_count, f_count, stage, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
