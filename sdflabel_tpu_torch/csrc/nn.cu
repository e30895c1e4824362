// Streaming top-1 nearest neighbour: min squared distance + first-min index.
//
// Replaces sdflabel_tpu/ops/nn_pallas.py::_nn_call (_nn_kernel), reached
// through nearest_neighbor_fused. The (N, M) distance matrix is never
// built. Numerics: per pair t = q - d, d2 = (t0*t0 + t1*t1) + t2*t2, each
// product and sum rounded on its own (built with -fmad=false, so no fma
// contraction), which is the plain version's arithmetic bit for bit.
// Masked data points score 1e30; ties keep the lower index because each
// thread scans the data in index order and updates only on a strictly
// smaller distance. A fully masked row returns index 0 and 1e30.
//
// Bound on the H100: fp32 operations, 9 per (query, data) pair; bytes are
// 16 per data point and 20 per query. Design: one thread per query, data
// streamed through shared memory in chunks that every thread of the block
// reuses; the TPU kernel's sequential data-chunk axis becomes the loop
// inside the thread, so no cross-thread reduction (and no tie rule for
// one) is needed.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int THREADS = 64;   // 128 blocks for 8192 queries
constexpr int CHUNK = 1024;  // data points per shared-memory chunk (16 KB)
constexpr float BIG = 1e30f;

__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ query, const float4* __restrict__ data,
          int n, int m, float* __restrict__ dmin, int* __restrict__ idx) {
  __shared__ float4 s_d[CHUNK];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  if (active) {
    q0 = query[(size_t)i * 3 + 0];
    q1 = query[(size_t)i * 3 + 1];
    q2 = query[(size_t)i * 3 + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int c0 = 0; c0 < m; c0 += CHUNK) {
    const int cn = min(CHUNK, m - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn; k += blockDim.x) s_d[k] = data[c0 + k];
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < cn; ++k) {
      const float4 dd = s_d[k];
      const float t0 = q0 - dd.x;
      const float t1 = q1 - dd.y;
      const float t2 = q2 - dd.z;
      float d2 = t0 * t0 + t1 * t1 + t2 * t2;
      d2 = dd.w > 0.5f ? d2 : BIG;
      if (d2 < best) {
        best = d2;
        best_i = c0 + k;
      }
    }
  }
  if (active) {
    dmin[i] = best;
    idx[i] = best_i;
  }
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// query (n, 3) f32, data (m, 4) f32 rows [x, y, z, mask] -> dmin (n,) f32
// squared distance, idx (n,) i32.
int nn_fwd(const void* query, const void* data, int n, int m, void* dmin,
           void* idx, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  nn_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)query, (const float4*)data, n, m, (float*)dmin,
      (int*)idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
