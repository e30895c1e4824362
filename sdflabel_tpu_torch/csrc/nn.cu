// Streaming top-1 nearest neighbour: min squared distance + first-min index.
//
// Replaces sdflabel_tpu/ops/nn_pallas.py::_nn_call (_nn_kernel), reached
// through nearest_neighbor_fused. The (N, M) distance matrix is never
// built. Numerics: per pair t = q - d, d2 = (t0*t0 + t1*t1) + t2*t2, each
// product and sum rounded on its own (built with -fmad=false, so no fma
// contraction), which is the plain version's arithmetic bit for bit.
// Masked data points score 1e30; ties keep the lower index. A fully masked
// row returns index 0 and 1e30.
//
// Bound on the H100: fp32 operations, 9 per (query, data) pair; bytes are
// 13 per data point and 24 per query. The TPU kernel's sequential
// data-chunk axis has to become parallel work here, or 8192 queries give
// 132 SMs 256 warps, two an SM.
//   split design (nn_split_kernel, every launch): grid (query blocks, S);
//             the S <= 8 CTAs of a query block form a thread-block cluster
//             and take contiguous slices of ceil(m / S) data points, each
//             staged once in shared memory (in chunks past SPLIT_CAP).
//             Each thread holds R queries, so every staged data point feeds
//             R independent distance chains. Within a slice a thread scans
//             in index order and updates on a strictly smaller d2, so it
//             keeps the slice's first minimum; the ranks' (d2, index) pairs
//             then merge in rank order with a strict < through distributed
//             shared memory, rank r merging the r-th share of the block's
//             queries. Slice r precedes slice r + 1, so the lower index
//             wins a tie: the result equals the first design's and the
//             plain version's, bit for bit. S = 1 when the query blocks
//             alone fill the card (RANSAC's 567 x n queries).
//   first design (nn_kernel, kept as the yardstick): one thread per query
//             over all data points, 64 threads a block.
//   crop axis (split design; the batched driver's 3D loss, as the TPU
//             kernel gains a batch grid axis under vmap): B crops of n
//             queries against m data points are one launch, crop b on grid
//             plane z = b over its own queries, data and mask; the cluster
//             spans only y, so the merge stays inside one crop and each
//             crop equals its launch alone (B = 1) bit for bit.
// Both read the (m, 3) points and an optional (m,) bool mask as they are
// and write the index as int64.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 64;   // the first design: 128 blocks for 8192 queries
constexpr int CHUNK = 1024;   // data points per shared-memory chunk (16 KB)
constexpr float BIG = 1e30f;
// the split design (scripts/split_sweep.py --variants builds others)
#ifndef NN_SPLIT_THREADS
#define NN_SPLIT_THREADS 128
#endif
#ifndef NN_SPLIT_R
#define NN_SPLIT_R 2
#endif
#ifndef NN_SPLIT_MAX
#define NN_SPLIT_MAX 8
#endif
constexpr int SPLIT_THREADS = NN_SPLIT_THREADS;
constexpr int SPLIT_R = NN_SPLIT_R;  // queries per thread
constexpr int SPLIT_QB = SPLIT_THREADS * SPLIT_R;  // queries per CTA
constexpr int SPLIT_MAX = NN_SPLIT_MAX;  // CTAs per cluster (8: portable)
constexpr int SPLIT_CAP = 1024;  // data points staged at once: 16 KB
constexpr int SPLIT_MIN_PTS = 256;  // fewest data points per slice
constexpr int SPLIT_CTAS_PER_SM = 2;  // CTAs the rule aims to give each SM
// Largest cluster the rule takes. At 8192 x 8192 clusters of 8 ran slower
// than clusters of 7 in every sweep on the H100, 0.055 against 0.044 ms
// a launch (scripts/split_sweep.py); how the card places 32 clusters of 8
// on its SMs is not measured.
constexpr int SPLIT_RULE_MAX = 7;

// Data point k as [x, y, z, valid] (valid 1 or 0).
__device__ __forceinline__ float4 data_point(const float* data,
                                             const uint8_t* mask, int k) {
  return make_float4(data[(size_t)k * 3 + 0], data[(size_t)k * 3 + 1],
                     data[(size_t)k * 3 + 2],
                     mask == nullptr || mask[k] ? 1.f : 0.f);
}

// The pair's squared distance, BIG for a masked data point.
__device__ __forceinline__ float pair_d2(float q0, float q1, float q2,
                                         float4 dd) {
  const float t0 = q0 - dd.x;
  const float t1 = q1 - dd.y;
  const float t2 = q2 - dd.z;
  const float d2 = t0 * t0 + t1 * t1 + t2 * t2;
  return dd.w > 0.5f ? d2 : BIG;
}

__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ query, const float* __restrict__ data,
          const uint8_t* __restrict__ mask, int n, int m,
          float* __restrict__ dmin, int64_t* __restrict__ idx) {
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
    for (int k = threadIdx.x; k < cn; k += blockDim.x)
      s_d[k] = data_point(data, mask, c0 + k);
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < cn; ++k) {
      const float d2 = pair_d2(q0, q1, q2, s_d[k]);
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

// Grid (query blocks, S), cluster (1, S). CTA rank r scans data points
// [r * per, min(m, (r + 1) * per)); thread t holds queries t, t + 128, ...
// of the block (SPLIT_R of them).
__global__ void __launch_bounds__(SPLIT_THREADS)
nn_split_kernel(const float* __restrict__ query,
                const float* __restrict__ data,
                const uint8_t* __restrict__ mask, int n, int m, int per,
                float* __restrict__ dmin, int64_t* __restrict__ idx) {
  __shared__ float4 s_d[SPLIT_CAP];
  __shared__ float s_best[SPLIT_QB];
  __shared__ int s_idx[SPLIT_QB];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slices = (int)cluster.num_blocks();
  const size_t b = blockIdx.z;  // the crop
  query += b * n * 3;
  data += b * m * 3;
  if (mask != nullptr) mask += b * m;
  dmin += b * n;
  idx += b * n;
  const int q_base = blockIdx.x * SPLIT_QB;
  const int lo = min(m, rank * per), hi = min(m, lo + per);
  float q[SPLIT_R][3], best[SPLIT_R];
  int best_i[SPLIT_R];
#pragma unroll
  for (int r = 0; r < SPLIT_R; ++r) {
    const int i = q_base + threadIdx.x + r * SPLIT_THREADS;
#pragma unroll
    for (int c = 0; c < 3; ++c) q[r][c] = i < n ? query[(size_t)i * 3 + c] : 0.f;
    best[r] = INFINITY;
    best_i[r] = 0;
  }
  for (int c0 = lo; c0 < hi; c0 += SPLIT_CAP) {
    const int cn = min(SPLIT_CAP, hi - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn; k += SPLIT_THREADS)
      s_d[k] = data_point(data, mask, c0 + k);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < cn; ++k) {
      const float4 dd = s_d[k];
#pragma unroll
      for (int r = 0; r < SPLIT_R; ++r) {
        const float d2 = pair_d2(q[r][0], q[r][1], q[r][2], dd);
        if (d2 < best[r]) {
          best[r] = d2;
          best_i[r] = c0 + k;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SPLIT_R; ++r) {
    s_best[threadIdx.x + r * SPLIT_THREADS] = best[r];
    s_idx[threadIdx.x + r * SPLIT_THREADS] = best_i[r];
  }
  cluster.sync();
  // rank r merges its share of the block's queries over the ranks in order
  const int share = (SPLIT_QB + slices - 1) / slices;
  const int j_end = min(SPLIT_QB, min((rank + 1) * share, n - q_base));
  for (int j = rank * share + (int)threadIdx.x; j < j_end;
       j += SPLIT_THREADS) {
    float b = *cluster.map_shared_rank(s_best + j, 0);
    int bi = *cluster.map_shared_rank(s_idx + j, 0);
    for (int s = 1; s < slices; ++s) {
      const float v = *cluster.map_shared_rank(s_best + j, s);
      if (v < b) {
        b = v;
        bi = *cluster.map_shared_rank(s_idx + j, s);
      }
    }
    dmin[q_base + j] = b;
    idx[q_base + j] = bi;
  }
  cluster.sync();  // no CTA leaves while a peer may still read it
}

// Slices S of the split design for n queries against m data points: enough
// CTAs for SPLIT_CTAS_PER_SM on every SM, at most SPLIT_RULE_MAX, slices of
// at least SPLIT_MIN_PTS points; 1 when the query blocks alone fill the
// card.
int split_slices(int n, int m) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = max((n + SPLIT_QB - 1) / SPLIT_QB, 1);
  int s = (sms * SPLIT_CTAS_PER_SM + blocks - 1) / blocks;
  s = min(s, SPLIT_RULE_MAX);
  s = min(s, (m + SPLIT_MIN_PTS - 1) / SPLIT_MIN_PTS);
  return max(s, 1);
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Data slices (CTAs per cluster) of nn_fwd for n queries, m data points.
int nn_slices(int n, int m) { return split_slices(n, m); }

// query (batch, n, 3) f32, data (batch, m, 3) f32, mask (batch, m) bool or
// null -> dmin (batch, n) f32 squared distance, idx (batch, n) int64, each
// crop as its launch alone. `slices` > 0 forces the cluster size (1..8); 0
// takes split_slices(n, m). The split design.
int nn_fwd(const void* query, const void* data, const void* mask, int batch,
           int n, int m, int slices, void* dmin, void* idx, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (slices <= 0) slices = split_slices(n, m);
  if (slices > SPLIT_MAX || batch > 65535) return (int)cudaErrorInvalidValue;
  if (slices > 8) {  // past the portable cluster size
    const cudaError_t err = cudaFuncSetAttribute(
        nn_split_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + SPLIT_QB - 1) / SPLIT_QB, slices, batch);
  cfg.blockDim = dim3(SPLIT_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, nn_split_kernel, (const float*)query, (const float*)data,
      (const uint8_t*)mask, n, m, (m + slices - 1) / slices, (float*)dmin,
      (int64_t*)idx);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// As nn_fwd, through the first design (nn_kernel).
int nn_first(const void* query, const void* data, const void* mask, int n,
             int m, void* dmin, void* idx, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  nn_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)data, (const uint8_t*)mask, n, m,
      (float*)dmin, (int64_t*)idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
