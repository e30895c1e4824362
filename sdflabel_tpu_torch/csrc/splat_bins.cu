// Row bins of the binned surfel splat, built on the card in two launches.
//
// The port's own kernel: the JAX package computes the bins in XLA
// (sdflabel_tpu/ops/splat_pallas.py::_compute_bins) before its binned
// kernels, and the first port did the same with ~35 torch operators, a
// stable argsort, two searchsorted and the gathers
// (ops/splat_cuda.py::compute_bins). Same result, at point granularity
// (chunk = 1):
//
//   per row block b of bin_px rays: m_b, M_b = min, max of gy; gz_lo,
//   gz_hi = min, max of gz (the last block padded by the last ray, which
//   changes no bound);
//   per point i and block b: ov = compute_bins' overlap test, in its fp32
//   operations and order (IEEE divisions; the library is built with
//   -fmad=false, so nothing is contracted);
//   first, last, any; key = first (nb for a point that touches nothing),
//   span = last - first (0 for none), smax = max span;
//   order = the stable sort of key; windows [prefix[max(b - smax, 0)],
//   prefix[b + 1]) with prefix[k] = #points of key < k.
//
// The stable sort is a counting sort over the nb + 1 keys: each tile of
// BINS_PTS points counts its keys, and point i of tile t with key k goes
// to prefix[k] + (points of key k in tiles before t) + (points of key k
// before i in its tile). That is torch.argsort(key, stable=True)'s and
// JAX's stable jnp.argsort's permutation.
//
// Launch 1 (splat_bins_keys_kernel): one CTA of BINS_THREADS per tile,
// BINS_G threads per point on interleaved row blocks, clusters of
// BINS_CLUSTER CTAs. Each CTA of a cluster reduces the ray bounds of every
// BINS_CLUSTER-th row block, then all read all blocks' bounds through
// distributed shared memory: the rays are read once per cluster, not once
// per CTA. Each point's (first, last) is reduced over its BINS_G lanes by
// shuffles; the tile writes its keys, its key histogram and its widest
// span.
// Launch 2 (splat_bins_scatter_kernel): one CTA per tile. Each reads all
// tiles' histograms, takes the per-key totals and its own tile's offsets,
// scans the totals, ranks its points within their keys by position, and
// writes order, the sorted keys and the packed points and features in
// sorted order; CTA 0 writes smax and the windows. No atomics on global
// memory and nothing read back by the host: the same result every run.
//
// Crop axis (the batched driver; JAX bins each crop under vmap): B crops of
// n points and p rays each are one launch each way, crop b on grid row y =
// b with its own points, rays, keys, histograms, smax and windows. The
// clusters of launch 1 span x only, so the ray bounds they share are one
// crop's, and smax is each crop's own widest span, as
// jax.vmap(_compute_bins) computes it. An all-masked crop (a padded lane)
// keys every point nb: its windows are empty. Each crop's result is
// bit-equal to its launch alone (B = 1).
//
// Bound on the H100: bytes, ~0.8 MB at 4096 points onto 128x128 px (the
// points and features read and written once, the rays read once); the
// overlap tests are 6 IEEE divisions per (point, row block), 0.8 M
// special-function ops at nb = 32. Both launches are short: what bounds
// them is latency (the launches themselves, the ray reduction, the
// barriers), not the card's rates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BINS_PTS = 128;    // points per tile
constexpr int BINS_G = 8;        // threads per point, on interleaved blocks
constexpr int BINS_THREADS = BINS_PTS * BINS_G;
constexpr int BINS_CLUSTER = 8;  // CTAs that share one pass over the rays
constexpr int SCATTER_THREADS = 2 * BINS_PTS;
constexpr int MAX_SMEM = 227 * 1024;

// torch's minimum / maximum / clamp propagate NaN; fminf / fmaxf do not
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_lo(float a, float lo) {
  return a != a ? a : fmaxf(a, lo);
}

int tiles_of(int n) {
  const int t = (max(n, 1) + BINS_PTS - 1) / BINS_PTS;
  return (t + BINS_CLUSTER - 1) / BINS_CLUSTER * BINS_CLUSTER;
}

size_t keys_smem(int nb) {
  return (size_t)nb * sizeof(float4) + (size_t)(nb + 1) * sizeof(int);
}

size_t scatter_smem(int nb) {
  return (size_t)(3 * (nb + 2)) * sizeof(int);
}

// kg (p, 4) rays [gx, gy, gz, 0]; pts (n, 8) [v, n, mask, 0]. Writes
// key (n,) unsorted, hist (tiles, nb + 1) and tile_span (tiles,); crop y
// at its own offsets of each.
__global__ void __launch_bounds__(BINS_THREADS)
splat_bins_keys_kernel(const float* __restrict__ pts,
                       const float* __restrict__ kg, int n, int p, int nb,
                       int bin_px, float diam, int* __restrict__ key,
                       int* __restrict__ hist, int* __restrict__ tile_span) {
  extern __shared__ float4 s_bound[];  // nb x (m_b, M_b, gz_lo, gz_hi)
  int* s_hist = reinterpret_cast<int*>(s_bound + nb);  // nb + 1
  __shared__ int s_span;
  const size_t crop = blockIdx.y, tiles = gridDim.x;
  pts += crop * n * 8;
  kg += crop * p * 4;
  key += crop * n;
  hist += crop * tiles * (nb + 1);
  tile_span += crop * tiles;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = BINS_THREADS / 32;

  // this CTA's share of the row blocks' ray bounds: one warp a block
  for (int b = rank + BINS_CLUSTER * warp; b < nb;
       b += BINS_CLUSTER * warps) {
    const int q0 = b * bin_px, q1 = min(q0 + bin_px, p);
    float ylo = INFINITY, yhi = -INFINITY, zlo = INFINITY, zhi = -INFINITY;
    for (int q = q0 + lane; q < q1; q += 32) {
      const float4 r = reinterpret_cast<const float4*>(kg)[q];
      ylo = min_nan(ylo, r.y);
      yhi = max_nan(yhi, r.y);
      zlo = min_nan(zlo, r.z);
      zhi = max_nan(zhi, r.z);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ylo = min_nan(ylo, __shfl_xor_sync(0xffffffffu, ylo, o));
      yhi = max_nan(yhi, __shfl_xor_sync(0xffffffffu, yhi, o));
      zlo = min_nan(zlo, __shfl_xor_sync(0xffffffffu, zlo, o));
      zhi = max_nan(zhi, __shfl_xor_sync(0xffffffffu, zhi, o));
    }
    if (lane == 0) s_bound[b] = make_float4(ylo, yhi, zlo, zhi);
  }
  for (int k = threadIdx.x; k <= nb; k += BINS_THREADS) s_hist[k] = 0;
  if (threadIdx.x == 0) s_span = 0;
  cluster.sync();
  // the other ranks' blocks, read from their shared memory
  for (int b = threadIdx.x; b < nb; b += BINS_THREADS)
    if (b % BINS_CLUSTER != rank)
      s_bound[b] = *cluster.map_shared_rank(s_bound + b, b % BINS_CLUSTER);
  cluster.sync();  // all bounds here, and no CTA leaves while read

  // each point's first and last overlapping block over its BINS_G lanes
  const int pt = threadIdx.x / BINS_G, g = threadIdx.x % BINS_G;
  const int i = blockIdx.x * BINS_PTS + pt;
  int first = nb, last = -1;
  if (i < n) {
    const float v_y = pts[(size_t)i * 8 + 1], v_z = pts[(size_t)i * 8 + 2];
    const float zlo = v_z - diam, zhi = v_z + diam;
    const float ylo = v_y - diam, yhi = v_y + diam;
    const float safe_zlo = clamp_lo(zlo, 1e-12f);
    const bool masked_in = pts[(size_t)i * 8 + 6] > 0.5f;
    const bool depth_ok = zlo > 0.f;
    if (masked_in) {
      for (int b = g; b < nb; b += BINS_G) {
        bool ov = true;  // no usable depth bound: every block
        if (depth_ok) {
          const float4 r = s_bound[b];
          const float t_lo = safe_zlo / clamp_lo(r.w, 1e-12f);
          const float t_hi = zhi / clamp_lo(r.z, 1e-12f);
          const float gy_lo = min_nan(ylo / t_lo, ylo / t_hi);
          const float gy_hi = max_nan(yhi / t_lo, yhi / t_hi);
          ov = (gy_lo <= r.y && gy_hi >= r.x) || r.z <= 0.f;
        }
        if (ov) {
          first = min(first, b);
          last = max(last, b);
        }
      }
    }
  }
#pragma unroll
  for (int o = BINS_G / 2; o > 0; o >>= 1) {
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  if (g == 0 && i < n) {
    const bool any = last >= 0;
    const int k = any ? first : nb;
    key[i] = k;
    atomicAdd(&s_hist[k], 1);  // integer counts: any order, same sum
    if (any) atomicMax(&s_span, last - first);
  }
  __syncthreads();
  for (int k = threadIdx.x; k <= nb; k += BINS_THREADS)
    hist[(size_t)blockIdx.x * (nb + 1) + k] = s_hist[k];
  if (threadIdx.x == 0) tile_span[blockIdx.x] = s_span;
}

// Exclusive scan of s[0, len) in place, len + 1 entries written (s[len] =
// the total), by SCATTER_THREADS threads: contiguous chunks a thread, the
// chunk sums scanned in thread order.
__device__ void block_exclusive_scan(int* s, int len, int* s_warp) {
  const int per = (len + SCATTER_THREADS - 1) / SCATTER_THREADS;
  const int lo = min(len, (int)threadIdx.x * per), hi = min(len, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += s[k];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  int run = base + incl - sum;
  __syncthreads();
  for (int k = lo; k < hi; ++k) {
    const int v = s[k];
    s[k] = run;
    run += v;
  }
  if ((int)threadIdx.x == SCATTER_THREADS - 1) s[len] = run;
  __syncthreads();
}

__global__ void __launch_bounds__(SCATTER_THREADS)
splat_bins_scatter_kernel(const float* __restrict__ pts,
                          const float* __restrict__ feats,
                          const int* __restrict__ key,
                          const int* __restrict__ hist,
                          const int* __restrict__ tile_span, int n, int nb,
                          int tiles, int* __restrict__ order,
                          int* __restrict__ key_sorted,
                          int* __restrict__ smax_out, int* __restrict__ win,
                          float* __restrict__ pts_sorted,
                          float* __restrict__ feats_sorted) {
  extern __shared__ int s_int[];
  int* s_pref = s_int;              // nb + 2: totals, then their scan
  int* s_col = s_pref + (nb + 2);   // nb + 1: this tile's offsets
  __shared__ int s_key[BINS_PTS];
  __shared__ int s_warp[SCATTER_THREADS / 32];
  __shared__ int s_smax;
  const int t = blockIdx.x, nk = nb + 1;
  const size_t crop = blockIdx.y;
  pts += crop * n * 8;
  feats += crop * n * 8;
  key += crop * n;
  hist += crop * tiles * nk;
  tile_span += crop * tiles;
  order += crop * n;
  key_sorted += crop * n;
  smax_out += crop;
  win += crop * nb * 2;
  pts_sorted += crop * n * 8;
  feats_sorted += crop * n * 8;

  // per key: the total over all tiles, and the count in tiles before t
  for (int k = threadIdx.x; k < nk; k += SCATTER_THREADS) {
    int tot = 0, col = 0;
#pragma unroll 4
    for (int u = 0; u < tiles; ++u) {
      const int h = hist[(size_t)u * nk + k];
      tot += h;
      col += u < t ? h : 0;
    }
    s_pref[k] = tot;
    s_col[k] = col;
  }
  if (threadIdx.x == 0) s_smax = 0;
  const int j = threadIdx.x % BINS_PTS;
  const int i = t * BINS_PTS + j;
  if (threadIdx.x < BINS_PTS) s_key[j] = i < n ? key[i] : -1;
  __syncthreads();
  int span = 0;
  for (int u = threadIdx.x; u < tiles; u += SCATTER_THREADS)
    span = max(span, tile_span[u]);
  if (span > 0) atomicMax(&s_smax, span);
  block_exclusive_scan(s_pref, nk, s_warp);  // s_pref[k] = #keys < k
  const int smax = s_smax;

  if (t == 0) {
    if (threadIdx.x == 0) smax_out[0] = smax;
    for (int b = threadIdx.x; b < nb; b += SCATTER_THREADS) {
      win[2 * b] = s_pref[max(b - smax, 0)];
      win[2 * b + 1] = s_pref[b + 1];
    }
  }
  if (i >= n) return;
  const int k = s_key[j];
  int rank = 0;  // points of key k before this one in the tile
  for (int u = 0; u < j; ++u) rank += s_key[u] == k;
  const int pos = s_pref[k] + s_col[k] + rank;
  if (threadIdx.x < BINS_PTS) {
    order[pos] = i;
    key_sorted[pos] = k;
    const float4* src = reinterpret_cast<const float4*>(pts) + (size_t)i * 2;
    float4* dst = reinterpret_cast<float4*>(pts_sorted) + (size_t)pos * 2;
    dst[0] = src[0];
    dst[1] = src[1];
  } else {
    const float4* src =
        reinterpret_cast<const float4*>(feats) + (size_t)i * 2;
    float4* dst = reinterpret_cast<float4*>(feats_sorted) + (size_t)pos * 2;
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// int32 scratch splat_bins needs for n points and nb row blocks, a crop:
// the keys (n), the tiles' histograms and their widest spans.
int splat_bins_work(int n, int nb) {
  const int tiles = tiles_of(n);
  return n + tiles * (nb + 1) + tiles;
}

// pts (batch, n, 8) [v, n, mask, 0], feats (batch, n, 8), kg (batch, p,
// 4) [g, 0] float32 -> order, key_sorted (batch, n) int32, smax (batch,)
// int32, win (batch, nb, 2) int32 [start, end), pts_sorted, feats_sorted
// (batch, n, 8) float32; work: batch * splat_bins_work int32. Two launches
// for all crops; n may be 0.
int splat_bins(const void* pts, const void* feats, const void* kg, int batch,
               int n, int p, int bin_px, float diam, void* work, void* order,
               void* key_sorted, void* smax, void* win, void* pts_sorted,
               void* feats_sorted, void* stream) {
  if (p <= 0 || bin_px <= 0 || n < 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int nb = (p + bin_px - 1) / bin_px;
  const size_t smem1 = keys_smem(nb), smem2 = scatter_smem(nb);
  if (smem1 > (size_t)MAX_SMEM || smem2 > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      splat_bins_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(splat_bins_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const int tiles = tiles_of(n);
  int* key = (int*)work;  // (batch, n), then each crop's hist and spans
  int* hist = key + (size_t)batch * n;
  int* tile_span = hist + (size_t)batch * tiles * (nb + 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, batch);
  cfg.blockDim = dim3(BINS_THREADS);
  cfg.dynamicSmemBytes = smem1;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BINS_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, splat_bins_keys_kernel, (const float*)pts,
                           (const float*)kg, n, p, nb, bin_px, diam, key,
                           hist, tile_span);
  if (err != cudaSuccess) return (int)err;
  splat_bins_scatter_kernel<<<dim3(tiles, batch), SCATTER_THREADS, smem2,
                              (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, key, hist, tile_span, n, nb,
      tiles, (int*)order, (int*)key_sorted, (int*)smax, (int*)win,
      (float*)pts_sorted, (float*)feats_sorted);
  return (int)cudaGetLastError();
}

}  // extern "C"
