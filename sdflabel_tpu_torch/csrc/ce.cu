// Fused mean cross-entropy with an internal log-softmax over NCHW logits,
// forward and backward.
//
// Replaces sdflabel_tpu/ops/ce_pallas.py::_block_call with its forward
// kernel _fwd_kernel (via _fwd_value) and backward kernel _bwd_kernel (via
// _bwd). For logits x (B, C, H, W) and targets t (B, H, W):
//
//   loss = sum_p (lse_p - x[t_p, p]) / (B H W),  lse_p = log sum_k e^x[k, p]
//   dx[k, p] = (softmax_k(x[:, p]) - [k == t_p]) * g / (B H W)
//
// The final sum of the per-block partials and the division by B H W stay
// outside the kernel, as jnp.sum(partial) / (b*h*w) does in JAX. A target
// outside [0, C) picks nothing, as the TPU kernel's one-hot compare does.
// Targets are read as int32 or int64, whichever the caller holds.
//
// Bound on the H100: bytes. At the train shape (13, 256, 128, 128) the
// logits are 218 MB: the forward reads them once (~65 us at 3.35 TB/s) for
// ~6 flops and one exp each, the backward reads them once and writes the
// gradient once (~130 us).
//
// Two designs of each direction; ops/ce_cuda.py launches the second ones.
//
// First designs (ce_fwd_kernel, ce_bwd_kernel), kept as yardsticks: one
// thread per pixel walks the C classes in order (a 4-byte load, a branch
// and an exp per class, so few loads are in flight). The backward
// recomputes the log-sum-exp and then reads every logit again: 2 reads
// and 1 write of the logits, whose floor (0.195 ms at the train shape)
// lies at 67% of the bound.
//
// ce_fwd_split_kernel: a CTA of 8 warps takes a tile of contiguous pixels
// of one image with all C classes. Each lane holds VEC = 4 neighbouring
// pixels (one float4), so a warp reads 128 pixels of one class row per
// load; the class axis splits over G warp groups (G = 8 for C >= 113,
// fewer for small C, where the tile grows in pixels instead: 8 / G pixel
// groups of 32 * VEC). A thread takes its classes in chunks of 16: sixteen
// loads issued before any arithmetic (with a 256-byte L2 prefetch hint),
// then the chunk's max, one rescale of the running sum and one exp per
// element, with no per-element branch. The thread holds its pixels'
// targets and keeps x[t_p] when class t_p passes (a compare and a
// select): a gather of x[t_p] by the merging thread after the pass was
// slower (scripts/ce_sweep.py). The groups' (max, sum) pairs merge through
// shared memory in group order, the picked logits too (one group's is
// nonzero); the merging thread writes lse_p and adds lse_p - x[t_p] over
// its pixels; a butterfly over each warp's lanes and the warps in order
// give the CTA's partial. Fixed orders and no atomics: two launches are
// bit-equal. VEC = 1 (one pixel a lane) where H*W % 4 != 0 or x or t is
// not 16-byte aligned. Bytes a call at the train shape: 218.1 MB read
// (logits) + 1.7 MB (int64 targets) + 0.85 MB (lse) written.
//
// ce_bwd_lse_kernel: one read of the logits and one write of dx. It takes
// the forward's lse (B*H*W floats, 0.85 MB at the train shape) in place of
// recomputing it: dx[k, p] = (exp(x[k, p] - lse_p) - [k == t_p]) * g / n.
// A thread holds VEC = 4 pixels (float4 loads and stores) of 8 classes:
// its lse and targets are loaded once, then eight independent row loads
// are in flight before any arithmetic. 6656 CTAs at the train shape. Bytes
// a call there: 218.1 MB read (logits) + 0.85 MB (lse) + 0.85 or 1.7 MB
// (int32 or int64 targets) + 218.1 MB written.
//
// No TPU tiling contract (H % 8, W % 128) is needed: any B, C >= 1, H, W
// is taken.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int CE_THREADS = 256;     // first designs: pixels per block
constexpr int SPLIT_WARPS = 8;      // forward: warps per CTA
constexpr int SPLIT_THREADS = SPLIT_WARPS * 32;
constexpr int CHUNK = 16;           // forward: class loads before arithmetic
constexpr int BWD_THREADS = 256;
constexpr int BWD_CLASSES = 8;      // backward: class rows a thread takes

// ------------------------------------------------------ first designs

// online log-sum-exp over the C classes of one pixel; also picks x[t]
template <typename T>
__device__ __forceinline__ float lse_and_pick(const float* __restrict__ xp,
                                              int c, size_t hw, T t,
                                              float& picked) {
  float m = -INFINITY, s = 0.f;
  picked = 0.f;
  for (int k = 0; k < c; ++k) {
    const float v = xp[(size_t)k * hw];
    if (k == t) picked = v;
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  return m + logf(s);
}

template <typename T>
__global__ void __launch_bounds__(CE_THREADS)
ce_fwd_kernel(const float* __restrict__ x, const T* __restrict__ t, int b,
              int c, int hw, float* __restrict__ partial) {
  __shared__ float s_sum[CE_THREADS];
  const size_t idx = (size_t)blockIdx.x * CE_THREADS + threadIdx.x;
  float term = 0.f;
  if (idx < (size_t)b * hw) {
    const size_t bi = idx / hw, pi = idx % hw;
    float picked;
    const float lse = lse_and_pick(x + bi * c * hw + pi, c, hw, t[idx],
                                   picked);
    term = lse - picked;
  }
  s_sum[threadIdx.x] = term;
  __syncthreads();
  for (int w = CE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s_sum[threadIdx.x] += s_sum[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = s_sum[0];
}

template <typename T>
__global__ void __launch_bounds__(CE_THREADS)
ce_bwd_kernel(const float* __restrict__ x, const T* __restrict__ t,
              const float* __restrict__ g, int n, int b, int c, int hw,
              float* __restrict__ dx) {
  const size_t idx = (size_t)blockIdx.x * CE_THREADS + threadIdx.x;
  if (idx >= (size_t)b * hw) return;
  const size_t bi = idx / hw, pi = idx % hw;
  const size_t off = bi * c * hw + pi;
  const T tk = t[idx];
  float picked;
  const float lse = lse_and_pick(x + off, c, hw, tk, picked);
  const float scale = *g / (float)n;
  for (int k = 0; k < c; ++k) {
    const size_t o = off + (size_t)k * hw;
    const float p = expf(x[o] - lse);
    dx[o] = (p - (k == tk ? 1.f : 0.f)) * scale;
  }
}

// ------------------------------------------------------ Hopper designs

// VEC neighbouring floats of one row, as one load
__device__ __forceinline__ void load_px(const float* __restrict__ p,
                                        float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_px(const float* __restrict__ p,
                                        float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void store_px(float* __restrict__ p,
                                         const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_px(float* __restrict__ p,
                                         const float (&v)[1]) {
  *p = v[0];
}

// the same with a 256-byte L2 prefetch of the line's neighbours, for the
// forward's class rows (3% faster there, 3% slower in the backward:
// scripts/ce_sweep.py)
__device__ __forceinline__ void load_px_l2(const float* __restrict__ p,
                                           float (&v)[4]) {
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
      : "l"(p));
}
__device__ __forceinline__ void load_px_l2(const float* __restrict__ p,
                                           float (&v)[1]) {
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];"
               : "=f"(v[0])
               : "l"(p));
}

// VEC targets as class indices, -1 for one outside [0, c)
template <typename T, int VEC>
__device__ __forceinline__ void load_targets(const T* __restrict__ t, int c,
                                             int (&k)[VEC]) {
  long long v[VEC];
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(t));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VEC == 4) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(t));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(t) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = (long long)__ldg(t);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    k[j] = (v[j] >= 0 && v[j] < c) ? (int)v[j] : -1;
}

// e^(v - base) for the running max nm's base: an all -inf max takes base
// 0, so that every term is 0 rather than NaN
__device__ __forceinline__ float safe_base(float nm) {
  return nm == -INFINITY ? 0.f : nm;
}

// One chunk of CHUNK classes [k, k + CHUNK) of a lane's VEC pixels into
// their running (max, sum of e^(x - max), picked logit): the loads first,
// then per pixel the chunk's max, one rescale of the sum and one exp a
// class. TAIL: the chunk ends at k1 (loads past it give -inf, and their
// exps, which would add 0, are skipped).
template <int VEC, bool TAIL>
__device__ __forceinline__ void absorb_chunk(const float* __restrict__ xb,
                                             int hw, int k, int k1,
                                             const int (&tk)[VEC],
                                             float (&m)[VEC], float (&s)[VEC],
                                             float (&pk)[VEC]) {
  float v[CHUNK][VEC];
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    if (!TAIL || k + i < k1) {
      load_px_l2(xb + (size_t)(k + i) * hw, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = -INFINITY;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float cm = v[0][j];
#pragma unroll
    for (int i = 1; i < CHUNK; ++i) cm = fmaxf(cm, v[i][j]);
    const float nm = fmaxf(m[j], cm);
    const float base = safe_base(nm);
    float acc = s[j] * expf(m[j] - base);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (TAIL && k + i >= k1) break;
      acc += expf(v[i][j] - base);
      if (k + i == tk[j]) pk[j] = v[i][j];
    }
    s[j] = acc;
    m[j] = nm;
  }
}

// G class groups of warps, 8 / G pixel groups; a warp covers 32 * VEC
// pixels of one class row, a group cpg classes (a multiple of CHUNK).
// Block blockIdx.x = image * tiles + tile.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(SPLIT_THREADS)
ce_fwd_split_kernel(const float* __restrict__ x, const T* __restrict__ t,
                    int c, int hw, int tiles, int cpg,
                    float* __restrict__ lse, float* __restrict__ partial) {
  constexpr int Q = SPLIT_WARPS / G;
  constexpr int TP = Q * 32 * VEC;  // pixels of a tile
  constexpr int NPT = (TP + SPLIT_THREADS - 1) / SPLIT_THREADS;
  __shared__ float s_m[G][TP], s_s[G][TP], s_p[G][TP];
  __shared__ float s_red[SPLIT_WARPS];

  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * TP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp % G, q = warp / G;
  const int px = q * 32 * VEC + lane * VEC;  // this lane's first pixel
  const int k0 = grp * cpg, k1 = min(c, k0 + cpg);
  const float* xb = x + (size_t)b * c * hw + p0 + px;

  // running max, sum of e^(x - max) and the picked logit of each pixel
  float m[VEC], s[VEC], pk[VEC];
  int tk[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = -INFINITY;
    s[j] = pk[j] = 0.f;
  }
  // VEC == 4 only with hw % 4 == 0: a lane's pixels are all in or all out
  if (p0 + px < hw) {
    load_targets<T, VEC>(t + (size_t)b * hw + p0 + px, c, tk);
    int k = k0;
    for (; k + CHUNK <= k1; k += CHUNK)
      absorb_chunk<VEC, false>(xb, hw, k, k1, tk, m, s, pk);
    if (k < k1) absorb_chunk<VEC, true>(xb, hw, k, k1, tk, m, s, pk);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s_m[grp][px + j] = m[j];
    s_s[grp][px + j] = s[j];
    s_p[grp][px + j] = pk[j];
  }
  __syncthreads();

  // thread i merges the tile's pixels i, i + 256, ...: the groups' (max,
  // sum) pairs in group order; the picked logit is one group's (the
  // others hold 0), or 0 for a target outside [0, c)
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < NPT; ++u) {
    const int i = threadIdx.x + u * SPLIT_THREADS;
    if (i < TP && p0 + i < hw) {
      float mm = s_m[0][i], ss = s_s[0][i], pick = s_p[0][i];
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        const float mg = s_m[gg][i];
        const float nm = fmaxf(mm, mg);
        const float base = safe_base(nm);
        ss = ss * expf(mm - base) + s_s[gg][i] * expf(mg - base);
        mm = nm;
        pick += s_p[gg][i];
      }
      const float l = mm + logf(ss);
      lse[(size_t)b * hw + p0 + i] = l;
      acc += l - pick;
    }
  }
  // the CTA's partial: a butterfly over each warp's lanes, then the warps
  // in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) s_red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = s_red[0];
#pragma unroll
    for (int w = 1; w < SPLIT_WARPS; ++w) sum += s_red[w];
    partial[blockIdx.x] = sum;
  }
}

// Block blockIdx.x = (image * kblocks + class block) * pblocks + pixel
// block; a thread takes VEC pixels of BWD_CLASSES class rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(BWD_THREADS)
ce_bwd_lse_kernel(const float* __restrict__ x, const T* __restrict__ t,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  int n, int c, int hw, int kblocks, int pblocks,
                  float* __restrict__ dx) {
  const int pb = blockIdx.x % pblocks;
  const int kb = (blockIdx.x / pblocks) % kblocks;
  const int b = blockIdx.x / (pblocks * kblocks);
  const int p = (pb * BWD_THREADS + threadIdx.x) * VEC;
  if (p >= hw) return;  // VEC == 4 only with hw % 4 == 0
  const int k0 = kb * BWD_CLASSES;
  const size_t pix = (size_t)b * hw + p;
  float l[VEC];
  int tk[VEC];
  load_px(lse + pix, l);
  load_targets<T, VEC>(t + pix, c, tk);
  const size_t row0 = ((size_t)b * c + k0) * hw + p;
  float v[BWD_CLASSES][VEC];
#pragma unroll
  for (int i = 0; i < BWD_CLASSES; ++i)
    if (k0 + i < c) load_px(x + row0 + (size_t)i * hw, v[i]);
  const float scale = __ldg(g) / (float)n;
#pragma unroll
  for (int i = 0; i < BWD_CLASSES; ++i) {
    if (k0 + i < c) {
      float d[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        d[j] = (expf(v[i][j] - l[j]) - (k0 + i == tk[j] ? 1.f : 0.f)) *
               scale;
      store_px(dx + row0 + (size_t)i * hw, d);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int VEC, int G>
int fwd_split_launch(const void* x, const void* t, int b, int c, int hw,
                     int cpg, void* lse, void* partial, cudaStream_t stream) {
  if constexpr (G > SPLIT_WARPS) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int TP = SPLIT_WARPS / G * 32 * VEC;
    const int tiles = (hw + TP - 1) / TP;
    ce_fwd_split_kernel<T, VEC, G>
        <<<(unsigned)b * tiles, SPLIT_THREADS, 0, stream>>>(
            (const float*)x, (const T*)t, c, hw, tiles, cpg, (float*)lse,
            (float*)partial);
    return (int)cudaGetLastError();
  }
}

template <typename T, int VEC>
int fwd_split_launch(const void* x, const void* t, int b, int c, int hw,
                     int groups, int cpg, void* lse, void* partial,
                     cudaStream_t stream) {
  switch (groups) {
    case 1:
      return fwd_split_launch<T, VEC, 1>(x, t, b, c, hw, cpg, lse, partial,
                                         stream);
    case 2:
      return fwd_split_launch<T, VEC, 2>(x, t, b, c, hw, cpg, lse, partial,
                                         stream);
    case 4:
      return fwd_split_launch<T, VEC, 4>(x, t, b, c, hw, cpg, lse, partial,
                                         stream);
    case 8:
      return fwd_split_launch<T, VEC, 8>(x, t, b, c, hw, cpg, lse, partial,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
int bwd_lse_launch(const void* x, const void* t, const void* lse,
                   const void* g, int n, int b, int c, int hw, void* dx,
                   cudaStream_t stream) {
  const int kblocks = (c + BWD_CLASSES - 1) / BWD_CLASSES;
  const int pblocks = (hw + BWD_THREADS * VEC - 1) / (BWD_THREADS * VEC);
  const dim3 grid((unsigned)b * kblocks * pblocks);
  ce_bwd_lse_kernel<T, VEC><<<grid, BWD_THREADS, 0, stream>>>(
      (const float*)x, (const T*)t, (const float*)lse, (const float*)g, n,
      c, hw, kblocks, pblocks, (float*)dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every launcher: x (b, c, hw) float32; t (b, hw) int32 (t_bytes 4) or
// int64 (t_bytes 8).

// First design -> partial (ceil(b*hw / 256),) float32: the sum of the
// per-pixel terms of each block of 256 pixels.
int ce_fwd(const void* x, const void* t, int t_bytes, int b, int c, int hw,
           void* partial, void* stream) {
  const size_t n = (size_t)b * hw;
  if (n == 0) return 0;
  const int blocks = (int)((n + CE_THREADS - 1) / CE_THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (t_bytes == 4)
    ce_fwd_kernel<int><<<blocks, CE_THREADS, 0, st>>>(
        (const float*)x, (const int*)t, b, c, hw, (float*)partial);
  else if (t_bytes == 8)
    ce_fwd_kernel<long long><<<blocks, CE_THREADS, 0, st>>>(
        (const float*)x, (const long long*)t, b, c, hw, (float*)partial);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// First design; g (1,) float32 the upstream cotangent, n = b*hw the mean's
// count -> dx (b, c, hw).
int ce_bwd(const void* x, const void* t, int t_bytes, const void* g, int n,
           int b, int c, int hw, void* dx, void* stream) {
  const size_t np = (size_t)b * hw;
  if (np == 0) return 0;
  const int blocks = (int)((np + CE_THREADS - 1) / CE_THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (t_bytes == 4)
    ce_bwd_kernel<int><<<blocks, CE_THREADS, 0, st>>>(
        (const float*)x, (const int*)t, (const float*)g, n, b, c, hw,
        (float*)dx);
  else if (t_bytes == 8)
    ce_bwd_kernel<long long><<<blocks, CE_THREADS, 0, st>>>(
        (const float*)x, (const long long*)t, (const float*)g, n, b, c, hw,
        (float*)dx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Class-split forward with the plan ops/ce_cuda.py::fwd_plan chose:
// `groups` warp groups over the classes (1, 2, 4 or 8) of `cpg` classes
// each, `vec` pixels a lane (4 needs hw % 4 == 0 and x and t 16-byte
// aligned).
// -> lse (b, hw) float32 and partial (b * tiles,) float32, tiles =
// ceil(hw / (32 * vec * 8 / groups)).
int ce_fwd_split(const void* x, const void* t, int t_bytes, int b, int c,
                 int hw, int groups, int cpg, int vec, void* lse,
                 void* partial, void* stream) {
  if ((size_t)b * hw == 0) return 0;
  if (cpg < 1 || cpg % CHUNK != 0 ||
      (vec == 4 && (hw % 4 || !aligned16(x) || !aligned16(t))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (t_bytes == 4 && vec == 4)
    return fwd_split_launch<int, 4>(x, t, b, c, hw, groups, cpg, lse,
                                    partial, st);
  if (t_bytes == 4 && vec == 1)
    return fwd_split_launch<int, 1>(x, t, b, c, hw, groups, cpg, lse,
                                    partial, st);
  if (t_bytes == 8 && vec == 4)
    return fwd_split_launch<long long, 4>(x, t, b, c, hw, groups, cpg, lse,
                                          partial, st);
  if (t_bytes == 8 && vec == 1)
    return fwd_split_launch<long long, 1>(x, t, b, c, hw, groups, cpg, lse,
                                          partial, st);
  return (int)cudaErrorInvalidValue;
}

// Backward from the saved lse (b, hw) float32; g (1,) float32 the upstream
// cotangent, n = b*hw the mean's count; `vec` 4 needs hw % 4 == 0 and x,
// t, lse and dx 16-byte aligned -> dx (b, c, hw).
int ce_bwd_lse(const void* x, const void* t, int t_bytes, const void* lse,
               const void* g, int n, int b, int c, int hw, int vec, void* dx,
               void* stream) {
  if ((size_t)b * hw * c == 0) return 0;
  if (vec == 4 && (hw % 4 || !aligned16(x) || !aligned16(t) ||
                   !aligned16(lse) || !aligned16(dx)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (t_bytes == 4 && vec == 4)
    return bwd_lse_launch<int, 4>(x, t, lse, g, n, b, c, hw, dx, st);
  if (t_bytes == 4 && vec == 1)
    return bwd_lse_launch<int, 1>(x, t, lse, g, n, b, c, hw, dx, st);
  if (t_bytes == 8 && vec == 4)
    return bwd_lse_launch<long long, 4>(x, t, lse, g, n, b, c, hw, dx, st);
  if (t_bytes == 8 && vec == 1)
    return bwd_lse_launch<long long, 1>(x, t, lse, g, n, b, c, hw, dx, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
