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
//
// Bound on the H100: bytes. The forward reads every logit once (218 MB
// for the (13, 256, 128, 128) towers, ~65 us at 3.35 TB/s) for ~5 flops
// and one exp each; the backward reads them twice and writes the gradient
// once. Design: one thread per pixel loops over the C classes. The class
// stride is H*W, so the 32 threads of a warp read 32 neighbouring floats
// of one class row per step. The forward keeps an online max and
// sum-exp in registers (one pass) and reduces the block's per-pixel terms
// in shared memory to one partial. The backward recomputes the online
// log-sum-exp, then a second pass writes the gradient. No TPU tiling
// contract (H % 8, W % 128) is needed: any B, C, H, W is taken.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int CE_THREADS = 256;

// online log-sum-exp over the C classes of one pixel; also picks x[t]
__device__ __forceinline__ float lse_and_pick(const float* __restrict__ xp,
                                              int c, size_t hw, int t,
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

__global__ void __launch_bounds__(CE_THREADS)
ce_fwd_kernel(const float* __restrict__ x, const int* __restrict__ t, int b,
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

__global__ void __launch_bounds__(CE_THREADS)
ce_bwd_kernel(const float* __restrict__ x, const int* __restrict__ t,
              const float* __restrict__ scale, int b, int c, int hw,
              float* __restrict__ dx) {
  const size_t idx = (size_t)blockIdx.x * CE_THREADS + threadIdx.x;
  if (idx >= (size_t)b * hw) return;
  const size_t bi = idx / hw, pi = idx % hw;
  const size_t off = bi * c * hw + pi;
  const int tk = t[idx];
  float picked;
  const float lse = lse_and_pick(x + off, c, hw, tk, picked);
  const float g = *scale;
  for (int k = 0; k < c; ++k) {
    const size_t o = off + (size_t)k * hw;
    const float p = expf(x[o] - lse);
    dx[o] = (p - (k == tk ? 1.f : 0.f)) * g;
  }
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (b, c, hw) float32, t (b, hw) int32 -> partial (ceil(b*hw / 256),)
// float32: the sum of the per-pixel terms of each block of 256 pixels.
int ce_fwd(const void* x, const void* t, int b, int c, int hw, void* partial,
           void* stream) {
  const size_t n = (size_t)b * hw;
  if (n == 0) return 0;
  const int blocks = (int)((n + CE_THREADS - 1) / CE_THREADS);
  ce_fwd_kernel<<<blocks, CE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)t, b, c, hw, (float*)partial);
  return (int)cudaGetLastError();
}

// x, t as ce_fwd; scale (1,) float32 = g / (b*hw) -> dx (b, c, hw).
int ce_bwd(const void* x, const void* t, const void* scale, int b, int c,
           int hw, void* dx, void* stream) {
  const size_t n = (size_t)b * hw;
  if (n == 0) return 0;
  const int blocks = (int)((n + CE_THREADS - 1) / CE_THREADS);
  ce_bwd_kernel<<<blocks, CE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)t, (const float*)scale, b, c, hw,
      (float*)dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
