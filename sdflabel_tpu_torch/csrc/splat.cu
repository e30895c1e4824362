// Fused surfel splat + depth-softmax composite, forward and backward.
//
// Replaces sdflabel_tpu/ops/splat_pallas.py::_fwd_call (dense branch:
// _znorm_kernel, _softmax_kernel) and ::_core_bwd (dense branch:
// _grads_kernel). Computes, without ever building the (N, P) matrices,
//
//   img[p, :] = sum_i prob[i, p] * feats[i, :]
//   prob[:, p] = softmax_i(masked scores) * footprint     (per pixel p)
//
// i.e. ops/splat.py::splat_surfel(softclamp=False, add_bg=False) followed
// by prob.T @ feats. The per-pair arithmetic is the TPU kernel's, operation
// for operation (built with -fmad=false, so nothing is contracted to fma):
// the sqrt-free footprint dist^2 = vv - 2 vk z + gg z^2 < diam^2 with
// mask > 0.5, the guard |n.g| < 0.01 -> nk = FLT_EPSILON, NEG_BIG = -1e30,
// 1 / (zn + eps), and in the backward no gradient at all through a guarded
// pair. The dense plain version uses the explicit ||v - g z||, so a
// footprint bit can flip at the disc boundary between the two.
//
// Bound on the H100: fp32 operations. Every (point, pixel) pair costs
// ~25 flops of ray-plane geometry in each of the two forward passes and
// ~45 in the backward; bytes are ~0.6 MB per call. Design: the TPU
// kernels' sequential chunk axis carried in VMEM scratch becomes a loop
// inside the thread over point chunks staged in shared memory.
//   forward : one thread per pixel; pass 1 reduces the z-norm, pass 2 runs
//             the online softmax with the running max, denominator and 8
//             feature accumulators in registers.
//   backward: point-major, one thread per point looping over pixel chunks
//             staged in shared memory; no atomics, so it is deterministic.
// At <= 1536 pixels the forward fills only P / 64 blocks of the 132 SMs;
// splitting points across blocks (and merging the softmax partials) is the
// first thing to change for speed.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr float NK_EPS_THRESHOLD = 0.01f;  // primitives.py:213 guard
constexpr float NEG_BIG = -1e30f;
constexpr int NF = 8;            // [color(3) | mask | depth | normal(3)]
constexpr int FWD_THREADS = 64;  // pixels per block
constexpr int FWD_CHUNK = 256;   // points per shared-memory chunk
constexpr int BWD_THREADS = 128; // points per block
constexpr int BWD_CHUNK = 128;   // pixels per shared-memory chunk
constexpr int PIX_W = 16;        // packed pixel row, see splat_bwd_kernel

// Ray-plane geometry of point q = [v(3), n(3), mask, pad] against pixel ray
// g with gg = g.g (splat_pallas.py::_geometry). Returns the footprint bit;
// z, nk and guard feed the backward.
__device__ __forceinline__ bool geometry(const float* q, float gx, float gy,
                                         float gz, float gg, float diam2,
                                         float& z, float& nk, bool& guard) {
  const float nv = q[3] * q[0] + q[4] * q[1] + q[5] * q[2];
  const float vv = q[0] * q[0] + q[1] * q[1] + q[2] * q[2];
  const float nk_raw = q[3] * gx + q[4] * gy + q[5] * gz;
  guard = fabsf(nk_raw) < NK_EPS_THRESHOLD;
  nk = guard ? FLT_EPSILON : nk_raw;
  z = nv / nk;
  const float vk = q[0] * gx + q[1] * gy + q[2] * gz;
  const float dist_sq = vv - 2.0f * vk * z + gg * z * z;
  return dist_sq < diam2 && q[6] > 0.5f;
}

// kg rows (P, 4): [gx, gy, gz, gg].
__global__ void __launch_bounds__(FWD_THREADS)
splat_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                 const float* __restrict__ kg, int n, int p, float diam2,
                 float dc, float* __restrict__ img, float* __restrict__ m_out,
                 float* __restrict__ d_out, float* __restrict__ zn_out) {
  __shared__ float s_pts[FWD_CHUNK * 8];
  __shared__ float s_feat[FWD_CHUNK * NF];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pix < p;
  float gx = 0.f, gy = 0.f, gz = 0.f, gg = 0.f;
  if (active) {
    gx = kg[pix * 4 + 0];
    gy = kg[pix * 4 + 1];
    gz = kg[pix * 4 + 2];
    gg = kg[pix * 4 + 3];
  }
  float z, nk;
  bool guard;

  // pass 1: per-pixel norm of the footprint depths (primitives.py:229-231)
  float ssq = 0.f;
  for (int c0 = 0; c0 < n; c0 += FWD_CHUNK) {
    const int cn = min(FWD_CHUNK, n - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 8; i += blockDim.x)
      s_pts[i] = pts[(size_t)c0 * 8 + i];
    __syncthreads();
    if (active) {
      for (int i = 0; i < cn; ++i) {
        if (geometry(&s_pts[i * 8], gx, gy, gz, gg, diam2, z, nk, guard))
          ssq += z * z;
      }
    }
  }
  const float zn = sqrtf(ssq);
  const float inv_zn = 1.f / (zn + FLT_EPSILON);

  // pass 2: online softmax over footprint points + feature composite
  float m = NEG_BIG, d = 0.f;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  for (int c0 = 0; c0 < n; c0 += FWD_CHUNK) {
    const int cn = min(FWD_CHUNK, n - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 8; i += blockDim.x) {
      s_pts[i] = pts[(size_t)c0 * 8 + i];
      s_feat[i] = feats[(size_t)c0 * NF + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < cn; ++i) {
      if (!geometry(&s_pts[i * 8], gx, gy, gz, gg, diam2, z, nk, guard))
        continue;
      const float s = fmaxf(-z * inv_zn + 1.f, 0.f) * dc;
      const float* fi = &s_feat[i * NF];
      if (s > m) {
        const float scale = expf(m - s);
        d = d * scale + 1.f;
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] = acc[f] * scale + fi[f];
        m = s;
      } else {
        const float w = expf(s - m);
        d += w;
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] += w * fi[f];
      }
    }
  }
  if (active) {
    const float inv_d = d > 0.f ? 1.f / fmaxf(d, 1e-30f) : 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) img[(size_t)pix * NF + f] = acc[f] * inv_d;
    m_out[pix] = m;
    d_out[pix] = d;
    zn_out[pix] = zn;
  }
}

// pix rows (P, 16): [gx, gy, gz, gg, m, d, zn, corr, g_img(8)], where
// corr = g_img . img is the softmax correction sum_i prob_ip (g_p . f_i).
__global__ void __launch_bounds__(BWD_THREADS)
splat_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                 const float* __restrict__ pix, int n, int p, float diam2,
                 float dc, float* __restrict__ dv, float* __restrict__ dn,
                 float* __restrict__ df) {
  __shared__ float s_pix[BWD_CHUNK * PIX_W];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  float q[8], fi[NF];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = active ? pts[(size_t)i * 8 + k] : 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) fi[f] = active ? feats[(size_t)i * NF + f] : 0.f;
  float dnv_sum = 0.f, dnk_g0 = 0.f, dnk_g1 = 0.f, dnk_g2 = 0.f;
  float gf[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) gf[f] = 0.f;
  float z, nk;
  bool guard;

  for (int c0 = 0; c0 < p; c0 += BWD_CHUNK) {
    const int cn = min(BWD_CHUNK, p - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn * PIX_W; k += blockDim.x)
      s_pix[k] = pix[(size_t)c0 * PIX_W + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cn; ++j) {
      const float* r = &s_pix[j * PIX_W];
      // a pair outside the footprint has prob 0 and adds nothing
      if (!geometry(q, r[0], r[1], r[2], r[3], diam2, z, nk, guard)) continue;
      const float d = r[5];
      const float inv_d = d > 0.f ? 1.f / fmaxf(d, 1e-30f) : 0.f;
      const float inv_zn = 1.f / (r[6] + FLT_EPSILON);
      const float x = -z * inv_zn + 1.f;
      const float s = fmaxf(x, 0.f) * dc;
      const float prob = expf(s - r[4]) * inv_d;
      const float* g = r + 8;
      float u = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        u = u + fi[f] * g[f];
        gf[f] += prob * g[f];
      }
      if (x > 0.f && !guard) {
        const float ds = prob * (u - r[7]);
        const float dz = -(ds * dc) * inv_zn;
        const float dnv = dz / nk;
        const float dnk = -dnv * z;
        dnv_sum += dnv;
        dnk_g0 += dnk * r[0];
        dnk_g1 += dnk * r[1];
        dnk_g2 += dnk * r[2];
      }
    }
  }
  if (active) {
    dv[(size_t)i * 3 + 0] = dnv_sum * q[3];
    dv[(size_t)i * 3 + 1] = dnv_sum * q[4];
    dv[(size_t)i * 3 + 2] = dnv_sum * q[5];
    dn[(size_t)i * 3 + 0] = dnv_sum * q[0] + dnk_g0;
    dn[(size_t)i * 3 + 1] = dnv_sum * q[1] + dnk_g1;
    dn[(size_t)i * 3 + 2] = dnv_sum * q[2] + dnk_g2;
#pragma unroll
    for (int f = 0; f < NF; ++f) df[(size_t)i * NF + f] = gf[f];
  }
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pts (n, 8) [v, n, mask, 0], feats (n, 8), kg (p, 4) [g, g.g] float32 ->
// img (p, 8), m, d, zn (p,) float32.
int splat_fwd(const void* pts, const void* feats, const void* kg, int n, int p,
              float diam2, float depth_constant, void* img, void* m, void* d,
              void* zn, void* stream) {
  if (p <= 0) return 0;
  const int blocks = (p + FWD_THREADS - 1) / FWD_THREADS;
  splat_fwd_kernel<<<blocks, FWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const float*)kg, n, p, diam2,
      depth_constant, (float*)img, (float*)m, (float*)d, (float*)zn);
  return (int)cudaGetLastError();
}

// pts, feats as above; pix (p, 16) -> dv (n, 3), dn (n, 3), df (n, 8).
int splat_bwd(const void* pts, const void* feats, const void* pix, int n,
              int p, float diam2, float depth_constant, void* dv, void* dn,
              void* df, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  splat_bwd_kernel<<<blocks, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const float*)pix, n, p, diam2,
      depth_constant, (float*)dv, (float*)dn, (float*)df);
  return (int)cudaGetLastError();
}

}  // extern "C"
