// Fused surfel splat + depth-softmax composite, forward and backward.
//
// Replaces sdflabel_tpu/ops/splat_pallas.py::_fwd_call (dense branch:
// _znorm_kernel, _softmax_kernel; binned branch: _znorm_kernel_binned,
// _softmax_kernel_binned) and ::_core_bwd (dense branch: _grads_kernel;
// binned branch: _grads_kernel_binned). Computes, without ever building
// the (N, P) matrices,
//
//   img[p, :] = sum_i prob[i, p] * feats[i, :]
//   prob[:, p] = softmax_i(masked scores) * footprint     (per pixel p)
//
// i.e. ops/splat.py::splat_surfel(softclamp=False, add_bg=False) followed
// by prob.T @ feats. The per-pair arithmetic follows the plain version
// and the reference (primitives.py:215-218), built with -fmad=false so
// that nothing is contracted to fma: the explicit tangent-plane offset
// x = v - g z and the footprint test sqrt(x.x) < diam with mask > 0.5,
// the guard |n.g| < 0.01 -> nk = FLT_EPSILON, NEG_BIG = -1e30,
// 1 / (zn + eps), and in the backward no gradient at all through a guarded
// pair. The TPU kernel tests the sqrt-free expanded form
// vv - 2 vk z + gg z^2 < diam^2 instead; at camera distances of 10-20 the
// terms reach ~400 and their fp32 rounding (~1e-4) is 6% of diam^2, so a
// pair within ~3% of the disc edge may land on either side of it. The
// explicit offset keeps that error at ~1e-6 of a 0.04 diameter.
//
// Bound on the H100: operations. Every (point, pixel) pair costs ~18 flops
// of ray-plane geometry and two special-function ops (the division
// z = n.v / n.g and the distance's sqrt, at 16 per clock per SM a quarter
// of the fp32 rate), in each of the two forward passes and in the
// backward; bytes are ~0.6 MB per call. The TPU kernels carry the point
// axis as a sequential grid dimension in VMEM scratch.
//   dense forward, split design (splat_fwd_split_kernel, every dense
//             render): a 32x32 crop has only 16 tiles of 64 pixels, so the
//             points are split too: grid (tiles, S), the S <= 8 CTAs of a
//             tile one thread-block cluster, each on a contiguous slice
//             staged once in shared memory for both passes, 8 threads per
//             pixel on interleaved points (16 warps per CTA). The z-norm's
//             partial sums and the online-softmax partials (m, d, acc) are
//             merged in fixed orders, over the threads and then over the
//             cluster's ranks through distributed shared memory: no
//             atomics, the same result every run. 8192 points onto 32x32
//             px: 128 CTAs. What bounds it now: the per-pair fp32 and
//             special-function work of both passes on every pair, footprint
//             or not; a per-tile cull of the pairs far from any disc edge
//             is the next step.
//   first design (splat_fwd_kernel): one thread per pixel over all points;
//             pass 1 reduces the z-norm, pass 2 runs the online softmax
//             with the running max, denominator and 8 feature accumulators
//             in registers. The yardstick of both split forwards: dense
//             (splat_fwd_first) and with windows (splat_fwd_binned).
//   dense backward, split design (splat_bwd_split_kernel, every dense
//             render's VJP): point-major, but the pixels are split too, as
//             the forward's points are: grid (point blocks, S), the S <= 8
//             CTAs of a block of 64 points one cluster, each on a
//             contiguous slice of the pixel rows staged once in shared
//             memory (in chunks past BSPLIT_CAP). In a CTA, BSPLIT_T groups
//             of two warps take contiguous parts of each staged chunk; the
//             32 lanes of a warp hold 32 points that read the same pixel
//             row, a broadcast. Each thread's PointGrads partial goes to
//             shared memory, the groups' partials are added in warp order,
//             then the ranks' sums in rank order through distributed shared
//             memory, rank r adding the r-th share of the block's points:
//             no atomics, the same result every run. The per-pair work is
//             the first design's; only the order of the per-point sums over
//             pixels changes. 8192 points onto 32x32 px: 128 point blocks
//             x 3 CTAs of 8 warps (bwd_split_slices), 23 warps an SM.
//   dense backward, first design (splat_bwd_kernel, the split design's
//             yardstick, splat_bwd_first): one thread per point looping
//             over all pixel chunks; 64 CTAs of 4 warps for 8192 points.
//   crop axis (both split designs; the batched driver, as the TPU kernels
//             gain a batch grid axis under vmap): a batch of B crops of the
//             same n points and p pixels is one launch, crop b on grid
//             plane z = b over its own points, rays and outputs. A cluster
//             spans only y, so every distributed-shared-memory merge stays
//             inside one crop, and the slice count depends on n and p
//             alone: each crop's result is bit-equal to its launch alone
//             (B = 1, the single-crop path). The binned split designs
//             take the same axis: crop b walks only its own windows (its
//             bins from splat_bins.cu's crop axis, its own smax), so a
//             padded lane with every point masked meets no window.
//
// Row binning (renders of >= 4096 px): the points arrive sorted by the
// first bin_px-pixel row block their footprint can touch (csrc/splat_bins.cu,
// the bins of ops/splat_cuda.py::compute_bins built on the card), and block
// b may only meet the sorted window [start_b, end_b). The footprint test
// stays exact on every pair a kernel visits, so binning changes only the
// order of the sums.
//   binned forward, split design (splat_fwd_binned_split_kernel): the dense
//             split forward's tile (fwd_tile, shared) on its row block's
//             window (bin_px is a multiple of the 64 pixels of a tile, so a
//             tile lies in one row block), split over a cluster of S CTAs
//             when the tiles alone leave SMs idle (binned_split_slices; the
//             windows' lengths are on the card, so the rule takes n / nb
//             points a window). At 128x128 px the 256 tiles of 16 warps
//             already fill the card (S = 1) and the window's points are
//             shared by 8 threads a pixel where the first design gave one.
//   binned backward, split design (splat_bwd_binned_split_kernel): the
//             dense split backward's block of 64 sorted points (bwd_block,
//             shared) on the union of its points' rows, [key_first *
//             bin_px, min((key_last + smax + 1) * bin_px, p)), split over
//             a cluster of S CTAs (bwd_binned_split_slices; 4096 points:
//             64 blocks x 5, where the first design had 32 CTAs of 4 warps
//             on 132 SMs). Each thread adds only the rows of its point's
//             blocks [key_j, key_j + smax], exactly the pairs the forward
//             visited, and writes its point's gradient row to the point's
//             own slot order[j]: no scatter after the kernel.
//   first designs, the yardsticks (splat_fwd_binned, splat_bwd_binned):
//             splat_fwd_kernel with windows; splat_bwd_binned_kernel, one
//             thread per sorted point over its rows, outputs in sorted
//             order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>

namespace cg = cooperative_groups;

namespace {

constexpr float NK_EPS_THRESHOLD = 0.01f;  // primitives.py:213 guard
constexpr float NEG_BIG = -1e30f;
constexpr int NF = 8;            // [color(3) | mask | depth | normal(3)]
constexpr int FWD_THREADS = 64;  // pixels per block
constexpr int FWD_CHUNK = 256;   // points per shared-memory chunk
constexpr int BWD_THREADS = 128; // points per block
constexpr int BWD_CHUNK = 128;   // pixels per shared-memory chunk
constexpr int PIX_W = 16;        // packed pixel row, see splat_bwd_kernel
// the split dense forward, splat_fwd_split_kernel
constexpr int SPLIT_PX = 64;     // pixels per CTA
constexpr int SPLIT_T = 8;       // threads per pixel, on interleaved points
constexpr int SPLIT_THREADS = SPLIT_PX * SPLIT_T;
constexpr int SPLIT_MAX = 8;     // CTAs per cluster: the portable limit
constexpr int SPLIT_MIN_PTS = 128;  // fewest points per slice worth a CTA
constexpr int SPLIT_CAP = 1024;  // points staged at once: 64 KB
constexpr int PART = 2 + NF;     // a softmax partial: m, d, acc[NF]
constexpr size_t SPLIT_SMEM =
    (size_t)(SPLIT_CAP * (8 + NF) + SPLIT_T * PART * SPLIT_PX +
             (1 + PART) * SPLIT_PX) * sizeof(float);
// the split dense backward, splat_bwd_split_kernel
constexpr int BSPLIT_PTS = 64;   // points per CTA: two warps
constexpr int BSPLIT_T = 4;      // groups of two warps over the pixels
constexpr int BSPLIT_THREADS = BSPLIT_PTS * BSPLIT_T;
constexpr int BSPLIT_CAP = 256;  // pixel rows staged at once: 16 KB
constexpr int BSPLIT_MIN_PX = 64;  // fewest pixels per slice worth a CTA
constexpr int BSPLIT_CTAS_PER_SM = 2;  // CTAs (16 warps) the rule aims at
constexpr int NG = 4 + NF;       // the floats of a PointGrads

// Ray-plane geometry of point q = [v(3), n(3), mask, pad] against pixel ray
// g (splat_pallas.py::_geometry, with the explicit distance of
// primitives.py:215-218). Returns the footprint bit; z, nk and guard feed
// the backward.
__device__ __forceinline__ bool geometry(const float* q, float gx, float gy,
                                         float gz, float diam, float& z,
                                         float& nk, bool& guard) {
  const float nv = q[3] * q[0] + q[4] * q[1] + q[5] * q[2];
  const float nk_raw = q[3] * gx + q[4] * gy + q[5] * gz;
  guard = fabsf(nk_raw) < NK_EPS_THRESHOLD;
  nk = guard ? FLT_EPSILON : nk_raw;
  z = nv / nk;
  const float x0 = q[0] - gx * z, x1 = q[1] - gy * z, x2 = q[2] - gz * z;
  return sqrtf(x0 * x0 + x1 * x1 + x2 * x2) < diam && q[6] > 0.5f;
}

// One point's gradient sums over the pixels it meets. add() takes a pixel
// row [gx, gy, gz, 0, m, d, zn, corr, g_img(8)], where corr = g_img . img
// is the softmax correction sum_i prob_ip (g_p . f_i).
struct PointGrads {
  float dnv_sum = 0.f, dnk_g0 = 0.f, dnk_g1 = 0.f, dnk_g2 = 0.f;
  float gf[NF] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  __device__ __forceinline__ void add(const float* q, const float* fi,
                                      const float* r, float diam, float dc) {
    float z, nk;
    bool guard;
    // a pair outside the footprint has prob 0 and adds nothing
    if (!geometry(q, r[0], r[1], r[2], diam, z, nk, guard)) return;
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

  // entry k of the partial: 0 dnv_sum, 1-3 dnk_g0..2, 4 + f gf[f]
  __device__ __forceinline__ float& at(int k) {
    return k == 0 ? dnv_sum : k == 1 ? dnk_g0 : k == 2 ? dnk_g1
         : k == 3 ? dnk_g2 : gf[k - 4];
  }

  __device__ __forceinline__ void store(const float* q, int i, float* dv,
                                        float* dn, float* df) const {
    dv[(size_t)i * 3 + 0] = dnv_sum * q[3];
    dv[(size_t)i * 3 + 1] = dnv_sum * q[4];
    dv[(size_t)i * 3 + 2] = dnv_sum * q[5];
    dn[(size_t)i * 3 + 0] = dnv_sum * q[0] + dnk_g0;
    dn[(size_t)i * 3 + 1] = dnv_sum * q[1] + dnk_g1;
    dn[(size_t)i * 3 + 2] = dnv_sum * q[2] + dnk_g2;
#pragma unroll
    for (int f = 0; f < NF; ++f) df[(size_t)i * NF + f] = gf[f];
  }
};

// kg rows (P, 4): [gx, gy, gz, 0].
__global__ void __launch_bounds__(FWD_THREADS)
// win (nb, 2) [start, end) of each row block's sorted point window, or
// null for the dense sweep over all n points.
splat_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                 const float* __restrict__ kg, int n, int p,
                 const int* __restrict__ win, int bin_px, float diam,
                 float dc, float* __restrict__ img, float* __restrict__ m_out,
                 float* __restrict__ d_out, float* __restrict__ zn_out) {
  __shared__ float s_pts[FWD_CHUNK * 8];
  __shared__ float s_feat[FWD_CHUNK * NF];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pix < p;
  int lo = 0, hi = n;
  if (win != nullptr) {
    const int b = (blockIdx.x * FWD_THREADS) / bin_px;
    lo = win[2 * b];
    hi = win[2 * b + 1];
  }
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (active) {
    gx = kg[pix * 4 + 0];
    gy = kg[pix * 4 + 1];
    gz = kg[pix * 4 + 2];
  }
  float z, nk;
  bool guard;

  // pass 1: per-pixel norm of the footprint depths (primitives.py:229-231)
  float ssq = 0.f;
  for (int c0 = lo; c0 < hi; c0 += FWD_CHUNK) {
    const int cn = min(FWD_CHUNK, hi - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 8; i += blockDim.x)
      s_pts[i] = pts[(size_t)c0 * 8 + i];
    __syncthreads();
    if (active) {
      for (int i = 0; i < cn; ++i) {
        if (geometry(&s_pts[i * 8], gx, gy, gz, diam, z, nk, guard))
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
  for (int c0 = lo; c0 < hi; c0 += FWD_CHUNK) {
    const int cn = min(FWD_CHUNK, hi - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 8; i += blockDim.x) {
      s_pts[i] = pts[(size_t)c0 * 8 + i];
      s_feat[i] = feats[(size_t)c0 * NF + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < cn; ++i) {
      if (!geometry(&s_pts[i * 8], gx, gy, gz, diam, z, nk, guard))
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

// Online-softmax partials (m, d, acc) merged in order into (m, d, acc):
// m = max m_s, d = sum d_s e^(m_s - m), acc = sum acc_s e^(m_s - m). An
// empty partial (NEG_BIG, 0, 0) adds nothing; all empty stay empty.
// part(s, q) gives partial s's entry q: 0 m, 1 d, 2 + f acc[f].
template <typename Part>
__device__ __forceinline__ void merge_partials(int count, Part part,
                                               float& m, float& d,
                                               float (&acc)[NF]) {
  m = part(0, 0);
  for (int s = 1; s < count; ++s) m = fmaxf(m, part(s, 0));
  d = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  for (int s = 0; s < count; ++s) {
    const float w = expf(part(s, 0) - m);
    d += part(s, 1) * w;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] += part(s, 2 + f) * w;
  }
}

// One 64-pixel tile of the split forward, on the points [lo, hi) of this
// CTA's slice; the cluster's S CTAs share the tile. In a CTA, SPLIT_T
// threads share each pixel, thread k on the slice's points k, k + SPLIT_T,
// ... Each CTA stages its slice (up to SPLIT_CAP points; larger slices in
// chunks) in shared memory once for both passes. Pass 1: the z-norm's sums
// of squares, merged over the threads in order, then every CTA reads every
// rank's through distributed shared memory in rank order, so all hold the
// same zn. Pass 2: each thread's online softmax, merged over the threads
// in order into the CTA's partial; rank 0 merges the S partials in rank
// order and writes img, m, d, zn. The per-pair arithmetic is
// splat_fwd_kernel's; only the order of the sums differs.
__device__ __forceinline__ void fwd_tile(
    const float* __restrict__ pts, const float* __restrict__ feats,
    const float* __restrict__ kg, int p, int lo, int hi, float diam,
    float dc, float* smem, cg::cluster_group& cluster,
    float* __restrict__ img, float* __restrict__ m_out,
    float* __restrict__ d_out, float* __restrict__ zn_out) {
  float* s_pts = smem;                     // SPLIT_CAP x 8
  float* s_feat = s_pts + SPLIT_CAP * 8;   // SPLIT_CAP x NF
  float* s_red = s_feat + SPLIT_CAP * NF;  // per thread: SPLIT_T x PART x px
  float* s_ssq = s_red + SPLIT_T * PART * SPLIT_PX;  // the CTA's, per px
  float* s_part = s_ssq + SPLIT_PX;                  // PART x px
  const int rank = (int)cluster.block_rank();
  const int slices = (int)cluster.num_blocks();
  const int px = threadIdx.x % SPLIT_PX, k = threadIdx.x / SPLIT_PX;
  const int pix = blockIdx.x * SPLIT_PX + px;
  const bool active = pix < p;
  const bool resident = hi - lo <= SPLIT_CAP;
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (active) {
    gx = kg[pix * 4 + 0];
    gy = kg[pix * 4 + 1];
    gz = kg[pix * 4 + 2];
  }
  auto stage = [&](int c0, int cn) {
    __syncthreads();
    const float4* p4 = reinterpret_cast<const float4*>(pts) + (size_t)c0 * 2;
    const float4* f4 =
        reinterpret_cast<const float4*>(feats) + (size_t)c0 * (NF / 4);
    for (int i = threadIdx.x; i < cn * 2; i += SPLIT_THREADS)
      reinterpret_cast<float4*>(s_pts)[i] = p4[i];
    for (int i = threadIdx.x; i < cn * (NF / 4); i += SPLIT_THREADS)
      reinterpret_cast<float4*>(s_feat)[i] = f4[i];
    __syncthreads();
  };
  float z, nk;
  bool guard;

  // pass 1: this thread's sum of footprint depths squared
  float ssq = 0.f;
  for (int c0 = lo; c0 < hi; c0 += SPLIT_CAP) {
    const int cn = min(SPLIT_CAP, hi - c0);
    stage(c0, cn);
    if (!active) continue;
    for (int i = k; i < cn; i += SPLIT_T)
      if (geometry(&s_pts[i * 8], gx, gy, gz, diam, z, nk, guard))
        ssq += z * z;
  }
  s_red[k * SPLIT_PX + px] = ssq;
  __syncthreads();
  if (k == 0) {
    float s = s_red[px];
    for (int t = 1; t < SPLIT_T; ++t) s += s_red[t * SPLIT_PX + px];
    s_ssq[px] = s;
  }
  cluster.sync();
  float ssq_all = 0.f;
  for (int r = 0; r < slices; ++r)
    ssq_all += *cluster.map_shared_rank(s_ssq + px, r);
  const float zn = sqrtf(ssq_all);
  const float inv_zn = 1.f / (zn + FLT_EPSILON);

  // pass 2: online softmax over this thread's footprint points
  float m = NEG_BIG, d = 0.f;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  for (int c0 = lo; c0 < hi; c0 += SPLIT_CAP) {
    const int cn = min(SPLIT_CAP, hi - c0);
    if (!resident) stage(c0, cn);
    if (!active) continue;
    for (int i = k; i < cn; i += SPLIT_T) {
      if (!geometry(&s_pts[i * 8], gx, gy, gz, diam, z, nk, guard))
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
  float* mine = s_red + k * PART * SPLIT_PX + px;
  mine[0] = m;
  mine[SPLIT_PX] = d;
#pragma unroll
  for (int f = 0; f < NF; ++f) mine[(2 + f) * SPLIT_PX] = acc[f];
  __syncthreads();
  if (k == 0) {  // the CTA's partial: its threads in order
    merge_partials(
        SPLIT_T,
        [&](int t, int q) { return s_red[(t * PART + q) * SPLIT_PX + px]; },
        m, d, acc);
    s_part[px] = m;
    s_part[SPLIT_PX + px] = d;
#pragma unroll
    for (int f = 0; f < NF; ++f) s_part[(2 + f) * SPLIT_PX + px] = acc[f];
  }
  cluster.sync();
  if (rank == 0 && k == 0 && active) {  // the cluster's: its ranks in order
    merge_partials(
        slices,
        [&](int r, int q) {
          return *cluster.map_shared_rank(s_part + q * SPLIT_PX + px, r);
        },
        m, d, acc);
    const float inv_d = d > 0.f ? 1.f / fmaxf(d, 1e-30f) : 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) img[(size_t)pix * NF + f] = acc[f] * inv_d;
    m_out[pix] = m;
    d_out[pix] = d;
    zn_out[pix] = zn;
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read it
}

// The dense forward split over the points. Grid (pixel tiles, S): the S
// CTAs of one tile form a cluster and take contiguous slices of `per`
// points (fwd_tile).
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
splat_fwd_split_kernel(const float* __restrict__ pts,
                       const float* __restrict__ feats,
                       const float* __restrict__ kg, int n, int p, int per,
                       float diam, float dc, float* __restrict__ img,
                       float* __restrict__ m_out, float* __restrict__ d_out,
                       float* __restrict__ zn_out) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const size_t b = blockIdx.z;  // the crop: its own points, rays and image
  const int lo = min(n, (int)cluster.block_rank() * per);
  fwd_tile(pts + b * n * 8, feats + b * n * NF, kg + b * p * 4, p, lo,
           min(n, lo + per), diam, dc, reinterpret_cast<float*>(smem4),
           cluster, img + b * p * NF, m_out + b * p, d_out + b * p,
           zn_out + b * p);
}

// The binned forward on the split forward's tile. The points arrive sorted
// by row block (splat_bins.cu); a tile lies in one row block b (bin_px is
// a multiple of SPLIT_PX) and meets exactly its window [start_b, end_b),
// which the S CTAs of its cluster split into contiguous slices.
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
splat_fwd_binned_split_kernel(const float* __restrict__ pts,
                              const float* __restrict__ feats,
                              const float* __restrict__ kg, int n, int p,
                              const int* __restrict__ win, int bin_px,
                              float diam, float dc, float* __restrict__ img,
                              float* __restrict__ m_out,
                              float* __restrict__ d_out,
                              float* __restrict__ zn_out) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const size_t c = blockIdx.z;  // the crop: its sorted points and windows
  const int nb = (p + bin_px - 1) / bin_px;
  win += c * nb * 2;
  const int b = (blockIdx.x * SPLIT_PX) / bin_px;
  const int start = win[2 * b], end = max(win[2 * b + 1], start);
  const int slices = (int)cluster.num_blocks();
  const int per = (end - start + slices - 1) / slices;
  const int lo = min(end, start + (int)cluster.block_rank() * per);
  fwd_tile(pts + c * n * 8, feats + c * n * NF, kg + c * p * 4, p, lo,
           min(end, lo + per), diam, dc, reinterpret_cast<float*>(smem4),
           cluster, img + c * p * NF, m_out + c * p, d_out + c * p,
           zn_out + c * p);
}

// Slices S of the split forward for n points onto p pixels: enough CTAs
// to give each SM of the card one, at most SPLIT_MAX, and slices of at
// least SPLIT_MIN_PTS points; 1 when the pixel tiles alone fill the card.
int split_slices(int n, int p) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (p + SPLIT_PX - 1) / SPLIT_PX;
  int s = min(sms / max(tiles, 1), SPLIT_MAX);
  s = min(s, (n + SPLIT_MIN_PTS - 1) / SPLIT_MIN_PTS);
  return max(s, 1);
}

// pix rows (P, 16): see PointGrads.
__global__ void __launch_bounds__(BWD_THREADS)
splat_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                 const float* __restrict__ pix, int n, int p, float diam,
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
  PointGrads acc;

  for (int c0 = 0; c0 < p; c0 += BWD_CHUNK) {
    const int cn = min(BWD_CHUNK, p - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn * PIX_W; k += blockDim.x)
      s_pix[k] = pix[(size_t)c0 * PIX_W + k];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < cn; ++j) acc.add(q, fi, &s_pix[j * PIX_W], diam, dc);
  }
  if (active) acc.store(q, i, dv, dn, df);
}

// One block of BSPLIT_PTS points of the split backward, on the pixel rows
// [lo, hi) of this CTA's slice; the cluster's S CTAs share the block.
// Thread t is point t % BSPLIT_PTS of the block in group g = t /
// BSPLIT_PTS, and group g takes the g-th contiguous part (ceil(cn /
// BSPLIT_T) rows) of each staged chunk of cn rows, of which the thread adds
// only the rows of [q_lo, q_hi), its own point's. Each thread's PointGrads
// partial is added over the groups in order, then over the ranks in rank
// order; rank r stores the r-th share of the points, point j at row
// order[j] of the outputs (j itself when order is null).
__device__ __forceinline__ void bwd_block(
    const float* __restrict__ pts, const float* __restrict__ feats,
    const float* __restrict__ pix, int n, int lo, int hi, int q_lo,
    int q_hi, const int* __restrict__ order, float diam, float dc,
    float4* s_pix4, float* s_part, float* s_sum, cg::cluster_group& cluster,
    float* __restrict__ dv, float* __restrict__ dn, float* __restrict__ df) {
  const float* s_pix = reinterpret_cast<const float*>(s_pix4);
  const int rank = (int)cluster.block_rank();
  const int slices = (int)cluster.num_blocks();
  const int pt = threadIdx.x % BSPLIT_PTS, grp = threadIdx.x / BSPLIT_PTS;
  const int i = blockIdx.x * BSPLIT_PTS + pt;
  const bool active = i < n;
  float q[8], fi[NF];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = active ? pts[(size_t)i * 8 + k] : 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) fi[f] = active ? feats[(size_t)i * NF + f] : 0.f;
  PointGrads acc;

  for (int c0 = lo; c0 < hi; c0 += BSPLIT_CAP) {
    const int cn = min(BSPLIT_CAP, hi - c0);
    __syncthreads();
    const float4* p4 = reinterpret_cast<const float4*>(pix) +
                       (size_t)c0 * (PIX_W / 4);
    for (int k = threadIdx.x; k < cn * (PIX_W / 4); k += BSPLIT_THREADS)
      s_pix4[k] = p4[k];
    __syncthreads();
    if (!active) continue;
    const int sub = (cn + BSPLIT_T - 1) / BSPLIT_T;
    const int j0 = max(grp * sub, q_lo - c0);
    const int j1 = min(min(cn, grp * sub + sub), q_hi - c0);
    for (int j = j0; j < j1; ++j) acc.add(q, fi, &s_pix[j * PIX_W], diam, dc);
  }
#pragma unroll
  for (int k = 0; k < NG; ++k)
    s_part[(grp * NG + k) * BSPLIT_PTS + pt] = acc.at(k);
  __syncthreads();
  if (grp == 0) {  // the CTA's partial: its groups in warp order
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      float v = s_part[k * BSPLIT_PTS + pt];
      for (int g = 1; g < BSPLIT_T; ++g)
        v += s_part[(g * NG + k) * BSPLIT_PTS + pt];
      s_sum[k * BSPLIT_PTS + pt] = v;
    }
  }
  cluster.sync();
  // rank r adds the ranks' sums of its share of the points in rank order
  // (share <= BSPLIT_PTS < BSPLIT_THREADS: one point a thread)
  const int share = (BSPLIT_PTS + slices - 1) / slices;
  const int j = rank * share + (int)threadIdx.x;
  const int ij = blockIdx.x * BSPLIT_PTS + j;
  if ((int)threadIdx.x < share && j < BSPLIT_PTS && ij < n) {
    PointGrads total;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      float v = *cluster.map_shared_rank(s_sum + k * BSPLIT_PTS + j, 0);
      for (int r = 1; r < slices; ++r)
        v += *cluster.map_shared_rank(s_sum + k * BSPLIT_PTS + j, r);
      total.at(k) = v;
    }
    float qj[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) qj[k] = pts[(size_t)ij * 8 + k];
    total.store(qj, order != nullptr ? order[ij] : ij, dv, dn, df);
  }
  cluster.sync();  // no CTA leaves while a peer may still read it
}

// The dense backward split over the pixels. Grid (point blocks, S): the S
// CTAs of a block of BSPLIT_PTS points form a cluster and take contiguous
// slices of `per` pixel rows (bwd_block), every row for every point.
__global__ void __launch_bounds__(BSPLIT_THREADS, 3)
splat_bwd_split_kernel(const float* __restrict__ pts,
                       const float* __restrict__ feats,
                       const float* __restrict__ pix, int n, int p, int per,
                       float diam, float dc, float* __restrict__ dv,
                       float* __restrict__ dn, float* __restrict__ df) {
  __shared__ float4 s_pix4[BSPLIT_CAP * PIX_W / 4];
  __shared__ float s_part[BSPLIT_T * NG * BSPLIT_PTS];
  __shared__ float s_sum[NG * BSPLIT_PTS];
  cg::cluster_group cluster = cg::this_cluster();
  const size_t b = blockIdx.z;  // the crop: its own points and pixel rows
  const int lo = min(p, (int)cluster.block_rank() * per);
  bwd_block(pts + b * n * 8, feats + b * n * NF, pix + b * p * PIX_W, n, lo,
            min(p, lo + per), 0, p, nullptr, diam, dc, s_pix4, s_part, s_sum,
            cluster, dv + b * n * 3, dn + b * n * 3, df + b * n * NF);
}

// The binned backward on the split backward's design, over points sorted
// as the binned forward saw them. key (n,) is each sorted point's first row
// block (nb: touches none), smax points at the widest span: sorted point j
// meets exactly the rows of the blocks [key_j, key_j + smax] (the pairs the
// forward visited), and a block of points the union of its points' rows,
// [key_first * bin_px, min((key_last + smax + 1) * bin_px, p)) with keys
// ascending in the block, which its cluster splits into contiguous slices.
// Each gradient row goes to the point's own slot order[j].
__global__ void __launch_bounds__(BSPLIT_THREADS, 3)
splat_bwd_binned_split_kernel(const float* __restrict__ pts,
                              const float* __restrict__ feats,
                              const float* __restrict__ pix,
                              const int* __restrict__ key,
                              const int* __restrict__ smax_p,
                              const int* __restrict__ order, int n, int p,
                              int bin_px, float diam, float dc,
                              float* __restrict__ dv, float* __restrict__ dn,
                              float* __restrict__ df) {
  __shared__ float4 s_pix4[BSPLIT_CAP * PIX_W / 4];
  __shared__ float s_part[BSPLIT_T * NG * BSPLIT_PTS];
  __shared__ float s_sum[NG * BSPLIT_PTS];
  __shared__ int s_kmax[BSPLIT_PTS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const size_t c = blockIdx.z;  // the crop: its sorted points and bins
  pts += c * n * 8;
  feats += c * n * NF;
  pix += c * p * PIX_W;
  key += c * n;
  order += c * n;
  dv += c * n * 3;
  dn += c * n * 3;
  df += c * n * NF;
  const int nb = (p + bin_px - 1) / bin_px;
  const int smax = smax_p[c];
  const int i = blockIdx.x * BSPLIT_PTS + (int)threadIdx.x % BSPLIT_PTS;
  const int ki = i < n ? key[i] : nb;
  if ((int)threadIdx.x < BSPLIT_PTS) {  // the block's last live key
    const int v = __reduce_max_sync(0xffffffffu, ki < nb ? ki : -1);
    if (threadIdx.x % 32 == 0) s_kmax[threadIdx.x / 32] = v;
  }
  __syncthreads();
  const int k_first = key[blockIdx.x * BSPLIT_PTS];
  int k_last = s_kmax[0];
  for (int w = 1; w < BSPLIT_PTS / 32; ++w) k_last = max(k_last, s_kmax[w]);
  int u_lo = 0, u_hi = 0;
  if (k_first < nb) {
    u_lo = k_first * bin_px;
    u_hi = min((k_last + smax + 1) * bin_px, p);
  }
  const int slices = (int)cluster.num_blocks();
  const int per = (u_hi - u_lo + slices - 1) / slices;
  const int lo = min(u_hi, u_lo + (int)cluster.block_rank() * per);
  int q_lo = 0, q_hi = 0;
  if (ki < nb) {
    q_lo = ki * bin_px;
    q_hi = min((ki + smax + 1) * bin_px, p);
  }
  bwd_block(pts, feats, pix, n, lo, min(u_hi, lo + per), q_lo, q_hi, order,
            diam, dc, s_pix4, s_part, s_sum, cluster, dv, dn, df);
}

// Slices S of the split backward for n points onto p pixels: enough CTAs
// for BSPLIT_CTAS_PER_SM on every SM, at most SPLIT_MAX, slices of at least
// BSPLIT_MIN_PX pixels; 1 when the point blocks alone fill the card.
int bwd_split_slices(int n, int p) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = max((n + BSPLIT_PTS - 1) / BSPLIT_PTS, 1);
  int s = (sms * BSPLIT_CTAS_PER_SM + blocks - 1) / blocks;
  s = min(s, SPLIT_MAX);
  s = min(s, (p + BSPLIT_MIN_PX - 1) / BSPLIT_MIN_PX);
  return max(s, 1);
}

// Slices S of the binned split forward for n points onto p pixels in
// row blocks of bin_px: split_slices' rule with the windows' length
// unknown to the host (it is on the card), each window taken as n / nb
// points, what a row block holds when the keys spread evenly; a window is
// longer by the blocks within smax before it, so this errs towards fewer
// CTAs. 128x128 px (256 tiles), 81x112 (142) and 320x320 px (1600): S = 1,
// the tiles already give every SM one; 64x64 px with 3000 points: 2.
int binned_split_slices(int n, int p, int bin_px) {
  const int nb = max((p + bin_px - 1) / bin_px, 1);
  return split_slices((n + nb - 1) / nb, p);
}

// Slices S of the binned split backward: bwd_split_slices' rule on the
// least union of rows a live block of points meets, one row block (the
// host does not know smax). 4096 points (64 blocks): S = 5.
int bwd_binned_split_slices(int n, int p, int bin_px) {
  return bwd_split_slices(n, min(bin_px, p));
}

// Binned backward over points sorted as the binned forward saw them. key
// (n,) is each sorted point's first row block (nb: touches none); smax
// points at the widest span. Outputs are in sorted order.
__global__ void __launch_bounds__(BWD_THREADS)
splat_bwd_binned_kernel(const float* __restrict__ pts,
                        const float* __restrict__ feats,
                        const float* __restrict__ pix,
                        const int* __restrict__ key,
                        const int* __restrict__ smax, int n, int p,
                        int bin_px, float diam, float dc,
                        float* __restrict__ dv, float* __restrict__ dn,
                        float* __restrict__ df) {
  __shared__ float s_pix[BWD_CHUNK * PIX_W];
  __shared__ int s_lo, s_hi;
  const int nb = (p + bin_px - 1) / bin_px;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  int b_lo = nb, b_hi = -1;  // this point's row blocks, empty by default
  if (active && key[i] < nb) {
    b_lo = key[i];
    b_hi = min(key[i] + *smax, nb - 1);
  }
  if (threadIdx.x == 0) {
    s_lo = nb;
    s_hi = -1;
  }
  __syncthreads();
  if (b_hi >= 0) {
    atomicMin(&s_lo, b_lo);
    atomicMax(&s_hi, b_hi);
  }
  __syncthreads();
  const int p_lo = s_lo * bin_px, p_hi = min((s_hi + 1) * bin_px, p);
  const int q_lo = b_lo * bin_px, q_hi = (b_hi + 1) * bin_px;
  float q[8], fi[NF];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = active ? pts[(size_t)i * 8 + k] : 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) fi[f] = active ? feats[(size_t)i * NF + f] : 0.f;
  PointGrads acc;

  for (int c0 = p_lo; c0 < p_hi; c0 += BWD_CHUNK) {
    const int cn = min(BWD_CHUNK, p_hi - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn * PIX_W; k += blockDim.x)
      s_pix[k] = pix[(size_t)c0 * PIX_W + k];
    __syncthreads();
    const int j0 = max(q_lo - c0, 0), j1 = min(q_hi - c0, cn);
    for (int j = j0; j < j1; ++j) acc.add(q, fi, &s_pix[j * PIX_W], diam, dc);
  }
  if (active) acc.store(q, i, dv, dn, df);
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Point slices (CTAs per cluster) of splat_fwd for n points onto p pixels.
int splat_fwd_slices(int n, int p) { return split_slices(n, p); }

// pts (batch, n, 8) [v, n, mask, 0], feats (batch, n, 8), kg (batch, p, 4)
// [g, 0] float32 -> img (batch, p, 8), m, d, zn (batch, p) float32: each
// crop of the batch on its own grid plane, its result bit-equal to a launch
// of that crop alone (batch 1). The split design.
int splat_fwd(const void* pts, const void* feats, const void* kg, int batch,
              int n, int p, float diam, float depth_constant, void* img,
              void* m, void* d, void* zn, void* stream) {
  if (p <= 0 || batch <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      splat_fwd_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SPLIT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int slices = split_slices(n, p);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p + SPLIT_PX - 1) / SPLIT_PX, slices, batch);
  cfg.blockDim = dim3(SPLIT_THREADS);
  cfg.dynamicSmemBytes = SPLIT_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, splat_fwd_split_kernel, (const float*)pts, (const float*)feats,
      (const float*)kg, n, p, (n + slices - 1) / slices, diam,
      depth_constant, (float*)img, (float*)m, (float*)d, (float*)zn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// As splat_fwd, through the first design: one thread per pixel over all n
// points (splat_fwd_kernel without windows).
int splat_fwd_first(const void* pts, const void* feats, const void* kg, int n,
                    int p, float diam, float depth_constant, void* img,
                    void* m, void* d, void* zn, void* stream) {
  if (p <= 0) return 0;
  const int blocks = (p + FWD_THREADS - 1) / FWD_THREADS;
  splat_fwd_kernel<<<blocks, FWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const float*)kg, n, p, nullptr,
      0, diam, depth_constant, (float*)img, (float*)m, (float*)d, (float*)zn);
  return (int)cudaGetLastError();
}

// Point slices of splat_fwd_binned_split for n points onto p pixels.
int splat_fwd_binned_slices(int n, int p, int bin_px) {
  return binned_split_slices(n, p, bin_px);
}

// As splat_fwd over points sorted by row block (splat_bins.cu); win
// (batch, nb, 2) int32 holds each crop's row blocks' [start, end) in its
// sorted points, bin_px % 64 == 0. The split design; `slices` > 0 forces
// the cluster size (1..8), 0 takes binned_split_slices.
int splat_fwd_binned_split(const void* pts, const void* feats, const void* kg,
                           int batch, int n, int p, const void* win,
                           int bin_px, int slices, float diam,
                           float depth_constant, void* img, void* m, void* d,
                           void* zn, void* stream) {
  if (p <= 0 || batch <= 0) return 0;
  if (bin_px <= 0 || bin_px % SPLIT_PX != 0 || slices > SPLIT_MAX ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      splat_fwd_binned_split_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SPLIT_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (slices <= 0) slices = binned_split_slices(n, p, bin_px);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p + SPLIT_PX - 1) / SPLIT_PX, slices, batch);
  cfg.blockDim = dim3(SPLIT_THREADS);
  cfg.dynamicSmemBytes = SPLIT_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, splat_fwd_binned_split_kernel, (const float*)pts,
      (const float*)feats, (const float*)kg, n, p, (const int*)win, bin_px,
      diam, depth_constant, (float*)img, (float*)m, (float*)d, (float*)zn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// As splat_fwd_binned_split, through the first design: one thread per
// pixel over its window (splat_fwd_kernel with windows).
int splat_fwd_binned(const void* pts, const void* feats, const void* kg, int n,
                     int p, const void* win, int bin_px, float diam,
                     float depth_constant, void* img, void* m, void* d,
                     void* zn, void* stream) {
  if (p <= 0) return 0;
  if (bin_px <= 0 || bin_px % FWD_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (p + FWD_THREADS - 1) / FWD_THREADS;
  splat_fwd_kernel<<<blocks, FWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const float*)kg, n, p,
      (const int*)win, bin_px, diam, depth_constant, (float*)img, (float*)m,
      (float*)d, (float*)zn);
  return (int)cudaGetLastError();
}

// Pixel slices (CTAs per cluster) of splat_bwd for n points onto p pixels.
int splat_bwd_slices(int n, int p) { return bwd_split_slices(n, p); }

// pts, feats as above; pix (batch, p, 16) -> dv (batch, n, 3), dn (batch,
// n, 3), df (batch, n, 8), each crop as a launch of it alone. The split
// design; `slices` > 0 forces the cluster size (1..8), 0 takes
// bwd_split_slices(n, p).
int splat_bwd(const void* pts, const void* feats, const void* pix, int batch,
              int n, int p, int slices, float diam, float depth_constant,
              void* dv, void* dn, void* df, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (slices <= 0) slices = bwd_split_slices(n, p);
  if (slices > SPLIT_MAX || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BSPLIT_PTS - 1) / BSPLIT_PTS, slices, batch);
  cfg.blockDim = dim3(BSPLIT_THREADS);
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
      &cfg, splat_bwd_split_kernel, (const float*)pts, (const float*)feats,
      (const float*)pix, n, p, (p + slices - 1) / slices, diam,
      depth_constant, (float*)dv, (float*)dn, (float*)df);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// As splat_bwd, through the first design (splat_bwd_kernel).
int splat_bwd_first(const void* pts, const void* feats, const void* pix,
                    int n, int p, float diam, float depth_constant, void* dv,
                    void* dn, void* df, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  splat_bwd_kernel<<<blocks, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const float*)pix, n, p, diam,
      depth_constant, (float*)dv, (float*)dn, (float*)df);
  return (int)cudaGetLastError();
}

// Pixel slices of splat_bwd_binned_split for n points onto p pixels.
int splat_bwd_binned_slices(int n, int p, int bin_px) {
  return bwd_binned_split_slices(n, p, bin_px);
}

// Sorted pts, feats as splat_fwd_binned_split, pix (batch, p, 16); key
// (batch, n) int32 sorted first row blocks, smax (batch,) int32, order
// (batch, n) int32 sorted position -> point -> dv, dn, df (batch, n, .) in
// each crop's points' own order (row order[j] for sorted point j). The
// split design; `slices` as in splat_bwd.
int splat_bwd_binned_split(const void* pts, const void* feats,
                           const void* pix, const void* key, const void* smax,
                           const void* order, int batch, int n, int p,
                           int bin_px, int slices, float diam,
                           float depth_constant, void* dv, void* dn, void* df,
                           void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (bin_px <= 0 || slices > SPLIT_MAX || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (slices <= 0) slices = bwd_binned_split_slices(n, p, bin_px);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BSPLIT_PTS - 1) / BSPLIT_PTS, slices, batch);
  cfg.blockDim = dim3(BSPLIT_THREADS);
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
      &cfg, splat_bwd_binned_split_kernel, (const float*)pts,
      (const float*)feats, (const float*)pix, (const int*)key,
      (const int*)smax, (const int*)order, n, p, bin_px, diam,
      depth_constant, (float*)dv, (float*)dn, (float*)df);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// As splat_bwd_binned_split without order, through the first design (one
// thread per sorted point, splat_bwd_binned_kernel): outputs in sorted
// order.
int splat_bwd_binned(const void* pts, const void* feats, const void* pix,
                     const void* key, const void* smax, int n, int p,
                     int bin_px, float diam, float depth_constant, void* dv,
                     void* dn, void* df, void* stream) {
  if (n <= 0) return 0;
  if (bin_px <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
  splat_bwd_binned_kernel<<<blocks, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)feats, (const float*)pix,
      (const int*)key, (const int*)smax, n, p, bin_px, diam, depth_constant,
      (float*)dv, (float*)dn, (float*)df);
  return (int)cudaGetLastError();
}

}  // extern "C"
