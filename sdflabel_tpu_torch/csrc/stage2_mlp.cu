// Stage-2 decode: the folded DeepSDF MLP, its raw normals, and its backward.
//
// Replaces sdflabel_tpu/ops/mlp2_pallas.py::stage2_fwd_apply (kernel 4a,
// _stage2_fwd_kernel) and ::stage2_bwd_apply (kernel 4b,
// _stage2_bwd_kernel). Same math as ops/mlp2_cuda.py::emulate_stage2:
//   h0 = relu(c0 + xyz . wx0)
//   h_{j+1} = relu(bf16(h_j) @ ws_j + c_{j+1} + xyz . wx_{j+1})  (fp32 acc)
//   s = h_nh . wlast + b_last + xyz . w_last;  t = tanh(s) (tanh again if
//   use_tanh)
// where c_j = bias_j + latent @ wlat_j is absorbed by the wrapper.
// 4a returns (t, dt/dxyz) per point: the forward, then the reverse sweep
// with cotangent dt/ds. 4b recomputes the forward, multiplies the loss
// cotangent into dt/ds, and sweeps back to d_xyz per point and to the
// per-layer sums over points of d_pre-activation (d_cvec).
//
// Bound on the H100: bf16 tensor-core operations, two chains of nh H x H
// products per point (4 * K * nh * H^2 flops: 60 GFLOP for 8192 points
// through the 8x512 decoder, 0.061 ms); bytes are the points, the 3.7 MB
// weight stack and the outputs.
//
// Kernels 4a and 4b at H in {128, 256, 384, 512}, when their sign bits
// fit: stage2_fwd_wgmma_kernel and stage2_bwd_wgmma_kernel, the Hopper
// design of mlp_wgmma.cuh (wgmma with register accumulators on pre-packed
// slices that a cluster shares through bulk-copy multicast; the reverse
// sweep streams a second, transposed packed stack through the same ring;
// one ReLU sign bit per activation in shared memory). 4b is 4a's body with
// the loss cotangent on the last layer, d_xyz as its output, and each
// layer's column sums of d_pre (the CTA's d_cvec partial) taken in
// registers, across lanes by shuffles and across warps through shared
// memory, in a fixed order. At 8192 points a launch is 128 CTAs, one wave;
// what bounds both is the epilogue between the products (mlp_wgmma.cuh).
//
// Wider layers keep the first design (stage2_kernel): the TPU kernel keeps
// every layer's activations in an (nh+1, 512, H) fp32 scratch (8 MB at 512
// points); a block here has 227 KB of shared memory. The reverse sweep needs only each activation's ReLU
// sign, so a block of R points keeps one bit per (layer, point, unit) --
// 32 KB at R = 64, nh = 7, H = 512 -- plus the current layer as an fp32
// tile and its bf16 copy. The products stream each layer's weights from L2
// into nvcuda::wmma bf16 fragments with fp32 accumulation; the backward's
// dh = bf16(d_pre) @ ws_j^T reads the same [in, out] stack as a
// column-major operand, with no transposed copy. d_cvec, in both designs:
// each block writes its (nh+1, H) column sums, and a second kernel adds the
// blocks' partials in block order: no atomics, the same result every run.
//
// Crop axis (the batched driver, as the TPU kernels gain a batch grid axis
// under vmap): B crops decode the same weights, each with its own absorbed
// cvec rows (nh+1, H), points (n, 3) and, in 4b, cotangent (n,). A launch
// takes all B; crop b runs on grid row y = b, and a cluster spans x only,
// so a multicast weight slice feeds one crop's point blocks and the L2
// serves the same slices to the other crops. Every crop has the same n (the
// band capacity), so 4b's partial buffer is regular: (B, blocks, nh+1, H),
// blocks = stage2_wgmma_blocks(n, cluster) (wgmma) or ceil(n / R) (wmma),
// and the reduction adds each crop's blocks in block order, never across
// crops. Each crop's outputs are bit-equal to its launch alone (B = 1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "mlp_wgmma.cuh"

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB opt-in dynamic shared memory

__device__ __forceinline__ float xyz_dot(const float* x, const float* w,
                                         int H, int c) {
  // x0*w0 + x1*w1 + x2*w2 left-associated, as the JAX kernel's xc(j)
  return x[0] * w[c] + x[1] * w[H + c] + x[2] * w[2 * H + c];
}

size_t smem_bytes(int R, int H, int nh) {
  return (size_t)R * H * 4                      // fp32 tile
         + (size_t)R * H * 2                    // bf16 tile
         + (size_t)(nh + 1) * R * H / 8         // ReLU sign bits
         + (size_t)R * 7 * 4;                   // xyz, cotangent, d_xyz
}

// acc (R x H fp32) = A (R x H bf16, row-major) @ B, where B is the H x H
// stack ws_j read row-major ([in, out], the forward) or column-major (its
// transpose, the backward).
template <int RT, typename Layout>
__device__ __forceinline__ void tile_product(const __nv_bfloat16* A,
                                             const __nv_bfloat16* W, int H,
                                             float* acc, int warp) {
  const int CT = H / 16;
  for (int ct = warp; ct < CT; ct += WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(c[r], 0.f);
    for (int k = 0; k < H; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, Layout> b;
      if constexpr (std::is_same<Layout, wmma::row_major>::value)
        wmma::load_matrix_sync(b, W + (size_t)k * H + ct * 16, H);
      else
        wmma::load_matrix_sync(b, W + (size_t)ct * 16 * H + k, H);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, A + r * 16 * H + k, H);
        wmma::mma_sync(c[r], a, b, c[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      wmma::store_matrix_sync(acc + r * 16 * H + ct * 16, c[r], H,
                              wmma::mem_row_major);
  }
}

// BWD = false: kernel 4a, out (n, 4) = [t, dt/dx, dt/dy, dt/dz].
// BWD = true: kernel 4b, ct_in (n,) -> dxyz (n, 3) and this block's
// d_cvec partial (nh+1, H) at partial + blockIdx.x * (nh+1) * H.
template <int RT, bool BWD>
__global__ void __launch_bounds__(THREADS)
stage2_kernel(const float* __restrict__ xyz,
              const __nv_bfloat16* __restrict__ ws,
              const float* __restrict__ wx, const float* __restrict__ cvec,
              const float* __restrict__ wlast, const float* __restrict__ scal,
              const float* __restrict__ ct_in, int n, int H, int nh,
              int use_tanh, float* __restrict__ out,
              float* __restrict__ partial) {
  constexpr int R = RT * 16;  // points per block
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t b = blockIdx.y;  // the crop: its points, cvec and outputs
  xyz += b * n * 3;
  cvec += b * (nh + 1) * H;
  out += b * n * (BWD ? 3 : 4);
  if (BWD) {
    ct_in += b * n;
    partial += b * gridDim.x * (nh + 1) * H;
  }
  float* acc = reinterpret_cast<float*>(smem);                       // R x H
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(acc + R * H);  // R x H
  unsigned* bits = reinterpret_cast<unsigned*>(h + R * H);  // nh+1, R*H/32
  float* sx = reinterpret_cast<float*>(bits + (nh + 1) * R * H / 32);
  float* sct = sx + R * 3;  // per-point cotangent on s
  float* sdx = sct + R;     // per-point d_xyz
  const int words = R * H / 32;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int k = tid; k < R * 3; k += THREADS) {
    const int r = k / 3;
    sx[k] = row0 + r < n ? xyz[(size_t)row0 * 3 + k] : 0.f;
  }
  __syncthreads();

  // layer 0: broadcast fp32 multiply-adds (K = 3 xyz + absorbed latent).
  // R * H is a multiple of THREADS, so a warp's 32 lanes hold 32
  // consecutive units of one row: one ballot is one word of sign bits.
  for (int k = tid; k < R * H; k += THREADS) {
    const int r = k / H, c = k % H;
    const float v = cvec[c] + xyz_dot(&sx[r * 3], wx, H, c);
    h[k] = __float2bfloat16(fmaxf(v, 0.f));
    const unsigned word = __ballot_sync(0xffffffffu, v > 0.f);
    if (lane == 0) bits[k / 32] = word;
  }
  __syncthreads();

  for (int j = 0; j < nh; ++j) {
    tile_product<RT, wmma::row_major>(h, ws + (size_t)j * H * H, H, acc,
                                      warp);
    __syncthreads();
    const float* wxj = wx + (size_t)(j + 1) * 4 * H;
    const float* cj = cvec + (size_t)(j + 1) * H;
    unsigned* bj = bits + (size_t)(j + 1) * words;
    if (j + 1 < nh) {
      for (int k = tid; k < R * H; k += THREADS) {
        const int r = k / H, c = k % H;
        const float v = acc[k] + cj[c] + xyz_dot(&sx[r * 3], wxj, H, c);
        h[k] = __float2bfloat16(fmaxf(v, 0.f));
        const unsigned word = __ballot_sync(0xffffffffu, v > 0.f);
        if (lane == 0) bj[k / 32] = word;
      }
    } else {
      // last hidden layer stays fp32 into the H -> 1 product: warp per row
      for (int r = warp; r < R; r += WARPS) {
        float part = 0.f;
        for (int c = lane; c < H; c += 32) {
          const float v =
              acc[r * H + c] + cj[c] + xyz_dot(&sx[r * 3], wxj, H, c);
          part += fmaxf(v, 0.f) * wlast[c];
          const unsigned word = __ballot_sync(0xffffffffu, v > 0.f);
          if (lane == 0) bj[(r * H + c) / 32] = word;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_down_sync(0xffffffffu, part, off);
        if (lane == 0) {
          const float* x = &sx[r * 3];
          float s = part + scal[0];
          s = s + x[0] * scal[1] + x[1] * scal[2] + x[2] * scal[3];
          const float t1 = tanhf(s);
          const float fin = use_tanh ? tanhf(t1) : t1;
          float d_pre = 1.f - t1 * t1;  // d fin / d s: the tanh chain
          if (use_tanh) d_pre = d_pre * (1.f - fin * fin);
          const bool live = row0 + r < n;
          float ct = d_pre;
          if (BWD) ct = live ? ct_in[row0 + r] * d_pre : 0.f;
          if (!BWD && live) out[(size_t)(row0 + r) * 4] = fin;
          sct[r] = ct;
          sdx[r * 3 + 0] = ct * scal[1];
          sdx[r * 3 + 1] = ct * scal[2];
          sdx[r * 3 + 2] = ct * scal[3];
        }
      }
    }
    __syncthreads();
  }

  // reverse sweep: dh = ct * wlast, then layer by layer
  for (int k = tid; k < R * H; k += THREADS)
    acc[k] = sct[k / H] * wlast[k % H];
  __syncthreads();
  for (int j = nh; j >= 0; --j) {
    const unsigned* bj = bits + (size_t)j * words;
    for (int k = tid; k < R * H; k += THREADS) {
      const bool on = (bj[k / 32] >> (k % 32)) & 1u;
      const float dpre = on ? acc[k] : 0.f;
      acc[k] = dpre;
      h[k] = __float2bfloat16(dpre);  // the cotangent's bf16 operand
    }
    __syncthreads();
    const float* wxj = wx + (size_t)j * 4 * H;
    for (int r = warp; r < R; r += WARPS) {
      float p0 = 0.f, p1 = 0.f, p2 = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float d = acc[r * H + c];
        p0 += d * wxj[c];
        p1 += d * wxj[H + c];
        p2 += d * wxj[2 * H + c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        p0 += __shfl_down_sync(0xffffffffu, p0, off);
        p1 += __shfl_down_sync(0xffffffffu, p1, off);
        p2 += __shfl_down_sync(0xffffffffu, p2, off);
      }
      if (lane == 0) {
        sdx[r * 3 + 0] += p0;
        sdx[r * 3 + 1] += p1;
        sdx[r * 3 + 2] += p2;
      }
    }
    if (BWD) {
      // this block's sum over its points, rows in order
      float* pj = partial + ((size_t)blockIdx.x * (nh + 1) + j) * H;
      for (int c = tid; c < H; c += THREADS) {
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += acc[r * H + c];
        pj[c] = s;
      }
    }
    __syncthreads();
    if (j > 0) {
      // dh_{j-1} = bf16(dpre) @ ws_{j-1}^T: contract the output dimension
      tile_product<RT, wmma::col_major>(h, ws + (size_t)(j - 1) * H * H, H,
                                        acc, warp);
      __syncthreads();
    }
  }

  for (int k = tid; k < R * 3; k += THREADS) {
    const int r = k / 3, d = k % 3;
    if (row0 + r >= n) continue;
    if (BWD)
      out[(size_t)row0 * 3 + k] = sdx[k];
    else
      out[(size_t)(row0 + r) * 4 + 1 + d] = sdx[k];
  }
}

// d_cvec (nh+1, H) = sum over blocks of the partials, in block order, for
// crop y (its partials at partial + y * blocks * size); REDUCE_LOADS loads
// in flight per thread ahead of their sums.
constexpr int REDUCE_THREADS = 64;
constexpr int REDUCE_LOADS = 8;

__global__ void __launch_bounds__(REDUCE_THREADS)
dcvec_reduce_kernel(const float* __restrict__ partial, int blocks, int size,
                    float* __restrict__ dcvec) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= size) return;
  const size_t crop = blockIdx.y;
  const float* col = partial + crop * blocks * size + i;
  float s = 0.f;
  int b = 0;
  for (; b + REDUCE_LOADS <= blocks; b += REDUCE_LOADS) {
    float v[REDUCE_LOADS];
#pragma unroll
    for (int u = 0; u < REDUCE_LOADS; ++u)
      v[u] = col[(size_t)(b + u) * size];
#pragma unroll
    for (int u = 0; u < REDUCE_LOADS; ++u) s += v[u];
  }
  for (; b < blocks; ++b) s += col[(size_t)b * size];
  dcvec[crop * size + i] = s;
}

int reduce_dcvec(const void* partial, int batch, int blocks, int size,
                 void* dcvec, cudaStream_t s) {
  const dim3 grid((size + REDUCE_THREADS - 1) / REDUCE_THREADS, batch);
  dcvec_reduce_kernel<<<grid, REDUCE_THREADS, 0, s>>>(
      (const float*)partial, blocks, size, (float*)dcvec);
  return (int)cudaGetLastError();
}

template <int RT, bool BWD>
int launch(const void* xyz, const void* ws, const void* wx, const void* cvec,
           const void* wlast, const void* scal, const void* ct_in, int batch,
           int n, int H, int nh, int use_tanh, void* out, void* partial,
           cudaStream_t stream) {
  constexpr int R = RT * 16;
  const size_t smem = smem_bytes(R, H, nh);
  cudaError_t err = cudaFuncSetAttribute(
      stage2_kernel<RT, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((n + R - 1) / R, batch);
  stage2_kernel<RT, BWD><<<blocks, THREADS, smem, stream>>>(
      (const float*)xyz, (const __nv_bfloat16*)ws, (const float*)wx,
      (const float*)cvec, (const float*)wlast, (const float*)scal,
      (const float*)ct_in, n, H, nh, use_tanh, (float*)out, (float*)partial);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(int R, const void* xyz, const void* ws, const void* wx,
             const void* cvec, const void* wlast, const void* scal,
             const void* ct_in, int batch, int n, int H, int nh, int use_tanh,
             void* out, void* partial, cudaStream_t s) {
  switch (R) {
    case 64:
      return launch<4, BWD>(xyz, ws, wx, cvec, wlast, scal, ct_in, batch, n,
                            H, nh, use_tanh, out, partial, s);
    case 32:
      return launch<2, BWD>(xyz, ws, wx, cvec, wlast, scal, ct_in, batch, n,
                            H, nh, use_tanh, out, partial, s);
    case 16:
      return launch<1, BWD>(xyz, ws, wx, cvec, wlast, scal, ct_in, batch, n,
                            H, nh, use_tanh, out, partial, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

constexpr int STAGE2_STAGES = 3;

using mlpw::Mode;

template <int H>
__global__ void __launch_bounds__(mlpw::THREADS, 1)
stage2_fwd_wgmma_kernel(const float* __restrict__ xyz,
                        const __nv_bfloat16* __restrict__ tiles,
                        const __nv_bfloat16* __restrict__ tiles_t,
                        const float* __restrict__ wx,
                        const float* __restrict__ cvec,
                        const float* __restrict__ wlast,
                        const float* __restrict__ scal, int n, int nh,
                        int use_tanh, float* __restrict__ out) {
  const size_t b = blockIdx.y;  // the crop
  mlpw::mlp_body<H, STAGE2_STAGES, Mode::STAGE2_FWD>(
      xyz + b * n * 3, tiles, tiles_t, wx, cvec + b * (nh + 1) * H, wlast,
      scal, nullptr, n, nh, use_tanh, out + b * n * 4, nullptr);
}

template <int H>
__global__ void __launch_bounds__(mlpw::THREADS, 1)
stage2_bwd_wgmma_kernel(const float* __restrict__ xyz,
                        const __nv_bfloat16* __restrict__ tiles,
                        const __nv_bfloat16* __restrict__ tiles_t,
                        const float* __restrict__ wx,
                        const float* __restrict__ cvec,
                        const float* __restrict__ wlast,
                        const float* __restrict__ scal,
                        const float* __restrict__ ct, int n, int nh,
                        int use_tanh, float* __restrict__ dxyz,
                        float* __restrict__ partial) {
  const size_t b = blockIdx.y;  // the crop: its own rows of partials
  mlpw::mlp_body<H, STAGE2_STAGES, Mode::STAGE2_BWD>(
      xyz + b * n * 3, tiles, tiles_t, wx, cvec + b * (nh + 1) * H, wlast,
      scal, ct + b * n, n, nh, use_tanh, dxyz + b * n * 3,
      partial + b * gridDim.x * (nh + 1) * H);
}

template <int H>
int launch_wgmma(const void* xyz, const void* tiles, const void* tiles_t,
                 const void* wx, const void* cvec, const void* wlast,
                 const void* scal, int batch, int n, int nh, int use_tanh,
                 int cluster, void* out, cudaStream_t stream) {
  return mlpw::launch_clustered(
      stage2_fwd_wgmma_kernel<H>,
      mlpw::smem_bytes<H, STAGE2_STAGES, Mode::STAGE2_FWD>(nh), n, cluster,
      batch, stream, (const float*)xyz, (const __nv_bfloat16*)tiles,
      (const __nv_bfloat16*)tiles_t, (const float*)wx, (const float*)cvec,
      (const float*)wlast, (const float*)scal, n, nh, use_tanh, (float*)out);
}

template <int H>
int launch_wgmma_bwd(const void* xyz, const void* tiles, const void* tiles_t,
                     const void* wx, const void* cvec, const void* wlast,
                     const void* scal, const void* ct, int batch, int n,
                     int nh, int use_tanh, int cluster, void* dxyz,
                     void* partial, cudaStream_t stream) {
  return mlpw::launch_clustered(
      stage2_bwd_wgmma_kernel<H>,
      mlpw::smem_bytes<H, STAGE2_STAGES, Mode::STAGE2_BWD>(nh), n, cluster,
      batch, stream, (const float*)xyz, (const __nv_bfloat16*)tiles,
      (const __nv_bfloat16*)tiles_t, (const float*)wx, (const float*)cvec,
      (const float*)wlast, (const float*)scal, (const float*)ct, n, nh,
      use_tanh, (float*)dxyz, (float*)partial);
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Points per block for width H and nh hidden products: 64, 32 or 16, or 0
// when even 16 do not fit in shared memory.
int stage2_tile(int H, int nh) {
  for (int R = 64; R >= 16; R /= 2)
    if (smem_bytes(R, H, nh) <= SMEM_LIMIT) return R;
  return 0;
}

// Kernel 4a, the wmma design, for `batch` crops. xyz (batch, n, 3) f32;
// ws (nh, H, H) bf16 [in, out]; wx (nh+1, 4, H) f32; cvec (batch, nh+1, H)
// f32; wlast (H,) f32; scal (4,) f32 -> out (batch, n, 4) f32.
int stage2_fwd(const void* xyz, const void* ws, const void* wx,
               const void* cvec, const void* wlast, const void* scal,
               int batch, int n, int H, int nh, int use_tanh, void* out,
               void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (H % 16 != 0 || nh < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(stage2_tile(H, nh), xyz, ws, wx, cvec, wlast, scal,
                         nullptr, batch, n, H, nh, use_tanh, out, nullptr,
                         (cudaStream_t)stream);
}

// Kernel 4b. As 4a plus ct (batch, n) f32 -> dxyz (batch, n, 3) f32, dcvec
// (batch, nh+1, H) f32; partial is scratch of batch * ceil(n / stage2_tile)
// * (nh+1) * H floats.
int stage2_bwd(const void* xyz, const void* ws, const void* wx,
               const void* cvec, const void* wlast, const void* scal,
               const void* ct, int batch, int n, int H, int nh, int use_tanh,
               void* dxyz, void* dcvec, void* partial, void* stream) {
  if (H % 16 != 0 || nh < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int size = (nh + 1) * H;
  if (n <= 0)
    return (int)cudaMemsetAsync(dcvec, 0, (size_t)batch * size * 4, s);
  const int R = stage2_tile(H, nh);
  const int err = dispatch<true>(R, xyz, ws, wx, cvec, wlast, scal, ct, batch,
                                 n, H, nh, use_tanh, dxyz, partial, s);
  if (err != 0) return err;
  return reduce_dcvec(partial, batch, (n + R - 1) / R, size, dcvec, s);
}

// Dynamic shared memory of 4a's wgmma design at width H and nh hidden
// products, in bytes.
int stage2_fwd_wgmma_smem(int H, int nh) {
  return (int)mlpw::Smem(H, STAGE2_STAGES, nh + 1).total;
}

// The same for 4b's wgmma design (4a's map plus the column-sum exchange).
int stage2_bwd_wgmma_smem(int H, int nh) {
  return (int)mlpw::Smem(H, STAGE2_STAGES, nh + 1, true).total;
}

// 1 when 4b at width H and nh hidden products takes the wgmma design
// (stage2_bwd_wgmma), else 0 (stage2_bwd).
int stage2_bwd_wgmma_fits(int H, int nh) {
  return mlpw::width_ok(H) && nh >= 1 &&
         (size_t)stage2_bwd_wgmma_smem(H, nh) <= mlpw::SMEM_LIMIT;
}

// CTAs, and so d_cvec partials, of a wgmma launch over n points:
// ceil(n / 64) rounded up to whole clusters.
int stage2_wgmma_blocks(int n, int cluster) {
  const int tiles = (n + mlpw::ROWS - 1) / mlpw::ROWS;
  return (tiles + cluster - 1) / cluster * cluster;
}

// 1 when 4a at width H and nh hidden products takes the wgmma design
// (stage2_fwd_wgmma), else 0 (stage2_fwd).
int stage2_fwd_wgmma_fits(int H, int nh) {
  return mlpw::width_ok(H) && nh >= 1 &&
         (size_t)stage2_fwd_wgmma_smem(H, nh) <= mlpw::SMEM_LIMIT;
}

// Kernel 4a, the wgmma design. As stage2_fwd, with tiles and tiles_t (nh,
// H / 32, 32 * H) bf16 in place of ws: the packed slices of ws_j and of
// ws_j^T (ops/mlp_cuda.py tile_stack); cluster CTAs (1..4) of one crop
// share each slice.
int stage2_fwd_wgmma(const void* xyz, const void* tiles, const void* tiles_t,
                     const void* wx, const void* cvec, const void* wlast,
                     const void* scal, int batch, int n, int H, int nh,
                     int use_tanh, int cluster, void* out, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (!stage2_fwd_wgmma_fits(H, nh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 128:
      return launch_wgmma<128>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                               batch, n, nh, use_tanh, cluster, out, s);
    case 256:
      return launch_wgmma<256>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                               batch, n, nh, use_tanh, cluster, out, s);
    case 384:
      return launch_wgmma<384>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                               batch, n, nh, use_tanh, cluster, out, s);
    default:
      return launch_wgmma<512>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                               batch, n, nh, use_tanh, cluster, out, s);
  }
}

// Kernel 4b, the wgmma design. As stage2_bwd, with tiles and tiles_t in
// place of ws (as stage2_fwd_wgmma) and cluster CTAs (1..4) of one crop
// sharing each slice; partial is scratch of batch * stage2_wgmma_blocks(n,
// cluster) * (nh+1) * H floats.
int stage2_bwd_wgmma(const void* xyz, const void* tiles, const void* tiles_t,
                     const void* wx, const void* cvec, const void* wlast,
                     const void* scal, const void* ct, int batch, int n,
                     int H, int nh, int use_tanh, int cluster, void* dxyz,
                     void* dcvec, void* partial, void* stream) {
  if (!stage2_bwd_wgmma_fits(H, nh) || cluster < 1 ||
      cluster > mlpw::MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int size = (nh + 1) * H;
  if (n <= 0)
    return (int)cudaMemsetAsync(dcvec, 0, (size_t)batch * size * 4, s);
  int err;
  switch (H) {
    case 128:
      err = launch_wgmma_bwd<128>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                                  ct, batch, n, nh, use_tanh, cluster, dxyz,
                                  partial, s);
      break;
    case 256:
      err = launch_wgmma_bwd<256>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                                  ct, batch, n, nh, use_tanh, cluster, dxyz,
                                  partial, s);
      break;
    case 384:
      err = launch_wgmma_bwd<384>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                                  ct, batch, n, nh, use_tanh, cluster, dxyz,
                                  partial, s);
      break;
    default:
      err = launch_wgmma_bwd<512>(xyz, tiles, tiles_t, wx, cvec, wlast, scal,
                                  ct, batch, n, nh, use_tanh, cluster, dxyz,
                                  partial, s);
  }
  if (err != 0) return err;
  return reduce_dcvec(partial, batch, stage2_wgmma_blocks(n, cluster), size,
                      dcvec, s);
}

}  // extern "C"
