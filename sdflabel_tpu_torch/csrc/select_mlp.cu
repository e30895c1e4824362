// Stage-1 band-selection decode: the folded DeepSDF MLP on every grid point.
//
// Replaces sdflabel_tpu/ops/mlp_pallas.py::select_mlp_apply
// (_select_kernel). Same math as ops/mlp_cuda.py::emulate_select_mlp:
//   h0 = relu(c0 + xyz . wx0)
//   h_{j+1} = relu(bf16(h_j) @ ws_j + c_{j+1} + xyz . wx_{j+1})  (fp32 acc)
//   s = tanh(h_nh . wlast + b_last + xyz . w_last)  (tanh again if use_tanh)
// where c_j = bias_j + latent @ wlat_j is absorbed by the wrapper. The
// output only ranks |sdf|; it carries no gradient.
//
// Crop axis (the batched driver, as the TPU kernel gains a batch grid axis
// under vmap): B crops rank the same weights with their own latents, so a
// launch takes B absorbed cvec rows (nh+1, H) and points shared by every
// crop (crop stride 0, the refresh's 64000 grid points) or their own (crop
// stride n * 3). Crop b runs on grid row y = b; a cluster spans x only, so
// a multicast weight slice feeds that crop's tiles, and the L2 serves the
// same slices to the other crops. Each crop's output is bit-equal to its
// launch alone (B = 1).
//
// Bound on the H100: bf16 tensor-core operations, 2 * nh * H * H per point
// (235 GFLOP for 64000 points through the 8x512 decoder); bytes are the
// points, the 3.7 MB weight stack and the output. Two designs, chosen by
// width:
// - H in {128, 256, 384, 512} (the reference 8x512 decoder):
//   select_wgmma_kernel, the Hopper design of mlp_wgmma.cuh -- wgmma with
//   register accumulators on pre-packed weight slices that a cluster of
//   CTAs shares through bulk-copy multicast, so each weight byte read from
//   L2 feeds 64 * cluster points and the ring keeps slices in flight across
//   layers.
// - wider layers (multiples of 128 up to the packer's 2304): the first
//   design, kept as it was: each block keeps one tile of R points on chip
//   across all layers (bf16 activations plus an fp32 accumulator tile) and
//   streams each layer's weights from L2 into nvcuda::wmma fragments; the
//   epilogue runs from the accumulator tile; the last layer's H -> 1
//   product is a warp reduction per point.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "mlp_wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float xyz_dot(const float* x, const float* w,
                                         int H, int c) {
  // x0*w0 + x1*w1 + x2*w2 left-associated, as the JAX kernel's xyz_contrib
  return x[0] * w[c] + x[1] * w[H + c] + x[2] * w[2 * H + c];
}

template <int RT>
__global__ void __launch_bounds__(THREADS)
select_mlp_kernel(const float* __restrict__ xyz,
                  const __nv_bfloat16* __restrict__ ws,
                  const float* __restrict__ wx, const float* __restrict__ cvec,
                  const float* __restrict__ wlast,
                  const float* __restrict__ scal, int xyz_stride, int n,
                  int H, int nh, int use_tanh, float* __restrict__ out) {
  constexpr int R = RT * 16;  // points per block
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t b = blockIdx.y;  // the crop
  xyz += b * xyz_stride;
  cvec += b * (nh + 1) * H;
  out += b * n;
  float* acc = reinterpret_cast<float*>(smem);                       // R x H
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(acc + R * H);  // R x H
  float* sx = reinterpret_cast<float*>(h + R * H);                   // R x 3
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int k = tid; k < R * 3; k += THREADS) {
    const int r = k / 3;
    sx[k] = row0 + r < n ? xyz[(size_t)row0 * 3 + k] : 0.f;
  }
  __syncthreads();

  // layer 0: broadcast fp32 multiply-adds (K = 3 xyz + absorbed latent)
  for (int k = tid; k < R * H; k += THREADS) {
    const int r = k / H, c = k % H;
    const float v = cvec[c] + xyz_dot(&sx[r * 3], wx, H, c);
    h[k] = __float2bfloat16(fmaxf(v, 0.f));
  }
  __syncthreads();

  const int CT = H / 16;
  for (int j = 0; j < nh; ++j) {
    const __nv_bfloat16* W = ws + (size_t)j * H * H;
    for (int ct = warp; ct < CT; ct += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) wmma::fill_fragment(c[r], 0.f);
      for (int k = 0; k < H; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, W + (size_t)k * H + ct * 16, H);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(a, h + r * 16 * H + k, H);
          wmma::mma_sync(c[r], a, b, c[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
        wmma::store_matrix_sync(acc + r * 16 * H + ct * 16, c[r], H,
                                wmma::mem_row_major);
    }
    __syncthreads();
    const float* wxj = wx + (size_t)(j + 1) * 4 * H;
    const float* cj = cvec + (size_t)(j + 1) * H;
    if (j + 1 < nh) {
      for (int k = tid; k < R * H; k += THREADS) {
        const int r = k / H, c = k % H;
        const float v = acc[k] + cj[c] + xyz_dot(&sx[r * 3], wxj, H, c);
        h[k] = __float2bfloat16(fmaxf(v, 0.f));
      }
      __syncthreads();
    } else {
      // last hidden layer stays fp32 into the H -> 1 product: warp per row
      for (int r = warp; r < R; r += WARPS) {
        float part = 0.f;
        for (int c = lane; c < H; c += 32) {
          const float v =
              acc[r * H + c] + cj[c] + xyz_dot(&sx[r * 3], wxj, H, c);
          part += fmaxf(v, 0.f) * wlast[c];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_down_sync(0xffffffffu, part, off);
        if (lane == 0 && row0 + r < n) {
          const float* x = &sx[r * 3];
          float s = part + scal[0];
          s = s + x[0] * scal[1] + x[1] * scal[2] + x[2] * scal[3];
          s = tanhf(s);
          if (use_tanh) s = tanhf(s);
          out[row0 + r] = s;
        }
      }
    }
  }
}

template <int RT>
int launch(const void* xyz, const void* ws, const void* wx, const void* cvec,
           const void* wlast, const void* scal, int batch, int xyz_stride,
           int n, int H, int nh, int use_tanh, void* out,
           cudaStream_t stream) {
  constexpr int R = RT * 16;
  const size_t smem = (size_t)R * H * (4 + 2) + R * 3 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      select_mlp_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((n + R - 1) / R, batch);
  select_mlp_kernel<RT><<<blocks, THREADS, smem, stream>>>(
      (const float*)xyz, (const __nv_bfloat16*)ws, (const float*)wx,
      (const float*)cvec, (const float*)wlast, (const float*)scal,
      xyz_stride, n, H, nh, use_tanh, (float*)out);
  return (int)cudaGetLastError();
}

constexpr int SELECT_STAGES = 4;

template <int H>
__global__ void __launch_bounds__(mlpw::THREADS, 1)
select_wgmma_kernel(const float* __restrict__ xyz,
                    const __nv_bfloat16* __restrict__ tiles,
                    const float* __restrict__ wx,
                    const float* __restrict__ cvec,
                    const float* __restrict__ wlast,
                    const float* __restrict__ scal, int xyz_stride, int n,
                    int nh, int use_tanh, float* __restrict__ out) {
  const size_t b = blockIdx.y;  // the crop
  mlpw::mlp_body<H, SELECT_STAGES, mlpw::Mode::SELECT>(
      xyz + b * xyz_stride, tiles, nullptr, wx, cvec + b * (nh + 1) * H,
      wlast, scal, nullptr, n, nh, use_tanh, out + b * n, nullptr);
}

template <int H>
int launch_wgmma(const void* xyz, const void* tiles, const void* wx,
                 const void* cvec, const void* wlast, const void* scal,
                 int batch, int xyz_stride, int n, int nh, int use_tanh,
                 int cluster, void* out, cudaStream_t stream) {
  return mlpw::launch_clustered(
      select_wgmma_kernel<H>,
      mlpw::smem_bytes<H, SELECT_STAGES, mlpw::Mode::SELECT>(nh),
      n, cluster, batch, stream, (const float*)xyz,
      (const __nv_bfloat16*)tiles, (const float*)wx, (const float*)cvec,
      (const float*)wlast, (const float*)scal, xyz_stride, n, nh, use_tanh,
      (float*)out);
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest point tile for width H: 64, 32 or 16 points, or 0 when even 16
// rows of activations do not fit in shared memory.
int select_mlp_tile(int H) {
  const size_t limit = 232448;  // 227 KB opt-in dynamic shared memory
  for (int R = 64; R >= 16; R /= 2)
    if ((size_t)R * H * 6 + R * 12 <= limit) return R;
  return 0;
}

// The wmma design. xyz: crop b's (n, 3) f32 points at xyz + b *
// xyz_stride (0: one set for every crop); ws (nh, H, H) bf16 [in, out]; wx
// (nh+1, 4, H) f32; cvec (batch, nh+1, H) f32; wlast (H,) f32; scal (4,)
// f32 -> out (batch, n) f32.
int select_mlp(const void* xyz, const void* ws, const void* wx,
               const void* cvec, const void* wlast, const void* scal,
               int batch, int xyz_stride, int n, int H, int nh, int use_tanh,
               void* out, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (H % 16 != 0 || nh < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (select_mlp_tile(H)) {
    case 64:
      return launch<4>(xyz, ws, wx, cvec, wlast, scal, batch, xyz_stride, n,
                       H, nh, use_tanh, out, s);
    case 32:
      return launch<2>(xyz, ws, wx, cvec, wlast, scal, batch, xyz_stride, n,
                       H, nh, use_tanh, out, s);
    case 16:
      return launch<1>(xyz, ws, wx, cvec, wlast, scal, batch, xyz_stride, n,
                       H, nh, use_tanh, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// 1 when width H takes the wgmma design (select_mlp_wgmma), else 0 (the
// wmma design, select_mlp).
int select_mlp_wgmma_fits(int H) {
  return mlpw::width_ok(H) &&
         mlpw::Smem(H, SELECT_STAGES, 0).total <= mlpw::SMEM_LIMIT;
}

// Dynamic shared memory of the wgmma design at width H, in bytes.
int select_mlp_wgmma_smem(int H) {
  return (int)mlpw::Smem(H, SELECT_STAGES, 0).total;
}

// The wgmma design. tiles (nh, H / 32, 32 * H) bf16, the packed slices of
// ops/mlp_cuda.py tile_stack; xyz, xyz_stride, wx, cvec, wlast, scal as
// select_mlp; cluster CTAs (1..4) share each slice -> out (batch, n) f32.
int select_mlp_wgmma(const void* xyz, const void* tiles, const void* wx,
                     const void* cvec, const void* wlast, const void* scal,
                     int batch, int xyz_stride, int n, int H, int nh,
                     int use_tanh, int cluster, void* out, void* stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (nh < 1 || !select_mlp_wgmma_fits(H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 128:
      return launch_wgmma<128>(xyz, tiles, wx, cvec, wlast, scal, batch,
                               xyz_stride, n, nh, use_tanh, cluster, out, s);
    case 256:
      return launch_wgmma<256>(xyz, tiles, wx, cvec, wlast, scal, batch,
                               xyz_stride, n, nh, use_tanh, cluster, out, s);
    case 384:
      return launch_wgmma<384>(xyz, tiles, wx, cvec, wlast, scal, batch,
                               xyz_stride, n, nh, use_tanh, cluster, out, s);
    default:
      return launch_wgmma<512>(xyz, tiles, wx, cvec, wlast, scal, batch,
                               xyz_stride, n, nh, use_tanh, cluster, out, s);
  }
}

}  // extern "C"
