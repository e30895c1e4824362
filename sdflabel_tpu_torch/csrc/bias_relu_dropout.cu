// The train-mode hidden layer of the DeepSDF decoder after its matrix
// product: bias add, ReLU and inverted dropout, forward and backward.
//
// Replaces no Pallas kernel: the JAX package computes this chain in XLA
// (sdflabel_tpu/models/deepsdf.py). In PyTorch the chain runs as six
// elementwise passes forward (add, relu, the uniforms, the compare, the
// scale, the select) and four backward (where, div, threshold, the bias's
// column sum) over an (R, C) fp32 tensor; these kernels run one pass each
// way. For z = x @ w (R, C), bias b (C), uniforms u (R, C) and the kept
// share `keep`:
//
//   y  = (u < keep) ? relu(z + b) * inv_keep : 0,   inv_keep = 1 / keep
//   gz = (y > 0) ? g * inv_keep : 0,                gb = sum_rows gz
//
// The arithmetic is PyTorch's on the card: the add and the compare in
// fp32, relu as max(s, 0), and the division by the Python scalar keep
// done as a product with its fp32 reciprocal (computed by the wrapper as
// PyTorch's CUDA division by a CPU scalar does). So y and gz are
// bit-equal to the chain on finite inputs. `y > 0` is the chain's
// relu-and-mask test: y is relu(z + b) * inv_keep where kept, else 0.
//
// Bound on the H100: bytes. At the DeepSDF training shape (1,048,576 x
// 512 fp32, T = 2.15 GB) the forward reads z and u and writes y (3 T,
// ~1.92 ms at 3.35 TB/s); the backward reads g and y and writes gz (3 T)
// for one add per element. The chain moves ~18.75 T a layer.
//
// Design: a CTA of bx x by threads (at most 256) takes a tile of rows with
// every column. Thread (tx, ty) holds VEC adjacent columns (a float4 for
// C % 4 == 0 and 16-byte aligned operands, a float2 for C = 506's 8-byte
// rows, else one float) and walks the tile's rows ty, ty + by, ...,
// UNROLL rows' loads issued before any arithmetic: a warp reads 512
// contiguous bytes a load. The bias stays in registers. The tile's rows
// are cut so that the grid is about TARGET_CTAS CTAs (ops/dropout_cuda.py
// ::plan): a wave or two on 132 SMs. Loads that are read once (z, u, g)
// take the streaming hint.
//
// The bias gradient: each thread adds its rows' gz in row order; the CTA
// adds its by threads' sums in order through shared memory and writes one
// partial row (ctas, C); brd_reduce_kernel then adds the partials of each
// column in CTA order (its warps over contiguous ranges, then the warps'
// sums in order; the wrapper gives the warp count, which its round-off
// bound reads). Fixed orders and no atomics: two launches are bit-equal.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int UNROLL = 4;            // rows a thread loads before arithmetic
constexpr int REDUCE_COLS = 32;      // reduce: columns a CTA (one a lane)
constexpr int MAX_REDUCE_WARPS = 32; // reduce: CTA ranges summed in order
constexpr int REDUCE_LOADS = 8;      // reduce: loads in flight a thread

template <int VEC>
__device__ __forceinline__ void load_stream(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_keep(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// y (rows, cols) from z (rows, cols), b (cols) and u (rows, cols), all
// contiguous; CTA blockIdx.x takes rows [blockIdx.x * tile, + tile).
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
brd_fwd_kernel(const float* __restrict__ z, const float* __restrict__ b,
               const float* __restrict__ u, long long rows, int cols,
               long long tile, float keep, float inv_keep,
               float* __restrict__ y) {
  const int bx = blockDim.x, by = blockDim.y;
  const int cvs = cols / VEC;
  const long long r0 = (long long)blockIdx.x * tile;
  const long long r1 = r0 + tile < rows ? r0 + tile : rows;
  for (int cv = threadIdx.x; cv < cvs; cv += bx) {
    const int c = cv * VEC;
    float bias[VEC];
    load_keep<VEC>(b + c, bias);
    for (long long r = r0 + threadIdx.y; r < r1; r += (long long)by * UNROLL) {
      float zv[UNROLL][VEC], uv[UNROLL][VEC];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long row = r + (long long)k * by;
        if (row < r1) {
          const size_t off = (size_t)row * cols + c;
          load_stream<VEC>(z + off, zv[k]);
          load_stream<VEC>(u + off, uv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long row = r + (long long)k * by;
        if (row < r1) {
          float out[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float s = zv[k][j] + bias[j];
            const float relu = s < 0.f ? 0.f : s;  // max(s, 0), NaN kept
            out[j] = uv[k][j] < keep ? relu * inv_keep : 0.f;
          }
          store<VEC>(y + (size_t)row * cols + c, out);
        }
      }
    }
  }
}

// gz (rows, cols) contiguous from g (rows, cols; row stride g_stride) and
// y (rows, cols) contiguous; partial (ctas, cols): each CTA's column sums
// of gz. Shared memory: by * bx * VEC floats.
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
brd_bwd_kernel(const float* __restrict__ g, long long g_stride,
               const float* __restrict__ y, long long rows, int cols,
               long long tile, float inv_keep, float* __restrict__ gz,
               float* __restrict__ partial) {
  extern __shared__ float sums[];
  const int bx = blockDim.x, by = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cvs = cols / VEC;
  const long long r0 = (long long)blockIdx.x * tile;
  const long long r1 = r0 + tile < rows ? r0 + tile : rows;
  // every thread takes every pass of this loop: the barriers below
  for (int cv0 = 0; cv0 < cvs; cv0 += bx) {
    const int cv = cv0 + tx;
    const bool active = cv < cvs;
    const int c = cv * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    if (active) {
      for (long long r = r0 + ty; r < r1; r += (long long)by * UNROLL) {
        float gv[UNROLL][VEC], yv[UNROLL][VEC];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const long long row = r + (long long)k * by;
          if (row < r1) {
            load_stream<VEC>(g + (size_t)row * g_stride + c, gv[k]);
            load_stream<VEC>(y + (size_t)row * cols + c, yv[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const long long row = r + (long long)k * by;
          if (row < r1) {
            float out[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              out[j] = yv[k][j] > 0.f ? gv[k][j] * inv_keep : 0.f;
              acc[j] += out[j];
            }
            store<VEC>(gz + (size_t)row * cols + c, out);
          }
        }
      }
    }
    if (by > 1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sums[(ty * bx + tx) * VEC + j] = acc[j];
      __syncthreads();
      if (ty == 0) {
        for (int t = 1; t < by; ++t) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += sums[(t * bx + tx) * VEC + j];
        }
      }
      __syncthreads();
    }
    if (ty == 0 && active) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        partial[(size_t)blockIdx.x * cols + c + j] = acc[j];
    }
  }
}

// gb (cols) = the sum over CTAs, in CTA order, of partial (ctas, cols):
// warp w of the blockDim.y warps of a CTA adds CTAs [w * span, (w + 1) *
// span) for the CTA's 32 columns (one a lane), then lane-wise the warps'
// sums in order.
__global__ void __launch_bounds__(REDUCE_COLS * MAX_REDUCE_WARPS)
brd_reduce_kernel(const float* __restrict__ partial, int ctas, int cols,
                  float* __restrict__ gb) {
  __shared__ float sums[MAX_REDUCE_WARPS][REDUCE_COLS];
  const int lane = threadIdx.x, warp = threadIdx.y, warps = blockDim.y;
  const int c = blockIdx.x * REDUCE_COLS + lane;
  const int span = (ctas + warps - 1) / warps;
  const int lo = warp * span;
  const int hi = lo + span < ctas ? lo + span : ctas;
  float s = 0.f;
  if (c < cols) {
    const float* col = partial + c;
    int i = lo;
    for (; i + REDUCE_LOADS <= hi; i += REDUCE_LOADS) {
      float v[REDUCE_LOADS];
#pragma unroll
      for (int k = 0; k < REDUCE_LOADS; ++k) v[k] = col[(size_t)(i + k) * cols];
#pragma unroll
      for (int k = 0; k < REDUCE_LOADS; ++k) s += v[k];
    }
    for (; i < hi; ++i) s += col[(size_t)i * cols];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float t = sums[0][lane];
    for (int w = 1; w < warps; ++w) t += sums[w][lane];
    gb[c] = t;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the launch shape ops/dropout_cuda.py::plan chose, checked
bool shape_ok(int vec, int cols, int bx, int by, long long tile) {
  return (vec == 1 || vec == 2 || vec == 4) && cols > 0 && cols % vec == 0 &&
         bx > 0 && by > 0 && bx * by <= MAX_THREADS && tile > 0;
}

}  // namespace

extern "C" {

const char* sdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Forward: z, u, y (rows, cols) contiguous float32, b (cols); `vec`
// columns a thread (z, b, u and y aligned to 4 * vec bytes), a bx x by
// CTA, `tile` rows a CTA, `ctas` CTAs.
int brd_forward(const void* z, const void* b, const void* u, long long rows,
                int cols, int vec, int bx, int by, long long tile, int ctas,
                float keep, float inv_keep, void* y, void* stream) {
  if (rows == 0) return 0;
  if (!shape_ok(vec, cols, bx, by, tile) || ctas <= 0 ||
      (long long)ctas * tile < rows)
    return (int)cudaErrorInvalidValue;
  const int a = 4 * vec;
  if (!aligned(z, a) || !aligned(b, a) || !aligned(u, a) || !aligned(y, a))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(bx, by);
  const float* zf = (const float*)z;
  const float* bf = (const float*)b;
  const float* uf = (const float*)u;
  float* yf = (float*)y;
  if (vec == 4)
    brd_fwd_kernel<4><<<ctas, block, 0, s>>>(zf, bf, uf, rows, cols, tile,
                                             keep, inv_keep, yf);
  else if (vec == 2)
    brd_fwd_kernel<2><<<ctas, block, 0, s>>>(zf, bf, uf, rows, cols, tile,
                                             keep, inv_keep, yf);
  else
    brd_fwd_kernel<1><<<ctas, block, 0, s>>>(zf, bf, uf, rows, cols, tile,
                                             keep, inv_keep, yf);
  return (int)cudaGetLastError();
}

// Backward: g (rows, cols) float32 with row stride g_stride (elements), y
// and gz (rows, cols) contiguous -> gz and partial (ctas, cols); `vec`
// as the forward's (g_stride a multiple of it).
int brd_backward(const void* g, long long g_stride, const void* y,
                 long long rows, int cols, int vec, int bx, int by,
                 long long tile, int ctas, float inv_keep, void* gz,
                 void* partial, void* stream) {
  if (rows == 0) return 0;
  if (!shape_ok(vec, cols, bx, by, tile) || ctas <= 0 ||
      (long long)ctas * tile < rows || g_stride < cols || g_stride % vec)
    return (int)cudaErrorInvalidValue;
  const int a = 4 * vec;
  if (!aligned(g, a) || !aligned(y, a) || !aligned(gz, a))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(bx, by);
  const size_t smem = (size_t)bx * by * vec * sizeof(float);
  const float* gf = (const float*)g;
  const float* yf = (const float*)y;
  float* gzf = (float*)gz;
  float* pf = (float*)partial;
  if (vec == 4)
    brd_bwd_kernel<4><<<ctas, block, smem, s>>>(gf, g_stride, yf, rows, cols,
                                                tile, inv_keep, gzf, pf);
  else if (vec == 2)
    brd_bwd_kernel<2><<<ctas, block, smem, s>>>(gf, g_stride, yf, rows, cols,
                                                tile, inv_keep, gzf, pf);
  else
    brd_bwd_kernel<1><<<ctas, block, smem, s>>>(gf, g_stride, yf, rows, cols,
                                                tile, inv_keep, gzf, pf);
  return (int)cudaGetLastError();
}

// gb (cols) = the column sums of partial (ctas, cols), in CTA order, by
// `warps` contiguous ranges of CTAs added in order.
int brd_reduce(const void* partial, int ctas, int cols, int warps, void* gb,
               void* stream) {
  if (ctas <= 0 || cols <= 0 || warps <= 0 || warps > MAX_REDUCE_WARPS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + REDUCE_COLS - 1) / REDUCE_COLS);
  const dim3 block(REDUCE_COLS, warps);
  brd_reduce_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)partial, ctas, cols, (float*)gb);
  return (int)cudaGetLastError();
}

}  // extern "C"
