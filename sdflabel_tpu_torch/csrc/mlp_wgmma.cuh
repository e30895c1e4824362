// The folded DeepSDF MLP on Hopper: wgmma on weight slices that a cluster
// shares through bulk-copy multicast. Included by select_mlp.cu (kernel 3)
// and stage2_mlp.cu (kernels 4a and 4b) for widths H in {128, 256, 384,
// 512}; mlp_body's Mode says which.
//
// What bounds the earlier wmma design (still in those files for wider
// layers): each block of 64 points streamed the whole bf16 stack from L2
// with synchronous fragment loads, nothing in flight, through mma.sync, and
// parked an fp32 R x H tile in shared memory at every layer. One weight
// byte served 64 points; 8 warps could not hide the L2 latency.
//
// The design here, per CTA of 64 points (one wgmma M):
// - Two consumer warpgroups split the H output columns: each runs
//   wgmma.m64n(H/2)k16 with its fp32 accumulator in registers (128 floats
//   a thread at H = 512). A is the bf16 activation tile in shared memory,
//   K-major with the 128-byte swizzle, read by both warpgroups.
// - The weights arrive as pre-packed slices (ops/mlp_cuda.py tile_stack):
//   32 K rows x H columns, already in the K-major 64-byte-swizzle image the
//   B descriptor reads, so one slice is one contiguous block. A ring of
//   STAGES slots holds them. One producer thread per CTA (its warpgroup
//   gives its registers to the consumers: setmaxnreg) copies 1/cluster of
//   every slice with cp.async.bulk ... .multicast::cluster into the same slot
//   of every CTA of its cluster, so each weight byte read from L2 feeds
//   64 * cluster points. A slot is refilled only when both warpgroups of
//   every CTA of the cluster have released it (the "empty" barrier counts
//   2 * cluster remote arrivals); the producer runs across layer boundaries,
//   so the next layer's slices load during this layer's epilogue.
//   The weight stream alone (no products, no epilogue) takes 0.56 ms for
//   kernel 3's 64000 points without sharing, 0.33 ms with clusters of 2,
//   0.30 with 4 (scripts/mlp_wgmma_ablation.py, PERF.md). Clusters of 4
//   run kernels 3 and 4a slower than 2 (the same script), so the wrappers
//   launch clusters of 2.
// - The epilogue runs in registers: + c_{j+1} + xyz . wx_{j+1} (the plain
//   version's order), ReLU, bf16, written in place as the next layer's A in
//   its swizzle once both warpgroups have finished reading this layer's A
//   (named barrier), then fence.proxy.async before the next wgmma. The last
//   layer's H -> 1 dot is quad shuffles and one shared-memory exchange
//   between the two warpgroups. The epilogue does not overlap the tensor
//   cores and is now what bounds the kernel: with the products and the
//   weight stream overlapped (0.36 ms for kernel 3), it adds 0.28 ms of
//   fp32 work and L1 loads of its per-column constants, which each product
//   prefetches for the epilogue after it (prefetch_cols; without it the
//   kernel takes 0.72 ms, not 0.64).
// - Kernels 4a and 4b keep each activation's ReLU sign as one bit in shared
//   memory, in the thread's own accumulator order ((nh+1) * H * 8 bytes),
//   and run the reverse sweep dh_{j-1} = bf16(dpre_j) @ ws_{j-1}^T through
//   a second packed stack (the transposed images), streamed by the same
//   ring after the forward slices. 4b takes the loss cotangent times
//   dt/ds at the last layer (0 for a row past n), writes d_xyz, and sums
//   each layer's d_pre over the CTA's rows: the thread's two rows, the
//   lanes that share lane % 4 (shuffles), then the four warps of the
//   warpgroup in order through an exchange area of 16 * H bytes; a second
//   kernel adds the CTAs' partials. In the 4c crop's device time 4b
//   takes 7% longer than 4a (PERF.md).
// The grid is rounded up to whole clusters; CTAs past n take part in every
// copy and barrier and only mask their stores. Every CTA ends on a cluster
// barrier, so none exits while a peer may still write into it.
//
// scripts/mlp_wgmma_ablation.py builds kernel 3 from copies of this file
// patched at exact lines of text (its PATCHES): the first NB line of
// hidden_epilogue, the wgmma::Mma call of product, the v0 / v1 lines of
// hidden_epilogue, the prefetch of prefetch_cols, the arrive of
// mbar_arrive_remote and the try_wait of mbar_wait. It stops with an error
// when an anchor is gone: edit it with any of those lines.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace mlpw {

constexpr int ROWS = 64;                 // points per CTA
constexpr int KS = 32;                   // K rows per ring slice
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int MAX_CLUSTER = 4;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB opt-in dynamic shared memory

__host__ __device__ constexpr bool width_ok(int H) {
  return H == 128 || H == 256 || H == 384 || H == 512;
}

// What mlp_body computes: kernel 3, kernel 4a or kernel 4b.
enum class Mode { SELECT, STAGE2_FWD, STAGE2_BWD };

// Shared-memory map (bytes from a 1024-aligned base): A tile, ring, sign
// bits (kernels 4a, 4b), xyz, exchanges, 4b's column sums, barriers.
struct Smem {
  uint32_t a, ring, bits, sx, red, ct, dx, ex, full, empty, total;
  __host__ __device__ Smem(int H, int stages, int sign_layers,
                           bool col_sums = false) {
    a = 0;
    ring = a + ROWS * H * 2;
    bits = ring + stages * KS * H * 2;
    sx = bits + sign_layers * CONSUMERS * (H / 128) * 4;
    red = sx + ROWS * 3 * 4;   // per-warpgroup row partials
    ct = red + 2 * ROWS * 4;   // per-row cotangent on s (4a)
    dx = ct + ROWS * 4;        // per-warpgroup d_xyz partials (4a)
    ex = dx + 2 * ROWS * 3 * 4;  // per-warp column sums of d_pre (4b)
    full = ex + (col_sums ? 8 * (H / 2) * 4 : 0);
    empty = full + stages * 8;
    total = empty + stages * 8 + 1024;  // + alignment slack
  }
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
// The default semantics (release at CTA scope), as CUTLASS's cluster
// barrier: with .release.cluster kernel 3 ran 1.1x (cluster 1) to 3.7x
// (cluster 4) slower on the H100 (scripts/mlp_wgmma_ablation.py).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar), "r"(cta) : "memory");
}

// `bytes` from global `src` to the same shared offset `dst` in every CTA of
// `mask`, each CTA's barrier at offset `bar` counting them.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

__device__ __forceinline__ void named_sync() {  // the two warpgroups
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING)
               : "memory");
}

template <int E>
__device__ __forceinline__ void fence_regs(float (&d)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// Shared-memory matrix descriptor: start address, leading offset 16 bytes
// (unused by swizzled K-major operands), stride between 8-row groups, and
// the swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

// Byte offset of A[row][col] in the activation tile: 64-column blocks of
// 64 rows x 128 bytes; the 16-byte chunk c of row r stored at c ^ (r & 7).
__device__ __forceinline__ uint32_t a_offset(int row, int col) {
  return (col >> 6) * (ROWS * 128) + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void st_shared(uint32_t addr, __nv_bfloat162 h) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&h))
               : "memory");
}

__device__ __forceinline__ float xyz_dot(const float (&x)[3], float w0,
                                         float w1, float w2) {
  // x0*w0 + x1*w1 + x2*w2 left-associated, as the plain version's xc(j)
  return x[0] * w0 + x[1] * w1 + x[2] * w2;
}

// Column blocks per batch of epilogue loads.
constexpr int G = 4;

// The epilogue's per-column constants of this thread's two columns in G
// 8-column blocks from col0: c_j (C), the three xyz weights of wx_j, and
// wlast (LAST), loaded once for both of the thread's rows.
template <int H, bool C, bool LAST>
struct Cols {
  float c[G][2], w[G][3][2], last[G][2];
  __device__ __forceinline__ Cols(const float* cj, const float* wxj,
                                  const float* wlast, int col0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = col0 + 8 * g + jj;
        if (C) c[g][jj] = cj[col];
        if (LAST) last[g][jj] = wlast[col];
#pragma unroll
        for (int d = 0; d < 3; ++d) w[g][d][jj] = wxj[d * H + col];
      }
  }
  __device__ __forceinline__ float xc(const float (&x)[3], int g,
                                      int jj) const {
    return xyz_dot(x, w[g][0][jj], w[g][1][jj], w[g][2][jj]);
  }
};

// ------------------------------------------------------------- the kernel

// Pointers into the CTA's shared memory, and where this thread sits.
struct Ctx {
  uint32_t a, ring, full, empty;
  unsigned* bits;
  float *sx, *red, *ct, *dx, *ex;
  int g, rA, cq, lane, tid, cl;
};

// acc = A @ B for one product whose slices come through the ring; slice
// counter t runs on across products, as the producer's does.
template <int H, int STAGES>
__device__ __forceinline__ void product(float (&acc)[H / 4], const Ctx& c,
                                        int& t) {
  constexpr int N = H / 2;
  constexpr int SLICES = H / KS;
  constexpr uint32_t SLICE = KS * H * 2;
  int prev = -1;
  for (int s = 0; s < SLICES; ++s) {
    const int slot = t % STAGES;
    mbar_wait(c.full + 8 * slot, (t / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const int k = s * KS + kk * 16;
      const uint64_t da =
          smem_desc(c.a + (k >> 6) * (ROWS * 128) + (k & 63) * 2, 1024, 1);
      const uint64_t db = smem_desc(
          c.ring + slot * SLICE + c.g * (N / 8) * 512 + kk * 32, 512, 2);
      wgmma::Mma<N>::run(acc, da, db, (s | kk) != 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      // the previous slice's products are done: release its slot in every
      // CTA of the cluster
      wgmma_wait<1>();
      if (c.tid % 128 == 0)
        for (int r = 0; r < c.cl; ++r)
          mbar_arrive_remote(c.empty + 8 * prev, r);
    }
    prev = slot;
    ++t;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (c.tid % 128 == 0)
    for (int r = 0; r < c.cl; ++r) mbar_arrive_remote(c.empty + 8 * prev, r);
}

// Bring this warpgroup's columns of the next epilogue's constants into L1
// while a product runs: c (when given), the three xyz rows of wx and wlast
// (when given). Loaded cold in the epilogue, each new 128-byte line cost an
// L2 round trip that the few loads in flight could not hide.
template <int H>
__device__ __forceinline__ void prefetch_cols(const Ctx& c, const float* cj,
                                              const float* wxj,
                                              const float* wlast) {
  constexpr int LINES = H / 64;  // 128-byte lines in H / 2 floats
  for (int l = c.tid % 128; l < 5 * LINES; l += 128) {
    const int arr = l / LINES;
    const float* base = arr == 0 ? cj : arr == 4 ? wlast : wxj + (arr - 1) * H;
    if (base)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(
          base + c.g * (H / 2) + (l % LINES) * 32));
  }
}

// h = relu(acc + c_j + xyz . wx_j) as bf16 into the A tile; 4a also keeps
// the signs of layer j.
template <int H, bool SIGNS>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[H / 4],
                                                const Ctx& c,
                                                const float (&x)[2][3],
                                                const float* cj,
                                                const float* wxj, int j) {
  constexpr int NB = H / 16;  // 8-column blocks per warpgroup
  constexpr int WORDS = H / 128;
  unsigned words[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) words[w] = 0u;
#pragma unroll
  for (int b0 = 0; b0 < NB; b0 += G) {
    const int col0 = c.g * (H / 2) + 8 * b0 + c.cq;
    const Cols<H, true, false> k(cj, wxj, nullptr, col0);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * (b0 + g) + 2 * i;
        const float v0 = acc[e] + k.c[g][0] + k.xc(x[i], g, 0);
        const float v1 = acc[e + 1] + k.c[g][1] + k.xc(x[i], g, 1);
        st_shared(c.a + a_offset(c.rA + 8 * i, col0 + 8 * g),
                  __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f)));
        if (SIGNS) {
          words[e / 32] |= (v0 > 0.f ? 1u : 0u) << (e % 32);
          words[e / 32] |= (v1 > 0.f ? 1u : 0u) << ((e + 1) % 32);
        }
      }
  }
  if (SIGNS) {
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
      c.bits[((size_t)j * WORDS + w) * CONSUMERS + c.tid] = words[w];
  }
}

// Kernel 4b: this warp's sums over its 16 rows of d_pre, for the thread's
// columns in the G 8-column blocks from b0, into the exchange area: the
// thread's two rows, then the lanes that share lane % 4, in a fixed order.
template <int H>
__device__ __forceinline__ void col_sums(const float (&acc)[H / 4],
                                         const Ctx& c, int b0) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int e = 4 * (b0 + g) + jj;
      float s = acc[e] + acc[e + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (c.lane < 4)
        c.ex[(c.tid / 32) * (H / 2) + 8 * (b0 + g) + c.cq + jj] = s;
    }
}

// Kernel 4b, once the exchange area holds layer j's warp sums (behind a
// named barrier): the CTA's column sums, the four warps of each
// warpgroup in order, to partial row j. The exchange is next written
// only after another named barrier.
template <int H>
__device__ __forceinline__ void store_col_sums(const Ctx& c,
                                               float* __restrict__ partial,
                                               int nh, int j) {
  for (int col = c.tid; col < H; col += CONSUMERS) {
    const float* w = c.ex + (col / (H / 2)) * 4 * (H / 2) + col % (H / 2);
    const float s = ((w[0] + w[H / 2]) + w[H]) + w[3 * (H / 2)];
    partial[((size_t)blockIdx.x * (nh + 1) + j) * H + col] = s;
  }
}

// Mode::SELECT: kernel 3, out (n,) = tanh chain of s.
// Mode::STAGE2_FWD: kernel 4a, out (n, 4) = [t, dt/dx, dt/dy, dt/dz].
// Mode::STAGE2_BWD: kernel 4b, the loss cotangent ct_in (n,) on t ->
// out (n, 3) = d_xyz, and this CTA's (nh+1, H) column sums of d_pre at
// partial + blockIdx.x * (nh+1) * H.
template <int H, int STAGES, Mode MODE>
__device__ __forceinline__ void mlp_body(
    const float* __restrict__ xyz, const __nv_bfloat16* __restrict__ tiles,
    const __nv_bfloat16* __restrict__ tiles_t, const float* __restrict__ wx,
    const float* __restrict__ cvec, const float* __restrict__ wlast,
    const float* __restrict__ scal, const float* __restrict__ ct_in, int n,
    int nh, int use_tanh, float* __restrict__ out,
    float* __restrict__ partial) {
  constexpr bool STAGE2 = MODE != Mode::SELECT;
  constexpr bool BWD = MODE == Mode::STAGE2_BWD;
  constexpr int E = H / 4;  // accumulator floats per thread
  constexpr int NB = H / 16;
  constexpr int WORDS = H / 128;
  constexpr int SLICES = H / KS;
  constexpr uint32_t SLICE = KS * H * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const Smem m(H, STAGES, STAGE2 ? nh + 1 : 0, BWD);

  Ctx c;
  c.a = base + m.a;
  c.ring = base + m.ring;
  c.full = base + m.full;
  c.empty = base + m.empty;
  c.bits = reinterpret_cast<unsigned*>(smem + m.bits);
  c.sx = reinterpret_cast<float*>(smem + m.sx);
  c.red = reinterpret_cast<float*>(smem + m.red);
  c.ct = reinterpret_cast<float*>(smem + m.ct);
  c.dx = reinterpret_cast<float*>(smem + m.dx);
  c.ex = reinterpret_cast<float*>(smem + m.ex);
  c.tid = threadIdx.x;
  c.lane = c.tid % 32;
  c.g = c.tid / 128;
  c.rA = ((c.tid % 128) / 32) * 16 + c.lane / 4;
  c.cq = 2 * (c.lane % 4);
  c.cl = (int)cluster_size();
  const int row0 = blockIdx.x * ROWS;

  if (c.tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(c.full + 8 * s, 1);
      mbar_init(c.empty + 8 * s, 2 * c.cl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = c.tid; k < ROWS * 3; k += THREADS)
    c.sx[k] = row0 + k / 3 < n ? xyz[(size_t)row0 * 3 + k] : 0.f;
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy lands

  if (c.tid >= CONSUMERS) {
    // producer: stream every slice of every product through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (c.tid == CONSUMERS) {
      const uint32_t rank = cluster_rank();
      const uint32_t part = SLICE / c.cl;
      const uint16_t mask = (uint16_t)((1u << c.cl) - 1u);
      const int fwd = nh * SLICES;
      const int total = STAGE2 ? 2 * fwd : fwd;
      for (int t = 0; t < total; ++t) {
        const int slot = t % STAGES;
        mbar_wait(c.empty + 8 * slot, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(c.full + 8 * slot, SLICE);
        // forward products read ws_0 .. ws_{nh-1}; the reverse sweep then
        // reads the transposed images of ws_{nh-1} .. ws_0
        const unsigned char* src;
        if (t < fwd) {
          src = reinterpret_cast<const unsigned char*>(tiles) +
                (size_t)t * SLICE;
        } else {
          const int q = t - fwd;
          const int layer = nh - 1 - q / SLICES;
          src = reinterpret_cast<const unsigned char*>(tiles_t) +
                ((size_t)layer * SLICES + q % SLICES) * SLICE;
        }
        bulk_multicast(c.ring + slot * SLICE + rank * part,
                       src + rank * part, part, c.full + 8 * slot, mask);
      }
    }
    __syncwarp();
    cluster_sync();  // no CTA leaves while a peer may still write into it
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float x[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int d = 0; d < 3; ++d) x[i][d] = c.sx[(c.rA + 8 * i) * 3 + d];
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    int t = 0;

    // layer 0: relu(0 + c_0 + xyz . wx_0), exactly the plain c_0 + xc(0)
    hidden_epilogue<H, STAGE2>(acc, c, x, cvec, wx, 0);
    fence_async_smem();
    named_sync();
    for (int j = 0; j < nh; ++j) {
      const float* cj = cvec + (size_t)(j + 1) * H;
      const float* wxj = wx + (size_t)(j + 1) * 4 * H;
      prefetch_cols<H>(c, cj, wxj, j + 1 == nh ? wlast : nullptr);
      product<H, STAGES>(acc, c, t);
      named_sync();  // both warpgroups are done reading this layer's A
      if (j + 1 < nh) {
        hidden_epilogue<H, STAGE2>(acc, c, x, cj, wxj, j + 1);
        fence_async_smem();
        named_sync();
        continue;
      }
      // last hidden layer stays fp32 into the H -> 1 product
      float part[2] = {0.f, 0.f};
      unsigned words[WORDS];
#pragma unroll
      for (int w = 0; w < WORDS; ++w) words[w] = 0u;
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += G) {
        const Cols<H, true, true> k(cj, wxj, wlast,
                                    c.g * (H / 2) + 8 * b0 + c.cq);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int e = 4 * (b0 + g) + 2 * i + jj;
              const float v = acc[e] + k.c[g][jj] + k.xc(x[i], g, jj);
              part[i] += fmaxf(v, 0.f) * k.last[g][jj];
              if (STAGE2) words[e / 32] |= (v > 0.f ? 1u : 0u) << (e % 32);
            }
      }
      if (STAGE2) {
#pragma unroll
        for (int w = 0; w < WORDS; ++w)
          c.bits[((size_t)nh * WORDS + w) * CONSUMERS + c.tid] = words[w];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
        if (c.lane % 4 == 0) c.red[c.g * ROWS + c.rA + 8 * i] = part[i];
      }
      named_sync();
      if (c.g == 0 && c.lane % 4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = c.rA + 8 * i;
          const float* xr = x[i];
          float s = c.red[r] + c.red[ROWS + r];
          s = s + scal[0];
          s = s + xr[0] * scal[1] + xr[1] * scal[2] + xr[2] * scal[3];
          const float t1 = tanhf(s);
          const float fin = use_tanh ? tanhf(t1) : t1;
          const bool live = row0 + r < n;
          if (!STAGE2) {
            if (live) out[row0 + r] = fin;
          } else {
            if (!BWD && live) out[(size_t)(row0 + r) * 4] = fin;
            float d_pre = 1.f - t1 * t1;  // d fin / d s: the tanh chain
            if (use_tanh) d_pre = d_pre * (1.f - fin * fin);
            // 4b: the loss cotangent times d fin / d s; 0 for a dead row,
            // so that it adds nothing to the column sums
            c.ct[r] = !BWD ? d_pre : live ? ct_in[row0 + r] * d_pre : 0.f;
          }
        }
      }
    }

    if (STAGE2) {
      named_sync();  // the cotangent of every row is in c.ct
      const float ct[2] = {c.ct[c.rA], c.ct[c.rA + 8]};
      // dh_nh = ct * wlast
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            acc[4 * b + 2 * i + jj] =
                ct[i] * wlast[c.g * (H / 2) + 8 * b + c.cq + jj];
      float pd[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      for (int j = nh; j >= 0; --j) {
        const float* wxj = wx + (size_t)j * 4 * H;
        unsigned words[WORDS];
#pragma unroll
        for (int w = 0; w < WORDS; ++w)
          words[w] = c.bits[((size_t)j * WORDS + w) * CONSUMERS + c.tid];
#pragma unroll
        for (int b0 = 0; b0 < NB; b0 += G) {
          const Cols<H, false, false> k(nullptr, wxj, nullptr,
                                        c.g * (H / 2) + 8 * b0 + c.cq);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int e = 4 * (b0 + g) + 2 * i + jj;
                const float dpre =
                    (words[e / 32] >> (e % 32)) & 1u ? acc[e] : 0.f;
                acc[e] = dpre;
                pd[i][0] += dpre * k.w[g][0][jj];
                pd[i][1] += dpre * k.w[g][1][jj];
                pd[i][2] += dpre * k.w[g][2][jj];
              }
          if (BWD) col_sums<H>(acc, c, b0);
        }
        if (j == 0) break;
        // dh_{j-1} = bf16(dpre) @ ws_{j-1}^T; A is free (the last product
        // that read it is behind a named barrier)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int col = c.g * (H / 2) + 8 * b + c.cq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * b + 2 * i;
            const __nv_bfloat162 h = __floats2bfloat162_rn(acc[e],
                                                           acc[e + 1]);
            st_shared(c.a + a_offset(c.rA + 8 * i, col), h);
          }
        }
        fence_async_smem();
        named_sync();
        if (BWD) store_col_sums<H>(c, partial, nh, j);
        prefetch_cols<H>(c, nullptr, wx + (size_t)(j - 1) * 4 * H, nullptr);
        product<H, STAGES>(acc, c, t);
        named_sync();
      }
      // d_xyz: quad sums, then the two warpgroups' halves
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float p = pd[i][d];
          p += __shfl_xor_sync(0xffffffffu, p, 1);
          p += __shfl_xor_sync(0xffffffffu, p, 2);
          if (c.lane % 4 == 0) c.dx[(c.g * ROWS + c.rA + 8 * i) * 3 + d] = p;
        }
      named_sync();
      if (BWD) store_col_sums<H>(c, partial, nh, 0);
      if (c.g == 0 && c.lane % 4 == 0) {
        // 4a writes [t, d_xyz] rows, 4b d_xyz rows
        constexpr int W = BWD ? 3 : 4, D0 = BWD ? 0 : 1;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = c.rA + 8 * i;
          if (row0 + r >= n) continue;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            out[(size_t)(row0 + r) * W + D0 + d] =
                ct[i] * scal[1 + d] +
                (c.dx[r * 3 + d] + c.dx[(ROWS + r) * 3 + d]);
        }
      }
    }
    cluster_sync();
  }
}

template <int H, int STAGES, Mode MODE>
size_t smem_bytes(int nh) {
  return Smem(H, STAGES, MODE != Mode::SELECT ? nh + 1 : 0,
              MODE == Mode::STAGE2_BWD)
      .total;
}

// Launch `kernel` over ceil(n / 64) CTAs rounded up to whole clusters, once
// for each of `batch` crops on grid rows y (a cluster spans x only, so it
// stays inside one crop).
template <typename Kernel, typename... Args>
int launch_clustered(Kernel kernel, size_t smem, int n, int cluster,
                     int batch, cudaStream_t stream, Args... args) {
  if (cluster < 1 || cluster > MAX_CLUSTER || smem > SMEM_LIMIT ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + ROWS - 1) / ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + cluster - 1) / cluster * cluster, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace mlpw
