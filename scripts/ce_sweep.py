"""Time variants of the cross-entropy kernels (kernel 5, csrc/ce.cu) on the
card, at the train step's tower shapes, beside the shipped build.

    python3 scripts/ce_sweep.py [--out FILE.json]

Each variant is ce.cu edited: other values of its tile constants (for the
class-split forward SPLIT_WARPS, warps a CTA, and CHUNK, class loads a
thread issues before any arithmetic; for the saved-lse backward
BWD_CLASSES, class rows a thread takes), the forward's class rows loaded
without the 256-byte L2 prefetch hint, the backward's loads with it, and
the target's logit gathered by the forward's merging thread after the class
pass (one load a pixel) in place of the compare in the pass. Every variant
is built by its own nvcc (all started together) into a temporary directory
and bound with ctypes. Its results are held against the shipped build: the
forward's loss to 1e-6 relative (its lse bit-equal where only the pick
moves), the backward bit-equal. Three yardsticks of what the card streams
are timed beside them: the logits read once in the forward's own pattern
(warp w reads classes [32 w, 32 w + 32) of a 128-pixel tile, 8 float4 loads
in flight a thread), read once as one contiguous array, and copied. Times
are device times of back-to-back launches (CUDA events around 30 launches,
the median of 5 such windows), the variants taken in order and then in
reverse within one process on one card. At C = 2 the launches take longer
on the host than on the card, so those times are the host's launch rate,
not the kernels'. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sdflabel_tpu_torch.ops import _cuda, ce_cuda  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# (SPLIT_WARPS, CHUNK), the shipped values first
FWD_TILES = [(8, 16), (8, 8), (4, 16), (16, 8)]
BWD_TILES = [8, 4]  # BWD_CLASSES, the shipped value first
FWD_EDITS = {
    # the forward's class rows by __ldg, without the L2 prefetch hint
    "nohint": [("load_px_l2(xb + (size_t)(k + i) * hw, v[i]);",
                "load_px(xb + (size_t)(k + i) * hw, v[i]);")],
    # the target's logit gathered by the merging thread after the pass
    "gather": [("if (k + i == tk[j]) pk[j] = v[i][j];", ""),
               ("float mm = s_m[0][i], ss = s_s[0][i], pick = s_p[0][i];",
                "float mm = s_m[0][i], ss = s_s[0][i];\n"
                "      const T tv = t[(size_t)b * hw + p0 + i];\n"
                "      float pick = (tv >= 0 && tv < c)\n"
                "          ? x[((size_t)b * c + (size_t)tv) * hw + p0 + i]"
                " : 0.f;"),
               ("pick += s_p[gg][i];", "")],
}
# the backward's loads (rows and lse) with the L2 prefetch hint
BWD_L2_HINT = [(
    "const float4 q = __ldg(reinterpret_cast<const float4*>(p));",
    "float4 q;\n  asm volatile(\"ld.global.nc.L1::no_allocate."
    "L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\" : \"=f\"(q.x), "
    "\"=f\"(q.y), \"=f\"(q.z), \"=f\"(q.w) : \"l\"(p));")]
# yardsticks of what the card streams: the logits read once (a sum over
# float4 loads, four in flight a thread, grid-stride) and read and written
# once (a float4 copy), by the same kind of launch
ROOFLINE_SRC = r"""
#include <cuda_runtime.h>
__global__ void read_roofline_kernel(const float4* __restrict__ x, size_t n4,
                                     float* __restrict__ out) {
  float acc = 0.f;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  for (; i < n4; i += stride) {
    const float4 v = __ldg(x + i);
    acc += (v.x + v.y) + (v.z + v.w);
  }
  if (acc == 1234.5f) out[0] = acc;
}
__global__ void copy_roofline_kernel(const float4* __restrict__ x, size_t n4,
                                     float4* __restrict__ y) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u) y[i + u * stride] = v[u];
  }
  for (; i < n4; i += stride) y[i] = __ldg(x + i);
}
// the split forward's loads alone: warp w of a 256-thread CTA reads classes
// [32 w, 32 w + 32) of a 128-pixel tile, 8 float4 rows in flight a thread
__global__ void pattern_read_kernel(const float* __restrict__ x, int c,
                                    int hw, int tiles,
                                    float* __restrict__ out) {
  const int b = blockIdx.x / tiles, p0 = (blockIdx.x % tiles) * 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xb = x + (size_t)b * c * hw + p0 + lane * 4;
  float acc = 0.f;
  for (int k = warp * 32; k < warp * 32 + 32; k += 8) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __ldg(reinterpret_cast<const float4*>(xb + (size_t)(k + i) * hw));
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  if (acc == 1234.5f) out[0] = acc;
}
extern "C" int pattern_read(const void* x, int b, int c, int hw, void* out,
                            void* stream) {
  const int tiles = hw / 128;
  pattern_read_kernel<<<b * tiles, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, c, hw, tiles, (float*)out);
  return (int)cudaGetLastError();
}
extern "C" int read_roofline(const void* x, size_t n4, void* out,
                             void* stream) {
  read_roofline_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, n4, (float*)out);
  return (int)cudaGetLastError();
}
extern "C" int copy_roofline(const void* x, size_t n4, void* y,
                             void* stream) {
  copy_roofline_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, n4, (float4*)y);
  return (int)cudaGetLastError();
}
"""


def build(variants: dict, out_dir: str) -> dict:
    """{tag: {constant: value, or "edits": [(old, new), ...]}} -> {tag:
    ctypes library}; the tag "roofline" builds the yardsticks."""
    with open(os.path.join(_cuda.CSRC, "ce.cu")) as f:
        text = f.read()
    procs = {}
    for tag, consts in variants.items():
        if tag == "roofline":
            src = ROOFLINE_SRC
        else:
            src = text
        for name, value in consts.items():
            if name == "edits":
                for a, b in value:
                    assert a in src, a
                    src = src.replace(a, b)
                continue
            src, k = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
            assert k == 1, name
        path = os.path.join(out_dir, f"ce_{tag}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"libce_{tag}.so")
        procs[tag] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda._COMMON_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, log
        libs[tag] = ctypes.CDLL(lib)
    return libs


def bind(lib, symbol: str, kernel: _cuda.CudaKernel):
    fn = getattr(lib, symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int

    def launch(*args):
        err = fn(*args)
        assert err == 0, f"{symbol}: CUDA error {err}"
    return launch


def device_ms(launch, reps: int = 30, windows: int = 5) -> float:
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the times to this JSON "
                                      "file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ce_sweep: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    variants = {f"fwd_w{w}_c{k}": dict(SPLIT_WARPS=w, CHUNK=k)
                for w, k in FWD_TILES}
    variants.update({f"bwd_k{k}": dict(BWD_CLASSES=k) for k in BWD_TILES})
    variants.update({f"fwd_{tag}": dict(edits=edits)
                     for tag, edits in FWD_EDITS.items()})
    variants["bwd_l2hint"] = dict(edits=BWD_L2_HINT)
    variants["roofline"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, tmp)
        results = {}
        for c in (256, 2):
            b, hw = 13, 128 * 128
            n = b * hw
            gen = torch.Generator(device=dev).manual_seed(c)
            x = torch.randn(b, c, hw, device=dev, generator=gen) * 3
            t = torch.randint(0, c, (b, hw), device=dev, generator=gen)
            g = torch.tensor(2.5, device=dev)
            stream = _cuda.stream(x)
            partial, lse = ce_cuda._fwd(x, t)
            dx = ce_cuda._bwd(x, t, lse, g, n)
            loss = float(partial.sum()) / n
            launches = {}

            def forward(tag, warps=ce_cuda.SPLIT_WARPS, chunk=ce_cuda.CHUNK):
                plan = ce_cuda.fwd_plan(c, hw, True, warps=warps, chunk=chunk)
                pv = torch.empty(b * plan["tiles"], device=dev)
                lv = torch.empty(b, hw, device=dev)
                fn = bind(libs[tag], "ce_fwd_split", ce_cuda.CE_FWD)
                args_v = (_cuda.ptr(x), _cuda.ptr(t), t.element_size(), b, c,
                          hw, plan["groups"], plan["per_group"], plan["vec"],
                          _cuda.ptr(lv), _cuda.ptr(pv), stream)
                fn(*args_v)
                torch.cuda.synchronize()
                rel = abs(float(pv.sum()) / n - loss) / abs(loss)
                print(f"C={c} {tag}: loss {rel:.3g} relative to the shipped "
                      f"build, lse bit-equal: {torch.equal(lv, lse)}")
                assert rel <= 1e-6, (tag, rel)
                launches[tag] = (lambda fn=fn, a=args_v, keep=(lv, pv):
                                 fn(*a))

            def backward(tag, lib):
                dv = torch.empty_like(x)
                fn = bind(lib, "ce_bwd_lse", ce_cuda.CE_BWD)
                args_v = (_cuda.ptr(x), _cuda.ptr(t), t.element_size(),
                          _cuda.ptr(lse), _cuda.ptr(g), n, b, c, hw, 4,
                          _cuda.ptr(dv), stream)
                fn(*args_v)
                torch.cuda.synchronize()
                assert torch.equal(dv, dx), tag
                launches[tag] = (lambda fn=fn, a=args_v, keep=dv: fn(*a))

            for w, k in FWD_TILES:
                forward(f"fwd_w{w}_c{k}", w, k)
            for tag in FWD_EDITS:
                forward(f"fwd_{tag}")
            for k in BWD_TILES:
                backward(f"bwd_k{k}", libs[f"bwd_k{k}"])
            backward("bwd_l2hint", libs["bwd_l2hint"])

            roof = libs["roofline"]
            for name in ("read_roofline", "copy_roofline"):
                getattr(roof, name).argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_void_p]
            roof.pattern_read.argtypes = [ctypes.c_void_p] + [
                ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
            n4 = x.numel() // 4
            sink, y = torch.empty(1, device=dev), torch.empty_like(x)
            if c == 256:
                launches["fwd_pattern_read"] = lambda: roof.pattern_read(
                    _cuda.ptr(x), b, c, hw, _cuda.ptr(sink), stream)
            launches["fwd_read_roofline"] = lambda: roof.read_roofline(
                _cuda.ptr(x), n4, _cuda.ptr(sink), stream)
            launches["bwd_copy_roofline"] = lambda: roof.copy_roofline(
                _cuda.ptr(x), n4, _cuda.ptr(y), stream)
            launches["fwd_first"] = lambda: ce_cuda._fwd(x, t, "first")
            launches["bwd_first"] = lambda: ce_cuda._bwd(x, t, None, g, n,
                                                         "first")
            times = {tag: [] for tag in launches}
            order = list(launches)
            for tag in order + order[::-1]:
                times[tag].append(device_ms(launches[tag]))
            fwd_bound = (4 * b * c * hw + t.element_size() * n) / \
                HBM_BYTES_PER_S * 1e3
            bwd_bound = fwd_bound + 4 * b * c * hw / HBM_BYTES_PER_S * 1e3
            rows = {}
            for tag, ts in times.items():
                bound = fwd_bound if tag.startswith("fwd") else bwd_bound
                ms = statistics.median(ts)
                rows[tag] = dict(ms=ts, median_ms=ms, bound_ms=bound,
                                 share=bound / ms)
                print(f"C={c} {tag}: {[round(v, 5) for v in ts]} ms, "
                      f"bound {bound:.5f} ms ({bound / ms:.1%})")
            results[c] = rows
            del x, dx, partial, lse, y
            launches.clear()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
