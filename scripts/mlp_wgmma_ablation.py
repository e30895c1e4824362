"""Where kernel 3's time goes: the selection MLP's wgmma design against
variants of itself, on one NVIDIA card.

    python3 scripts/mlp_wgmma_ablation.py [--out FILE]

Each variant is csrc/select_mlp.cu built from a copy of the sources with
one part taken out or changed (the copy lives in a temporary directory;
the repository's sources are not touched), then launched on the 64000
grid points of the stock selection decode through the seeded 8x512
decoder, packed as chip_smoke.py packs it. Times are medians of 30
CUDA-event launches after 3 warm-up launches. Variants that drop work
compute wrong values; only their times mean anything.

- base: the kernel as committed;
- no_epilogue: hidden layers skip the bias / xyz / ReLU / bf16 epilogue;
- no_wgmma: the products are not issued (the ring still streams);
- stream_only: neither, so the weight stream alone;
- no_xyz: the epilogue skips the xyz term (5 of its 8 flops per element
  and 3 of its 4 loads per column);
- no_prefetch: the epilogue's constants are not prefetched into L1;
- release_cluster: the ring's remote arrivals release, and its waits
  acquire, at cluster scope instead of the CTA-scope default.

Then kernels 4a and 4b as committed (ops/mlp2_cuda.py, csrc/stage2_mlp.cu)
on K = 8192 seeded points in [-1, 1]^3 (the stage-2 band) and seeded
cotangents, at each cluster size. The anchors
that the patches need are named in csrc/mlp_wgmma.cuh's source note.

Prints one line per variant and cluster size and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sdflabel_tpu_torch.models import deepsdf  # noqa: E402
from sdflabel_tpu_torch.ops import (  # noqa: E402
    _cuda, grid as grid_ops, mlp2_cuda, mlp_cuda)

HEADER = "mlp_wgmma.cuh"
PATCHES = {  # variant -> [(text in the header, its replacement)]
    "base": [],
    "no_epilogue": [("  constexpr int NB = H / 16;  // 8-column blocks per "
                     "warpgroup\n",
                     "  return;\n  constexpr int NB = H / 16;\n")],
    "no_wgmma": [("      wgmma::Mma<N>::run(acc, da, db, (s | kk) != 0);",
                  "      (void)da; (void)db;")],
    "no_xyz": [("const float v0 = acc[e] + k.c[g][0] + k.xc(x[i], g, 0);",
                "const float v0 = acc[e] + k.c[g][0];"),
               ("const float v1 = acc[e + 1] + k.c[g][1] + k.xc(x[i], g, 1);",
                "const float v1 = acc[e + 1] + k.c[g][1];")],
    "no_prefetch": [("    if (base)\n      asm volatile(\"prefetch",
                     "    if (false)\n      asm volatile(\"prefetch")],
    "release_cluster": [
        ('"mbarrier.arrive.shared::cluster.b64 _, [ra];\\n"',
         '"mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\\n"'),
        ('"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"',
         '"mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, '
         '[%1], %2;\\n"')],
}
PATCHES["stream_only"] = PATCHES["no_epilogue"] + PATCHES["no_wgmma"]
SIZES = (1, 2, 4)
CLUSTERS = {"base": SIZES, "release_cluster": SIZES, "stream_only": SIZES}


def build(work: str, name: str) -> str:
    src = os.path.join(work, name)
    os.makedirs(src)
    for f in ("select_mlp.cu", HEADER, "wgmma.cuh"):
        shutil.copy(os.path.join(_cuda.CSRC, f), src)
    path = os.path.join(src, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: patch anchor not found once: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(src, "libselect_mlp.so")
    subprocess.run([_cuda._nvcc(), *_cuda._COMMON_FLAGS, "-o", lib,
                    os.path.join(src, "select_mlp.cu")], check=True,
                   capture_output=True)
    return lib


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mlp_wgmma_ablation: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(512,) * 8,
                                norm_layers=tuple(range(8)), latent_in=(4,),
                                weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    packed = mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))
    pts = grid_ops.generate_point_grid(40, device=dev)
    lat = torch.tensor([0.6, -0.48, 0.64], device=dev)
    cvec = mlp_cuda._cvec(packed, lat).contiguous()
    wlast, scal = packed.wlast.reshape(-1), packed.scal.reshape(-1)
    out = torch.empty(pts.shape[0], device=dev)
    n, H, nh = pts.shape[0], packed.width, packed.n_hidden

    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(len(PATCHES)) as pool:
            libs = dict(zip(PATCHES, pool.map(lambda v: build(work, v),
                                              PATCHES)))
        result = {}
        for name, path in libs.items():
            fn = ctypes.CDLL(path).select_mlp_wgmma
            fn.argtypes = [_cuda.P] * 6 + [_cuda.I] * 5 + [_cuda.P] * 2
            fn.restype = ctypes.c_int
            result[name] = {}
            for cl in CLUSTERS.get(name, (mlp_cuda.CLUSTER,)):
                def launch():
                    err = fn(_cuda.ptr(pts), _cuda.ptr(packed.ws_tiles),
                             _cuda.ptr(packed.wx), _cuda.ptr(cvec),
                             _cuda.ptr(wlast), _cuda.ptr(scal), n, H, nh,
                             int(packed.use_tanh), cl, _cuda.ptr(out),
                             _cuda.stream(pts))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                result[name][cl] = time_ms(launch)
                print(f"{name:16s} cluster {cl}: {result[name][cl]:.4f} ms",
                      flush=True)

    # kernels 4a and 4b through the repository's own library, by cluster
    # size
    gen = torch.Generator().manual_seed(6)
    pts4 = (torch.rand(8192, 3, generator=gen) * 2 - 1).to(dev)
    ct4 = torch.randn(8192, generator=gen).to(dev)
    out4 = torch.empty(8192, 4, device=dev)
    result["stage2_fwd"], result["stage2_bwd"] = {}, {}
    for cl in SIZES:
        def launch4():
            mlp2_cuda.STAGE2_FWD_WGMMA(
                _cuda.ptr(pts4), _cuda.ptr(packed.ws_tiles),
                _cuda.ptr(packed.ws_tiles_t), _cuda.ptr(packed.wx),
                _cuda.ptr(cvec), _cuda.ptr(packed.wlast),
                _cuda.ptr(packed.scal), 8192, H, nh, int(packed.use_tanh),
                cl, _cuda.ptr(out4), _cuda.stream(pts4))
        result["stage2_fwd"][cl] = time_ms(launch4)
        result["stage2_bwd"][cl] = time_ms(lambda: mlp2_cuda.stage2_bwd(
            packed, cvec, pts4, ct4, "wgmma", cl))
        for name in ("stage2_fwd", "stage2_bwd"):
            print(f"{name:16s} cluster {cl}: {result[name][cl]:.4f} ms",
                  flush=True)
    line = json.dumps({"card": card, "points": n, "width": H,
                       "hidden_products": nh, "ms": result})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
