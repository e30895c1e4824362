"""How far kernel 4b's outputs lie from its plain version on small samples,
on one NVIDIA card.

    python3 scripts/stage2_bwd_shares.py

For the seeded decoders and inputs of tests/test_torch_kernels_cuda.py
(widths 512 and 384; n = 700 and 1000 points): the shares and medians of
``mlp2_cuda.stage2_agreement`` for d_points and d_cvec of each 4b design
(the wgmma design at clusters 1, 2 and 4, the wmma design) against the
plain version summed in fp32 and in fp64, and of the fp32 plain version
against the fp64 one; and whether the cluster sizes give the same bits.
For each case it also lists the d_cvec rows (layer j, column h of the
(nh + 1, H) cvec) that the wgmma design at the wrappers' cluster size puts
outside 5e-3 of the largest element against the fp32 plain version: per
layer, and each with its value in the kernel, the fp32 and the fp64 plain
versions, so that one sees which of the two fp32 results the fp64 sum
sides with. Prints one line per case and, last, one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_kernels_cuda as cases  # noqa: E402
from sdflabel_tpu_torch.ops import mlp2_cuda  # noqa: E402


def shares(dev, got, want):
    """stage2_agreement's (shares, medians) of (d_cvec, d_points)."""
    zero = torch.zeros(1, device=dev)
    s, m = mlp2_cuda.stage2_agreement(zero, zero, (
        ("d_points", got[1], want[1]),
        ("d_cvec", got[0].reshape(-1, 1), want[0].reshape(-1, 1))))
    s.pop("sdf")
    m.pop("sdf")
    return s, m


def outside_rows(got, fp32, fp64, limit=5e-3):
    """d_cvec rows of `got` outside `limit` of fp32's largest element:
    each (layer, column, kernel, fp32, fp64), the count per layer, and how
    many of them the kernel holds within `limit` of fp64's largest."""
    got, fp32, fp64 = (t.detach().double().cpu().reshape(fp32.shape)
                       for t in (got, fp32, fp64))
    err = (got - fp32).abs() / fp32.abs().max()
    err64 = (got - fp64).abs() / fp64.abs().max()
    plain_err = (fp32 - fp64).abs() / fp64.abs().max()
    rows = [dict(layer=int(j), column=int(h), kernel=float(got[j, h]),
                 fp32=float(fp32[j, h]), fp64=float(fp64[j, h]),
                 kernel_vs_fp64=float(err64[j, h]),
                 fp32_vs_fp64=float(plain_err[j, h]))
            for j, h in (err > limit).nonzero().tolist()]
    per_layer = [int(c) for c in (err > limit).sum(1).tolist()]
    return dict(count=len(rows), of=int(err.numel()), per_layer=per_layer,
                kernel_within_vs_fp64=sum(r["kernel_vs_fp64"] <= limit
                                          for r in rows),
                fp32_outside_vs_fp64=sum(r["fp32_vs_fp64"] > limit
                                         for r in rows),
                largest_fp32=float(fp32.abs().max()), rows=rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("stage2_bwd_shares: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = []
    for width in (512, 384):
        packed = cases._packed(dev, width)
        for n in (700, 1000):
            pts, _, cvec = cases._inputs(dev, packed, n)
            ct = torch.randn(n, generator=torch.Generator().manual_seed(7)
                             ).to(dev)
            plain = {}
            for dtype in (torch.float32, torch.float64):
                cv = cvec.clone().requires_grad_(True)
                p = pts.clone().requires_grad_(True)
                sdf = mlp2_cuda.stage2_plain(packed, cv, p, dtype)
                plain[dtype] = torch.autograd.grad(sdf, (cv, p), ct)
            row = {"width": width, "n": n, "plain_fp32_vs_fp64": shares(
                dev, plain[torch.float32], plain[torch.float64])}
            outs = {}
            for design, cluster in (("wgmma", 1), ("wgmma", 2),
                                    ("wgmma", 4), ("wmma", 2)):
                out = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct, design,
                                           cluster)
                outs[design, cluster] = out
                row[f"{design}_{cluster}"] = {
                    "vs_fp32": shares(dev, out, plain[torch.float32]),
                    "vs_fp64": shares(dev, out, plain[torch.float64])}
            row["d_cvec_outside_fp32"] = outside_rows(
                outs["wgmma", 2][0], plain[torch.float32][0],
                plain[torch.float64][0])
            row["clusters_bit_equal"] = all(
                all(torch.equal(a, b) for a, b in zip(
                    outs["wgmma", c], outs["wgmma", 2])) for c in (1, 4))
            print(json.dumps(row), flush=True)
            result.append(row)
    print(card)
    print(json.dumps({"card": card, "cases": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
