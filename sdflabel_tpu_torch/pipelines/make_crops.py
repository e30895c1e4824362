"""Synthetic CSS-training crops generator (crops.json database).

Counterpart of sdflabel_tpu/pipelines/make_crops.py, the first step of
the system's training loop

    train_deepsdf -> make_crops -> train_css -> refine_css -> evaluate

DeepSDF shapes are decoded (ops/grid.py), rendered with the disc-splat
rasterizer (renderer/rasterer.py) at random poses, given a
domain-randomized appearance, and written in the layout data/crops.py
(and the reference's datasets/crops.py) reads. A 128-px crop has 16384
pixels, so each render goes through the row-binned splat kernel
(ops/splat_cuda.py) on the card.

The host draws come from one ``np.random.RandomState(seed)`` in the JAX
package's order (latent jitter, view, appearance), so the two packages
write the same crops.json for a seed and the same images up to the
renderers' rounding.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import grid as grid_ops
from sdflabel_tpu_torch.renderer import rasterer as rast_mod
from sdflabel_tpu_torch.utils import png

# Nominal object radius used to size the focal length so the rendered
# shape fills `fill` of the crop (DeepSDF shapes live in [-1, 1]^3).
_NOMINAL_RADIUS = 1.1


def make_render_fn(decoder_fn, crop_px: int, grid_density: int,
                   capacity: int, device="cuda"):
    """render(latent, yaw, trans, K) -> (nocs (3, H, W) in [0, 1],
    mask (H, W) bool, normals (3, H, W) encoded (n + 1) / 2, the 4x4
    render pose), all on `device`."""
    device = refine_mod._device(device)
    grid_pts = grid_ops.generate_point_grid(grid_density, device=device)

    @torch.no_grad()
    def render(latent, yaw, trans, K):
        surf, _ = grid_ops.surface_from_decoder(
            decoder_fn, latent, grid_pts, capacity=capacity)
        pose = refine_mod.build_render_pose(yaw, trans)
        rendering, _ = rast_mod.render(
            K, (crop_px, crop_px), surf.points, surf.normals, surf.normals,
            pose, point_mask=surf.mask, rot="dcm", primitives="disc",
            output_nocs=True)
        return (rendering.color, rendering.mask[0] > 0.5, rendering.normals,
                pose)

    return render


def _sample_view(rng: np.random.RandomState, crop_px: int):
    """Random upright yaw-only view: (yaw, trans, K)."""
    yaw = rng.uniform(-np.pi, np.pi)
    dist = rng.uniform(6.0, 20.0)
    fill = rng.uniform(0.55, 0.9)
    focal = fill * crop_px * dist / (2.0 * _NOMINAL_RADIUS)
    cx = crop_px / 2.0 + rng.uniform(-0.08, 0.08) * crop_px
    cy = crop_px / 2.0 + rng.uniform(-0.08, 0.08) * crop_px
    K = np.array([[focal, 0.0, cx], [0.0, focal, cy], [0.0, 0.0, 1.0]],
                 np.float32)
    y_off = rng.uniform(0.0, 0.10) * dist  # camera slightly above the car
    trans = np.array([0.0, y_off, dist], np.float32)
    return yaw, trans, K


def _synthesize_rgb(rng: np.random.RandomState, nocs: np.ndarray,
                    mask: np.ndarray, normals_enc: np.ndarray) -> np.ndarray:
    """Lambertian shading of the rendered normals under a random light and
    albedo, over a random background, with sensor noise: (H, W, 3)
    float32 in [0, 1]."""
    h, w = mask.shape
    n = np.transpose(normals_enc, (1, 2, 0)) * 2.0 - 1.0
    light = rng.randn(3)
    light /= np.linalg.norm(light) + 1e-9
    diffuse = np.abs(n @ light)[..., None]  # two-sided

    mode = rng.randint(3)
    if mode == 0:  # solid body colour
        albedo = np.broadcast_to(rng.uniform(0.1, 0.9, 3).astype(np.float32),
                                 (h, w, 3))
    elif mode == 1:  # NOCS as texture
        albedo = np.clip(np.transpose(nocs, (1, 2, 0)), 0.0, 1.0)
    else:  # grey
        albedo = np.broadcast_to(np.float32(rng.uniform(0.2, 0.8)),
                                 (h, w, 3))

    ambient = rng.uniform(0.25, 0.45)
    strength = rng.uniform(0.5, 0.8)
    shaded = np.clip(albedo * (ambient + strength * diffuse), 0.0, 1.0)

    bg_mode = rng.randint(3)
    if bg_mode == 0:  # uniform noise
        bg = rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32)
    elif bg_mode == 1:  # vertical gradient between two random colours
        c0, c1 = rng.uniform(0.1, 0.9, 3), rng.uniform(0.1, 0.9, 3)
        t = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
        bg = np.broadcast_to((1.0 - t) * c0 + t * c1,
                             (h, w, 3)).astype(np.float32)
    else:  # solid
        bg = np.broadcast_to(rng.uniform(0.1, 0.9, 3).astype(np.float32),
                             (h, w, 3))

    img = np.where(mask[..., None], shaded, bg)
    img = img + rng.randn(h, w, 3).astype(np.float32) * rng.uniform(0.005,
                                                                    0.03)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _quantize_uvw(nocs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(3, H, W) NOCS in [0, 1] -> (H, W, 3) uint8 class bins. Clipped
    before the cast (a negative value would wrap to ~255); an on-object
    pixel whose three bins are all 0 gets bin 1, so that the mask
    uvw.sum(-1) > 0 has no holes."""
    nocs = np.clip(nocs, 0.0, 1.0)
    uvw = np.round(np.transpose(nocs, (1, 2, 0)) * 255.0).astype(np.uint8)
    uvw[~mask] = 0
    hole = mask & (uvw.sum(-1) == 0)
    uvw[hole] = 1
    return uvw


def _jitter_latent(lat: np.ndarray, rng: np.random.RandomState,
                   jitter: float) -> np.ndarray:
    """Gaussian-perturb a latent and rescale it to its original norm."""
    norm0 = np.linalg.norm(lat)
    out = lat + rng.randn(*lat.shape).astype(np.float32) * jitter
    return out * (norm0 / (np.linalg.norm(out) + 1e-9))


def sample_unit_latents(n: int, latent_size: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Random unit-sphere latents (the CSS latent head's codomain)."""
    z = rng.randn(n, latent_size).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def load_latents(path: str, latent_size: int) -> np.ndarray:
    """Latent table: a .pth (LatentCodes layout) or .npy/.npz (num, L)."""
    if path.endswith(".npy") or path.endswith(".npz"):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
        arr = data["latent_codes"] if isinstance(data, dict) else data
        if hasattr(arr, "detach"):
            arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr, np.float32).reshape(len(arr), -1)
    if arr.shape[1] != latent_size:
        raise ValueError(f"latent table width {arr.shape[1]} != decoder "
                         f"latent size {latent_size}")
    return arr


def make_crops(out_dir: str, decoder_fn, latents: np.ndarray, n_crops: int,
               crop_px: int = 128, grid_density: int = 40,
               capacity: int = 4096, seed: int = 0,
               latent_jitter: float = 0.0, device="cuda") -> dict:
    """Render `n_crops` crops into `out_dir` in the crops-database layout;
    latents cycle through `latents` (optionally jittered). Returns the
    crops.json dict."""
    device = refine_mod._device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    render = make_render_fn(decoder_fn, crop_px, grid_density, capacity,
                            device)

    db: dict[str, list] = {}
    for idx in range(n_crops):
        lat = latents[idx % len(latents)].copy()
        if latent_jitter > 0.0:
            lat = _jitter_latent(lat, rng, latent_jitter)
        yaw, trans, K = _sample_view(rng, crop_px)
        nocs, mask, normals_enc, pose = (t.cpu().numpy() for t in render(
            torch.as_tensor(lat, device=device),
            torch.tensor([yaw], dtype=torch.float32, device=device),
            torch.as_tensor(trans, device=device),
            torch.as_tensor(K, device=device)))

        rgb = _synthesize_rgb(rng, nocs, mask, normals_enc)
        uvw = _quantize_uvw(nocs, mask)
        png.write(os.path.join(out_dir, f"{idx:05d}_rgb.png"),
                  (rgb * 255.0).round().astype(np.uint8))
        png.write(os.path.join(out_dir, f"{idx:05d}_uvw.png"), uvw)
        db[str(idx)] = [{
            "latent": [float(v) for v in lat],
            "extrinsics": [float(v) for v in pose.flatten()],
            "intrinsics": [float(v) for v in K.flatten()],
        }]

    with open(os.path.join(out_dir, "crops.json"), "w") as f:
        json.dump(db, f)
    return db


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Render a synthetic CSS-training crops database from a "
                    "DeepSDF checkpoint")
    p.add_argument("out_dir")
    p.add_argument("--deepsdf", required=True,
                   help="path to <name>.pt (with <name>.json specs beside "
                        "it)")
    p.add_argument("--latents", default=None,
                   help="latent table: LatentCodes .pth or .npy/.npz; "
                        "default = random unit-sphere latents")
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--crop-px", type=int, default=128)
    p.add_argument("--grid-density", type=int, default=40)
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--latent-jitter", type=float, default=0.0)
    p.add_argument("--n-random-latents", type=int, default=16,
                   help="table size when --latents is not given")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    cfg, params = deepsdf.load_torch_checkpoint(args.deepsdf, device=device)
    decoder_fn = deepsdf.sdf_fn(cfg, params)
    if args.latents:
        latents = load_latents(args.latents, cfg.latent_size)
    else:
        latents = sample_unit_latents(args.n_random_latents, cfg.latent_size,
                                      np.random.RandomState(args.seed + 1))
    make_crops(args.out_dir, decoder_fn, latents, args.n,
               crop_px=args.crop_px, grid_density=args.grid_density,
               capacity=args.capacity, seed=args.seed,
               latent_jitter=args.latent_jitter, device=device)
    print(f"wrote {args.n} crops + crops.json to {args.out_dir}")


if __name__ == "__main__":
    main()
