"""Standalone renderer demo: render a DeepSDF latent (or a mesh) to PNG.

Counterpart of sdflabel_tpu/pipelines/render_demo.py (reference
sdfrenderer/main.py): ``render_sdf`` (:62-121: grid 40, latent [1, 0, 0],
a 200x100 image) and ``render_model`` (:13-59, a mesh's colored
vertices). The card by default; a 'disc' render of 200x100 px takes the
row-binned splat kernels (the bins and the binned forward).

Usage:
  python -m sdflabel_tpu_torch.pipelines.render_demo --model deepsdf.pt \\
      [--primitives disc|circle|circle_opt] [--out renderer_output] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sdflabel_tpu_torch.engine.refine import _device
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import grid as grid_ops
from sdflabel_tpu_torch.renderer import rasterer
from sdflabel_tpu_torch.utils import png


def _pose_y90(dist: float = 10.0) -> np.ndarray:
    """Camera pose: 90 deg about y, then z (sdfrenderer/main.py:78-84)."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    pose[:3, 3] = [0.0, 0.0, dist]
    return pose


def save_image(color_chw, path: str) -> None:
    """A (3, H, W) image in [0, 1] as an 8-bit PNG."""
    img = np.clip(np.asarray(torch.as_tensor(color_chw).detach().cpu()),
                  0, 1)
    png.write(path, (np.transpose(img, (1, 2, 0)) * 255).astype(np.uint8))


def _render(coords, normals, colors, pose, crop_size, primitives,
            output_nocs, device, point_mask=None, bg=None):
    K = torch.as_tensor(rasterer.calibration_matrix(crop_size), device=device)
    rendering, _ = rasterer.render(
        K, crop_size, coords, normals, colors,
        torch.as_tensor(pose, device=device), point_mask=point_mask,
        rot="dcm", primitives=primitives, output_nocs=output_nocs,
        bg=None if bg is None else torch.as_tensor(bg, device=device))
    return rendering


@torch.no_grad()
def render_sdf(path_dsdf: str, primitives: str = "disc",
               grid_density: int = 40, latent=(1.0, 0.0, 0.0),
               crop_size=(200, 100), output_dir: str = "renderer_output",
               bg=None, device="cuda"):
    """Render a DeepSDF latent (sdfrenderer/main.py:62-121); `bg`: an
    optional (3, H, W) background image. Returns (Rendering, PNG path)."""
    device = _device(device)
    cfg, params = deepsdf.load_torch_checkpoint(path_dsdf, device=device)
    surf, _ = grid_ops.surface_from_decoder(
        deepsdf.sdf_fn(cfg, params),
        torch.as_tensor(latent, dtype=torch.float32, device=device),
        grid_ops.generate_point_grid(grid_density, device=device),
        capacity=min(8192, grid_density ** 3))
    rendering = _render(surf.points, surf.normals, surf.normals, _pose_y90(),
                        crop_size, primitives, True, device,
                        point_mask=surf.mask, bg=bg)
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, "demo_dsdf.png")
    save_image(rendering.color, out)
    return rendering, out


@torch.no_grad()
def render_model(model_path: str, primitives: str = "disc",
                 crop_size=(200, 100), output_dir: str = "renderer_output",
                 device="cuda"):
    """Render a mesh's colored vertices (sdfrenderer/main.py:13-59),
    loaded by utils/meshio.py::load_mesh (.npz, .obj, else trimesh).
    Returns (Rendering, PNG path)."""
    from sdflabel_tpu_torch.utils import meshio

    device = _device(device)
    verts, normals, colors = (torch.as_tensor(np.asarray(a, np.float32),
                                              device=device)
                              for a in meshio.load_mesh(model_path))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    pose[:3, 3] = [0.0, 0.0, 10.0]
    rendering = _render(verts, normals, colors, pose, crop_size, primitives,
                        False, device)
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, "demo_cad.png")
    save_image(rendering.color, out)
    return rendering, out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", "-m", required=True,
                        help="DeepSDF .pt checkpoint or mesh file")
    parser.add_argument("--primitives", "-p", default="disc",
                        help="circle, circle_opt, disc")
    parser.add_argument("--out", default="renderer_output")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if os.path.splitext(args.model)[1] == ".pt":
        _, out = render_sdf(args.model, args.primitives,
                            output_dir=args.out, device=args.device)
    else:
        _, out = render_model(args.model, args.primitives,
                              output_dir=args.out, device=args.device)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
