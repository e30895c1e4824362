"""Pixel-sharded rendering over the mesh's rays axis.

Counterpart of sdflabel_tpu/parallel/rays.py. Every rank of a rays group
holds the whole (small) point set and composites only its block of
H*W / n_rays pixel rows; the blocks are all-gathered into the image. The
splat's softmax runs over points for each pixel, so a block needs nothing
of the other blocks. On the card each block goes through the splat
kernels (ops/splat_cuda.py::surfel_composite: the dense pair below 4096
pixels a block, the bins and the binned pair above; the bins come from
the block's own rays, so any contiguous block is valid); on the CPU
through their plain versions.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.ops import splat as splat_ops
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.ops.projection import project_dcm
from sdflabel_tpu_torch.parallel import mesh as mesh_mod


def make_rays_sharded_render(mesh: mesh_mod.Mesh, K,
                             resolution_px: tuple[int, int],
                             diam: float = 0.04,
                             depth_constant: float = 150.0):
    """render(coords, normals, pose, point_mask) -> the (3, H, W) NOCS image
    of a 'disc' render, whole on every rank of the rays group; H*W must
    divide over the rays axis. The inputs are the same on every rank; the
    gradients that reach them are the sum of every block's, the same on
    every rank (a loss over the image is then the unsharded render's)."""
    res_x, res_y = resolution_px
    n_rays = mesh.shape["rays"]
    p = res_x * res_y
    if p % n_rays:
        raise ValueError(f"{p} pixels do not divide over {n_rays} rays "
                         "shards")
    rows = p // n_rays
    group = mesh.rays_group

    def render(coords, normals, pose, point_mask):
        dev = coords.device
        K_t = torch.as_tensor(K, dtype=torch.float32, device=dev)
        if n_rays > 1:
            coords, normals, pose = (mesh_mod.from_replicated(t, group)
                                     for t in (coords, normals, pose))
        grid = splat_ops.pixel_grid(res_x, res_y, device=dev)
        grid = grid[mesh.rays_index * rows:(mesh.rays_index + 1) * rows]
        # the block's rays through the one shared definition: an
        # ulp-different variant flips binarized footprint bits
        kinv_block = splat_ops.kinv_pixel_rays(K_t, grid)
        proj = project_dcm(K_t, pose, coords, normals, normals,
                           resolution_px, output_nocs=True)
        v3d, nrm = proj.points_3d, proj.normals_3d
        feats = torch.cat([(proj.colors_3d + 1.0) / 2.0,
                           torch.ones_like(v3d[:, :1]), v3d[:, 2:3],
                           (nrm + 1.0) / 2.0], -1)
        img = splat_cuda.surfel_composite(
            v3d, nrm, feats, kinv_block, point_mask=point_mask, diam=diam,
            depth_constant=depth_constant)[:, :3]
        img = torch.clamp(img, max=1.0)
        if n_rays > 1:
            img = mesh_mod.all_gather(img, group)
        return img.T.reshape(3, res_y, res_x)

    return render
