"""Batched multi-crop refinement: every crop of a frame in one loop.

Counterpart of sdflabel_tpu/parallel/batched_refine.py. JAX applies
``jax.vmap`` to the whole refine scan; here the refine loop itself carries
a leading crop axis (engine/refine.py::make_refine_batch_fn), and each
kernel on the loop takes it as a grid dimension: the dense splat forward
and backward (kernels 1a, 1b), the nearest neighbour (2) and the selection
MLP (3) launch once per iteration for the whole batch, each crop's result
bit-equal to a launch of that crop alone. The stage-2 kernels (4a, 4b,
``stage2_pallas``) and the row-binned splat (buckets of 4096 px and more)
still launch once per crop.

Not ported: the mesh (JAX shards the crop axis over a device mesh; the
port refuses ``mesh`` until multi-GPU lands), and ``batch_tile_hints``,
which returns the TPU splat kernel's tile defaults (0, 0): the port's
kernels have no tile knobs, so it has no counterpart.
"""

from __future__ import annotations

from sdflabel_tpu_torch.engine import labels as labels_mod
from sdflabel_tpu_torch.engine import refine as refine_mod


def make_batched_refine(sdf_decoder, cfg: refine_mod.RefineConfig,
                        grid_points, crop_hw: tuple[int, int],
                        select_decoder=None, stage2_fn=None,
                        with_extents: bool = False, mesh=None,
                        device="cuda"):
    """Returns refine_batch(params0_b, K_b, nocs_b, frustum_b, fmask_b,
    pixel_masks_b) -> (final, history) or, with_extents, (final, history,
    SurfaceExtents of each crop's final latent). The six arguments all
    carry the crop axis; the pixel mask is required (letterboxed crops
    always have one; pass ones for full-size crops). K varies per crop."""
    if mesh is not None:
        raise NotImplementedError("make_batched_refine(mesh=...) is not "
                                  "ported to sdflabel_tpu_torch yet (see "
                                  "ROADMAP.md)")
    refine = refine_mod.make_refine_batch_fn(
        sdf_decoder, cfg, grid_points, crop_hw, select_decoder=select_decoder,
        stage2_fn=stage2_fn, device=device)

    def refine_batch(params0, K, nocs, frustum, fmask, pixel_masks):
        final, hist = refine(params0, K, nocs, frustum, fmask, pixel_masks)
        if not with_extents:
            return final, hist
        ext = labels_mod.surface_extents(
            sdf_decoder, grid_points.to(final.latent.device), final.latent,
            capacity=cfg.surface_capacity, threshold=cfg.surface_threshold)
        return final, hist, ext

    return refine_batch
