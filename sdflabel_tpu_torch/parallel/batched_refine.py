"""Batched multi-crop refinement: every crop of a frame in one loop.

Counterpart of sdflabel_tpu/parallel/batched_refine.py. JAX applies
``jax.vmap`` to the whole refine scan; here the refine loop itself carries
a leading crop axis (engine/refine.py::make_refine_batch_fn), and each
kernel on the loop takes it as a grid dimension: the dense splat forward
and backward (kernels 1a, 1b), the nearest neighbour (2) and the selection
MLP (3) launch once per iteration for the whole batch, each crop's result
bit-equal to a launch of that crop alone; so do the stage-2 kernels (4a,
4b, ``stage2_pallas``) and the row-binned trio (the bins, 1c, 1d; buckets
of 4096 px and more).

With a mesh (parallel/mesh.py), the crop axis is sharded over its data
axis as JAX's ``P('data')`` sharding does: each rank refines its
contiguous share of the batch alone (no collective inside the loop; crops
do not couple), then the results are all-gathered over the data group,
so that every rank ends with the whole batch.

Not ported: ``batch_tile_hints``, which returns the TPU splat kernel's
tile defaults (0, 0): the port's kernels have no tile knobs, so it has no
counterpart.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.engine import labels as labels_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.utils.profiling import span


def make_batched_refine(sdf_decoder, cfg: refine_mod.RefineConfig,
                        grid_points, crop_hw: tuple[int, int],
                        select_decoder=None, stage2_fn=None,
                        with_extents: bool = False, mesh=None,
                        device="cuda"):
    """Returns refine_batch(params0_b, K_b, nocs_b, frustum_b, fmask_b,
    pixel_masks_b) -> (final, history) or, with_extents, (final, history,
    SurfaceExtents of each crop's final latent). The six arguments all
    carry the crop axis; the pixel mask is required (letterboxed crops
    always have one; pass ones for full-size crops). K varies per crop.

    With `mesh`, every rank of it calls refine_batch together with the
    whole batch, whose size must divide over the data axis; each refines
    its share (mesh.py::data_slice) and gets back the whole result."""
    refine = refine_mod.make_refine_batch_fn(
        sdf_decoder, cfg, grid_points, crop_hw, select_decoder=select_decoder,
        stage2_fn=stage2_fn, device=device)

    def refine_batch(params0, K, nocs, frustum, fmask, pixel_masks):
        if mesh is not None:
            cut = mesh_mod.data_slice(len(K), mesh)
            params0 = refine_mod.RefineParams(*(p[cut] for p in params0))
            K, nocs, frustum, fmask, pixel_masks = (
                t[cut] for t in (K, nocs, frustum, fmask, pixel_masks))
        out = refine(params0, K, nocs, frustum, fmask, pixel_masks)
        if with_extents:
            final = out[0]
            with span("refine.extents"):
                out += (labels_mod.surface_extents(
                    sdf_decoder, grid_points.to(final.latent.device),
                    final.latent, capacity=cfg.surface_capacity,
                    threshold=cfg.surface_threshold),)
        if mesh is None or mesh.shape["data"] == 1:
            return out
        return _gather_tree(out, mesh.data_group)

    return refine_batch


def _gather_tree(tree, group):
    """Every tensor of a tree of NamedTuples, all-gathered along its crop
    axis over `group` (no gradient: the loop is over)."""
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            return mesh_mod.all_gather(tree, group)
    parts = [_gather_tree(t, group) for t in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
