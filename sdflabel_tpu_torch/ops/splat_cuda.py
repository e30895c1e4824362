"""Fused surfel splat + composite (kernel 1), forward and backward.

Counterpart of sdflabel_tpu/ops/splat_pallas.py, dense and row-binned
branches. The kernels live in csrc/splat.cu, whose source note says what
bounds them on the H100 and how the design follows. ``surfel_composite``
returns the composited (P, 8) image rows; CPU tensors take the plain
versions (ops/splat.py::surfel_composite_dense, or
:func:`surfel_composite_windowed` when binning is on) and CUDA tensors the
kernels.

The dense forward has two designs in csrc/splat.cu: the split design
(``SPLAT_FWD``, every dense render), which splits the points over a
cluster of up to 8 CTAs per 64-pixel tile and merges their softmax
partials in one launch, and the first design (``SPLAT_FWD_FIRST``), one
thread per pixel over all points, kept as the yardstick.
:func:`split_slices` says how many CTAs share a tile. The dense backward
likewise: the split design (``SPLAT_BWD``, every dense VJP) splits the
pixels over a cluster of up to 8 CTAs per block of 64 points and adds
their per-point partial gradients in rank order (:func:`bwd_split_slices`
CTAs a block); the first design (``SPLAT_BWD_FIRST``, one thread per point
over all pixels) is the yardstick, launched only by measurements and
tests.

Binning (splat_pallas.py:211-292) sorts the points by the first
``bin_px``-pixel row block their footprint can touch; each row block then
meets only a window of the sorted points. On the card a binned render is
three kernels: the bins (``SPLAT_BINS``, csrc/splat_bins.cu: keys, a
stable counting sort, the windows and the sorted points in two launches),
the forward on the split forward's tile over each tile's window
(``SPLAT_FWD_BINNED``) and, in the VJP, the backward on the split
backward's blocks over their rows, writing each point's gradient to its
own slot (``SPLAT_BWD_BINNED``). :func:`compute_bins` is the plain version
of the bins: it repeats the JAX arithmetic in fp32 operation for
operation, because the windows are right only while the row bound stays
conservative, and the kernel equals it bit for bit. The kernels take the
windows at point granularity; the TPU's rounding to point chunks only
widens them. The first designs (``compute_bins`` with torch gathers,
``SPLAT_FWD_BINNED_FIRST``, ``SPLAT_BWD_BINNED_FIRST`` with torch scatters)
are the yardsticks, reached only through the ``design`` argument of
:func:`_sort_bins`, :func:`_fwd_binned` and :func:`_bwd_binned`.

Tolerance against the plain version: the kernels take the plain
version's explicit footprint distance ||v - g z|| (the TPU kernel's
sqrt-free expanded form loses ~6% of diam^2 to rounding for points 10-20
units away; see csrc/splat.cu), so a footprint bit flips only for a pair
within fp32 rounding of the disc edge (the JAX package's own kernel test
allows 0.5% of pixels); elsewhere values agree to fp32 reassociation
(2e-4). A guarded pair (|n . g| < 0.01) passes no gradient in the kernel,
as on the TPU. The binned kernels sum in sorted point order: against the
dense kernel they differ by fp32 reassociation only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sdflabel_tpu_torch.ops import _cuda
from sdflabel_tpu_torch.ops import splat as splat_ops

NUM_FEATURES = 8  # [color(3) | mask(1) | depth(1) | normal(3)]

SPLAT_FWD = _cuda.CudaKernel("splat", "splat_fwd", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.F, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_FWD_FIRST = _cuda.CudaKernel("splat", "splat_fwd_first", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.F, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_BWD = _cuda.CudaKernel("splat", "splat_bwd", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_BWD_FIRST = _cuda.CudaKernel("splat", "splat_bwd_first", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.F, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_FWD_BINNED = _cuda.CudaKernel("splat", "splat_fwd_binned_split", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.I, _cuda.I,
    _cuda.F, _cuda.F, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_FWD_BINNED_FIRST = _cuda.CudaKernel("splat", "splat_fwd_binned", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.I, _cuda.F,
    _cuda.F, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_BWD_BINNED = _cuda.CudaKernel("splat", "splat_bwd_binned_split", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I,
    _cuda.I, _cuda.I, _cuda.F, _cuda.F, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_BWD_BINNED_FIRST = _cuda.CudaKernel("splat", "splat_bwd_binned", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I,
    _cuda.F, _cuda.F, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_BINS = _cuda.CudaKernel("splat_bins", "splat_bins", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P])

BIN_AUTO_PX = 512  # row-block size of the auto policy (splat_pallas.py:64)
BIN_MIN_PX = 4096  # renders from this many pixels up are binned


def bin_policy(num_px: int, bin_px: int | None = None) -> int:
    """The row-block size a render of `num_px` pixels uses, 0 for the dense
    sweep (splat_pallas.py:682-688): None or < 0 is auto (512 from 4096 px
    up), 0 forces dense, and fewer than two row blocks fall back to
    dense."""
    if bin_px is None or bin_px < 0:
        bin_px = BIN_AUTO_PX if num_px >= BIN_MIN_PX else 0
    if bin_px and num_px < 2 * bin_px:
        bin_px = 0
    return bin_px


class Bins(NamedTuple):
    """Row bins of one render (all on the points' device)."""

    order: torch.Tensor  # (N,) int64: sorted position -> point index
    key: torch.Tensor  # (N,) int64 sorted first row block; nb = none
    smax: torch.Tensor  # () int64: widest span last - first
    start: torch.Tensor  # (nb,) int64 first chunk of each block's window
    count: torch.Tensor  # (nb,) int64 chunks in the window


def bin_keys(pts: torch.Tensor, kg: torch.Tensor, diam: float,
             bin_px: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each packed point's (N, 8) [v, n, mask, 0] first row block and span
    on the rays (P, 4) [gx, gy, gz, gg], (N,) int64 each:
    splat_pallas.py::_compute_bins up to its sort. A point that touches
    no block has key nb and span 0."""
    p = kg.shape[0]
    nb = -(-p // bin_px)
    g = kg[:, 1:3]
    if nb * bin_px > p:  # pad by the last ray, as jnp.pad(mode='edge')
        g = torch.cat([g, g[-1:].expand(nb * bin_px - p, 2)])
    gy = g[:, 0].reshape(nb, bin_px)
    gz = g[:, 1].reshape(nb, bin_px)
    m_b, big_m = gy.amin(1), gy.amax(1)
    gz_lo, gz_hi = gz.amin(1), gz.amax(1)

    v_y, v_z, mask = pts[:, 1], pts[:, 2], pts[:, 6]
    zlo, zhi = v_z - diam, v_z + diam
    ylo, yhi = v_y - diam, v_y + diam
    safe_zlo = zlo.clamp(min=1e-12)[:, None]
    safe_gzlo = gz_lo.clamp(min=1e-12)[None, :]
    t_lo = safe_zlo / gz_hi.clamp(min=1e-12)[None, :]  # (N, nb)
    t_hi = zhi[:, None] / safe_gzlo
    gy_lo = torch.minimum(ylo[:, None] / t_lo, ylo[:, None] / t_hi)
    gy_hi = torch.maximum(yhi[:, None] / t_lo, yhi[:, None] / t_hi)
    ov = (gy_lo <= big_m[None, :]) & (gy_hi >= m_b[None, :])
    # no usable depth or ray bound: touch every block
    ov = ov | (gz_lo <= 0)[None, :]
    ov = torch.where((zlo > 0)[:, None], ov, True)
    ov = ov & (mask > 0.5)[:, None]  # masked points touch nothing

    any_ov = ov.any(1)
    ov8 = ov.to(torch.uint8)
    first = ov8.argmax(1)
    last = (nb - 1) - ov8.flip(1).argmax(1)
    span = torch.where(any_ov, last - first, 0)
    # points that touch nothing sort past every window
    return torch.where(any_ov, first, nb), span


def compute_bins(pts: torch.Tensor, kg: torch.Tensor, diam: float,
                 bin_px: int, chunk: int = 1) -> Bins:
    """splat_pallas.py::_compute_bins on the packed points (N, 8)
    [v, n, mask, 0] and rays (P, 4) [gx, gy, gz, gg]. ``chunk`` = 1 gives
    the windows at point granularity, as the kernels take them."""
    nb = -(-kg.shape[0] // bin_px)
    key, span = bin_keys(pts, kg, diam, bin_px)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    smax = span.max()
    blocks = torch.arange(nb, device=pts.device)
    starts = torch.searchsorted(key_sorted, blocks - smax, side="left")
    ends = torch.searchsorted(key_sorted, blocks, side="right")
    start_chunk = starts // chunk
    end_chunk = (ends + chunk - 1) // chunk
    return Bins(order, key_sorted, smax, start_chunk,
                (end_chunk - start_chunk).clamp(min=0))


def _pack_points(points_cam, normals_cam, mask):
    n = points_cam.shape[0]
    return torch.cat([points_cam.float(), normals_cam.float(),
                      mask.float()[:, None],
                      points_cam.new_zeros(n, 1, dtype=torch.float32)],
                     1).contiguous()


def _pack_rays(kinv_grid):
    """(P, 3) rays -> the kernels' (P, 4) rows [gx, gy, gz, 0]."""
    kg = kinv_grid.float()
    return torch.cat([kg, kg.new_zeros(kg.shape[0], 1)], 1).contiguous()


class SortedBins(NamedTuple):
    """What the binned kernels take: a render's points sorted by row block
    (all on the points' device)."""

    order: torch.Tensor  # (N,) sorted position -> point; int32 (first: int64)
    key: torch.Tensor  # (N,) int32 sorted first row block; nb = none
    smax: torch.Tensor  # (1,) int32 widest span
    win: torch.Tensor  # (nb, 2) int32 [start, end) of each block's window
    pts: torch.Tensor  # (N, 8) packed points in sorted order
    feats: torch.Tensor  # (N, 8) features in sorted order


@functools.lru_cache(maxsize=64)
def _bins_work(n: int, nb: int) -> int:
    """int32 scratch of the bins kernel for n points and nb row blocks."""
    return _cuda.query("splat_bins", "splat_bins_work", n, nb)


def _sort_bins(pts, feats, kg, diam, bin_px,
               design="kernel") -> SortedBins:
    """The packed points (N, 8) and features (N, 8) binned onto the rays
    (P, 4) and sorted: on the card through the bins kernel (two launches)
    or, with ``design="first"``, through :func:`compute_bins` and torch
    gathers (the first design, kept as the yardstick)."""
    dev = pts.device
    n, p = pts.shape[0], kg.shape[0]
    nb = -(-p // bin_px)
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("kg", kg, torch.float32, (p, 4), dev)
    if design == "first":
        bins = compute_bins(pts, kg, diam, bin_px)
        win = torch.stack([bins.start, bins.start + bins.count],
                          1).to(torch.int32).contiguous()
        return SortedBins(bins.order, bins.key.to(torch.int32),
                          bins.smax.reshape(1).to(torch.int32), win,
                          pts[bins.order].contiguous(),
                          feats[bins.order].contiguous())
    if design != "kernel":
        raise ValueError(f"design: {design!r}, expected 'kernel' or 'first'")
    if feats.data_ptr() % 16:  # the kernel copies rows as float4
        feats = feats.clone()
    ints = torch.empty(2 * n + 1 + 2 * nb, device=dev, dtype=torch.int32)
    order, key, smax, win = ints.split([n, n, 1, 2 * nb])
    rows = torch.empty(2, n, 8, device=dev, dtype=torch.float32)
    work = torch.empty(_bins_work(n, nb), device=dev, dtype=torch.int32)
    SPLAT_BINS(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(kg), n, p, bin_px,
               float(diam), _cuda.ptr(work), _cuda.ptr(order), _cuda.ptr(key),
               _cuda.ptr(smax), _cuda.ptr(win), _cuda.ptr(rows[0]),
               _cuda.ptr(rows[1]), _cuda.stream(pts))
    return SortedBins(order, key, smax, win.view(nb, 2), rows[0], rows[1])


def split_slices(n: int, p: int) -> int:
    """CTAs (point slices) that share each 64-pixel tile in the split
    dense forward for n points onto p pixels, on the current card."""
    return _cuda.query("splat", "splat_fwd_slices", n, p)


def bwd_split_slices(n: int, p: int) -> int:
    """CTAs (pixel slices) that share each block of 64 points in the split
    dense backward for n points onto p pixels, on the current card."""
    return _cuda.query("splat", "splat_bwd_slices", n, p)


def binned_slices(n: int, p: int, bin_px: int) -> int:
    """CTAs (window slices) that share each 64-pixel tile in the binned
    split forward, on the current card."""
    return _cuda.query("splat", "splat_fwd_binned_slices", n, p, bin_px)


def bwd_binned_slices(n: int, p: int, bin_px: int) -> int:
    """CTAs (row slices) that share each block of 64 sorted points in the
    binned split backward, on the current card."""
    return _cuda.query("splat", "splat_bwd_binned_slices", n, p, bin_px)


def _fwd(pts, feats, kg, diam, depth_constant, kernel=SPLAT_FWD):
    """The dense forward through `kernel`: SPLAT_FWD (the split design)
    or SPLAT_FWD_FIRST."""
    dev = pts.device
    n, p = pts.shape[0], kg.shape[0]
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("kg", kg, torch.float32, (p, 4), dev)
    img = torch.empty(p, NUM_FEATURES, device=dev, dtype=torch.float32)
    m, d, zn = (torch.empty(p, device=dev, dtype=torch.float32)
                for _ in range(3))
    kernel(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(kg), n, p, diam,
           float(depth_constant), _cuda.ptr(img), _cuda.ptr(m),
           _cuda.ptr(d), _cuda.ptr(zn), _cuda.stream(pts))
    return img, m, d, zn


def _fwd_binned(pts, feats, kg, win, bin_px, diam, depth_constant,
                design="split", slices=0):
    """The binned forward over sorted points and their windows: the split
    design (`slices` > 0 forces its cluster size) or, with
    ``design="first"``, the first design."""
    dev = pts.device
    n, p = pts.shape[0], kg.shape[0]
    nb = -(-p // bin_px)
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("kg", kg, torch.float32, (p, 4), dev)
    _cuda.check("win", win, torch.int32, (nb, 2), dev)
    img = torch.empty(p, NUM_FEATURES, device=dev, dtype=torch.float32)
    m, d, zn = (torch.empty(p, device=dev, dtype=torch.float32)
                for _ in range(3))
    extra = (slices,) if design == "split" else ()
    kernel = {"split": SPLAT_FWD_BINNED,
              "first": SPLAT_FWD_BINNED_FIRST}[design]
    kernel(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(kg), n, p,
           _cuda.ptr(win), bin_px, *extra, diam, float(depth_constant),
           _cuda.ptr(img), _cuda.ptr(m), _cuda.ptr(d), _cuda.ptr(zn),
           _cuda.stream(pts))
    return img, m, d, zn


def _bwd_binned(pts, feats, pix, key, smax, order, bin_px, diam,
                depth_constant, design="split", slices=0):
    """The binned backward over sorted points -> d_points, d_normals,
    d_features in the points' own order: the split design writes each row
    to its slot order[j] (`slices` > 0 forces its cluster size); the first
    design (``design="first"``) writes sorted rows that torch scatters."""
    dev = pts.device
    n, p = pts.shape[0], pix.shape[0]
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("pix", pix, torch.float32, (p, 16), dev)
    _cuda.check("key", key, torch.int32, (n,), dev)
    _cuda.check("smax", smax, torch.int32, (1,), dev)
    # one allocation for the three outputs, each a contiguous part of it
    dv, dn, df = torch.empty((6 + NUM_FEATURES) * n, device=dev,
                             dtype=torch.float32).split(
        [3 * n, 3 * n, NUM_FEATURES * n])
    dv, dn, df = dv.view(n, 3), dn.view(n, 3), df.view(n, NUM_FEATURES)
    if design == "split":
        _cuda.check("order", order, torch.int32, (n,), dev)
        SPLAT_BWD_BINNED(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(pix),
                         _cuda.ptr(key), _cuda.ptr(smax), _cuda.ptr(order),
                         n, p, bin_px, slices, diam, float(depth_constant),
                         _cuda.ptr(dv), _cuda.ptr(dn), _cuda.ptr(df),
                         _cuda.stream(pts))
        return dv, dn, df
    if design != "first":
        raise ValueError(f"design: {design!r}, expected 'split' or 'first'")
    SPLAT_BWD_BINNED_FIRST(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(pix),
                           _cuda.ptr(key), _cuda.ptr(smax), n, p, bin_px,
                           diam, float(depth_constant), _cuda.ptr(dv),
                           _cuda.ptr(dn), _cuda.ptr(df), _cuda.stream(pts))
    out = []
    for t in (dv, dn, df):  # sorted order -> each point's own slot
        u = torch.empty_like(t)
        u[order] = t
        out.append(u)
    return tuple(out)


def _bwd(pts, feats, pix, diam, depth_constant, kernel=SPLAT_BWD,
         slices=0):
    """The dense backward through `kernel`: SPLAT_BWD (the split design;
    `slices` > 0 forces its cluster size) or SPLAT_BWD_FIRST."""
    dev = pts.device
    n, p = pts.shape[0], pix.shape[0]
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("pix", pix, torch.float32, (p, 16), dev)
    # one allocation for the three outputs, each a contiguous part of it
    dv, dn, df = torch.empty((6 + NUM_FEATURES) * n, device=dev,
                             dtype=torch.float32).split(
        [3 * n, 3 * n, NUM_FEATURES * n])
    dv, dn, df = dv.view(n, 3), dn.view(n, 3), df.view(n, NUM_FEATURES)
    extra = (slices,) if kernel is SPLAT_BWD else ()
    kernel(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(pix), n, p, *extra,
           diam, float(depth_constant), _cuda.ptr(dv), _cuda.ptr(dn),
           _cuda.ptr(df), _cuda.stream(pts))
    return dv, dn, df


class _SurfelComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, points_cam, normals_cam, features, kinv_grid, mask,
                diam, depth_constant, bin_px):
        pts = _pack_points(points_cam, normals_cam, mask)
        feats = features.float().contiguous()
        kg = _pack_rays(kinv_grid)
        ctx.consts = (float(diam), depth_constant, bin_px)
        if not bin_px:
            img, m, d, zn = _fwd(pts, feats, kg, diam, depth_constant)
            ctx.save_for_backward(pts, feats, kg, m, d, zn, img)
            return img
        sb = _sort_bins(pts, feats, kg, diam, bin_px)
        img, m, d, zn = _fwd_binned(sb.pts, sb.feats, kg, sb.win, bin_px,
                                    diam, depth_constant)
        ctx.save_for_backward(sb.pts, sb.feats, kg, m, d, zn, img, sb.order,
                              sb.key, sb.smax)
        return img

    @staticmethod
    def backward(ctx, g_img):
        pts, feats, kg, m, d, zn, img, *binned = ctx.saved_tensors
        diam, depth_constant, bin_px = ctx.consts
        g = g_img.float()
        # softmax correction sum_i p_ip (g_p . f_i) == g_p . img_p
        corr = (g * img).sum(-1, keepdim=True)
        pix = torch.cat([kg, m[:, None], d[:, None], zn[:, None], corr, g],
                        1).contiguous()
        if not bin_px:
            dv, dn, df = _bwd(pts, feats, pix, diam, depth_constant)
        else:
            order, key, smax = binned
            dv, dn, df = _bwd_binned(pts, feats, pix, key, smax, order,
                                     bin_px, diam, depth_constant)
        return dv, dn, df, None, None, None, None, None


def surfel_composite_windowed(points_cam: torch.Tensor,
                              normals_cam: torch.Tensor,
                              features: torch.Tensor,
                              kinv_grid: torch.Tensor,
                              point_mask: torch.Tensor | None = None,
                              diam: float = 0.04,
                              depth_constant: float = 150.0,
                              bin_px: int = BIN_AUTO_PX) -> torch.Tensor:
    """Plain version of the binned kernels: each row block of `bin_px`
    pixels composited from its window of the sorted points only, through
    the dense plain arithmetic (ops/splat.py::surfel_prob). Equals
    surfel_composite_dense while the windows lose no footprint pair."""
    n = points_cam.shape[0]
    mask = (torch.ones(n, device=points_cam.device) if point_mask is None
            else point_mask.detach())
    bins = compute_bins(_pack_points(points_cam.detach(),
                                     normals_cam.detach(), mask),
                        _pack_rays(kinv_grid.detach()), diam, bin_px)
    o = bins.order
    v, nrm, f, msk = points_cam[o], normals_cam[o], features[o], mask[o]
    rows = []
    for b, (s, c) in enumerate(zip(bins.start.tolist(),
                                   bins.count.tolist())):
        kb = kinv_grid[b * bin_px:(b + 1) * bin_px].detach()
        prob = splat_ops.surfel_prob(kb, v[s:s + c], nrm[s:s + c],
                                     msk[s:s + c], diam, depth_constant)
        rows.append(prob.T @ f[s:s + c])
    return torch.cat(rows)


def surfel_composite(points_cam: torch.Tensor, normals_cam: torch.Tensor,
                     features: torch.Tensor, kinv_grid: torch.Tensor,
                     point_mask: torch.Tensor | None = None,
                     diam: float = 0.04, depth_constant: float = 150.0,
                     bin_px: int | None = None) -> torch.Tensor:
    """Fused splat_surfel(softclamp=False, add_bg=False) + prob.T @ feats:
    (N,3) points, (N,3) normals, (N,8) features, (P,3) pixel rays ->
    (P, 8). Gradients reach points, normals and features, not the rays.
    `bin_px` follows :func:`bin_policy` (None: auto)."""
    if features.shape[-1] != NUM_FEATURES:
        raise ValueError(f"features: {features.shape[-1]} channels, "
                         f"expected {NUM_FEATURES}")
    bin_px = bin_policy(kinv_grid.shape[0], bin_px)
    if points_cam.device.type == "cpu":
        plain = (splat_ops.surfel_composite_dense if not bin_px else
                 functools.partial(surfel_composite_windowed, bin_px=bin_px))
        return plain(points_cam, normals_cam, features, kinv_grid,
                     point_mask, diam, depth_constant)
    mask = (torch.ones(points_cam.shape[0], device=points_cam.device)
            if point_mask is None else point_mask.detach())
    return _SurfelComposite.apply(points_cam, normals_cam, features,
                                  kinv_grid.detach(), mask, diam,
                                  depth_constant, bin_px).to(points_cam.dtype)
