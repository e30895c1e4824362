"""Kernel 1a (the dense surfel composite forward, csrc/splat.cu) against its
roofline: the least time of the window's forward renders, the larger of
the special-function ops of the point-pixel pairs whose footprint covers
the pixel (counted by the reference on the same inputs; never all N x P)
over the derived 4.18 T/s and their bytes over 3.35 TB/s, over the device
time of its launches, in %."""

from portbench import common, counts

PATTERNS = ("splat_fwd_split_kernel", "splat_fwd_kernel")


def read(ctx):
    if not ctx.get("splat_pairs_known"):
        return None
    least = counts.least_time_s(sfu=ctx["splat_sfu"],
                                nbytes=ctx["splat_bytes"])
    return common.kernel_share(ctx, PATTERNS, least)
