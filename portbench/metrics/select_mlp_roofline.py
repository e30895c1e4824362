"""Kernel 3 (the selection MLP, csrc/select_mlp.cu) against its roofline:
the least time of the selection decodes the window's refreshes need (bf16
FLOPs with the latent absorbed over 989 TFLOP/s, or their bytes over 3.35
TB/s, the larger) over the device time of its launches, in %."""

from portbench import common, counts

PATTERNS = ("select_wgmma_kernel", "select_mlp_kernel")


def read(ctx):
    least = counts.least_time_s(flops=ctx.get("select_flops", 0.0),
                                peak_flops=counts.BF16_FLOPS,
                                nbytes=ctx.get("select_bytes", 0.0))
    return common.kernel_share(ctx, PATTERNS, least)
