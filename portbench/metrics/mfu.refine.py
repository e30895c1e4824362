"""The refine's share of the card's bf16 peak: the decoder matmul FLOPs the
configuration's algorithm needs for the crops of the traced window (each
refresh's selection decode of the grid, each iteration's stage-2 decode
of the warm band with its normals and its backward, the label's surface)
over the window and 989 TFLOP/s, in %."""


def read(ctx):
    if not ctx.get("decoder_flops") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["decoder_flops"] / (ctx["window_s"]
                                          * ctx["decoder_peak"])
