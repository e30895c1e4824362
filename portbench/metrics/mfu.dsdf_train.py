"""DeepSDF training's share of the card's fp32 peak: 3 x the forward matmul
FLOPs of the decoder chain x the rows stepped in the traced window, over
the window and 67 TFLOP/s (fp32 with TF32 off, as the configuration
states), in %."""


def read(ctx):
    if not ctx.get("train_flops") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["train_flops"] / (ctx["window_s"] * ctx["train_peak"])
