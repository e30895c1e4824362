"""CSS training's share of the card's fp32 peak: the FLOPs the stepped
images need (counts.css_train_flops: the forward of every convolution and
upsampling matmul at 128 px, and both gradients of the layers that train)
over the traced window and 67 TFLOP/s (fp32 with TF32 off, as the
configuration states), in %."""


def read(ctx):
    if not ctx.get("train_flops") or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["train_flops"] / (ctx["window_s"] * ctx["train_peak"])
