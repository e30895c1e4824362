"""The yardstick's arithmetic: the peaks of one NVIDIA H100 and the work
(operations, bytes, special-function ops) that each measured piece needs
for its inputs, whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W limit: 989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores,
3.35 TB/s HBM. The special-function rate is derived, not published: 132
SMs x 16 SFU results a clock x 1.98 GHz = 4.18 T/s.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def decoder_layer_io(latent: int, dims: list[int], latent_in: list[int]):
    """(in, out) of each linear layer of the DeepSDF decoder
    (deep_sdf_decoder_scale.py: the concat bookkeeping lives in the
    previous layer's out width; no xyz_in_all)."""
    widths = [latent + 3, *dims, 1]
    io = []
    for l in range(len(widths) - 1):
        out = widths[l + 1] - widths[0] if l + 1 in latent_in \
            else widths[l + 1]
        io.append((widths[l], out))
    return io


def decoder_macs(latent: int, dims: list[int], latent_in: list[int],
                 absorb_latent: bool = False) -> int:
    """Multiply-adds of one point through the decoder. `absorb_latent`:
    the latent's columns of the layers that take it (the first and each
    latent_in layer) are constant per crop, so a selection decode needs
    them once a crop, not once a point; they are left out."""
    total = 0
    for l, (i, o) in enumerate(decoder_layer_io(latent, dims, latent_in)):
        if absorb_latent and (l == 0 or l in latent_in):
            i -= latent
        total += i * o
    return total


def decoder_weight_count(latent: int, dims: list[int],
                         latent_in: list[int]) -> int:
    return sum(i * o + o for i, o in
               decoder_layer_io(latent, dims, latent_in))


def select_mlp_work(points: int, latent: int, dims: list[int],
                    latent_in: list[int]) -> tuple[float, float]:
    """(bf16 FLOPs, bytes) of one selection decode of `points` points:
    the points read once (3 fp32), the bf16 weights read once, one fp32
    sdf written a point."""
    flops = 2.0 * points * decoder_macs(latent, dims, latent_in,
                                        absorb_latent=True)
    nbytes = points * (12 + 4) + 2 * decoder_weight_count(latent, dims,
                                                          latent_in)
    return flops, nbytes


def splat_fwd_work(footprint_pairs: float, points: int, pixels: int,
                   features: int = 8) -> tuple[float, float]:
    """(special-function ops, bytes) of one dense surfel composite
    forward. Only the point-pixel pairs whose disc footprint covers the
    pixel contribute; each needs at least two special-function results
    (its ray depth's reciprocal and its softmax exponential). Bytes: each
    point's position, normal and features read once, each pixel's ray read
    once and its features written once, fp32."""
    sfu = 2.0 * footprint_pairs
    nbytes = 4.0 * (points * (3 + 3 + features) + pixels * (3 + features))
    return sfu, nbytes


def least_time_s(flops: float = 0.0, peak_flops: float = BF16_FLOPS,
                 nbytes: float = 0.0, sfu: float = 0.0) -> float:
    """The least time the card can take: the larger of the operations over
    their peak, the bytes over the memory rate and the special-function ops
    over their rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S,
               sfu / SFU_OPS_PER_S)


def css_macs(width: int, size: int = 128, latent: int = 3):
    """(multiply-adds of one image through the CSS net's convolutions and
    upsampling matmuls, the part of them in layers that train). The net:
    sdflabel's ResNet18 trunk to layer3 and four U-Net heads (u, v, w of
    256 bins, mask of 2), input (3, size, size)."""
    wd = width
    frozen, train = 0, 0

    def conv(cin, cout, k, hw):
        return cin * cout * k * k * hw * hw

    def up(c, h):  # (c, h, h) -> (c, 2h, 2h): two interpolation matmuls
        return 2 * h * h * c * h + 2 * h * h * c * 2 * h

    s = size
    frozen += conv(3, wd, 7, s // 2)
    frozen += 4 * conv(wd, wd, 3, s // 4)                      # layer1
    train += conv(wd, 2 * wd, 3, s // 8) + conv(2 * wd, 2 * wd, 3, s // 8) \
        + conv(wd, 2 * wd, 1, s // 8) + 2 * conv(2 * wd, 2 * wd, 3, s // 8)
    train += conv(2 * wd, 4 * wd, 3, s // 16) \
        + conv(4 * wd, 4 * wd, 3, s // 16) + conv(2 * wd, 4 * wd, 1, s // 16) \
        + 2 * conv(4 * wd, 4 * wd, 3, s // 16)
    train += conv(4 * wd, latent, 1, s // 16)
    for ch in (256, 256, 256, 2):
        train += up(4 * wd, s // 16) + conv(6 * wd, 2 * wd, 3, s // 8) \
            + conv(2 * wd, 2 * wd, 3, s // 8)
        train += up(2 * wd, s // 8) + conv(3 * wd, wd, 3, s // 4) \
            + conv(wd, wd, 3, s // 4)
        train += up(wd, s // 4) + conv(2 * wd, wd, 3, s // 2) \
            + conv(wd, wd, 3, s // 2)
        train += up(wd, s // 2) + 2 * conv(wd, wd, 3, s)
        train += conv(wd, ch, 1, s)
    return frozen + train, train


def css_train_flops(width: int, size: int = 128, latent: int = 3) -> float:
    """FLOPs one training image needs: the forward of every layer, and the
    gradients (to the inputs and to the weights) of the layers that train;
    the frozen conv1 / layer1 need neither."""
    total, train = css_macs(width, size, latent)
    return 2.0 * (total + 2 * train)
