"""The share of the rendered pixels that belong to a real crop in the
traced window's frames, in %: the crops' own pixels (the ``pixels`` count
of each ``refine.frame`` span, the sum of h x w) over the pixels rendered
(``lane_pixels``: lanes after the power-of-two padding x the render
bucket's h x w), summed over the frames."""

from portbench import spans


def read(ctx):
    frames = [sp for sp in spans.window() if sp.name == "refine.frame"]
    lanes = sum(sp.counts.get("lane_pixels", 0) for sp in frames)
    if not lanes:
        return None
    return 100.0 * sum(sp.counts.get("pixels", 0) for sp in frames) / lanes
