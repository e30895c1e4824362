"""Host-side launch calls per refine iteration in the traced window: kernel
launches (cudaLaunchKernel*, cuLaunchKernel*), graph launches and async
copies and fills, over the refine iterations the window ran. The host
paces the loop by these calls (refine.crops_per_wall_s); a cut that fuses
kernels also cuts the card's busy time, so this moves crops_per_card_s."""


def read(ctx):
    if not ctx.get("iterations") or not ctx["trace"].launches:
        return None
    return len(ctx["trace"].launches) / ctx["iterations"]
