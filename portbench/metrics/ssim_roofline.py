"""The SSIM kernels' share of their roofline (%): the least time the card
could take for a step's forward and backward launches (the frozen formulas'
operations at the f32 peak and bytes, 3 and 5 elements of the compute type a
pixel-channel, at the shapes the reference's step gives them) over their
measured device time by kernel name."""

from portbench.flops import ELEMENT_SIZE, SSIM_BWD_FLOPS, SSIM_FWD_FLOPS, bound_s

KERNELS = ("ssim_fwd_kernel", "ssim_bwd_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    measured = ctx.trace.device_seconds(KERNELS) / ctx.trace.steps
    if measured <= 0:
        return None
    esz = ELEMENT_SIZE[ctx.cfg["compute_dtype"]]
    bound = 0.0
    for name, phase, shape in ctx.calls.calls:
        if name != "ssim":
            continue
        n = 1
        for d in shape:
            n *= d
        if phase == "fwd":
            bound += bound_s(3 * n * esz, SSIM_FWD_FLOPS * n, "float32", ctx.device_name)
        else:
            bound += bound_s(5 * n * esz, SSIM_BWD_FLOPS * n, "float32", ctx.device_name)
    return 100.0 * bound / measured if bound > 0 else None
