"""Device time a step (ms) of every device activity but the convolutions'
and matrix products' kernels (by name, ``trace.CONV_KERNELS``) and the
hand-written kernels: the loss graph's elementwise work, the networks'
normalisations and activations, copies and the optimizer."""

from portbench.trace import CONV_KERNELS

HAND_WRITTEN = ("warp_gather", "corr_fwd_kernel", "corr_bwd_kernel", "ssim_fwd_kernel",
                "ssim_bwd_kernel", "splat_window_kernel", "splat_direct_kernel",
                "splat_cast_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    s = t.device_seconds() - t.device_seconds(CONV_KERNELS) - t.device_seconds(HAND_WRITTEN)
    return 1e3 * s / t.steps if s > 0 else None
