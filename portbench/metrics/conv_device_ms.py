"""Device time a step (ms) of the convolutions' and matrix products'
kernels, by kernel name (``trace.CONV_KERNELS``): the networks' dense work,
whether the step dispatched its ops or replayed a CUDA graph."""

from portbench.trace import CONV_KERNELS


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_seconds(CONV_KERNELS)
    return 1e3 * s / ctx.trace.steps if s > 0 else None
