"""Device time a step (ms) of the depth decoder's reflection pads, by kernel
name: ATen's ``reflection_pad2d`` forward and backward kernels, or the
port's ``reflect_pad`` kernels where they take their place. Nothing but the
depth decoder's 3x3 convolutions pads by reflection. The layout conversions
cuDNN makes of an NCHW pad's output are convolution kernels
(``conv_device_ms``) and are not counted here."""

KERNELS = ("reflection_pad", "reflect_pad")


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_seconds(KERNELS)
    return 1e3 * s / ctx.trace.steps if s > 0 else None
