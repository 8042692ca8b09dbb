"""The cost-volume kernels' share of their roofline (%): the least time the
card could take for the forward, df1 and df2 launches of a step (the frozen
formulas' operations and bytes at the shapes the reference's step gives them,
at the peaks of the configuration's compute type) over their measured device
time by kernel name."""

from portbench.flops import ELEMENT_SIZE, bound_s, corr_bytes, corr_flops

KERNELS = ("corr_fwd_kernel", "corr_bwd_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    measured = ctx.trace.device_seconds(KERNELS) / ctx.trace.steps
    if measured <= 0:
        return None
    dt = ctx.cfg["compute_dtype"]
    bound = 0.0
    for name, phase, shape in ctx.calls.calls:
        if name != "correlation":
            continue
        b, h, w, c, md, k = shape
        fwd_bytes, half_bytes = corr_bytes(b, h, w, c, md, ELEMENT_SIZE[dt])
        fl = corr_flops(b, h, w, c, md)
        if phase == "fwd":
            bound += bound_s(fwd_bytes, fl, dt, ctx.device_name)
        else:
            bound += k * bound_s(half_bytes, fl, dt, ctx.device_name)
    return 100.0 * bound / measured if bound > 0 else None
