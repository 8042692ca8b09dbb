"""The warp-gather kernels' share of their roofline (%): the least time the
card could take for a step's launches (the frozen formulas' operations at
the f32 peak and bytes, ``flops.warp_bytes``, at the shapes of the
reference's ``warp`` calls) over the measured device time of the
``warp_gather*`` kernels by name.

The route is the configuration's ``warp_impl``: "pallas_fused" launches
``warp_gather`` for each forward call (its backward is elementwise);
"pallas" launches ``warp_gather_nograd`` for each forward call and
``warp_gather_bwd`` for each backward call. Another route, or float
sources sent to the plain sampler (``warp_bf16`` false), gives no reading.
"""

from portbench.flops import ELEMENT_SIZE, WARP_KERNEL_FLOPS_PER_PIXEL, bound_s, warp_bytes

KERNELS = ("warp_gather",)
ROUTES = {"pallas_fused": {"fwd": "warp_gather", "bwd": None},
          "pallas": {"fwd": "warp_gather_nograd", "bwd": "warp_gather_bwd"}}


def read(ctx):
    route = ROUTES.get(ctx.cfg.get("warp_impl"))
    if ctx.trace is None or route is None or not ctx.cfg.get("warp_bf16", True):
        return None
    measured = ctx.trace.device_seconds(KERNELS) / ctx.trace.steps
    if measured <= 0:
        return None
    esz = ELEMENT_SIZE[ctx.cfg["compute_dtype"]]
    bound = 0.0
    for name, phase, shape in ctx.calls.calls:
        kernel = route[phase] if name == "warp" else None
        if kernel is not None:
            n = shape[0]
            bound += bound_s(warp_bytes(kernel, n, esz), WARP_KERNEL_FLOPS_PER_PIXEL[kernel] * n,
                             "float32", ctx.device_name)
    return 100.0 * bound / measured if bound > 0 else None
