"""Device time a step (ms) of the correlation lookup's kernels, by kernel
name: the bilinear sampler's forward and backward, as cuDNN's
``bilinear_sampler_{fw,bw}_4d`` (where ``F.grid_sample`` of RAFT's lookup
runs on the card: bilinear, zeros outside, ``align_corners=True``) or as
ATen's ``grid_sampler_2d`` kernels, and any ``corr_lookup`` kernel that
takes their place. Nothing else in a flow step samples with them. The zero
fill of the pyramid's gradient and the sum of the iterations' gradients
run on generic kernels and are not counted here."""

KERNELS = ("bilinear_sampler", "grid_sampler_2d", "corr_lookup")


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_seconds(KERNELS)
    return 1e3 * s / ctx.trace.steps if s > 0 else None
