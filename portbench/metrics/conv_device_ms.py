"""Device time a step (ms) of the kernels whose launching op is a
convolution or a matrix product: the networks' dense work."""

from portbench.trace import MATRIX_OPS


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.op_seconds(MATRIX_OPS)
    return 1e3 * s / ctx.trace.steps if s > 0 else None
