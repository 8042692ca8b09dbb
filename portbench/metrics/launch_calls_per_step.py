"""Host-side CUDA launch API calls a step (kernel and graph launches), from
the profiler's runtime events over the traced steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.launch_calls:
        return None
    return ctx.trace.launch_calls / ctx.trace.steps
