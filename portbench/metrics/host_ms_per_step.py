"""Host time to enqueue one training step (the harness's span around the
step call, no sync), mean over the window's steps, in ms."""


def read(ctx):
    spans = ctx.spans.get("step")
    return 1e3 * sum(spans) / len(spans) if spans else None
