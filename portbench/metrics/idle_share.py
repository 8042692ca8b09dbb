"""Share of the traced span of steps in which no device activity ran:
1 - (union of the activities' intervals) / (the span)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
