"""Share of the traced steps that replayed the train step's CUDA graph: the
``train_step.replay`` spans over the harness's ``portbench.step`` spans.
None when no step replayed (a step run op by op, or a program without the
graph)."""

from portbench.trace import STEP_SPAN

REPLAY = "train_step.replay"


def read(ctx):
    if ctx.trace is None:
        return None
    names = [h[2] for h in ctx.trace.host]
    steps, replays = names.count(STEP_SPAN), names.count(REPLAY)
    return replays / steps if steps and replays else None
