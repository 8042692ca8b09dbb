"""Device idle time a step (ms) while ``train_step.optimizer`` (the clip and
``optimizer.step()``) are the innermost program spans open, over the traced
steps (``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "optimizer")
