"""Host self time a step (ms) of ``train_step.optimizer`` (the clip and
``optimizer.step()``), over the traced steps (``portbench/spans.py``)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "optimizer")
