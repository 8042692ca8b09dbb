"""Device idle time a step (ms) while the loss graph's spans (the self time of
``train_step.forward`` and ``loss.*``) are the innermost program spans open,
over the traced steps (``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "loss_graph")
