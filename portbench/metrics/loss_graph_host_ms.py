"""Host self time a step (ms) of the loss graph's spans (the self time of
``train_step.forward`` and ``loss.*``), over the traced steps
(``portbench/spans.py``)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "loss_graph")
