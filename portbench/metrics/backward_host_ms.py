"""Host self time a step (ms) of ``train_step.backward`` (``zero_grad`` and
``backward()``), over the traced steps (``portbench/spans.py``)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "backward")
