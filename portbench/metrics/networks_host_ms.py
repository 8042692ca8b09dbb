"""Host self time a step (ms) of the networks' spans (``net.depth``,
``net.pose``, ``net.pyramid``, ``net.pwc``), over the traced steps
(``portbench/spans.py``)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "networks")
