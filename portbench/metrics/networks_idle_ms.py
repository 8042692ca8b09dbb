"""Device idle time a step (ms) while the networks' spans (``net.depth``,
``net.pose``, ``net.pyramid``, ``net.pwc``) are the innermost program spans
open, over the traced steps (``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "networks")
