"""Top-level ATen ops a step that the loss graph's spans (the self time of
``train_step.forward`` and ``loss.*``) dispatch, over the traced steps
(``portbench/spans.py``). With ``loss_graph_host_ms`` it gives the host time
an op."""

from portbench.spans import ops_per_step


def read(ctx):
    return ops_per_step(ctx, "loss_graph")
