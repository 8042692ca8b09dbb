"""Time the training loop waits for its next batch on the card (the
harness's span around the call that takes the batch from the port's loader
and copies it to the card), mean over the window's steps, in ms. Only a cell
fed by the loader has it."""


def read(ctx):
    spans = ctx.spans.get("loader")
    return 1e3 * sum(spans) / len(spans) if spans else None
