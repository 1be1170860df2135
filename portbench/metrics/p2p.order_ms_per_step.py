"""p2p.order_ms_per_step (ms/step): the p2p runner's order stage on the
device clock (cell key, stable sort, CSR offsets, row gather and pad:
the stamps "start" to "order"), averaged over the untraced window steps
(``portbench/stamps.py``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.stage_ms_per_step(ctx, "order")
