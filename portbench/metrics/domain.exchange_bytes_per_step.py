"""domain.exchange_bytes_per_step (B/step): the bytes a card sends its
neighbours a step, as sent: a ghost buffer and a migrant buffer of fixed
capacity to each neighbour, every slot's rows whether it holds a
particle or not (the runner's ``exchange_bytes_per_step``), the mean over
the cards (``rank_stamps.py``)."""

from portbench import rank_stamps


def read(ctx):
    return rank_stamps.value(ctx, "exchange_bytes_per_step")
