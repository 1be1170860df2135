"""domain.ghost_lanes_per_step (lanes/step): the ghosts a card receives
from its neighbours a step (the live lanes of its two halo buffers, the
runner's "ghosts" counter), over each card's window steps, the mean over
the cards (``rank_stamps.py``)."""

from portbench import rank_stamps


def read(ctx):
    return rank_stamps.count_per_step(ctx, "ghosts")
