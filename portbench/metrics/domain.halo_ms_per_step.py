"""domain.halo_ms_per_step (ms/step): the domain runner's halo stage on
the device clock (the ghosts' pack and their exchange with the
neighbours: stamps "start" to "halo"), averaged over each card's
untraced window steps, the mean over the cards (``rank_stamps.py``)."""

from portbench import rank_stamps


def read(ctx):
    return rank_stamps.stage_ms_per_step(ctx, "halo")
