"""domain.migrate_ms_per_step (ms/step): the domain runner's migration
stage on the device clock (the migrants' pack, their exchange and the
merge into the rank's slots: stamps "integrate" to "end"), averaged over
each card's untraced window steps, the mean over the cards
(``rank_stamps.py``)."""

from portbench import rank_stamps


def read(ctx):
    return rank_stamps.stage_ms_per_step(ctx, "end")
