"""Every rank's own telemetry of a cell on several cards, as the domain
runner's adapter hands it over (``systems/domain_runner.py::counters``,
gathered into ``ctx.rank_counters``): for each ``with_stats`` call its
index, steps, stage sums (ms) and counter sums.  The readers take each
card's figure and report the mean over the cards; a program without
that telemetry leaves nothing, and they report nothing."""

from __future__ import annotations


def _calls(ctx, c: dict, untraced: bool) -> list:
    """A rank's window calls: the warm calls left out, and with
    ``untraced`` those at the mix's traced positions (``stamps.calls``'s
    rule)."""
    warm = ctx.mix["warm_chunks"]
    per = ctx.mix["episode_steps"] // ctx.mix["chunk_steps"]
    traced = set(ctx.mix["traced_chunks"]) if untraced else set()
    return [x for x in c.get("calls", ())
            if x[0] >= warm and (x[0] - warm) % per not in traced]


def _mean(values: list):
    return sum(values) / len(values) if values else None


def stage_ms_per_step(ctx, stage: str):
    """A stage's ms a step over each card's untraced window calls, the
    mean over the cards."""
    per_card = []
    for c in ctx.rank_counters or ():
        calls = [x for x in _calls(ctx, c or {}, True) if stage in x[2]]
        steps = sum(x[1] for x in calls)
        if steps:
            per_card.append(sum(x[2][stage] for x in calls) / steps)
    return _mean(per_card)


def count_per_step(ctx, name: str):
    """A counter's sum a step over each card's window calls, the mean over
    the cards."""
    per_card = []
    for c in ctx.rank_counters or ():
        calls = _calls(ctx, c or {}, False)
        steps = sum(x[1] for x in calls)
        if steps:
            per_card.append(sum(x[3][name] for x in calls) / steps)
    return _mean(per_card)


def value(ctx, name: str):
    """A figure each card reports once (``counters()[name]``), the mean
    over the cards."""
    return _mean([c[name] for c in ctx.rank_counters or () if c and name in c])
