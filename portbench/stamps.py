"""The sorted runner's own telemetry (``runner.telemetry``: the stage
stamps and counters of its ``with_stats`` calls, one record a call, and
its set-up laps), as the stamp and counter readers take it.  ``take``
copies it in ``probe``, while the system lives; a program without it
leaves nothing, and those readers report nothing."""


def take(ctx) -> None:
    """Copy the runner's records and set-up laps into ``ctx.values``
    (once a run)."""
    if "telemetry" in ctx.values:
        return
    tel = getattr(getattr(ctx.system, "runner", None), "telemetry", None)
    ctx.values["telemetry"] = None if tel is None else (
        list(tel.records), dict(tel.setup_laps))


def calls(ctx, untraced: bool = True) -> list:
    """The records of the window's calls: the warm calls left out, and with
    ``untraced`` those at the mix's traced positions in every episode
    (``(call - warm_chunks) mod chunks-per-episode``), whose steps the
    profiler slows."""
    tel = ctx.values.get("telemetry")
    if not tel:
        return []
    warm = ctx.mix["warm_chunks"]
    per = ctx.mix["episode_steps"] // ctx.mix["chunk_steps"]
    traced = set(ctx.mix["traced_chunks"]) if untraced else set()
    return [r for r in tel[0] if r.call >= warm and (r.call - warm) % per not in traced]


def stage_ms_per_step(ctx, stage: str):
    """A stage's mean ms a step over the untraced window calls, or None."""
    recs = [r.stages_ms[stage] for r in calls(ctx) if stage in r.stages_ms]
    steps = sum(len(x) for x in recs)
    return float(sum(x.sum() for x in recs)) / steps if steps else None


def setup_s(ctx, lap: str):
    tel = ctx.values.get("telemetry")
    return tel[1].get(lap) if tel else None
