"""The readers of the sorted runner's telemetry on the CPU (host stamps
there): the replay gap on synthetic records, every reader within its
range in a traced hybrid run, and nothing reported by a program without
``runner.telemetry``."""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness

from conftest import small_bench

SPATIAL = "dragon_spatial_2M.episodes"
HYBRID = "dragon_hybrid_2M.episodes"

# the runner's telemetry readers and, on the CPU, the range each reads in
TELEMETRY = {"runner.step_ms_p99": (0.0, 1e4), "runner.order_ms_per_step": (0.0, 1e3),
             "runner.replay_gap_ms_per_step": (0.0, 1e3),
             "spatial.main_ms_per_step": (0.0, 1e3), "rescue.device_ms_per_step": (0.0, 1e4),
             "screenspace.stage_device_ms_per_step": (0.0, 1e3),
             "screenspace.step_undecided_share": (0.0, 100.0),
             "rescue.worklist_lanes_per_step": (0.0, 1152.0),
             "setup.tables_s": (0.0, 60.0), "setup.capture_s": (0.0, 60.0)}


def _run(root, bench, workload, *, trace_on=False, seconds=1.0, wrap=None, seed=2**31 + 3):
    spec = harness.cell(bench, workload, root=root)
    return harness.run_cell(spec, seed, seconds, trace_on, t0=time.perf_counter(),
                            device="cpu", wrap=wrap)


def test_replay_gap_counts_the_idle_inside_the_step_spans():
    """The gaps between one step's end stamp and the next's start, within
    the untraced window calls (the warm call and the traced positions
    left out), averaged; no call with two steps, nothing."""
    reader = harness.load_module(
        os.path.join(harness.ROOT, "metrics", "runner.replay_gap_ms_per_step.py"), "gap")
    mix = {"warm_chunks": 1, "episode_steps": 8, "chunk_steps": 2, "traced_chunks": [1]}
    recs = [SimpleNamespace(call=c, gap_ms=np.array(g)) for c, g in
            ((0, [9.0]), (1, [0.1, 0.3]), (2, [7.0]), (5, [0.2]), (7, []))]
    ctx = SimpleNamespace(mix=mix, values={"telemetry": (recs, {})})
    assert reader.read(ctx) == pytest.approx(0.6 / 3)
    ctx.values["telemetry"] = (recs[4:], {})
    assert reader.read(ctx) is None


def test_traced_run_reports_the_runner_telemetry(tmp_path):
    """The stamp and counter readers report in a traced hybrid run, each
    within its range; a step's period is at least the sum of its stages'
    means."""
    root = str(tmp_path)
    line = _run(root, small_bench(root, episode_steps=300, traced=(5, 14)), HYBRID,
                trace_on=True, seconds=0.5)
    assert line["correct"]
    for name, (lo, hi) in TELEMETRY.items():
        assert lo < line["metrics"][name]["value"] < hi, name
    v = {k: line["metrics"][k]["value"] for k in TELEMETRY}
    stages = (v["screenspace.stage_device_ms_per_step"] + v["runner.order_ms_per_step"]
              + v["spatial.main_ms_per_step"] + v["rescue.device_ms_per_step"])
    assert stages < v["runner.step_ms_p99"]


def test_telemetry_readers_report_nothing_without_the_telemetry(tmp_path):
    """A program without ``runner.telemetry`` (the parent of the readers),
    in a traced spatial run: every telemetry reader reports nothing, and
    the spatial cell has no screen-space stage to read."""
    root = str(tmp_path)

    class _Without:
        def __init__(self, inner):
            self.inner = inner
            self.runner = type("Runner", (), {})()

        def __getattr__(self, name):
            return getattr(self.inner, name)

    bench = small_bench(root, episode_steps=60, traced=(1,))
    for m in bench["per_layer"]:
        if m["name"].startswith("screenspace."):
            m["workloads"].append(SPATIAL)
    line = _run(root, bench, SPATIAL, trace_on=True, seconds=0.1, wrap=_Without)
    assert line["correct"]
    assert not set(line["metrics"]) & set(TELEMETRY)
    line = _run(root, bench, SPATIAL, trace_on=True, seconds=0.1)
    got = set(line["metrics"])
    assert {"runner.step_ms_p99", "rescue.worklist_lanes_per_step", "setup.tables_s"} <= got
    assert not got & {"screenspace.stage_device_ms_per_step",
                      "screenspace.step_undecided_share"}
