"""The harness on more than one rank, on the CPU: two gloo ranks of one
thread each run the port's mesh runner (``mesh_system.py``) on a small
DragonScene through ``workers.Workers``, ``ranks.join`` and
``harness.run_cell`` (``ranks_run.py``, in a process of its own).  A
sound run reads ``correct`` with the readings merged over the ranks; one
rank's output broken reads ``correct`` false; a worker that raises, is
killed or hangs in the window ends the run with no line, in bounded
time, and leaves no process; a one-rank run starts no process and no
group."""

import json
import multiprocessing
import os
import subprocess
import sys
import time
import uuid

import pytest
import torch.distributed as dist

from portbench import harness, workers

from conftest import small_bench

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "dragon_spatial_mesh.episodes"
SEED = 2**31 + 5
# a run's own time, far under the limit; a fault must end it well inside
LIMIT_S = 240


def mesh_bench(root, world=2, fault=None):
    """The small benchmark with one more cell: the spatial configuration
    on ``world`` ranks through the mesh runner (the particles padded so
    that every rank's slice is whole), read by the device's idle share,
    two counters, and ``ranks.steps`` (the steps of every rank, from
    ``ctx.rank_counters``)."""
    bench = small_bench(root)
    with open(bench["configs"][0]["file"], encoding="utf-8") as f:
        cfg = json.load(f)
    cfg.update(name="dragon_spatial_mesh", system="../tests/mesh_system")
    cfg["particles"]["pad_multiple"] = 1024 * world
    if fault:
        cfg["fault"] = fault
    path = os.path.join(root, "configs", "dragon_spatial_mesh.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "metrics", "ranks.steps.py"), "w", encoding="utf-8") as f:
        f.write("def read(ctx):\n"
                "    return float(sum(c['steps'] for c in ctx.rank_counters))\n")
    bench["configs"].append({"name": "dragon_spatial_mesh", "file": path})
    bench["workloads"].append({"name": CELL, "config": "dragon_spatial_mesh",
                               "traffic": "episodes", "chips": world})
    for m in bench["per_layer"]:
        if m["name"] in ("device.idle_share", "runner.host_reads_per_step",
                         "rescue.overflow_lanes_per_step"):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "ranks.steps", "unit": "steps",
                               "workloads": [CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(bench, f)
    return bench


def left_behind(mark: str) -> list:
    """Processes whose environment holds ``mark``."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/environ", "rb") as f:
                    if mark.encode() in f.read():
                        out.append(int(d))
            except OSError:
                continue
    return out


def run_ranks(root, *, trace_on=False, seconds=0.0, wait_s=""):
    """(exit code, the last line of standard output or None, standard
    error, seconds taken, processes of the run left behind)."""
    mark = f"PORTBENCH_TEST_{uuid.uuid4().hex}"
    env = dict(os.environ, PYTHONPATH=harness.REPO, **{mark: "1"})
    t = time.monotonic()
    out = subprocess.run([sys.executable, os.path.join(HERE, "ranks_run.py"), root, CELL,
                          str(SEED), str(seconds), str(int(trace_on)), str(wait_s)],
                         cwd=harness.REPO, env=env, capture_output=True, text=True,
                         timeout=LIMIT_S)
    took = time.monotonic() - t
    lines = out.stdout.strip().splitlines()
    for _ in range(50):  # a killed process may take a moment to go
        left = left_behind(mark)
        if not left:
            break
        time.sleep(0.1)
    return out.returncode, (lines[-1] if lines else None), out.stderr, took, left


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_run_on_two_ranks_is_correct_and_merges_its_readings(tmp_path, trace_on):
    """The reference's judge reads ``correct`` over the whole state
    gathered from both ranks; ``device.count`` is the ranks; with
    ``--trace 1`` the merged ``busy_s``/``window_s``, the peaks by rank
    and every rank's counters (two ranks' steps) are in the line."""
    root = str(tmp_path)
    mesh_bench(root)
    rc, last, err, _, left = run_ranks(root, trace_on=trace_on)
    assert rc == 0, err[-4000:]
    line = json.loads(last)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k != "chunks_compared")
    assert line["attempted"] == 6  # one episode: the window ends with it
    assert line["device"]["count"] == 2
    assert line["device"]["memory_peak_bytes_by_rank"] == [0, 0]  # the CPU
    assert list(line)[-1] == "checks" and not left
    if trace_on:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        steps = line["metrics"]["ranks.steps"]["value"]
        assert steps == 2 * 20 * (1 + line["attempted"])  # the warm call and the window's
        assert 0.0 <= line["metrics"]["rescue.overflow_lanes_per_step"]["value"]
        assert "device.idle_share" not in line["metrics"]  # no device records on the CPU
    else:
        assert set(line["metrics"]) == {"particle_steps_per_s", "setup_s"}


def test_one_ranks_output_broken_is_not_correct(tmp_path):
    """Rank 1 alters one of its particles in every call of the window."""
    root = str(tmp_path)
    mesh_bench(root, fault={"rank": 1, "at_call": 2, "kind": "answer"})
    rc, last, err, _, left = run_ranks(root)
    assert rc == 0, err[-4000:]
    line = json.loads(last)
    assert not line["correct"] and line["failed"] >= 1
    assert not left


# rank 0's wait on the others in the window, lowered for the hang
WAIT_S = 5.0


@pytest.mark.parametrize("kind", ["raise", "kill", "hang"])
def test_a_worker_that_fails_in_the_window_ends_the_run_with_no_line(tmp_path, kind):
    """Rank 1 raises, is killed, or hangs at its fourth call (the
    window's third): the run exits with the watchdog's code and no line,
    well inside its time, and no process of it is left.  A hang ends it
    when rank 0's wait on the others passes its limit (``WAIT_S`` here)."""
    root = str(tmp_path)
    mesh_bench(root, fault={"rank": 1, "at_call": 4, "kind": kind})
    rc, last, err, took, left = run_ranks(root, wait_s=WAIT_S)
    assert rc == workers.FAULT_EXIT, err[-4000:]
    assert last is None or not last.startswith("{"), last
    why = (f"rank 0 waited over {WAIT_S} s on the other ranks" if kind == "hang" else
           "rank 1 ended with exit code")
    assert why in err, err[-4000:]
    assert took < LIMIT_S and not left


# a one-chip CPU run of the small benchmark's spatial cell at seed
# 2**31 + 3, one episode, as the harness gave it before it had ranks, its
# values that are not times: (metric, unit) in order, each check's limit
LINE_BEFORE_RANKS = {
    False: ([("particle_steps_per_s", "particle-steps/s"), ("setup_s", "s")],
            {"free_gap.chunk0": 0.02, "contact_far_pct.chunk0": 20,
             "free_gap.chunk3": 0.02, "contact_far_pct.chunk3": 20,
             "free_gap.chunk5": 0.02, "contact_far_pct.chunk5": 20,
             "chunks_compared": 3}),
    True: ([("runner.host_reads_per_step", "reads/step"),
            ("rescue.overflow_lanes_per_step", "lanes/step"), ("runner.step_ms_p99", "ms"),
            ("runner.replay_gap_ms_per_step", "ms/step"),
            ("runner.order_ms_per_step", "ms/step"), ("spatial.main_ms_per_step", "ms/step"),
            ("rescue.device_ms_per_step", "ms/step"),
            ("rescue.worklist_lanes_per_step", "lanes/step"), ("setup.tables_s", "s"),
            ("setup.capture_s", "s")],
           {"free_gap.chunk0": 0.02, "contact_far_pct.chunk0": 20,
            "free_gap.chunk2": 0.02, "contact_far_pct.chunk2": 20,
            "free_gap.chunk3": 0.02, "contact_far_pct.chunk3": 20,
            "free_gap.chunk5": 0.02, "contact_far_pct.chunk5": 20,
            "chunks_compared": 3}),
}


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_one_rank_run_gives_the_line_it_gave_before_ranks(tmp_path, trace_on):
    """One rank starts no process and no group, and its line holds what
    it held before the harness had ranks, the times aside: the keys in
    their order, ``device``, the metrics and their units, the checks and
    their limits."""
    root = str(tmp_path)
    spec = harness.cell(small_bench(root), "dragon_spatial_2M.episodes", root=root)
    line = harness.run_cell(spec, 2**31 + 3, 0.0, trace_on, t0=time.perf_counter(),
                            device="cpu")
    assert not multiprocessing.active_children() and not dist.is_initialized()
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace_on else []) + ["checks"]
    assert (line["correct"], line["attempted"], line["failed"]) == (True, 6, 0)
    metrics, limits = LINE_BEFORE_RANKS[trace_on]
    assert [(k, m["unit"]) for k, m in line["metrics"].items()] == metrics
    assert {k: c["limit"] for k, c in line["checks"].items()} == limits
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k != "chunks_compared")
    assert line["checks"]["chunks_compared"]["value"] == (4 if trace_on else 3)
    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if trace_on:
        device.update(busy_s=0.0, window_s=0.0)
        assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert line["device"] == device
