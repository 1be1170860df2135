"""The harness on the CPU: it finds cells, mixes, configurations and
metrics by name; a run whose timed path is broken reads ``correct``
false; its arithmetic on synthetic inputs; the readers of the sorted
runner's telemetry (host stamps on the CPU): the replay gap on synthetic
records, every reader within its range in a traced hybrid run, and
nothing reported by a program without ``runner.telemetry``; the command
refuses a machine without a card; ``BENCHMARK.json`` keeps the
contract's form."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, roofline, roofline_p2p, trace

from conftest import REPO, small_bench

SPATIAL = "dragon_spatial_2M.episodes"
HYBRID = "dragon_hybrid_2M.episodes"


def _run(root, bench, workload, *, trace_on=False, seconds=1.0, wrap=None, seed=2**31 + 3):
    spec = harness.cell(bench, workload, root=root)
    return harness.run_cell(spec, seed, seconds, trace_on, t0=time.perf_counter(),
                            device="cpu", wrap=wrap)


def test_a_new_configuration_mix_and_metric_are_found_by_name(tmp_path):
    """New files and entries only: a configuration (the spatial one with a
    lower drop), a mix (shorter episodes) and a metric whose reader counts
    the window's steps; the harness runs the cell and reports it."""
    root = str(tmp_path)
    bench = small_bench(root)
    with open(bench["configs"][0]["file"], encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["name"] = "dragon_spatial_low"
    cfg["sim"]["spawn_origin"] = [0.0, 399.0, 0.0]
    path = os.path.join(root, "configs", "dragon_spatial_low.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "short.json"), "w", encoding="utf-8") as f:
        json.dump({"episode_steps": 40, "chunk_steps": 10, "warm_chunks": 1,
                   "compare_fixed": [0, 3], "compare_drawn": 1, "traced_chunks": [1]}, f)
    with open(os.path.join(root, "metrics", "window.steps.py"), "w", encoding="utf-8") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    bench["configs"].append({"name": "dragon_spatial_low", "file": path})
    bench["workloads"].append({"name": "dragon_spatial_low.short",
                               "config": "dragon_spatial_low", "traffic": "short",
                               "chips": 1})
    bench["per_layer"].append({"name": "window.steps", "unit": "steps",
                               "workloads": ["dragon_spatial_low.short"]})
    for m in bench["per_layer"]:
        if m["name"] == "runner.host_reads_per_step":
            m["workloads"].append("dragon_spatial_low.short")
    w, got_cfg, mix, e2e, layers = harness.cell(bench, "dragon_spatial_low.short", root=root)
    assert got_cfg["sim"]["spawn_origin"] == [0.0, 399.0, 0.0]
    assert mix["episode_steps"] == 40
    assert [m["name"] for m, _ in layers] == ["runner.host_reads_per_step", "window.steps"]
    assert {m["name"] for m, _ in e2e} == {"particle_steps_per_s", "setup_s"}
    line = _run(root, bench, "dragon_spatial_low.short", trace_on=True)
    assert line["correct"]
    assert 0.0 < line["metrics"]["runner.host_reads_per_step"]["value"] < 1.0
    assert line["metrics"]["window.steps"]["value"] == 10.0 * line["attempted"]
    assert line["attempted"] % 4 == 0  # whole episodes
    assert line["checks"]["chunks_compared"]["value"] >= 3


@pytest.mark.parametrize("workload", [SPATIAL, HYBRID])
def test_sound_runs_are_correct(tmp_path, workload):
    root = str(tmp_path)
    line = _run(root, small_bench(root), workload, seconds=2.0)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"particle_steps_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k != "chunks_compared")
    assert line["attempted"] % 6 == 0  # the window ends with an episode


class _Broken:
    """The program with one fault planted in its timed path."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run(self, state, steps, with_stats=False):
        out, ovf = self.inner.run(state, steps, with_stats)
        if self.fault == "unchanged":  # a step that returns its state unchanged
            return state, ovf
        pos, vel, col = out.pos.clone(), out.vel.clone(), out.collisions.clone()
        if self.fault == "half":  # half of the particles left out
            pos[:, 1::2], vel[:, 1::2] = state.pos[:, 1::2], state.vel[:, 1::2]
            col[1::2] = state.collisions[1::2]
        elif self.fault == "answer":  # one particle's answer altered by a radius
            pos[1, 7] += state.radius[7]
        return out._replace(pos=pos, vel=vel, collisions=col), ovf


class _Control:
    """The reference, computed in another precision, in the program's
    place."""

    def __init__(self, inner, ref):
        self.inner, self.ref = inner, ref

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run(self, state, steps, with_stats=False):
        src = {k: getattr(state, k) for k in ("pos", "vel", "collisions", "radius",
                                               "restitution")}
        got = self.ref.run(src, steps)
        return state._replace(pos=got["pos"].float(), vel=got["vel"].float(),
                              collisions=got["collisions"]), None


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    """Each fault a one-chip cell can have (a step that leaves its state
    unchanged, half the particles left out, one answer altered where the
    system produces it) makes ``correct`` false."""
    root = str(tmp_path)
    line = _run(root, small_bench(root), SPATIAL, wrap=lambda s: _Broken(s, fault))
    assert not line["correct"] and line["failed"] >= 1


def test_the_bfloat16_control_is_not_correct(tmp_path):
    root = str(tmp_path)
    bench = small_bench(root)
    _, cfg, _, _, _ = harness.cell(bench, HYBRID, root=root)
    low = harness.load_reference(cfg, harness.build_scene(cfg), "cpu", dtype=torch.bfloat16)
    line = _run(root, bench, HYBRID, wrap=lambda s: _Control(s, low))
    assert not line["correct"]
    assert line["checks"]["free_gap.chunk0"]["value"] > 0.1


@pytest.mark.parametrize("workload", [SPATIAL, HYBRID])
def test_a_change_of_rounding_alone_is_correct(tmp_path, workload):
    """The reference computed in float64 in the program's place differs
    from the float32 one by rounding alone, as a kernel that fuses a
    multiply-add would: the lanes in no contact stay within the
    tolerance, and those in contact that part ways stay under the
    limit."""
    root = str(tmp_path)
    bench = small_bench(root)
    _, cfg, _, _, _ = harness.cell(bench, workload, root=root)
    wide = harness.load_reference(cfg, harness.build_scene(cfg), "cpu", dtype=torch.float64)
    line = _run(root, bench, workload, wrap=lambda s: _Control(s, wide))
    assert line["correct"], line["checks"]
    assert any(c["value"] > 0 for k, c in line["checks"].items() if k.startswith("free_gap"))


def test_compare_tells_free_lanes_from_lanes_in_contact():
    """Lane 0 falls free and is off by 0.5; lane 1 is in contact on the
    reference's side only; lane 2 in contact on both, within the
    tolerance; lane 3 in contact on both, its velocity off by 3 (0.03 a
    step); lane 4 is padding, off by any amount."""
    ref = {"pos": torch.zeros(3, 5), "vel": torch.zeros(3, 5),
           "collisions": torch.tensor([0, 1, 1, 1, 0], dtype=torch.int32)}
    out = {k: v.clone() for k, v in ref.items()}
    out["pos"][1, 0] = 0.5
    out["collisions"][1] = 0
    out["pos"][0, 2] = 0.01
    out["vel"][2, 3] = 3.0
    out["pos"][:, 4] = float("nan")
    start = torch.zeros(5, dtype=torch.int32)
    assert harness.judge(out, ref, start, 4, 0.01, 0.02) == (0.5, 2, 3)
    out["pos"][1, 0] = 0.0
    assert harness.judge(out, ref, start, 4, 0.01, 0.02)[0] == 0.0
    out["pos"][1, 0] = float("nan")
    assert harness.judge(out, ref, start, 4, 0.01, 0.02)[0] == float("inf")


def test_chunk_plan_is_drawn_from_the_seed():
    mix = {"episode_steps": 2001, "chunk_steps": 87, "compare_fixed": [0, 22],
           "compare_drawn": 2, "traced_chunks": [1, 8, 15, 22]}
    per, a, traced = harness.chunk_plan(mix, 2**31 + 99, True)
    assert per == 23 and traced == [1, 8, 15, 22]
    assert len(a) == 4 and {0, 22} <= set(a)
    assert harness.chunk_plan(mix, 2**31 + 99, False)[1] == a
    assert harness.chunk_plan(mix, 2**31 + 99, False)[2] == []
    drawn = {tuple(harness.chunk_plan(mix, s, False)[1]) for s in range(40)}
    assert len(drawn) > 10


def test_rate_idle_and_roofline_arithmetic():
    assert roofline.rate(2_097_120, 2001, 4.7) == pytest.approx(2_097_120 * 2001 / 4.7)
    assert roofline.idle_pct(0.9, 1.0) == pytest.approx(10.0)
    assert roofline.idle_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 0.0) is None
    w = {"lanes": 2_097_152, "candidates": 0, "rows": 0, "keys": 1000}
    # free fall: bytes bind B1 (lane state in and out)
    assert roofline.b1_bound_s(w) == pytest.approx(2_097_152 * 60 / 3.35e12)
    w["candidates"] = 10_000_000
    assert roofline.b1_bound_s(w) == pytest.approx(
        (550 * 10_000_000 + 100 * 2_097_152) / 67e12)
    assert roofline.b2_bound_s(w) == pytest.approx(
        (12 * 2_097_152 + 8 * 16_384 + 4000) / 3.35e12)
    assert roofline.share_pct(roofline.b2_bound_s(w), 2 * roofline.b2_bound_s(w)) == 50.0


def test_trace_arithmetic_on_a_synthetic_session():
    s = trace.Session(
        steps=2,
        device=[("window_collide_kernel<false>", 10.0, 20.0), ("Memcpy DtoD", 15.0, 25.0),
                ("cells_window_lookup_kernel", 40.0, 45.0),
                ("window_collide_kernel<false>", 60.0, 70.0)],
        host=[("cudaGraphLaunch", 0.0, 5.0), ("aten::item", 30.0, 55.0),
              ("cudaStreamSynchronize", 32.0, 50.0)],
        work=[])
    assert trace.union([(1, 3), (2, 4), (6, 7)]) == [(1, 4), (6, 7)]
    busy, window = trace.busy_window_us(s)
    assert busy == 15.0 + 5.0 + 10.0 and window == 70.0
    assert trace.kernel_us([s], ("window_collide_kernel",)) == 20.0
    assert trace.kernel_count([s], "cells_window_lookup_kernel") == 1
    assert trace.top_device_ops([s])[0] == ["window_collide_kernel", 20.0 / 1e6]
    gaps = dict(trace.idle_gaps([s]))
    assert gaps == {"cudaStreamSynchronize": 15.0 / 1e6, "aten::item": 15.0 / 1e6}
    assert not trace.is_kernel("Memset (Device)") and trace.is_kernel("finish_kernel")
    # two ranks' sessions: each device's mean
    assert trace.top_device_ops([s, s], devices=2) == trace.top_device_ops([s])
    assert trace.idle_gaps([s, s], devices=2) == trace.idle_gaps([s])


def _chunk(scale: float, work: list) -> trace.Session:
    """One traced step on one card, its kernels one after another, each
    ``scale`` times as long as on a card at 1."""
    names = ("window_collide_kernel", "cells_window_lookup_kernel",
             "worklist_collide_kernel", "p2p_window_kernel")
    ends = np.cumsum([10.0, 2.0, 3.0, 5.0]) * scale
    device = [(n, float(a), float(b)) for n, a, b in zip(names, [0.0, *ends[:-1]], ends)]
    return trace.Session(steps=1, device=device, host=[("cudaGraphLaunch", 0.0, 30.0)],
                         work=work)


@pytest.mark.parametrize("name", ["device.idle_share", "runner.kernels_per_step",
                                  "rescue.worklist_ms_per_step", "b1_window_collide_roofline",
                                  "b2_cells_lookup_roofline", "b3_p2p_window_roofline"])
def test_device_time_readers_read_every_rank(name):
    """One rank: the reader reads rank 0's sessions, as before there were
    ranks.  Two ranks, the second card's kernels twice as long: the idle
    share is the line's ``busy_s`` over ``window_s``; kernels and time a
    step are each card's mean; a roofline holds each chunk's work,
    counted once on the whole state (rank 0's session), against the
    kernels' time summed over both cards."""
    reader = harness.load_module(os.path.join(harness.ROOT, "metrics", f"{name}.py"), name)
    work = [{"lanes": 4096, "candidates": 50_000, "rows": 300, "keys": 700,
             "offsets": 900, "columns": 2000}]
    r0 = [_chunk(1.0, list(work)), _chunk(1.0, list(work))]
    r1 = [_chunk(2.0, []), _chunk(2.0, [])]

    def read(rank_sessions):
        return reader.read(SimpleNamespace(rank_sessions=rank_sessions, sessions=r0,
                                           log=harness.log))

    one, two = read([r0]), read([r0, r1])
    if name == "device.idle_share":
        bw = [trace.busy_window_us(s) for s in r0 + r1]
        assert two == roofline.idle_pct(sum(b for b, _ in bw), sum(w for _, w in bw))
        assert one == pytest.approx(100.0 / 3)  # 20 busy of 30
    elif name == "runner.kernels_per_step":
        assert one == two == 4.0
    elif name == "rescue.worklist_ms_per_step":
        assert one == pytest.approx(0.003) and two == pytest.approx(1.5 * one)
    else:
        assert two == pytest.approx(one / 3)
        # B1's time holds its worklist kernel's
        kernel_s = {"b1_window_collide_roofline": 13e-6, "b2_cells_lookup_roofline": 2e-6,
                    "b3_p2p_window_roofline": 5e-6}[name]
        bound = (roofline_p2p.b3_bound_s if name.startswith("b3") else
                 roofline.b2_bound_s if name.startswith("b2") else roofline.b1_bound_s)
        assert one == pytest.approx(100.0 * bound(work[0]) / kernel_s)


def test_device_info_gives_the_fullest_device_and_each_rank():
    assert harness.device_info(torch.device("cpu"), [0], 1) == {
        "platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = harness.device_info(torch.device("cpu"), [0, 0, 0, 0], 4)
    assert info["count"] == 4 and info["memory_peak_bytes_by_rank"] == [0, 0, 0, 0]


# the runner's telemetry readers and, on the CPU, the range each reads in
TELEMETRY = {"runner.step_ms_p99": (0.0, 1e4), "runner.order_ms_per_step": (0.0, 1e3),
             "runner.replay_gap_ms_per_step": (0.0, 1e3),
             "spatial.main_ms_per_step": (0.0, 1e3), "rescue.device_ms_per_step": (0.0, 1e4),
             "screenspace.stage_device_ms_per_step": (0.0, 1e3),
             "screenspace.step_undecided_share": (0.0, 100.0),
             "rescue.worklist_lanes_per_step": (0.0, 1152.0),
             "setup.tables_s": (0.0, 60.0), "setup.capture_s": (0.0, 60.0)}


@pytest.mark.parametrize("readers", ["counters", "telemetry"])
def test_traced_run_reports_its_per_layer_metrics(tmp_path, readers):
    """A traced hybrid run.  ``counters``: on the CPU the profiler records
    no device time, so the readers that need it report nothing, the
    counters report.  ``telemetry``: the stamp and counter readers report,
    each within its range; a step's period is at least the sum of its
    stages' means."""
    root = str(tmp_path)
    line = _run(root, small_bench(root, episode_steps=300, traced=(5, 14)), HYBRID,
                trace_on=True, seconds=0.5)
    assert line["correct"]
    if readers == "counters":
        got = set(line["metrics"])
        assert {"runner.host_reads_per_step", "rescue.overflow_lanes_per_step",
                "screenspace.undecided_share"} <= got
        assert not got & {"particle_steps_per_s", "setup_s", "device.idle_share"}
        assert 0.0 < line["metrics"]["screenspace.undecided_share"]["value"] < 100.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        return
    for name, (lo, hi) in TELEMETRY.items():
        assert lo < line["metrics"][name]["value"] < hi, name
    v = {k: line["metrics"][k]["value"] for k in TELEMETRY}
    stages = (v["screenspace.stage_device_ms_per_step"] + v["runner.order_ms_per_step"]
              + v["spatial.main_ms_per_step"] + v["rescue.device_ms_per_step"])
    assert stages < v["runner.step_ms_p99"]


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


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", SPATIAL,
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", SPATIAL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "not in this checkout" in out.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contracts_form():
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["portbench"]
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(REPO, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(harness.ROOT, "traffic", f"{w['traffic']}.json"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(harness.ROOT, "metrics", f"{m['name']}.py"))
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
        assert layer
    assert len(json.dumps(bench)) <= 64 * 1024
