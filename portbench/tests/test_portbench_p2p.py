"""The gravity-box cell on the CPU: the plain reference equals the
program's CPU path (the p2p runner) bit for bit on a small pile, the
harness finds the cell's configuration, mix and metrics by name, a broken
timed path (half the particles left out among its faults) and the
bfloat16 control read ``correct`` false and the float64 witness true, a pile is made the same twice and read back from
its cache, and the reference imports nothing of the program or of JAX.
Small boxes by config 4's own formula (side = round(n^(1/3) * 1.6)),
the cell's constants otherwise."""

import json
import os
import time

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import _box_state
from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_p2p_episode_runner,
)
from portbench import guard, harness

from conftest import small_bench
from test_portbench_harness import _Broken, _Control

CELL = "box_p2p_1M.pile"
METRICS = ["p2p.order_ms_per_step", "p2p.main_ms_per_step", "p2p.fallback_ms_per_step",
           "p2p.integrate_ms_per_step", "p2p.overflow_lanes_per_step", "p2p.step_ms_p99",
           "b3_p2p_window_roofline"]
STAMPED = ["p2p.order_ms_per_step", "p2p.main_ms_per_step", "p2p.fallback_ms_per_step",
           "p2p.integrate_ms_per_step", "p2p.step_ms_p99"]
SEED = 2**31 + 11


def _cfg(n: int, pile_step: int) -> dict:
    """The cell's configuration at ``n`` particles in config 4's box for
    ``n``, its pile made after ``pile_step`` steps."""
    _, cfg, _, _, _ = harness.cell(harness.load_bench(), CELL)
    side = round(n ** (1 / 3) * 4 * 0.4)
    cfg["scene"]["box_hi"] = [float(side), side / 2, float(side)]
    cfg["particles"].update(n=n, pile_step=pile_step)
    return cfg


def _small_cell(root, n=1024, pile_step=200, episode_steps=60, chunk_steps=10):
    """A small copy of the benchmark whose box cell runs ``n`` particles
    in 6-chunk episodes."""
    bench = small_bench(root)
    entry = next(c for c in bench["configs"] if c["name"] == "box_p2p_1M")
    with open(entry["file"], "w", encoding="utf-8") as f:
        json.dump(_cfg(n, pile_step), f)
    with open(os.path.join(root, "traffic", "pile.json"), "w", encoding="utf-8") as f:
        json.dump({"name": "pile", "episode_steps": episode_steps,
                   "chunk_steps": chunk_steps, "warm_chunks": 1, "compare_fixed": [0, 5],
                   "compare_drawn": 2, "traced_chunks": [1, 4]}, f)
    return bench


def _run(root, bench, *, trace_on=False, wrap=None, seconds=0.1):
    spec = harness.cell(bench, CELL, root=root)
    return harness.run_cell(spec, SEED, seconds, trace_on, t0=time.perf_counter(),
                            device="cpu", wrap=wrap)


def test_the_cell_its_configuration_mix_and_metrics_are_found_by_name():
    w, cfg, mix, e2e, layers = harness.cell(harness.load_bench(), CELL)
    assert w["chips"] == 1 and cfg["name"] == "box_p2p_1M" and cfg["reduced"] == {}
    assert (cfg["system"], cfg["reference"], cfg["inputs"]) == ("p2p_runner", "p2p", "box")
    assert cfg["particles"]["n"] == 1_000_000 and cfg["scene"]["box_hi"] == [160.0, 80.0,
                                                                               160.0]
    assert (mix["episode_steps"], mix["chunk_steps"], mix["warm_chunks"]) == (600, 100, 1)
    assert cfg["limits"] == {"gap_tolerance": 0.004, "contact_far_pct": 25}
    assert {m["name"] for m, _ in e2e} == {"particle_steps_per_s", "setup_s"}
    assert [m["name"] for m, _ in layers] == ["device.idle_share"] + METRICS
    assert all(m["moves"] == "particle_steps_per_s" for m, _ in layers)


def test_the_drop_is_config_4s():
    """The drop of a seed equals the program's own ``_box_state``, draw
    for draw."""
    from portbench.inputs import box

    cfg = _cfg(5000, 0)
    mine = box.drop(cfg, 2**31 + 5)
    theirs = _box_state(5000, cfg["scene"]["box_lo"], cfg["scene"]["box_hi"], 0.4, 0.3,
                        seed=2**31 + 5, device="cpu")
    for k in ("pos", "vel", "radius", "restitution"):
        assert np.array_equal(mine[k], getattr(theirs, k).numpy()), k


def test_the_reference_equals_the_programs_cpu_path():
    """From the 300-step pile of 8,192 particles, two calls of 100 steps:
    the program's runner (at the cell's window and at a window of 64,
    where most lanes overflow into the fallback) and the reference agree
    in every bit of every lane, and the reference's listed lanes are the
    runner's overflow, step by step."""
    from portbench.inputs import box

    cfg = _cfg(8192, 300)
    sc = box.make_scene(cfg)
    ref = harness.load_reference(cfg, sc, "cpu")
    d = {k: torch.from_numpy(v) for k, v in box.drop(cfg, 7).items()}
    d["collisions"] = torch.zeros(8192, dtype=torch.int32)
    pile = ref.run(d, 300)
    sim = cfg["sim"]
    prog = SimConfig(particle_radius=sim["particle_radius"], dt=sim["dt"],
                     bounciness=sim["bounciness"], gravity=tuple(sim["gravity"]))
    state = ParticleState(pos=pile["pos"], vel=pile["vel"], collisions=pile["collisions"],
                          radius=pile["radius"], restitution=pile["restitution"])
    runners = {w: make_p2p_episode_runner(sc["box_lo"], sc["box_hi"], prog,
                                          cell_size=sim["cell_size"], window=w,
                                          device="cpu") for w in (512, 64)}
    src = {k: getattr(state, k) for k in ("pos", "vel", "collisions", "radius",
                                          "restitution")}
    outs = {w: state for w in runners}
    for call in range(2):
        want = ref.run(src, 100, count_work=True)
        listed = [wk["listed"] for wk in ref.work]
        for w, run in runners.items():
            got, ovf = run(outs[w], 100, with_stats=True)
            for k in ("pos", "vel", "collisions"):
                assert torch.equal(getattr(got, k), want[k]), (call, w, k)
            if w == 512:
                assert ovf == listed
            else:
                assert min(ovf) > 4000
            outs[w] = got
        src = dict(src, **{k: want[k] for k in ("pos", "vel", "collisions")})
    assert int(want["collisions"].sum()) > 8192 * 100  # a pile: contacts every step


def test_a_sound_run_is_correct_and_traced_runs_read_the_telemetry(tmp_path):
    """The runner's cell in small: correct, every chunk equal to the
    reference's (checks 0); traced, the stamp and counter readers report
    (the roofline needs the card), a step's stages within its period."""
    root = str(tmp_path)
    bench = _small_cell(root)
    line = _run(root, bench)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"particle_steps_per_s", "setup_s"}
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k != "chunks_compared")
    line = _run(root, bench, trace_on=True)
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(METRICS) - {"b3_p2p_window_roofline"}
    assert got["p2p.overflow_lanes_per_step"] == 0.0
    stages = sum(got[k] for k in STAMPED[:4])
    assert all(got[k] > 0 for k in STAMPED) and stages < got["p2p.step_ms_p99"]


def test_stamp_readers_report_nothing_without_the_telemetry(tmp_path):
    """A program whose runner has no ``telemetry`` (the parent of this
    cell's readers): the stamp readers report nothing, the overflow, which
    ``with_stats`` returns, still reads."""
    root = str(tmp_path)

    class _Without:
        def __init__(self, inner):
            self.inner = inner
            self.runner = type("Runner", (), {})()

        def __getattr__(self, name):
            return getattr(self.inner, name)

    line = _run(root, _small_cell(root), trace_on=True, wrap=_Without)
    assert line["correct"]
    assert set(line["metrics"]) == {"p2p.overflow_lanes_per_step"}


class _Fault:
    """The program with one fault planted in its timed path: a call that
    runs one step short, one particle's answer altered by a radius, a
    particle in no contact during the call, or half the particles left
    out (the second half of the batch keeps its input state; the first
    half is stepped exactly, so only the half left out is off: about 50%
    of the lanes in contact, in a pile nearly all of them; the cell's
    limit is 25%)."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run(self, state, steps, with_stats=False):
        if self.fault == "one step short":
            return self.inner.run(state, steps - 1, with_stats)
        out, ovf = self.inner.run(state, steps, with_stats)
        if self.fault == "half left out":
            h = state.pos.shape[1] // 2
            left = {k: torch.cat([getattr(out, k)[..., :h], getattr(state, k)[..., h:]], -1)
                    for k in ("pos", "vel", "collisions")}
            return out._replace(**left), ovf
        free = (out.collisions == state.collisions).nonzero()[:, 0]
        pos = out.pos.clone()
        pos[1, free[len(free) // 2]] += state.radius[0]
        return out._replace(pos=pos), ovf


@pytest.mark.parametrize("fault", ["unchanged", "one step short", "free answer",
                                   "half left out"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    """A step that leaves its state unchanged, a call one step short, one
    free particle's answer altered, half the particles left out:
    ``correct`` false."""
    root = str(tmp_path)
    wrap = ((lambda s: _Broken(s, fault)) if fault == "unchanged"
            else (lambda s: _Fault(s, fault)))
    line = _run(root, _small_cell(root), wrap=wrap)
    assert not line["correct"] and line["failed"] >= 1
    if fault == "half left out":  # told apart by the lanes in contact alone
        far = [c for k, c in line["checks"].items() if k.startswith("contact_far_pct")]
        assert far and all(c["value"] > c["limit"] for c in far), line["checks"]


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False), (torch.float64, True)])
def test_the_control_is_not_correct_and_the_witness_is(tmp_path, dtype, correct):
    """The reference in bfloat16 (the control) in the program's place is
    told apart; in float64 (the witness: rounding alone) it passes in this
    small, young pile's 10-step calls.  (At the cell's own size and
    100-step calls rounding alone moves 99.9% of the lanes in contact
    there, and the witness reads false: the cell holds the program to the
    reference's bits; PERF.md.)"""
    root = str(tmp_path)
    bench = _small_cell(root)
    _, cfg, _, _, _ = harness.cell(bench, CELL, root=root)
    other = harness.load_reference(cfg, harness.build_scene(cfg), "cpu", dtype=dtype)
    line = _run(root, bench, wrap=lambda s: _Control(s, other))
    assert line["correct"] == correct, line["checks"]


def test_a_pile_is_made_the_same_twice_and_read_back(tmp_path, monkeypatch):
    from portbench.inputs import box

    cfg = _cfg(1024, 60)
    first = box.make_spawn(cfg, SEED)
    path = box._cache_path(cfg, SEED, torch.device("cpu"))
    assert os.path.exists(path)
    os.remove(path)
    again = box.make_spawn(cfg, SEED)
    for k in box.KEYS:
        assert np.array_equal(first[k], again[k]), k
    assert not np.array_equal(first["pos"], box.drop(cfg, SEED)["pos"])

    def no_reference(*a, **k):
        raise AssertionError("the pile was made again")

    monkeypatch.setattr(harness, "load_reference", no_reference)
    cached = box.make_spawn(cfg, SEED)
    assert cached["n_real"] == 1024
    for k in box.KEYS:
        assert np.array_equal(first[k], cached[k]), k


def test_the_reference_imports_neither_package():
    assert guard.reference_imports_bad() == {}
    got = guard.imports_of(os.path.join(guard.REFERENCE_DIR, "p2p.py"))
    assert got <= {"__future__", "numpy", "torch"}


def test_b3_bound_arithmetic():
    """Bytes bind a pile's step: 65 B a lane, 32 B a column, 4 B an offset;
    candidates bind only when they are many."""
    from portbench import roofline_p2p

    w = {"lanes": 1_000_000, "candidates": 30_000_000, "columns": 1_000_000,
         "offsets": 1_500_000, "listed": 150}
    want = (65 * 1_000_000 + 32 * 1_000_000 + 4 * 1_500_000) / 3.35e12
    assert roofline_p2p.b3_bound_s(w) == pytest.approx(want)
    w["candidates"] = 10**10
    assert roofline_p2p.b3_bound_s(w) == pytest.approx((53 * 10**10 + 8 * 10**6) / 67e12)
