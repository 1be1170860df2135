"""PyTorch port, the episode runners' telemetry (``with_stats=True``): the
stage stamps and counters each step writes into its ring row, the set-up
laps, and that neither changes a state; the sorted runner's and the p2p
runner's.  On the CPU the stamps are the host clock
(``ops/cuda/telemetry_kernel.py``'s plain versions), so the layout and
the counters are held here; the captured path and the kernels run on the
card (``-m cuda``).  Small sizes: the sample scene with 20x dt (49
particles padded to 1024, first impacts within ~45 steps); a box of
2,000 spheres (``_p2p_cloud``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as tgraphed
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core import telemetry as ttel
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import screenspace_kernel as tssk
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import telemetry_kernel as ttk
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk
from particlesystemhybridcollisiondetection_tpu_torch.ops.screenspace import (
    screen_space_collide,
)
from particlesystemhybridcollisiondetection_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

STEPS = 60
METHODS = ["spatial", "hybrid"]
# what a step of the runner launches on CUDA, by wrapper (B2 with the code
# table); on the CPU every stage takes its plain version and launches none
STEP_LAUNCHES = {"cells_window_lookup": 1, "window_collide_sorted": 1,
                 "window_collide_sorted_rescue": 0, "window_collide_worklist": 1,
                 "rescue_front": 1}


@pytest.fixture(scope="module")
def fast():
    scene = sample_scene(width=128, height=128)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


def _runner(fast, method, device="cpu", **kw):
    cam = {"camera": fast.cameras[0]} if method == "hybrid" else {}
    return tstep.make_sorted_episode_runner(
        fast.triangles, fast.config, resort_every="auto", resort_threshold=0,
        device=device, **cam, **kw)


def _launched(counts: dict) -> dict:
    """The wrappers of ``counts`` that launch (a runner's ``launches``)."""
    return {k: v for k, v in counts.items() if v}


def _equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("pos", "vel", "collisions"))


@pytest.mark.parametrize("method", METHODS)
def test_stats_leave_the_states_bit_for_bit(fast, method, monkeypatch):
    """Two calls with stats (the second across a drain of a 16-row ring)
    equal two calls without, bit for bit; the ring holds one row a step,
    its stamps non-decreasing along the slots, and the stage times sum to
    each step's stamped span, and a step's span and the gap after it to
    its period; the overflow list is the ring's counter."""
    monkeypatch.setattr(tgraphed, "StepRing", functools.partial(ttel.StepRing, cap=16))
    state = spawn_grid(fast.config, 1, device="cpu")
    on, off = _runner(fast, method), _runner(fast, method)
    a, ovf = on(state, STEPS, with_stats=True)
    b = off(state, STEPS)
    assert _equal(a, b) and int(a.collisions.sum()) > 0
    a2 = on(a, 3)
    a3, ovf3 = on(a2, 40, with_stats=True)
    b3 = off(off(b, 3), 40)
    assert _equal(a3, b3)
    tel = on.telemetry
    assert tel.calls == 3 and [r.call for r in tel.records] == [0, 2]
    rec = tel.records[1]
    want = ["order", "main", "rescue", "end"]
    if method == "hybrid":
        want.insert(0, "screenspace")
    assert list(rec.stages_ms) == want
    assert all(len(x) == 40 for x in rec.stages_ms.values())
    assert len(rec.period_ms) == 39 and (rec.period_ms > 0).all()
    assert ovf3 == rec.counters["n_over"].tolist() and ovf == tel.records[0].counters[
        "n_over"].tolist()
    assert sum(ovf) > 0
    # the last drain holds steps 33-40 of the call in rows 0-7
    ring = on._rings[state.pos.shape[-1]].ring.numpy()[:8]
    stamps = ring[:, [ttel.STAMPS.index(s) for s in ["start"] + want]]
    assert (np.diff(stamps, axis=1) >= 0).all()
    span = (stamps[:, -1] - stamps[:, 0]) / 1e6
    total = sum(x[32:] for x in rec.stages_ms.values())
    np.testing.assert_allclose(total, span, rtol=1e-12)
    assert len(rec.gap_ms) == 39 and (rec.gap_ms >= 0).all()
    steps = sum(rec.stages_ms.values())
    np.testing.assert_allclose(steps[:-1] + rec.gap_ms, rec.period_ms, rtol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_cpu_route_launches_nothing(fast, method):
    """On the CPU every stage of a runner's step takes its plain version:
    its steps add nothing to any launch counter (``STEP_LAUNCHES``' keys,
    the rescue's front among them, which launches once a sorted step on
    CUDA) and its ``launches`` stays empty."""
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    assert set(STEP_LAUNCHES) <= set(build.COUNTERS)
    before = {k: c[k] for k, c in build.COUNTERS.items()}
    runner = _runner(fast, method)
    runner(spawn_grid(fast.config, 1, device="cpu"), 5)
    assert {k: c[k] for k, c in build.COUNTERS.items()} == before
    assert runner.launches == {}


def test_undecided_counter_is_the_stages_undecided_real_lanes(fast):
    """The hybrid's ring counter, step by step, equals the screen-space
    stage's undecided real lanes recomputed on the step's input state."""
    runner = _runner(fast, "hybrid")
    s = spawn_grid(fast.config, 1, device="cpu")
    got, want = [], []
    for _ in range(STEPS):
        _, und = screen_space_collide(s, runner.tex, runner.sp.gravity,
                                      fast.config.dt, hybrid=True)
        want.append(int((und & active_mask(s)).sum()))
        s, _ = runner(s, 1, with_stats=True)
        got.append(int(runner.telemetry.records[-1].counters["undecided"][0]))
    assert got == want
    assert len(set(want)) > 5  # at rest, then falling off screen, then landing


def test_lanes_counter_is_compact_lanes_count(fast, monkeypatch):
    """The ring's "n_lanes" is the count ``compact_lanes`` returned in the
    same step (rescue phase 2's list), and -1 stands for the spatial
    method's undecided counter."""
    listed = []

    def spy(take):
        lanes, n = twk.compact_lanes(take)
        listed.append(int(n))
        return lanes, n

    monkeypatch.setattr(tstep, "compact_lanes", spy)
    runner = _runner(fast, "spatial")
    runner(spawn_grid(fast.config, 1, device="cpu"), STEPS, with_stats=True)
    rec = runner.telemetry.records[0]
    assert rec.counters["n_lanes"].tolist() == listed and sum(listed) > 0
    assert (rec.counters["undecided"] == -1).all()


@pytest.mark.parametrize("method", METHODS)
def test_setup_laps(fast, method):
    """``tables`` and ``bake`` when the runner is built, ``capture`` on its
    first step (on the CPU, the eager first step); later calls add none."""
    runner = _runner(fast, method)
    laps = runner.telemetry.setup_laps
    want = {"tables", "bake"} if method == "hybrid" else {"tables"}
    assert set(laps) == want
    s = runner(spawn_grid(fast.config, 1, device="cpu"), 2)
    assert set(laps) == want | {"capture"} and all(v > 0 for v in laps.values())
    first = laps["capture"]
    runner(s, 2)
    assert laps["capture"] == first


def test_each_stats_step_is_one_host_span(fast):
    """A call with stats: one "psys.runner.step" record a step, a host
    record and not a user annotation (which the profiler would mirror on
    the device); a call without: none."""
    from torch.profiler import ProfilerActivity, profile

    runner = _runner(fast, "spatial")
    s = runner(spawn_grid(fast.config, 1, device="cpu"), 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s, _ = runner(s, 7, with_stats=True)
        runner(s, 3)
    spans = [e for e in prof.events() if e.name == ttel.STEP_SPAN]
    assert len(spans) == 7 and not any(e.is_user_annotation for e in spans)


def test_records_keep_the_newest_calls(fast, monkeypatch):
    """A runner keeps the records of its newest ``KEEP_CALLS`` calls with
    stats, however many it makes."""
    monkeypatch.setattr(ttel, "KEEP_CALLS", 3)
    runner = _runner(fast, "spatial")
    s = spawn_grid(fast.config, 1, device="cpu")
    for _ in range(5):
        s, _ = runner(s, 2, with_stats=True)
    assert [r.call for r in runner.telemetry.records] == [2, 3, 4]


def test_stopwatch_restart_drops_the_time_between_laps():
    sw = tprof.Stopwatch()
    sum(range(200000))
    sw.restart()
    sw.lap("a")
    assert set(sw.laps) == {"a"} and sw.laps["a"] < 0.05


def test_launch_counters_are_one_registry():
    """Every kernel module's ``LAUNCHES`` is registered in
    ``build.COUNTERS`` under each of its wrapper names, no name in two
    modules, and a replay adds each wrapper's launches to its own
    module's counter (``core/graphed.py::_replay``)."""
    import types

    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        p2p_window_kernel as tpk,
    )

    mods = (twk, tssk, ttk, tpk)
    names = [k for m in mods for k in m.LAUNCHES]
    assert len(names) == len(set(names)) == len(build.COUNTERS)
    assert all(build.COUNTERS[k] is m.LAUNCHES for m in mods for k in m.LAUNCHES)
    before = {k: c[k] for k, c in build.COUNTERS.items()}
    replays = []
    try:
        tgraphed._replay(types.SimpleNamespace(replay=lambda: replays.append(1)),
                         {"window_collide_sorted": 2, "stamp": 3, "p2p_collide_worklist": 1})
        assert replays == [1]
        assert {k: c[k] - before[k] for k, c in build.COUNTERS.items()
                if c[k] != before[k]} == {
            "window_collide_sorted": 2, "stamp": 3, "p2p_collide_worklist": 1}
        assert twk.LAUNCHES["window_collide_sorted"] == before["window_collide_sorted"] + 2
    finally:  # the counts this replay added were made up: later tests read the counters
        for k, c in build.COUNTERS.items():
            c[k] = before[k]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_captured_stats_graphs_on_card(fast, method):
    """On the card: the runner with stats (its own captured pair) equals
    the runner without, and the same runner stepping eagerly, bit for
    bit; without stats the replayed graphs launch what a step launches
    (and the hybrid's screen-space kernel once a step, none in the
    spatial method), the stats pair the same wrappers and, counted apart,
    a stamp a stage (and the hybrid's count); the stamps rise along each
    row."""
    dev = _card()
    state = spawn_grid(fast.config, 1, device=dev)
    on = _runner(fast, method, device=dev, cells_lookup="kernel")
    off = _runner(fast, method, device=dev, cells_lookup="kernel")
    hybrid = method == "hybrid"
    stamped = {"stamp": 5 + hybrid, "count_undecided": int(hybrid)}
    step_launches = {**STEP_LAUNCHES, "screen_space_collide": int(hybrid)}
    tel0 = dict(ttk.LAUNCHES)
    a, ovf = on(state, STEPS, with_stats=True)
    assert on.telemetry_launches == _launched(stamped)
    assert {k: ttk.LAUNCHES[k] - tel0[k] for k in tel0} == {
        k: STEPS * v for k, v in stamped.items()}
    before, tel0 = dict(twk.LAUNCHES), dict(ttk.LAUNCHES)
    ss0 = tssk.LAUNCHES["screen_space_collide"]
    b = off(state, STEPS)
    assert {k: twk.LAUNCHES[k] - before[k] for k in before} == {
        k: STEPS * v for k, v in STEP_LAUNCHES.items()}
    assert tssk.LAUNCHES["screen_space_collide"] - ss0 == STEPS * hybrid
    assert ttk.LAUNCHES == tel0 and off.telemetry_launches == {}
    assert off.launches == _launched(step_launches) == on.launches
    assert set(off._graphs) == {(state.pos.shape[-1], False)}
    assert set(on._graphs) == {(state.pos.shape[-1], True)}
    with tgraphed.uncaptured():
        c, ovf_c = _runner(fast, method, device=dev, cells_lookup="kernel")(
            state, STEPS, with_stats=True)
    assert _equal(a, b) and _equal(a, c) and ovf == ovf_c
    on(a, 5)  # a call without stats captures the plain pair beside
    assert on.launches == _launched(step_launches) and len(on._graphs) == 2
    rec = on.telemetry.records[0]
    assert all((x >= 0).all() for x in rec.stages_ms.values())
    assert (rec.period_ms > 0).all()
    if method == "hybrid":  # none at rest, then falling off screen
        assert (rec.counters["undecided"] >= 0).all() and rec.counters["undecided"].max() > 0


@pytest.mark.cuda
def test_telemetry_kernels_match_their_plain_versions():
    """The count kernel equals its plain version (sentinel, NaN and
    infinite lanes among them); the stamp kernel writes a rising clock
    and the counters, zeroes the accumulator and advances the row."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    n = 300_000
    x = torch.randn(n, generator=g) * 100
    x[::97] = 1e38
    x[5::101] = float("nan")
    x[7::103] = -float("inf")
    und = torch.rand(n, generator=g) < 0.6
    acc_c = torch.zeros((), dtype=torch.int32)
    ttk.count_undecided_plain(und, x, acc_c)
    acc = torch.full((), 11, dtype=torch.int32, device=dev)
    ttk.count_undecided(und.to(dev), x.to(dev), acc)
    assert int(acc) == int(acc_c) + 11 and int(acc_c) > 0

    ring = torch.full((8, 9), -1, dtype=torch.int64, device=dev)
    step = torch.zeros((1,), dtype=torch.int32, device=dev)
    n_over = torch.tensor(5, dtype=torch.int32, device=dev)
    lanes = torch.tensor(3, dtype=torch.int32, device=dev)
    for _ in range(5):
        for slot in range(5):
            ttk.stamp(ring, step, slot)
        ttk.stamp(ring, step, 5, counters_at=6, n_over=n_over, undecided=acc,
                  n_lanes=lanes)
    got = ring.cpu().numpy()
    assert int(step) == 5 and int(acc) == 0
    assert (np.diff(got[:5, :6].ravel()) >= 0).all() and got[0, 0] > 0
    assert got[0, 6:].tolist() == [5, int(acc_c) + 11, 3]
    assert got[1:5, 6:].tolist() == [[5, 0, 3]] * 4 and (got[5:] == -1).all()


# ------------------------------------------------- the p2p runner's ----

P2P_BOX = ((0.0, 0.0, 0.0), (4.0, 4.0, 4.0))
P2P_STAMPS = ["start", "order", "main", "rescue", "end"]


def _p2p_cloud(device="cpu") -> ParticleState:
    """2,000 spheres of radius 0.12 in a box of 4 (seed 13): cells of
    0.24 hold several, and at a window of 64 columns lanes overflow into
    the fallback every step."""
    rng = np.random.default_rng(13)
    n = 2000
    f32 = np.float32
    return ParticleState(
        pos=torch.from_numpy(rng.uniform(0.6, 3.4, size=(3, n)).astype(f32)).to(device),
        vel=torch.from_numpy((rng.normal(size=(3, n)) * 2).astype(f32)).to(device),
        collisions=torch.zeros(n, dtype=torch.int32, device=device),
        radius=torch.full((n,), 0.12, dtype=torch.float32, device=device),
        restitution=torch.full((n,), 0.7, dtype=torch.float32, device=device))


def _p2p_runner(device="cpu", window=64):
    return tstep.make_p2p_episode_runner(
        *P2P_BOX, SimConfig(particle_radius=0.12, dt=0.004), window=window,
        device=device)


def test_p2p_stats_leave_the_states_bit_for_bit(monkeypatch):
    """The p2p runner with stats (across a drain of a 16-row ring) equals
    the runner without, bit for bit, over two calls, with no host read;
    each ring row holds the five stamps in order (no screen-space one), the
    stages sum to each step's stamped span, the overflow list is the
    ring's "n_over" counter and the fallback's listed lanes ("n_lanes")
    are the overflow."""
    monkeypatch.setattr(tgraphed, "StepRing", functools.partial(ttel.StepRing, cap=16))
    state = _p2p_cloud()
    on, off = _p2p_runner(), _p2p_runner()
    a, ovf = on(state, 20, with_stats=True)
    b = off(state, 20)
    assert _equal(a, b) and int(a.collisions.sum()) > 0
    a2, ovf2 = on(a, 12, with_stats=True)
    assert _equal(a2, off(b, 12))
    assert on.syncs.count == 0 and on.steps == 32
    tel = on.telemetry
    assert tel.calls == 2 and [r.call for r in tel.records] == [0, 1]
    rec = tel.records[1]
    assert list(rec.stages_ms) == P2P_STAMPS[1:]
    assert all(len(x) == 12 for x in rec.stages_ms.values())
    assert ovf == tel.records[0].counters["n_over"].tolist() and len(ovf) == 20
    assert ovf2 == rec.counters["n_over"].tolist() and min(ovf + ovf2) > 0
    for r in tel.records:
        assert (r.counters["n_lanes"] == r.counters["n_over"]).all()
        assert (r.counters["undecided"] == -1).all()
    (ring,) = [r.ring.numpy()[:12] for r in on._rings.values()]
    assert (ring[:, ttel.STAMPS.index("screenspace")] == -1).all()
    stamps = ring[:, [ttel.STAMPS.index(s) for s in P2P_STAMPS]]
    assert (stamps > 0).all() and (np.diff(stamps, axis=1) >= 0).all()
    np.testing.assert_allclose(sum(rec.stages_ms.values()),
                               (stamps[:, -1] - stamps[:, 0]) / 1e6, rtol=1e-12)
    np.testing.assert_allclose(sum(rec.stages_ms.values())[:-1] + rec.gap_ms,
                               rec.period_ms, rtol=1e-12)


def test_p2p_calls_without_stats_stamp_nothing(monkeypatch):
    """A p2p runner's call without stats takes no stamp and keeps no
    record; one with stats takes five stamps a step and one record; its
    first step is the set-up lap "capture"."""
    taken = []
    real = ttel.StepRing.stamp

    def spy(self, name):
        taken.append(name)
        real(self, name)

    monkeypatch.setattr(ttel.StepRing, "stamp", spy)
    run = _p2p_runner()
    s = run(_p2p_cloud(), 6)
    assert taken == [] and len(run.telemetry.records) == 0
    assert set(run.telemetry.setup_laps) == {"capture"}
    run(s, 3, with_stats=True)
    assert taken == ["start", "order", "main", "rescue"] * 3
    assert len(run.telemetry.records) == 1 and run.telemetry.calls == 2


def test_p2p_each_stats_step_is_one_host_span():
    from torch.profiler import ProfilerActivity, profile

    run = _p2p_runner()
    s = run(_p2p_cloud(), 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s, _ = run(s, 4, with_stats=True)
        run(s, 3)
    assert len([e for e in prof.events() if e.name == ttel.STEP_SPAN]) == 4


@pytest.mark.cuda
def test_p2p_captured_stats_graph_on_card():
    """On the card: the p2p runner with stats (its own captured graph)
    equals the runner without and the same runner stepping eagerly, bit
    for bit, with no host read; the stats graph launches the step's
    kernels and, counted apart, five stamps; calls without stats launch no
    telemetry kernel; the stamps rise along each row."""
    dev = _card()
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        p2p_window_kernel as tpk,
    )

    state = _p2p_cloud(dev)
    on, off = _p2p_runner(dev), _p2p_runner(dev)
    tel0 = dict(ttk.LAUNCHES)
    a, ovf = on(state, 20, with_stats=True)
    assert on.telemetry_launches == {"stamp": 5}
    assert ttk.LAUNCHES["stamp"] - tel0["stamp"] == 5 * 20
    before, tel0 = dict(tpk.LAUNCHES), dict(ttk.LAUNCHES)
    b = off(state, 20)
    assert ttk.LAUNCHES == tel0 and off.telemetry_launches == {}
    assert _launched({k: tpk.LAUNCHES[k] - before[k] for k in before}) == {
        k: 20 * v for k, v in off.launches.items()}
    assert off.launches == on.launches and sum(on.launches.values()) == 2
    with tgraphed.uncaptured():
        c, ovf_c = _p2p_runner(dev)(state, 20, with_stats=True)
    assert _equal(a, b) and _equal(a, c) and ovf == ovf_c and min(ovf) > 0
    assert on.syncs.count == 0 and off.syncs.count == 0
    on(a, 5)  # a call without stats captures the plain graph beside
    assert set(on._graphs) == {(2048, True), (2048, False)}
    rec = on.telemetry.records[0]
    assert list(rec.stages_ms) == P2P_STAMPS[1:]
    assert all((x >= 0).all() for x in rec.stages_ms.values())
    assert (rec.period_ms > 0).all()
    assert (rec.counters["n_lanes"] == rec.counters["n_over"]).all()
