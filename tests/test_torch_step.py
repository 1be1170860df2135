"""PyTorch port, the slice end to end on the CPU: the sorted spatial step
against the JAX package's (fed the same state every step, both cells
plans, both rescue phases), and the persistent runner against the port's
per-step path and the JAX package's runner.  Small sizes: the fast
sample scene (49 particles padded to 1024)."""

import dataclasses

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.bench.harness import (
    PlanChooser as JPlanChooser,
)
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as tharness
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    active_mask,
    snapshot,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

STEPS = 60


def _fast_scene():
    """sample_scene with 20x dt: first impacts within ~45 steps."""
    scene = sample_scene(width=128, height=128)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


@pytest.fixture(scope="module")
def fast():
    return _fast_scene()


@pytest.fixture(scope="module")
def jax_traj(fast):
    """JAX sorted-step trajectory (gather plan, interpret mode) from
    spawn: STEPS + 1 numpy snapshots and the per-step overflow."""
    step = jstep.make_spatial_step_sorted(
        fast.triangles, fast.config, interpret=True, cells_lookup="gather",
        with_stats=True)
    s = jstate.spawn_grid(fast.config, layers_y=1)
    snaps, ovf = [jstate.snapshot(s)], []
    for _ in range(STEPS):
        s, st = step(s)
        snaps.append(jstate.snapshot(s))
        ovf.append(int(st["window_overflow"]))
    return snaps, ovf


@pytest.mark.parametrize("cells_lookup", ["gather", "kernel"])
def test_sorted_step_matches_jax(fast, jax_traj, cells_lookup):
    """Port step fed the JAX state every step.  The JAX package's own
    tests hold its "kernel" plan bit-equal to its "gather" plan, so both
    port plans are held against the JAX gather trajectory."""
    snaps, ovf = jax_traj
    step = tstep.make_spatial_step_sorted(
        fast.triangles, fast.config, cells_lookup=cells_lookup,
        with_stats=True, device="cpu")
    mask = snaps[0]["pos"][0] < 1e37
    hits = 0
    for k in range(STEPS):
        out, st = step(convert.state_from_numpy(snaps[k], device="cpu"))
        got, want = snapshot(out), snaps[k + 1]
        np.testing.assert_array_equal(got["collisions"], want["collisions"],
                                      err_msg=f"step {k}")
        np.testing.assert_allclose(got["pos"][:, mask], want["pos"][:, mask],
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {k}")
        if cells_lookup == "gather":
            assert st["window_overflow"] == ovf[k], f"step {k}"
        hits += int((want["collisions"] - snaps[k]["collisions"]).sum())
    assert hits > 0


@pytest.fixture(scope="module")
def dense_probe(fast):
    """A denser, jittered spawn (16 x 16 particles at spacing 0.25, numpy
    jitter from seed 1) 47 steps in, as the first impacts land: its
    config and numpy state."""
    cfg = dataclasses.replace(fast.config, num_particles_xz=16, offset_xz=0.25)
    main = tstep.make_spatial_step_sorted(fast.triangles, cfg, device="cpu")
    s = spawn_grid(cfg, 1, jitter=0.35, seed=1, device="cpu")
    for _ in range(47):
        s = main(s)
    return cfg, snapshot(s)


def test_rescue_phases_match_jax_under_overflow(fast, dense_probe, monkeypatch):
    """Window 128 on the dense probe: overflow everywhere, and the
    rescue that fitting cells need runs -- one launch of the window
    kernel's worklist entry point, each overflow lane alone; no cell of
    this scene needs phase 3 (the packed path).
    Port gather and kernel plans agree bitwise, and with the JAX step on
    the same state.  (Later steps of this spawn hit shared-edge near-ties
    that round differently under XLA's fused multiply-adds: ROADMAP.md
    C.)"""
    cfg, probe = dense_probe
    calls = {"window": 0, "worklist": 0, "packed": 0}
    wcs, wcw = tstep.window_collide_sorted, tstep.window_collide_worklist
    scp = tstep.spatial_collide_packed

    def count_window(*a, **k):
        calls["window"] += 1
        return wcs(*a, **k)

    def count_listed(*a, **k):
        calls["worklist"] += int(a[7] > 0)  # a launch with listed lanes
        return wcw(*a, **k)

    def count_packed(*a, **k):
        calls["packed"] += 1
        return scp(*a, **k)

    monkeypatch.setattr(tstep, "window_collide_sorted", count_window)
    monkeypatch.setattr(tstep, "window_collide_worklist", count_listed)
    monkeypatch.setattr(tstep, "spatial_collide_packed", count_packed)
    outs = {}
    for plan in ("gather", "kernel"):
        step = tstep.make_spatial_step_sorted(
            fast.triangles, cfg, window=128, cells_lookup=plan,
            with_stats=True, device="cpu")
        out, st = step(convert.state_from_numpy(probe, device="cpu"))
        assert st["window_overflow"] > 0
        outs[plan] = snapshot(out)
    # per plan: the main launch and one worklist launch
    assert calls["window"] == 2 and calls["worklist"] == 2, calls
    assert calls["packed"] == 0, calls
    for f in ("pos", "vel", "collisions"):
        np.testing.assert_array_equal(outs["kernel"][f], outs["gather"][f], err_msg=f)

    j_step = jstep.make_spatial_step_sorted(
        fast.triangles, cfg, window=128, interpret=True, cells_lookup="gather")
    want = jstate.snapshot(j_step(jstate.restore(probe)))
    mask = probe["pos"][0] < 1e37
    assert (want["collisions"] - probe["collisions"]).sum() > 0
    np.testing.assert_array_equal(outs["gather"]["collisions"], want["collisions"])
    np.testing.assert_allclose(outs["gather"]["pos"][:, mask], want["pos"][:, mask],
                               rtol=1e-5, atol=1e-6)


def test_rescue_routes_agree(fast, dense_probe, monkeypatch):
    """Every route of a lane through the window kernel gives the same
    bits: the default step (every overflow lane alone through the
    worklist entry point, no phase-1 chunk built) equals bit for bit the
    step with the rescue looped on the host in its place
    (``_chunked_rescue``: B1 at the rescue window first, then the lanes
    it leaves one per row).  With the fit refused, phase 3 (the packed
    path, for cells larger than the rescue window, here let run on a
    scene that has none) takes the lanes: exact collisions, positions
    within rtol 1e-5 / atol 1e-6 (it rounds differently)."""
    cfg, probe = dense_probe
    mask = probe["pos"][0] < 1e37

    def run():
        step = tstep.make_spatial_step_sorted(fast.triangles, cfg, window=128,
                                              with_stats=True, device="cpu")
        out, st = step(convert.state_from_numpy(probe, device="cpu"))
        assert st["window_overflow"] > 0
        return snapshot(out)

    rc, p2, wcw = tstep._rescue_chunk, tstep._phase2_plan, tstep.window_collide_worklist
    wcs = tstep.window_collide_sorted
    calls = {"listed": 0, "packed": 0, "chunks": 0, "phase 1": 0}

    def count_chunks(*a, **k):
        calls["chunks"] += 1
        return rc(*a, **k)

    def count_listed(*a, **k):
        calls["listed"] += int(a[7])  # n_lanes
        return wcw(*a, **k)

    def count_phase1(*a, **k):
        calls["phase 1"] += k.get("launch_key") == tstep._RESCUE_LAUNCHES
        return wcs(*a, **k)

    monkeypatch.setattr(tstep, "_rescue_chunk", count_chunks)
    monkeypatch.setattr(tstep, "window_collide_worklist", count_listed)
    monkeypatch.setattr(tstep, "window_collide_sorted", count_phase1)
    base = run()
    assert (base["collisions"] - probe["collisions"]).sum() > 0
    assert calls["listed"] >= 1 and calls["chunks"] == calls["phase 1"] == 0
    device_rescue = tstep._device_rescue
    monkeypatch.setattr(tstep, "_device_rescue", tstep._chunked_rescue)
    host = run()
    assert calls["chunks"] >= 1 and calls["phase 1"] >= 1
    for f in ("pos", "vel", "collisions"):
        np.testing.assert_array_equal(host[f], base[f], err_msg=f)
    monkeypatch.setattr(tstep, "_device_rescue", device_rescue)

    scp = tstep.spatial_collide_packed

    def refuse_phase2(*a, **k):
        start, count, fit = p2(*a, **k)
        return start, count, torch.zeros_like(fit)

    def count_packed(*a, **k):
        calls["packed"] += 1
        return scp(*a, **k)

    monkeypatch.setattr(tstep, "_phase2_plan", refuse_phase2)
    monkeypatch.setattr(tstep, "_phase3_possible", lambda sp: True)
    monkeypatch.setattr(tstep, "spatial_collide_packed", count_packed)
    phase3 = run()
    assert calls["packed"] >= 1
    np.testing.assert_array_equal(phase3["collisions"], base["collisions"])
    np.testing.assert_allclose(phase3["pos"][:, mask], base["pos"][:, mask],
                               rtol=1e-5, atol=1e-6)


def test_dense_demote_and_compact_order_are_exact(fast, jax_traj):
    """Demoting dense-cell lanes to the rescue changes no result bit."""
    snaps, _ = jax_traj
    probe = convert.state_from_numpy(snaps[STEPS], device="cpu")
    cfg = fast.config
    plain = tstep.make_spatial_step_sorted(fast.triangles, cfg, dense_demote=None,
                                           device="cpu")
    demoted = tstep.make_spatial_step_sorted(fast.triangles, cfg, dense_demote=2,
                                             with_stats=True, device="cpu")
    a = plain(probe)
    b, st = demoted(probe)
    assert st["window_overflow"] > 0
    for f in ("pos", "vel", "collisions"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_runner_matches_per_step_and_jax(fast):
    """Persistent runner (resort_every 1, 7 and "auto" with threshold 0,
    so both branches run) against the port's per-step path and against
    the JAX package's runner, over 75 steps."""
    cfg = fast.config
    state = spawn_grid(cfg, 1, device="cpu")
    mask = active_mask(state).numpy()
    step = tstep.make_spatial_step_sorted(fast.triangles, cfg, device="cpu")
    s = state
    for _ in range(75):
        s = step(s)
    per_step = snapshot(s)
    assert per_step["collisions"][mask].sum() > 0

    j_run = jstep.make_sorted_episode_runner(
        fast.triangles, cfg, interpret=True, resort_every="auto",
        resort_threshold=0)
    j_out = jstate.snapshot(j_run(jstate.spawn_grid(cfg, layers_y=1), 75))

    for kw in ({"resort_every": 1}, {"resort_every": 7},
               {"resort_every": "auto", "resort_threshold": 0}):
        runner = tstep.make_sorted_episode_runner(fast.triangles, cfg,
                                                  device="cpu", **kw)
        r, ovf = runner(state, 75, with_stats=True)
        got = snapshot(r)
        assert len(ovf) == 75 and runner.steps == 75
        # the re-sort flag under "auto", one read a step after step 0;
        # none with a fixed resort_every
        assert runner.syncs.count == (74 if kw["resort_every"] == "auto" else 0)
        np.testing.assert_array_equal(got["collisions"][mask],
                                      per_step["collisions"][mask], err_msg=str(kw))
        np.testing.assert_allclose(got["pos"][:, mask], per_step["pos"][:, mask],
                                   rtol=1e-6, atol=1e-7, err_msg=str(kw))
        np.testing.assert_array_equal(got["collisions"][mask],
                                      j_out["collisions"][mask], err_msg=str(kw))
        np.testing.assert_allclose(got["pos"][:, mask], j_out["pos"][:, mask],
                                   rtol=1e-5, atol=1e-6, err_msg=str(kw))
        # sentinels stay at 1e38 and never collide
        assert (got["pos"][0, ~mask] == 1e38).all()
        assert (got["collisions"][~mask] == 0).all()


def test_unported_options_raise(fast):
    cfg = fast.config
    # mesh= is ported (tests/test_torch_parallel*.py); what is not a 1-D
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_sorted_episode_runner(fast.triangles, cfg, camera=fast.cameras[0],
                                         mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_spatial_step_sorted(fast.triangles, cfg, mesh=object(),
                                       device="cpu")
    # "dense" and "stream" are ported now; an unknown variant still raises
    with pytest.raises(ValueError, match="unknown spatial variant"):
        tstep.make_method_step(fast, "spatial", spatial_variant="bvh", device="cpu")


def test_run_episode_spatial_on_cpu(fast):
    """The harness entry point on the CPU: adaptive plan (both plans
    built, the chooser samples each), per-chunk timings, collisions."""
    twk.reset_launches()
    res = tharness.run_episode(fast, "spatial", num_steps=61, chunk=20,
                               resort_every="auto", persistent=True,
                               device="cpu")
    assert res.num_particles == 49 and res.num_steps == 60
    assert len(res.step_ms) == 60 and res.steps_per_sec > 0
    assert res.collisions.shape == (49,) and res.collisions.sum() > 0
    assert twk.LAUNCHES == {"cells_window_lookup": 0, "window_collide_sorted": 0,
                            "window_collide_sorted_rescue": 0,
                            "window_collide_worklist": 0, "rescue_front": 0}


def test_plan_chooser_matches_jax():
    """Same probe schedule as the JAX package's chooser under phase
    changes, close and lopsided costs."""
    def cost(name, i):
        base = {"A": 10.0, "B": 12.0, "C": 12.5}[name]
        return base * (2.5 if (name == "A" and 40 <= i < 90) else 1.0)

    for names in (["A", "B"], ["A", "B", "C"], ["A"]):
        a, b = tharness.PlanChooser(names), JPlanChooser(names)
        for i in range(120):
            pa, pb = a.pick(), b.pick()
            assert pa == pb, (names, i)
            a.record(pa, cost(pa, i))
            b.record(pb, cost(pb, i))
