"""PyTorch port, the hybrid slice end to end on the CPU: the three
methods' steps (``make_method_step``) against the JAX package's, fed
the same state every step; the sorted hybrid step against the packed
one, both cells plans; the persistent runner's ``camera=`` stage
against the per-step path and the JAX package's runner; and the
harness.  Small sizes: the fast sample scene (49 particles padded to
1024, 128 x 128 camera)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu.ops import screenspace as jss
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.bench import configs as tconfigs
from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as tharness
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    active_mask,
    snapshot,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry import scenes as tscenes
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as tss
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

# The suite runs several workers side by side; with PyTorch's default of
# one thread per core in each of them, the many small CPU ops of the
# port's plain paths spend their time contending for cores.
torch.set_num_threads(1)


def _fast(make_scene):
    """sample_scene with 20x dt: first impacts within ~45 steps."""
    scene = make_scene(width=128, height=128)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


@pytest.fixture(autouse=True)
def bake_dir(tmp_path, monkeypatch):
    """Both packages bake into a fresh directory."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path))
    monkeypatch.setattr(jss, "_BAKE_DISK_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def fast():
    return _fast(sample_scene)


@pytest.fixture(scope="module")
def j_fast():
    return _fast(j_sample_scene)


def _close(got, want, mask):
    return np.isclose(got["pos"][:, mask], want["pos"][:, mask],
                      rtol=1e-5, atol=1e-6).all(0)


@pytest.mark.parametrize("method", ["screen_space", "spatial", "hybrid"])
def test_method_step_matches_jax(fast, j_fast, method):
    """make_method_step of each method (on the CPU: the packed path for
    spatial and hybrid, in both packages) fed the JAX state every step
    for 85 steps: collisions exact, positions within rtol 1e-5 / atol
    1e-6.

    A particle that has sunk into a surface has an ill-conditioned hit
    distance (t < 0 from a cancelling plane equation), and XLA's fused
    multiply-adds move it: on a step where a lane leaves the tolerance,
    the JAX step must move it by as much against itself run op by op
    (``jax.disable_jit``), and the port is held to that run on every
    lane (ROADMAP.md C)."""
    j_step = jstep.make_method_step(j_fast, method)
    step = tstep.make_method_step(fast, method, device="cpu")
    s = jstate.spawn_grid(j_fast.config, layers_y=1)
    mask = np.asarray(jstate.active_mask(s))
    hits = 0
    for k in range(85):
        snap = jstate.snapshot(s)
        s = j_step(s)
        want = jstate.snapshot(s)
        got = snapshot(step(convert.state_from_numpy(snap, device="cpu")))
        np.testing.assert_array_equal(got["collisions"], want["collisions"],
                                      err_msg=f"step {k}")
        far = ~_close(got, want, mask)
        if far.any():
            with jax.disable_jit():
                eager = jstate.snapshot(j_step(jstate.restore(snap)))
            np.testing.assert_array_equal(got["collisions"], eager["collisions"])
            assert not _close(eager, want, mask)[far].any(), f"step {k}"
            want = eager
        np.testing.assert_allclose(got["pos"][:, mask], want["pos"][:, mask],
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {k}")
        hits += int((want["collisions"] - snap["collisions"]).sum())
    assert hits > 0


@pytest.mark.parametrize("cells_lookup", ["gather", "kernel"])
def test_hybrid_sorted_matches_hybrid_packed(fast, cells_lookup):
    """The sorted hybrid step (through make_method_step, spatial_variant
    "sorted") against the packed hybrid step on the same state, on every
    step that collides and every 30th (test_window_kernel.py::
    test_hybrid_sorted_matches_hybrid_packed_smoke)."""
    cfg = fast.config
    a_step = tstep.make_hybrid_step(fast.triangles, cfg, fast.cameras[0],
                                    device="cpu")
    b_step = tstep.make_method_step(fast, "hybrid", spatial_variant="sorted",
                                    cells_lookup=cells_lookup, device="cpu")
    s = spawn_grid(cfg, 1, device="cpu")
    mask = active_mask(s).numpy()
    checked = 0
    for k in range(85):
        na = a_step(s)
        if k % 30 == 0 or int(na.collisions.sum()) != int(s.collisions.sum()):
            got, want = snapshot(b_step(s)), snapshot(na)
            np.testing.assert_array_equal(got["collisions"][mask],
                                          want["collisions"][mask], err_msg=f"step {k}")
            np.testing.assert_allclose(got["pos"][:, mask], want["pos"][:, mask],
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {k}")
            checked += 1
        s = na
    assert checked >= 5
    assert int(s.collisions[active_mask(s)].sum()) > 0
    assert b_step.syncs.count == 0  # the rescue sizes its work on the device


# episode length of the comparison with the JAX package's runner: at
# step 48 of this spawn a particle bouncing off a 45-degree wall meets a
# shared edge, whose nearest hit rounds differently under XLA's fused
# multiply-adds, and its trajectory parts from there (ROADMAP.md C)
JAX_RUNNER_STEPS = 47


def test_hybrid_runner_matches_per_step_and_jax(fast, j_fast):
    """Hybrid runner (camera=; resort_every 1, 7 and "auto" with
    threshold 0, so both bodies run) against the port's per-step
    make_hybrid_step_sorted over 75 steps (rtol 1e-6 / atol 1e-7), and
    against the JAX package's hybrid runner over JAX_RUNNER_STEPS (rtol
    1e-5 / atol 1e-6)."""
    cfg = fast.config
    cam = fast.cameras[0]
    state = spawn_grid(cfg, 1, device="cpu")
    mask = active_mask(state).numpy()
    step = tstep.make_hybrid_step_sorted(fast.triangles, cfg, cam, device="cpu")
    s = state
    for _ in range(75):
        s = step(s)
    per_step = snapshot(s)
    assert per_step["collisions"][mask].sum() > 0

    j_run = jstep.make_sorted_episode_runner(
        j_fast.triangles, j_fast.config, interpret=True, resort_every="auto",
        resort_threshold=0, camera=j_fast.cameras[0])
    j_out = jstate.snapshot(
        j_run(jstate.spawn_grid(j_fast.config, layers_y=1), JAX_RUNNER_STEPS))
    assert j_out["collisions"][mask].sum() > 0

    for kw in ({"resort_every": 1}, {"resort_every": 7},
               {"resort_every": "auto", "resort_threshold": 0}):
        runner = tstep.make_sorted_episode_runner(fast.triangles, cfg, camera=cam,
                                                  device="cpu", **kw)
        r, ovf = runner(state, 75, with_stats=True)
        got = snapshot(r)
        assert len(ovf) == 75 and runner.steps == 75
        np.testing.assert_array_equal(got["collisions"][mask],
                                      per_step["collisions"][mask], err_msg=str(kw))
        np.testing.assert_allclose(got["pos"][:, mask], per_step["pos"][:, mask],
                                   rtol=1e-6, atol=1e-7, err_msg=str(kw))
        # sentinels stay at 1e38 and never collide
        assert (got["pos"][0, ~mask] == 1e38).all()
        assert (got["collisions"][~mask] == 0).all()

        got = snapshot(runner(state, JAX_RUNNER_STEPS))
        np.testing.assert_array_equal(got["collisions"][mask],
                                      j_out["collisions"][mask], err_msg=str(kw))
        np.testing.assert_allclose(got["pos"][:, mask], j_out["pos"][:, mask],
                                   rtol=1e-5, atol=1e-6, err_msg=str(kw))


def test_hybrid_decided_lanes_skip_exact_stage(fast, monkeypatch):
    """Decided lanes enter the window plan with count 0: an all-decided
    mask gives the exact stage nothing to do (no candidate, no overflow),
    while the undecided mask of a real step leaves it work."""
    cfg = fast.config
    seen = []
    plan = tstep._window_plan

    def spy(cid_s, cells2, window, nb, active_s=None, demote=None):
        out = plan(cid_s, cells2, window, nb, active_s=active_s, demote=demote)
        seen.append((active_s, out[1], out[4]))
        return out

    monkeypatch.setattr(tstep, "_window_plan", spy)
    step = tstep.make_hybrid_step_sorted(fast.triangles, cfg, fast.cameras[0],
                                         cells_lookup="gather", device="cpu")
    s = spawn_grid(cfg, 1, device="cpu")
    for _ in range(55):  # the camera sees the first particles land
        s = step(s)
    active_s, count, overflow = seen[-1]
    assert active_s is not None and bool(active_s.any()) and not bool(active_s.all())
    assert not bool((count[~active_s] != 0).any())
    assert not bool(overflow[~active_s].any())

    def none_undecided(state, tex, gravity, dt, *, hybrid=False):
        out, und = tss.screen_space_collide(state, tex, gravity, dt, hybrid=hybrid)
        return out, und & False

    monkeypatch.setattr(tstep, "screen_space_collide", none_undecided)
    step(s)
    _, count, overflow = seen[-1]
    assert int(count.abs().sum()) == 0 and not bool(overflow.any())


@pytest.mark.parametrize("method", ["screen_space", "hybrid"])
def test_run_episode_on_cpu(fast, method):
    """The harness drives the screen-space method (per-step path) and the
    hybrid method (persistent runner, adaptive plan) on the CPU and
    reports the camera."""
    twk.reset_launches()
    res = tharness.run_episode(fast, method, num_steps=61, chunk=20,
                               resort_every="auto", persistent=True,
                               device="cpu")
    assert res.method == method and res.camera == fast.cameras[0].name
    assert res.num_particles == 49 and res.num_steps == 60
    assert len(res.step_ms) == 60 and res.steps_per_sec > 0
    assert res.collisions.shape == (49,) and res.collisions.sum() > 0
    assert twk.LAUNCHES == {"cells_window_lookup": 0, "window_collide_sorted": 0,
                            "window_collide_sorted_rescue": 0,
                            "window_collide_worklist": 0, "rescue_front": 0}



def test_config_3_hybrid_on_bunny():
    """Config 3 (hybrid on the bunny scene, 960 x 540 camera) runs a few
    steps at one layer of 128^2 particles where the bunny mesh exists."""
    path = os.path.join(tscenes._REFERENCE_MESH_DIR, "stanford_bunny.fbx")
    if not os.path.exists(path):
        pytest.skip(f"bunny mesh absent: {path}")
    out = tconfigs.config_3(steps=3, layers=1, device="cpu")
    assert out["config"] == 3 and out["particles"] == 128 * 128
    assert out["steps_per_sec"] > 0
