"""PyTorch port, the episode lifecycle on the CPU: ``reset_episode``,
``snapshot`` / ``restore``, checkpoints and PNGs (``utils/io.py``), the
episode and trajectory runners and ``sorted_step_overflow_count``, each
against the JAX package on the same seeded numpy inputs: state arrays and
files bitwise, a short trajectory at the brute-force tolerance, the
overflow count exact."""

import dataclasses

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.config import PRESETS as JPRESETS
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu.utils import io as jio
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.config import PRESETS
from particlesystemhybridcollisiondetection_tpu_torch.core import state as tstate
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.utils import io as tio

torch.set_num_threads(1)


def _evolved(seed=0):
    """A sample-scene spawn and a perturbed copy, in both packages."""
    rng = np.random.default_rng(seed)
    init = tstate.spawn_grid(PRESETS["sample"], layers_y=1, pad_multiple=128,
                             device="cpu")
    d = tstate.snapshot(init)
    e = dict(d)
    e["pos"] = (d["pos"] + rng.normal(size=d["pos"].shape)).astype(np.float32)
    e["vel"] = rng.normal(size=d["vel"].shape).astype(np.float32)
    e["collisions"] = rng.integers(0, 9, size=d["collisions"].shape).astype(np.int32)
    return d, e


def test_reset_episode_restores_pos_vel_keeps_counters():
    """Episode reset re-uploads initial pos/vel and keeps the collision
    counters (ParticleSys.cs:520-526 + BenchmarkManager.cs:160), bitwise
    as the JAX package's reset."""
    d, e = _evolved()
    back = tstate.reset_episode(tstate.restore(e, device="cpu"),
                                tstate.restore(d, device="cpu"))
    jback = jstate.reset_episode(jstate.restore(e), jstate.restore(d))
    for k, v in tstate.snapshot(back).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jback, k)))
    np.testing.assert_array_equal(back.pos.numpy(), d["pos"])
    np.testing.assert_array_equal(back.vel.numpy(), d["vel"])
    np.testing.assert_array_equal(back.collisions.numpy(), e["collisions"])


def test_snapshot_restore_match_jax():
    """snapshot gives the JAX package's keys, dtypes and bits on the same
    spawn; restore round-trips bitwise onto the requested device."""
    t = tstate.spawn_grid(PRESETS["sample"], layers_y=2, device="cpu")
    j = jstate.spawn_grid(JPRESETS["sample"], layers_y=2)
    ts, js = tstate.snapshot(t), jstate.snapshot(j)
    assert list(ts) == list(js)
    for k in js:
        assert ts[k].dtype == js[k].dtype
        np.testing.assert_array_equal(ts[k], js[k])
    back = tstate.restore(js, device="cpu")
    for a, b in zip(back, t):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_checkpoint_roundtrip_both_ways(tmp_path):
    """save_state / load_state round-trip bitwise, with the JAX package's
    npz keys: each package reads the other's checkpoint."""
    _, e = _evolved(1)
    state = tstate.restore(e, device="cpu")
    p_t, p_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save_state(p_t, state)
    jio.save_state(p_j, jstate.restore(e))
    with np.load(p_t) as a, np.load(p_j) as b:
        assert a.files == b.files
    for path in (p_t, p_j):
        back = tio.load_state(path, device="cpu")
        for a, b in zip(back, state):
            assert torch.equal(a, b)
        jback = jio.load_state(path, jstate.ParticleState)
        for k, v in e.items():
            np.testing.assert_array_equal(np.asarray(getattr(jback, k)), v)


def test_png_bytes_match_jax(tmp_path):
    """write_png writes the JAX package's bytes for the same image."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(37, 53, 3)).astype(np.uint8)
    tio.write_png(str(tmp_path / "t.png"), img)
    jio.write_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def _fast(make_scene):
    scene = make_scene(width=96, height=64)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


def test_trajectory_runner_matches_jax():
    """make_trajectory_runner over the brute-force step, 60 steps at stride
    4 through the first impacts of the fast sample scene: hist [15, 3, N]
    and the final state against the JAX package's runner (collisions
    exact, positions rtol 1e-4 / atol 1e-4, the brute-force tolerance);
    make_episode_runner over 8 steps gives the second block bit for bit."""
    sc, jsc = _fast(sample_scene), _fast(j_sample_scene)
    s0 = jstate.spawn_grid(jsc.config, layers_y=1, pad_multiple=128)
    step = tstep.make_spatial_step_bruteforce(sc.triangles, sc.config, device="cpu")
    jrun = jstep.make_trajectory_runner(
        jstep.make_spatial_step_bruteforce(jsc.triangles, jsc.config), 60, stride=4)
    jfinal, jhist = jrun(s0)
    ts0 = convert.state_from_numpy(jstate.snapshot(s0), device="cpu")
    final, hist = tstep.make_trajectory_runner(step, 60, stride=4)(ts0)
    assert tuple(hist.shape) == tuple(jhist.shape) == (15, 3, 128)
    mask = np.abs(np.asarray(s0.pos)[0]) < 1e37
    np.testing.assert_array_equal(final.collisions.numpy(), np.asarray(jfinal.collisions))
    assert int(final.collisions.sum()) > 0
    np.testing.assert_allclose(hist.numpy()[:, :, mask], np.asarray(jhist)[:, :, mask],
                               rtol=1e-4, atol=1e-4)
    same = tstep.make_episode_runner(step, 8)(ts0)
    assert torch.equal(same.pos, hist[1])


@pytest.mark.parametrize("window", [256, 512])
def test_sorted_step_overflow_count_matches_jax(window):
    """The overflow count of a jittered impact-phase state equals the JAX
    package's, an exact integer, and is not zero at window 256."""
    sc, jsc = _fast(sample_scene), _fast(j_sample_scene)
    cfg = dataclasses.replace(jsc.config, num_particles_xz=24)
    s = jstate.spawn_grid(cfg, layers_y=1, jitter=0.35, seed=1)
    step = jstep.make_spatial_step_bruteforce(jsc.triangles, jsc.config)
    for _ in range(45):
        s = step(s)
    want = jstep.sorted_step_overflow_count(jsc.triangles, jsc.config, s, window)
    ts = convert.state_from_numpy(jstate.snapshot(s), device="cpu")
    got = tstep.sorted_step_overflow_count(sc.triangles, sc.config, ts, window)
    assert isinstance(got, int) and got == want
    if window == 256:
        assert got > 0


def test_trajectory_runner_zero_blocks():
    """Fewer steps than one stride: no step runs and the history is an
    empty [0, 3, N] tensor."""
    sc = sample_scene()
    step = tstep.make_spatial_step_grid(sc.triangles, sc.config, device="cpu")
    s = tstate.spawn_grid(sc.config, layers_y=1, pad_multiple=128, device="cpu")
    final, hist = tstep.make_trajectory_runner(step, 3, stride=4)(s)
    assert tuple(hist.shape) == (0, 3, 128) and final is s
