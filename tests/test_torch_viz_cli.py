"""PyTorch port, the viz modules and the command line on the CPU: images,
reports and PNG bytes equal to the JAX package's on the same inputs; the
CLI's subcommands and flags are the JAX package's plus ``--device``;
``bench`` writes the reference's files, ``simulate --checkpoint`` a
checkpoint both packages read, ``python -m`` runs; every new entry point
needs CUDA unless the caller asks for the CPU.  One case, marked
``cuda``, runs the new entry points on the card."""

import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu import cli as jcli
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.geometry import mesh as jmesh
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu.ops import grid as jgrid
from particlesystemhybridcollisiondetection_tpu.utils import compile_cache as jcache
from particlesystemhybridcollisiondetection_tpu.utils import io as jio
from particlesystemhybridcollisiondetection_tpu.viz import accuracy as jacc
from particlesystemhybridcollisiondetection_tpu.viz import camera_motion as jcm
from particlesystemhybridcollisiondetection_tpu.viz import grid_viz as jgv
from particlesystemhybridcollisiondetection_tpu.viz import render as jrender
from particlesystemhybridcollisiondetection_tpu_torch import cli as tcli
from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as tharness
from particlesystemhybridcollisiondetection_tpu_torch.bench.resilient import (
    ResilientRunner,
)
from particlesystemhybridcollisiondetection_tpu_torch.core import state as tstate
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.geometry import mesh as tmesh
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid
from particlesystemhybridcollisiondetection_tpu_torch.utils import io as tio
from particlesystemhybridcollisiondetection_tpu_torch.viz import accuracy as tacc
from particlesystemhybridcollisiondetection_tpu_torch.viz import camera_motion as tcm
from particlesystemhybridcollisiondetection_tpu_torch.viz import grid_viz as tgv
from particlesystemhybridcollisiondetection_tpu_torch.viz import render as trender

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def bake_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path / "bake"))


def test_render_state_shows_particles():
    """A particle in front of the camera changes pixels, one behind does
    not; every frame equals the JAX package's bit for bit."""
    tris = tmesh.flatten_scene([(tmesh.unity_plane(), tmesh.Transform())])
    jtris = jmesh.flatten_scene([(jmesh.unity_plane(), jmesh.Transform())])
    cam = tcm.look_at((0, 6, -12), (0, 0, 0), width=160, height=120)
    jcam = jcm.look_at((0, 6, -12), (0, 0, 0), width=160, height=120)
    frames = {}
    for tag, pos in (("base", np.zeros((0, 3))), ("front", np.array([[0.0, 2.0, 0.0]])),
                     ("behind", np.array([[0.0, 2.0, -40.0]]))):
        frames[tag] = trender.render_state(tris, pos, 0.8, cam)
        np.testing.assert_array_equal(
            frames[tag], jrender.render_state(jtris, pos, 0.8, jcam))
    assert (frames["front"] != frames["base"]).any()
    assert (frames["behind"] == frames["base"]).all()


def test_colormap_and_orbit():
    counts = np.array([0, 1, 5, 20])
    c = trender.collision_colormap(counts)
    assert c.shape == (4, 3) and c.dtype == np.uint8
    np.testing.assert_array_equal(c, jrender.collision_colormap(counts))
    cams = tcm.orbit_path((0, 0, 0), radius=10, height=5, frames=8, width=64,
                          height_px=64)
    jcams = jcm.orbit_path((0, 0, 0), radius=10, height=5, frames=8, width=64,
                           height_px=64)
    assert len(cams) == 8
    for cam, jcam in zip(cams, jcams):
        expect = -cam.position / np.linalg.norm(cam.position)
        np.testing.assert_allclose(cam.forward, expect, atol=1e-6)
        np.testing.assert_array_equal(cam.view_proj(), jcam.view_proj())
    fly = tcm.fly_path([(0, 5, -10), (10, 5, 0), (0, 5, 10)], [(0, 0, 0)] * 3, 7)
    jfly = jcm.fly_path([(0, 5, -10), (10, 5, 0), (0, 5, 10)], [(0, 0, 0)] * 3, 7)
    for cam, jcam in zip(fly, jfly):
        assert cam.name == jcam.name
        np.testing.assert_array_equal(cam.view_proj(), jcam.view_proj())


def test_grid_report(tmp_path):
    """write_grid_report: the same files as the JAX package's, byte for
    byte (heatmap PNGs and the stats text)."""
    scene = sample_scene()
    grid, meta = tgrid.build_triangle_grid(scene.triangles, scene.config.grid,
                                           device="cpu")
    paths = tgv.write_grid_report(grid, meta, str(tmp_path / "t"), name="sample")
    jg, jm = jgrid.build_triangle_grid(scene.triangles, j_sample_scene().config.grid)
    jpaths = jgv.write_grid_report(jg, jm, str(tmp_path / "j"), name="sample")
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read(), os.path.basename(p)
    stats = open([p for p in paths if p.endswith(".txt")][0]).read()
    assert "triangles: 1812" in stats


def test_accuracy_visualization_matches_jax(tmp_path):
    """run_accuracy_visualization of the screen-space method at step 8 on
    the fast sample scene, from one small inspection camera: the JAX
    package's PNG bytes (the state before any impact, integration only,
    is bit-identical)."""
    def fast(make_scene):
        sc = make_scene(width=96, height=64)
        return dataclasses.replace(
            sc, config=dataclasses.replace(sc.config, dt=sc.config.dt * 20))

    cams = [tcm.look_at((0, 8, -14), (0, 3, 0), width=96, height=64, name="insp")]
    jcams = [jcm.look_at((0, 8, -14), (0, 3, 0), width=96, height=64, name="insp")]
    got = tacc.run_accuracy_visualization(
        fast(sample_scene), ("screen_space",), (8,), cameras=cams,
        out_dir=str(tmp_path / "t"), device="cpu")
    want = jacc.run_accuracy_visualization(
        fast(j_sample_scene), ("screen_space",), (8,), cameras=jcams,
        out_dir=str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == ["insp_screen_space_step_8.png"]
    assert [os.path.basename(p) for p in want] == ["insp_screen_space_step_8.png"]
    with open(got[0], "rb") as a, open(want[0], "rb") as b:
        assert a.read() == b.read()
    assert [c.name for c in tacc.inspection_cameras(64, 48)] == \
        [c.name for c in jacc.inspection_cameras(64, 48)]


def _options(main, cmd, monkeypatch):
    """The option strings of one subcommand, from its --help."""
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a: None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main([cmd, "--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", buf.getvalue()))


@pytest.mark.parametrize("cmd", ["bench", "simulate", "accviz", "gridviz",
                                 "p2pbox", "config"])
def test_cli_flags_are_the_jax_packages(monkeypatch, cmd):
    """Same subcommands and flags as the JAX package's CLI, plus --device."""
    assert _options(tcli.main, cmd, monkeypatch) == \
        _options(jcli.main, cmd, monkeypatch) | {"--device"}


def test_cli_smoke(tmp_path):
    rc = tcli.main([
        "bench", "--scene", "sample", "--methods", "spatial",
        "--steps", "30", "--width", "96", "--height", "64",
        "--out", str(tmp_path), "--device", "cpu",
    ])
    assert rc == 0
    files = sorted(os.listdir(tmp_path))
    assert files == ["aggregate_SampleScene.json", "results_perf_SampleScene_49.csv",
                     "summary_SampleScene.json"]
    assert tcli.main(["p2pbox", "--particles", "128", "--steps", "50",
                      "--device", "cpu"]) == 0


def test_cli_simulate_checkpoint(tmp_path, capsys):
    """simulate --checkpoint --frames 1 on the sample scene: one frame PNG
    and one checkpoint; the checkpoint equals the state of the same 20
    steps run through make_method_step, bit for bit, and the JAX package
    reads it."""
    out = str(tmp_path / "sim")
    assert tcli.main(["simulate", "--scene", "sample", "--method", "spatial",
                      "--steps", "20", "--frames", "1", "--checkpoint",
                      "--width", "96", "--height", "64", "--out", out,
                      "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["frame_0000.png", "state_000020.npz"]
    assert "spatial on SampleScene: 20 steps" in capsys.readouterr().out
    sc = sample_scene(width=96, height=64)
    s = tstate.spawn_grid(sc.config, device="cpu")
    s = tstep.make_episode_runner(
        tstep.make_method_step(sc, "spatial", device="cpu"), 20)(s)
    back = tio.load_state(os.path.join(out, "state_000020.npz"), device="cpu")
    for a, b in zip(back, s):
        assert torch.equal(a, b)
    j = jio.load_state(os.path.join(out, "state_000020.npz"), jstate.ParticleState)
    np.testing.assert_array_equal(np.asarray(j.pos), s.pos.numpy())


def test_cli_without_cuda_raises_and_writes_nothing(tmp_path, monkeypatch):
    """Without --device and without CUDA the command raises before it
    writes a result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["bench", "--scene", "sample", "--methods", "spatial",
                   "--steps", "30", "--width", "96", "--height", "64",
                   "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_python_dash_m_runs(tmp_path):
    """``python -m particlesystemhybridcollisiondetection_tpu_torch`` runs a
    subcommand (gridviz on the sample scene, on the CPU)."""
    r = subprocess.run(
        [sys.executable, "-m", "particlesystemhybridcollisiondetection_tpu_torch",
         "gridviz", "--scene", "sample", "--out", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert "SampleScene_stats.txt" in r.stdout


_NEW_ENTRY_POINTS = {
    "make_spatial_step_bruteforce": lambda sc, d: tstep.make_spatial_step_bruteforce(
        sc.triangles, sc.config, **d),
    "make_spatial_step_grid_stream": lambda sc, d: tstep.make_spatial_step_grid(
        sc.triangles, sc.config, "stream", **d),
    "make_spatial_step_grid_dense": lambda sc, d: tstep.make_spatial_step_grid(
        sc.triangles, sc.config, "dense", **d),
    "restore": lambda sc, d: tstate.restore(
        tstate.snapshot(tstate.spawn_grid(sc.config, device="cpu")), **d),
    "run_benchmark": lambda sc, d: tharness.run_benchmark(
        sc, ("spatial",), [0], num_steps=3, **d),
    "run_accuracy_visualization": lambda sc, d: tacc.run_accuracy_visualization(
        sc, ("spatial",), (1,), cameras=[sc.cameras[0]], out_dir=None, **d),
    "cli_p2pbox": lambda sc, d: tcli.main(
        ["p2pbox", "--particles", "64", "--steps", "50"]
        + (["--device", d["device"]] if d else [])),
}


@pytest.mark.parametrize("entry", sorted(_NEW_ENTRY_POINTS))
def test_new_entry_points_need_cuda_by_default(monkeypatch, entry):
    """device defaults to "cuda": without a card the new entry points
    raise instead of falling back to the CPU."""
    sc = sample_scene(width=96, height=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _NEW_ENTRY_POINTS[entry](sc, {})


@pytest.mark.cuda
def test_new_entry_points_on_cuda(tmp_path):
    """On the card: the brute-force, stream and dense steps equal the
    packed step on a state with hits; run_benchmark, the episode and
    trajectory runners, the resilient runner, checkpoints and the CLI run
    on the small scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc = sample_scene(width=96, height=64)
    cfg = dataclasses.replace(sc.config, dt=sc.config.dt * 20)
    sc = dataclasses.replace(sc, config=cfg)
    s = tstate.spawn_grid(cfg, device="cuda")
    packed = tstep.make_spatial_step_grid(sc.triangles, cfg, device="cuda")
    s = tstep.make_episode_runner(packed, 46)(s)
    want = packed(s)
    for step in (tstep.make_spatial_step_bruteforce(sc.triangles, cfg),
                 tstep.make_spatial_step_grid(sc.triangles, cfg, "stream"),
                 tstep.make_spatial_step_grid(sc.triangles, cfg, "dense")):
        got = step(s)
        assert torch.equal(got.collisions, want.collisions)
        assert torch.allclose(got.pos, want.pos, rtol=1e-5, atol=1e-6)
    _, hist = tstep.make_trajectory_runner(packed, 4, stride=2)(s)
    assert hist.shape == (2, 3, s.pos.shape[-1]) and hist.is_cuda
    out = ResilientRunner(lambda: packed, chunk=2).run(s, 4)
    assert torch.equal(out.pos, hist[-1])
    tio.save_state(str(tmp_path / "c.npz"), out)
    assert tio.load_state(str(tmp_path / "c.npz")).pos.is_cuda
    res = tharness.run_benchmark(sc, ("screen_space", "spatial", "hybrid"), [0],
                                 num_steps=20, out_dir=str(tmp_path / "b"),
                                 accuracy=True)
    assert len(res) == 3
    assert tcli.main(["simulate", "--scene", "sample", "--method", "hybrid",
                      "--steps", "10", "--checkpoint", "--width", "96",
                      "--height", "64", "--out", str(tmp_path / "s")]) == 0
