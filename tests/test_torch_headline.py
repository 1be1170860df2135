"""PyTorch port, the headline benchmark (``bench/headline.py``, the
counterpart of the root ``bench.py``) on the CPU: the command's one JSON
line, the headline episode against the JAX package's ``run_episode``,
the settled probe's runner against the JAX package's runner with the
same arguments, the missing bunny FBX, the CUDA default and the
defaults taken from ``bench.py``.  Small sizes: the sample scene (49
particles padded to 1024), its fast variant for the parity tests."""

import ast
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.bench import harness as jharness
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu_torch.bench import headline as H
from particlesystemhybridcollisiondetection_tpu_torch.core.state import snapshot
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 47 steps: the fast sample scene's first impacts come near step 45, and
# from step 48 one lane meets the edge two triangles share, where the
# packages may pick different normals (ROADMAP C2)
PARITY_STEPS = 47


def _fast(make_scene):
    """sample_scene with 20x dt: first impacts within ~45 steps."""
    scene = make_scene(width=96, height=64)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


def test_main_prints_one_json_line():
    """The command on the CPU: exactly one stdout line, the four keys of
    ``bench.py``'s line, the metric named after the scene and the
    particle count, and the context on stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = H.main(["--device", "cpu", "--scene", "sample", "--layers-y", "1",
                     "--steps", "48", "--settled-pre", "40",
                     "--settled-steps", "7"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "particle_steps_per_sec_spatial_sample_49"
    assert line["unit"] == "particle-steps/s"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 6.0e7, 4)
    text = err.getvalue()
    assert "49 particles, 47 steps" in text and "device=cpu" in text
    assert "settled-phase: " in text and "ms/step" in text


def test_headline_episode_matches_jax():
    """The headline episode (the sorted runner, as on the card) against
    the JAX package's ``run_episode`` as its tests run it on the CPU, with
    the same scene, layers, steps, plan and re-sort rule: particle and
    step counts and every particle's collisions exact."""
    got = H.headline(_fast(sample_scene), layers_y=1, num_steps=PARITY_STEPS,
                     device="cpu")
    want = jharness.run_episode(
        _fast(j_sample_scene), "spatial", layers_y=1, num_steps=PARITY_STEPS,
        chunk=50, warmup_steps=1, plan="kernel", resort_every="auto")
    assert got.num_particles == want.num_particles == 49
    assert got.num_steps == want.num_steps == PARITY_STEPS - 1
    np.testing.assert_array_equal(got.collisions, want.collisions)
    assert got.collisions.sum() > 0
    assert got.particle_steps_per_sec == pytest.approx(
        got.steps_per_sec * got.num_particles)
    assert got.mean_ms > 0


def test_settled_runner_matches_jax():
    """The settled probe's runner (window 2048, a re-sort every 12 steps)
    against the JAX package's runner with the same arguments, in
    interpret mode, over 47 steps from the same spawn: collisions bit for
    bit, positions and velocities within rtol 1e-5, atol 1e-6 (ROADMAP
    C1), sentinels untouched."""
    scene = _fast(sample_scene)
    runner, state = H.settled_state(scene, layers_y=1, pre_steps=PARITY_STEPS,
                                    device="cpu")
    assert runner.sp.window == H.SETTLED_WINDOW == 2048
    assert runner.resort_every == H.SETTLED_RESORT_EVERY == 12
    got = snapshot(state)

    js = _fast(j_sample_scene)
    j_run = jstep.make_sorted_episode_runner(
        js.triangles, js.config, resort_every=12, window=2048, interpret=True)
    want = jstate.snapshot(j_run(jstate.spawn_grid(js.config, layers_y=1),
                                 PARITY_STEPS))
    mask = want["pos"][0] < 1e37
    assert mask.sum() == 49
    np.testing.assert_array_equal(got["collisions"], want["collisions"])
    assert got["collisions"].sum() > 0
    for f in ("pos", "vel"):
        np.testing.assert_allclose(got[f][:, mask], want[f][:, mask],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert (got["pos"][0, ~mask] == 1e38).all()
    assert (got["pos"][2, ~mask] == 1e38).all()


def test_bunny_without_fbx_fails(tmp_path):
    """``--scene bunny`` reads the FBX and, where it is absent, exits
    non-zero with FileNotFoundError and prints no JSON line: no other
    scene stands in.  The mesh directory points at an empty directory,
    so the FBX is absent whatever the machine holds."""
    env = dict(os.environ, PYTHONPATH=REPO, PSYS_REFERENCE_MESH_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "particlesystemhybridcollisiondetection_tpu_torch.bench.headline",
         "--device", "cpu", "--scene", "bunny", "--layers-y", "1", "--steps", "3",
         "--settled-pre", "1", "--settled-steps", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr and "stanford_bunny.fbx" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("call", ["headline", "settled_probe", "main"])
def test_entry_points_default_to_cuda(call):
    """Every entry point runs on the card unless asked: without CUDA it
    raises before any work, and ``main`` prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works here")
    scene = sample_scene(width=96, height=64)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="CUDA is not available"), \
            contextlib.redirect_stdout(out):
        if call == "main":
            H.main(["--scene", "sample"])
        else:
            getattr(H, call)(scene, layers_y=1)
    assert out.getvalue() == ""


def _call_keywords(tree, name):
    """The literal keyword arguments of the first call of ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == name:
            return {k.arg: ast.literal_eval(k.value) for k in node.keywords
                    if isinstance(k.value, ast.Constant)}
    raise AssertionError(f"no call of {name}")


def test_defaults_are_bench_py_constants():
    """The port's defaults are the root ``bench.py``'s: the episode's
    keywords, the settled probe's runner, its step counts and layers, and
    the real-time denominator (read from its source, which imports JAX
    only inside ``main``)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    ep = _call_keywords(tree, "run_episode")
    kw = H.headline.__kwdefaults__
    for k in ("layers_y", "num_steps"):
        assert kw[k] == ep[k], k
    assert (H.CHUNK, H.WARMUP_STEPS) == (ep["chunk"], ep["warmup_steps"])
    assert ep["plan"] == "kernel" and ep["resort_every"] == "auto"
    run = _call_keywords(tree, "make_sorted_episode_runner")
    assert run == {"resort_every": H.SETTLED_RESORT_EVERY, "window": H.SETTLED_WINDOW}
    assert _call_keywords(tree, "spawn_grid")["layers_y"] == \
        H.settled_probe.__kwdefaults__["layers_y"]
    steps = [node.args[1].value for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "run"]
    assert steps == [H.settled_probe.__kwdefaults__["pre_steps"],
                     H.settled_probe.__kwdefaults__["timed_steps"]]
    base = [node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) == "BASELINE_PARTICLE_STEPS_PER_SEC"]
    assert eval(compile(ast.Expression(base[0]), "bench.py", "eval")) == \
        H.BASELINE_PARTICLE_STEPS_PER_SEC == 6.0e7
    assert H.result_line("dragon", 7.5e7, 1_048_576) == {
        "metric": "particle_steps_per_sec_spatial_dragon_1M", "value": 75000000.0,
        "unit": "particle-steps/s", "vs_baseline": 1.25}
    assert H.result_line("dragon", 1.0, 1_048_575)["metric"].endswith("_1048575")
