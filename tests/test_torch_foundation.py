"""PyTorch port, foundation: spawn, integration, scenes and state
conversion are bit-identical to the JAX package; entry points refuse a
missing CUDA device; the port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.config import PRESETS as J_PRESETS
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.geometry import scenes as jscenes
from particlesystemhybridcollisiondetection_tpu.ops.integrate import (
    integrate as j_integrate,
)
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.config import PRESETS
from particlesystemhybridcollisiondetection_tpu_torch.core import state as tstate
from particlesystemhybridcollisiondetection_tpu_torch.geometry import scenes as tscenes
from particlesystemhybridcollisiondetection_tpu_torch.ops.integrate import (
    integrate as t_integrate,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_presets_match():
    assert PRESETS.keys() == J_PRESETS.keys()
    for k in PRESETS:
        assert repr(PRESETS[k]).replace("particlesystemhybridcollisiondetection_tpu_torch",
                                        "") == repr(J_PRESETS[k]).replace(
            "particlesystemhybridcollisiondetection_tpu", "")


@pytest.mark.parametrize("preset,layers,kw", [
    ("sample", 1, {}),
    ("dragon", 3, {}),
    ("dragon", 200, {"cap": 100_000}),
    ("sphere", 2, {"jitter": 0.3, "seed": 7, "pad_multiple": 4096}),
])
def test_spawn_bitwise(preset, layers, kw):
    cfg_t, cfg_j = PRESETS[preset], J_PRESETS[preset]
    a = convert.state_to_numpy(tstate.spawn_grid(cfg_t, layers, device="cpu", **kw))
    b = jstate.snapshot(jstate.spawn_grid(cfg_j, layers, **kw))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(
        tstate.active_mask(tstate.spawn_grid(cfg_t, layers, device="cpu", **kw)).numpy(),
        np.asarray(jstate.active_mask(jstate.spawn_grid(cfg_j, layers, **kw))),
    )


def test_integrate_bitwise():
    rng = np.random.default_rng(0)
    pos = rng.normal(scale=100.0, size=(3, 4096)).astype(np.float32)
    pos[:, -100:] = 1.0e38  # sentinels stay put
    vel = rng.normal(scale=30.0, size=(3, 4096)).astype(np.float32)
    g = np.asarray([0.0, -9.81, 0.0], np.float32)
    for dt in (0.01, 0.02, 0.001):
        pj, vj = j_integrate(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(g), dt)
        pt, vt = t_integrate(torch.from_numpy(pos), torch.from_numpy(vel),
                             torch.from_numpy(g), dt)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        assert (pt[:, -100:] == 1.0e38).all()


@pytest.mark.parametrize("name,kw", [
    ("sample", {}), ("sphere", {}), ("dragon", {"tri_budget": 3000}),
])
def test_scene_triangles_bitwise(name, kw):
    a = tscenes.SCENES[name](**kw)
    b = jscenes.SCENES[name](**kw)
    assert a.name == b.name
    assert a.triangles.dtype == np.float32
    np.testing.assert_array_equal(a.triangles, b.triangles)
    np.testing.assert_array_equal(a.corner_normals, b.corner_normals)
    assert [c.name for c in a.cameras] == [c.name for c in b.cameras]
    for ca, cb in zip(a.cameras, b.cameras):
        np.testing.assert_array_equal(ca.view_proj(), cb.view_proj())


def test_bunny_missing_mesh_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tscenes, "_REFERENCE_MESH_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tscenes.bunny_scene()


def test_state_convert_roundtrip():
    j = jstate.spawn_grid(J_PRESETS["sample"], 2, jitter=0.2, seed=3)
    snap = jstate.snapshot(j)
    t = convert.state_from_numpy(snap, device="cpu")
    back = convert.state_to_numpy(t)
    for k in snap:
        np.testing.assert_array_equal(back[k], snap[k])
    bad = dict(snap, pos=snap["pos"].astype(np.float64))
    with pytest.raises(ValueError):
        convert.state_from_numpy(bad, device="cpu")


def test_entry_points_refuse_missing_cuda():
    """Default device is CUDA; without it the entry points raise instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path cannot run")
    from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
        make_sorted_episode_runner,
        make_spatial_step_sorted,
    )

    scene = tscenes.sample_scene(width=64, height=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.spawn_grid(scene.config)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_spatial_step_sorted(scene.triangles, scene.config)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sorted_episode_runner(scene.triangles, scene.config)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.state_from_numpy(jstate.snapshot(
            jstate.spawn_grid(J_PRESETS["sample"])))


def test_port_imports_no_jax():
    """Every port module and chip_smoke.py import without JAX or the JAX
    package (whose name is a prefix of the port's: match the module
    exactly or with a trailing dot)."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import particlesystemhybridcollisiondetection_tpu_torch as pkg
names = [pkg.__name__]
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    names.append(m.name)
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
ref = "particlesystemhybridcollisiondetection_tpu"
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m.startswith("jaxlib.") or m == ref or m.startswith(ref + ".")]
assert len(names) >= 15, names
assert not bad, bad
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
