"""The plain reference: its grid is the program's, it agrees with the
program's CPU path bit for bit, it imports nothing of the program or of
JAX, and its bfloat16 control is told apart."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import GridConfig, SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_sorted_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import build_triangle_grid
from portbench import guard, harness, scene, spawn
from portbench.reference import grid as ref_grid
from portbench.reference.step import Reference

from conftest import REPO, small_bench


@pytest.mark.parametrize("budget", [6000, 40_000])
def test_grid_equals_the_programs(budget):
    tris = scene.dragon_scene(96, 54, tri_budget=budget)["triangles"]
    theirs, meta = build_triangle_grid(tris, GridConfig(cell_size=4.0, expand=3.1),
                                       device="cpu")
    mine = ref_grid.build(tris, 4.0, 3.1, "cpu")
    assert mine["dims"] == meta.dims
    assert mine["origin"] == meta.origin
    assert torch.equal(mine["offsets"], theirs.offsets.long())
    assert torch.equal(mine["tri_ids"], theirs.tri_ids.long())


def _sample_case():
    """The sample scene (SampleScene.unity) a short drop above the cube
    and the bowl, 7 x 7 x 2 particles, dt 0.01: as (scene dict, config
    dict, program config)."""
    sc = sample_scene(64, 48)
    cam = sc.cameras[0]
    cams = {cam.name: {"name": cam.name, "position": cam.transform.position,
                       "rotation": cam.transform.rotation, "fov_deg": cam.fov_deg,
                       "near": cam.near, "far": cam.far, "width": cam.width,
                       "height": cam.height}}
    scene_d = {"triangles": sc.triangles, "corner_normals": sc.corner_normals,
               "cameras": cams}
    sim = {"particle_radius": 0.2, "dt": 0.01, "bounciness": 0.5,
           "gravity": [0.0, -9.81, 0.0], "num_particles_xz": 7, "offset_xz": 0.3,
           "spawn_origin": [0.0, 0.95, 0.0], "lifetime_steps": 100, "cell_size": 1.0,
           "expand": 0.5, "backoff": 0.0015}
    prog = SimConfig(particle_radius=0.2, lifetime_steps=100, num_particles_xz=7,
                     offset_xz=0.3, dt=0.01, bounciness=0.5,
                     spawn_origin=(0.0, 0.95, 0.0),
                     grid=GridConfig(cell_size=1.0, expand=0.5, max_tris_per_cell=16))
    return sc, scene_d, sim, prog, cam


@pytest.mark.parametrize("method", ["spatial", "hybrid"])
def test_reference_agrees_with_the_program_on_the_sample_scene(method, tmp_path):
    """47 steps (the limit the port's parity tests keep against the JAX
    package, ROADMAP C item 2), with impacts on the cube and the bowl."""
    sc, scene_d, sim, prog, cam = _sample_case()
    cfg = {"sim": sim, "method": method,
           "scene": {"name": "sample", "camera": cam.name}}
    kw = dict(camera=cam, normals=sc.corner_normals) if method == "hybrid" else {}
    runner = make_sorted_episode_runner(sc.triangles, prog, cells_lookup="kernel",
                                        resort_every="auto", device="cpu", **kw)
    sp = spawn.spawn(sim, 2, 10**9, 1024, 0.05, 11)
    st = {k: torch.from_numpy(sp[k]) for k in ("pos", "vel", "radius", "restitution")}
    st["collisions"] = torch.zeros(sp["pos"].shape[1], dtype=torch.int32)
    out = runner(ParticleState(**st), 47)
    ref = Reference(scene_d, cfg, "cpu", cache_dir=str(tmp_path)).run(st, 47)
    n = sp["n_real"]
    off, gap = harness.lanes_off({k: getattr(out, k) for k in harness.STATE_KEYS}, ref, n)
    assert int(out.collisions[:n].sum()) > 20  # the drop hits
    assert off == 0 and gap == 0.0


@pytest.mark.parametrize("workload", ["dragon_spatial_2M.episodes",
                                      "dragon_hybrid_2M.episodes"])
def test_reference_agrees_with_the_program_on_a_small_dragon(tmp_path, workload):
    """The cells' configuration at a small size: 300 steps from a drop
    just above the dragon, compared after every 60."""
    bench = small_bench(str(tmp_path))
    _, cfg, _, _, _ = harness.cell(bench, workload, root=str(tmp_path))
    sc, sp, st = harness.build_inputs(cfg, 2**31 + 5, "cpu")
    system = harness.load_system(cfg, sc, "cpu")
    ref = harness.load_reference(cfg, sc, "cpu")
    state = system.state(**st)
    for _ in range(5):
        src = {k: getattr(state, k) for k in ("pos", "vel", "collisions", "radius",
                                               "restitution")}
        state, _ = system.run(state, 60)
        got = ref.run(src, 60)
        off, _ = harness.lanes_off({k: getattr(state, k) for k in harness.STATE_KEYS},
                                   got, sp["n_real"])
        assert off == 0
    assert int(state.collisions.sum()) > 1000


def test_bfloat16_control_differs(tmp_path):
    bench = small_bench(str(tmp_path))
    _, cfg, _, _, _ = harness.cell(bench, "dragon_spatial_2M.episodes", root=str(tmp_path))
    sc, sp, st = harness.build_inputs(cfg, 9, "cpu")
    good = harness.load_reference(cfg, sc, "cpu").run(st, 30)
    bad = harness.load_reference(cfg, sc, "cpu", dtype=torch.bfloat16).run(st, 30)
    off, gap = harness.lanes_off(bad, good, sp["n_real"])
    assert off == sp["n_real"] and gap > 0.1


def test_reference_imports_nothing_of_the_program_or_jax():
    assert guard.reference_imports_bad() == {}
    code = ("import sys; import portbench.reference.step; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (guard.FORBIDDEN | {guard.PROGRAM})


def test_scan_finds_a_forbidden_import(tmp_path):
    (tmp_path / "a.py").write_text(
        "import os\nfrom particlesystemhybridcollisiondetection_tpu_torch.ops import grid\n")
    (tmp_path / "b.py").write_text("import jax.numpy as jnp\nfrom . import a\n")
    (tmp_path / "c.py").write_text("import particlesystemhybridcollisiondetection_tpux\n")
    assert guard.reference_imports_bad(str(tmp_path)) == {
        "a.py": [guard.PROGRAM], "b.py": ["jax"]}
    mods = {"jax.numpy": 1, "jaxtyping": 1, "particlesystemhybridcollisiondetection_tpu.ops": 1,
            guard.PROGRAM: 1, "flax": 1}
    assert guard.loaded_forbidden(mods) == [
        "flax", "jax.numpy", "particlesystemhybridcollisiondetection_tpu.ops"]


def test_no_jax_in_a_process_that_drives_the_program(tmp_path):
    """The harness, the adapter and the program's runner load no JAX."""
    code = (
        "import sys, json, os\n"
        "from portbench import harness, guard\n"
        f"from conftest import small_bench\n"
        f"b = small_bench({str(tmp_path)!r})\n"
        f"_, cfg, _, _, _ = harness.cell(b, 'dragon_spatial_2M.episodes', root={str(tmp_path)!r})\n"
        "sc, sp, st = harness.build_inputs(cfg, 1, 'cpu')\n"
        "s = harness.load_system(cfg, sc, 'cpu')\n"
        "s.run(s.state(**st), 2)\n"
        "print(json.dumps(guard.loaded_forbidden()))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.dirname(__file__)]),
               PSYS_BAKE_CACHE=str(tmp_path / "bake"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
def test_reference_agrees_with_the_kernels_on_the_card(tmp_path):
    """On the card: the small dragon through the captured runner and its
    CUDA kernels against the reference, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = small_bench(str(tmp_path))
    for workload in ("dragon_spatial_2M.episodes", "dragon_hybrid_2M.episodes"):
        _, cfg, _, _, _ = harness.cell(bench, workload, root=str(tmp_path))
        sc, sp, st = harness.build_inputs(cfg, 17, "cuda")
        system = harness.load_system(cfg, sc, "cuda")
        ref = harness.load_reference(cfg, sc, "cuda")
        state = system.state(**st)
        src = {k: getattr(state, k) for k in ("pos", "vel", "collisions", "radius",
                                               "restitution")}
        state, _ = system.run(state, 300)
        got = ref.run(src, 300)
        off, _ = harness.lanes_off({k: getattr(state, k) for k in harness.STATE_KEYS},
                                   got, sp["n_real"])
        assert off == 0
        assert int(np.asarray(state.collisions.cpu()).sum()) > 1000
