"""PyTorch port, the reference protocol's particle ladder on the CPU:
``bench/protocol.py::main`` against the JAX package's
``benchmarks/run_reference_protocol.py`` on the same flags and scene (the
rows of ``protocol_<scene>.json`` equal in every non-timing field, the same
files written), ``merge_rows`` against ``benchmarks/merge_protocol.py``,
and the reference cap of 2,097,120 particles at the top of the ladder in
both packages' ``spawn_grid``."""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.config import (
    PRESETS as J_PRESETS,
)
from particlesystemhybridcollisiondetection_tpu.core.state import (
    spawn_grid as j_spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu.geometry import scenes as jscenes
from particlesystemhybridcollisiondetection_tpu.ops import screenspace as jss
from particlesystemhybridcollisiondetection_tpu.utils import compile_cache
from particlesystemhybridcollisiondetection_tpu_torch.bench import protocol
from particlesystemhybridcollisiondetection_tpu_torch.config import PRESETS
from particlesystemhybridcollisiondetection_tpu_torch.core.state import spawn_grid
from particlesystemhybridcollisiondetection_tpu_torch.geometry import scenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = ("mean_ms", "particle_steps_per_sec")


def _load_script(name):
    """A script of ``benchmarks/`` as a module, unedited."""
    spec = importlib.util.spec_from_file_location(
        f"_protocol_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fast(make_scene):
    """sample_scene with 20x dt and a 96 x 64 camera: first impacts
    within ~45 steps (as tests/test_torch_harness.py)."""
    def make():
        scene = make_scene(width=96, height=64)
        cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
        return dataclasses.replace(scene, config=cfg)
    return make


def test_protocol_matches_jax_script(tmp_path, monkeypatch):
    """The same flags through each package's protocol entry point: the
    same files in both output directories, and protocol_SampleScene.json
    with the same rows in the same order, ``k, method, camera, run,
    particles, collisions`` exactly equal and the timing fields positive.
    47 steps: the first impacts come near step 45, and the sample scene's
    first near tie is at step 48 (ROADMAP C2)."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path / "bake"))
    monkeypatch.setattr(jss, "_BAKE_DISK_DIR", str(tmp_path / "bake"))
    # the JAX script's compile cache would write outside the test's tmp
    monkeypatch.setattr(compile_cache, "enable_persistent_cache",
                        lambda path=None: str(tmp_path))
    monkeypatch.setitem(jscenes.SCENES, "sample", _fast(jscenes.sample_scene))
    monkeypatch.setitem(scenes.SCENES, "sample", _fast(scenes.sample_scene))
    flags = ["--scene", "sample", "--k-min", "0", "--k-max", "1", "--runs", "1",
             "--steps", "47", "--plan", "gather", "--no-accuracy"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(jdir)
    monkeypatch.setattr(sys, "argv", ["run_reference_protocol.py", *flags,
                                      "--out", str(jdir)])
    assert _load_script("run_reference_protocol").main() == 0
    assert protocol.main(["--device", "cpu", *flags, "--out", str(tdir)]) == 0

    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    jrows = json.loads((jdir / "protocol_SampleScene.json").read_text())
    trows = json.loads((tdir / "protocol_SampleScene.json").read_text())
    assert len(trows) == len(jrows) == 2 * 3
    for a, b in zip(trows, jrows):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in TIMING} == \
            {k: v for k, v in b.items() if k not in TIMING}
        assert all(a[k] > 0 for k in TIMING)
    assert [r["particles"] for r in trows] == [49] * 3 + [98] * 3
    assert sum(r["collisions"] for r in trows) > 0


def _row(k, method, camera="Main Camera", run=None, ms=1.0):
    r = {"k": k, "method": method, "camera": camera, "particles": 16384 << k,
         "mean_ms": ms, "particle_steps_per_sec": 1.0e6, "collisions": 7}
    if run is not None:
        r["run"] = run
    return r


MERGE_CASES = {
    # a fresh row replaces the stale one of the same (k, method, camera, run)
    "fresh_replaces_stale": (
        [_row(0, "spatial", run=0, ms=5.0), _row(0, "hybrid", run=0),
         _row(0, "spatial", run=1)],
        [_row(0, "spatial", run=0, ms=3.0)]),
    # rows from before the ``run`` field: numbered in file order in both
    # lists, so duplicates do not collapse
    "rows_without_run": (
        [_row(1, "hybrid", "Main Camera (1)"), _row(1, "hybrid", "Main Camera (1)", ms=2.0),
         _row(1, "screen_space")],
        [_row(1, "hybrid", "Main Camera (1)", ms=9.0), _row(1, "spatial"),
         _row(1, "spatial", ms=4.0)]),
    # disjoint k: everything kept, sorted by identity
    "disjoint_k": (
        [_row(5, "spatial", run=0), _row(3, "hybrid", run=1)],
        [_row(7, "screen_space", run=0), _row(6, "spatial", run=0)]),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_rows_matches_merge_protocol(tmp_path, case, capsys):
    """merge_rows on two row lists equals what the JAX package's
    merge_protocol.py writes for the same two JSON files; the inputs are
    left as they were."""
    base, fresh = MERGE_CASES[case]
    bpath, fpath = tmp_path / "base.json", tmp_path / "fresh.json"
    bpath.write_text(json.dumps(base))
    fpath.write_text(json.dumps(fresh))
    before = json.dumps([base, fresh])
    got = protocol.merge_rows(base, fresh)
    assert json.dumps([base, fresh]) == before
    assert _load_script("merge_protocol").merge(str(bpath), str(fpath)) == 0
    assert got == json.loads(bpath.read_text())
    assert len(got) == len({(r["k"], r["method"], r["camera"], r["run"]) for r in got})


def test_reference_cap_at_the_top_of_the_ladder():
    """k = 7 on DragonScene's preset: 128^2 * 128 = 2,097,152 spawns are cut
    to the reference cap of 2,097,120 and padded back to 2,097,152; the
    port's spawn equals the JAX package's bit for bit, the 32 padding rows
    at 1e38 with zero velocity included."""
    cfg, jcfg = PRESETS["dragon"], J_PRESETS["dragon"]
    assert cfg.spawn_count(128) == jcfg.spawn_count(128) == 65535 * 32 == 2_097_120
    t = spawn_grid(cfg, layers_y=128, device="cpu")
    j = j_spawn_grid(jcfg, layers_y=128)
    assert t.pos.shape == (3, 2_097_152)
    for name in t._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    pad = t.pos[:, 2_097_120:]
    assert pad.shape == (3, 32) and bool((pad == 1e38).all())
    assert bool((t.vel[:, 2_097_120:] == 0).all())
    assert bool((t.pos[:, :2_097_120].abs() < 1e37).all())
