"""Shared helpers of the benchmark's CPU tests: a small copy of the
benchmark (a few thousand triangles, a thousand particles a short drop
above the dragon, short episodes) that the harness runs on the CPU with
the program's plain versions."""

import json
import os
import shutil

import pytest
import torch

from portbench import harness

REPO = harness.REPO
# the tests run in several workers: one thread each keeps them from
# contending for the cores
torch.set_num_threads(1)


def small_bench(root, *, episode_steps=120, chunk_steps=20, traced=(2, 5)):
    """Write a small copy of BENCHMARK.json, its configurations and its mix
    under ``root`` (the metric readers are the benchmark's own); returns
    the bench dict."""
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(harness.ROOT, "metrics"), os.path.join(root, "metrics"),
                    dirs_exist_ok=True)
    bench = harness.load_bench()
    for entry in bench["configs"]:
        with open(os.path.join(REPO, entry["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        cfg["scene"].update(tri_budget=6000, width=96, height=54, camera="Main Camera (2)")
        cfg["sim"].update(num_particles_xz=24, spawn_origin=[0.0, 401.0, 0.0])
        cfg["particles"].update(layers_y=2)
        entry["file"] = os.path.join(root, "configs", f"{entry['name']}.json")
        with open(entry["file"], "w", encoding="utf-8") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "episodes.json"), "w", encoding="utf-8") as f:
        json.dump({"name": "episodes", "episode_steps": episode_steps,
                   "chunk_steps": chunk_steps, "warm_chunks": 1,
                   "compare_fixed": [0, episode_steps // chunk_steps - 1],
                   "compare_drawn": 1, "traced_chunks": list(traced)}, f)
    return bench


@pytest.fixture(autouse=True)
def _bake_cache(tmp_path, monkeypatch):
    """Bakes go to the test's directory, never to the user's cache."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path / "bake"))
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
