"""PyTorch port, the benchmark harness on the CPU: ``run_benchmark`` and
its CSVs, summary and aggregates against the JAX package's on the same
scene, size and pinned plan (headers, row counts, keys, and the
per-particle collisions of the accuracy CSV exact); ``_flag_transport_noise``
and ``_write_aggregates`` identical on the same synthetic summary; the
``per_step_timing`` and ``persistent`` options of ``run_episode``."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.bench import harness as jharness
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu.ops import screenspace as jss
from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as tharness
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene

torch.set_num_threads(1)

METHODS = ("screen_space", "spatial", "hybrid")


def _fast(make_scene):
    """sample_scene with 20x dt and a 96 x 64 camera: first impacts
    within ~45 steps."""
    scene = make_scene(width=96, height=64)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


@pytest.fixture(autouse=True)
def bake_dir(tmp_path, monkeypatch):
    """Both packages bake into a fresh directory."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path / "bake"))
    monkeypatch.setattr(jss, "_BAKE_DISK_DIR", str(tmp_path / "bake"))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """One sweep of the three methods (61 steps, camera 0, accuracy CSV,
    pinned plan) by each package, into its own directory."""
    out = {}
    for tag, make, run in (
            ("torch", sample_scene, lambda sc, d: tharness.run_benchmark(
                sc, METHODS, [0], num_steps=61, out_dir=d, accuracy=True,
                plan="gather", device="cpu")),
            ("jax", j_sample_scene, lambda sc, d: jharness.run_benchmark(
                sc, METHODS, [0], num_steps=61, out_dir=d, accuracy=True,
                plan="gather"))):
        d = str(tmp_path_factory.mktemp(tag))
        os.environ["PSYS_BAKE_CACHE"] = os.path.join(d, "bake")
        jss._BAKE_DISK_DIR = os.path.join(d, "bake")
        out[tag] = (d, run(_fast(make), d))
    return out


def _lines(d, name):
    with open(os.path.join(d, name)) as f:
        return f.read().splitlines()


def test_csv_layout_matches_jax(sweeps):
    """The perf CSV has the JAX package's headers, step indices and row
    counts (one ``<display name>;ms`` header and 60 rows per method); the
    accuracy CSV is the JAX package's text, per-particle collisions
    exact, with one exception: in the hybrid block lane 3 may differ.  It
    leaves a 45-degree wall at step 46 with a velocity one rounding apart
    (XLA contracts ``refl * speed - g dt`` into a fused multiply-add) and
    at step 48 meets the edge two triangles share, where each package
    picks a different normal (ROADMAP C); from there its trajectory
    parts."""
    (td, tres), (jd, jres) = sweeps["torch"], sweeps["jax"]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    name = "results_perf_SampleScene_49.csv"
    tl, jl = _lines(td, name), _lines(jd, name)
    assert len(tl) == len(jl) == 3 * 61
    for a, b in zip(tl, jl):
        ia, ma = a.split(";")
        ib, mb = b.split(";")
        assert ia == ib and (ma == mb if ma == "ms" else float(ma) > 0)
    acc = "results_acc_SampleScene_49.csv"
    ta, ja = _lines(td, acc), _lines(jd, acc)
    assert len(ta) == len(ja) == 3 * 50
    assert ta[:100] == ja[:100]  # screen-space and spatial blocks
    assert ta[100] == ja[100] == "Hybrid Collision Detection;collisions"
    parted = [i for i, (a, b) in enumerate(zip(ta[101:], ja[101:])) if a != b]
    assert set(parted) <= {3}, parted
    assert sum(int(r.collisions.sum()) for r in tres) > 0


def test_summary_and_aggregate_keys_match_jax(sweeps):
    """summary_<scene>.json and aggregate_<scene>.json: the JAX package's
    keys, rows and every non-timing value, but the hybrid row's
    ``total_collisions`` (lane 3 parts, see above), which must equal the
    sum of its accuracy-CSV block."""
    (td, tres), (jd, jres) = sweeps["torch"], sweeps["jax"]
    timing = {"mean_ms_per_step", "steps_per_sec", "particle_steps_per_sec",
              "mean_ms_mean", "mean_ms_std", "mean_ms_min", "mean_ms_max"}
    for name in ("summary_SampleScene.json", "aggregate_SampleScene.json"):
        with open(os.path.join(td, name)) as f:
            trows = json.load(f)
        with open(os.path.join(jd, name)) as f:
            jrows = json.load(f)
        assert len(trows) == len(jrows) == 3
        for a, b in zip(trows, jrows):
            assert list(a) == list(b)
            skip = timing | ({"total_collisions"} if a["method"] == "hybrid" else set())
            assert {k: v for k, v in a.items() if k not in skip} == \
                {k: v for k, v in b.items() if k not in skip}
    assert [r.method for r in tres] == [r.method for r in jres] == list(METHODS)
    acc = _lines(td, "results_acc_SampleScene_49.csv")
    with open(os.path.join(td, "summary_SampleScene.json")) as f:
        trows = json.load(f)
    for i, r in enumerate(tres):
        block = sum(int(x.split(";")[1]) for x in acc[50 * i + 1:50 * i + 50])
        assert trows[i]["total_collisions"] == int(r.collisions.sum()) == block


def test_run_offset_appends_and_merges(tmp_path):
    """Two runs in one sweep append to the CSV; a later sweep with
    run_offset=2 into the same directory rewrites the CSV and merges its
    summary row (runs 0-2, one aggregate row of three runs), as the JAX
    package does."""
    for tag, make, bench in (
            ("t", sample_scene, lambda *a, **k: tharness.run_benchmark(
                *a, device="cpu", **k)),
            ("j", j_sample_scene, jharness.run_benchmark)):
        d = str(tmp_path / tag)
        sc = make(width=96, height=64)
        bench(sc, ("spatial",), [0], num_steps=6, num_runs=2, out_dir=d)
        perf = "results_perf_SampleScene_49.csv"
        assert len(_lines(d, perf)) == 2 * 6
        bench(sc, ("spatial",), [0], num_steps=6, out_dir=d, run_offset=2)
        assert len(_lines(d, perf)) == 6
        with open(os.path.join(d, "summary_SampleScene.json")) as f:
            summary = json.load(f)
        with open(os.path.join(d, "aggregate_SampleScene.json")) as f:
            agg = json.load(f)
        assert sorted(r["run"] for r in summary) == [0, 1, 2]
        assert len(agg) == 1 and agg[0]["runs"] == 3


def test_transport_noise_flag_two_run_groups():
    """With exactly 2 duplicate episodes the min is the reference (the
    median of two contains the outlier); 3+ duplicates keep the median
    rule.  The port's flags equal the JAX package's on the same rows."""
    def row(ms, cam="c3"):
        return {"method": "hybrid", "camera": cam, "num_particles": 1,
                "mean_ms_per_step": ms}

    cases = ([row(306.0), row(28.5)], [row(30.0), row(36.0)],
             [row(28.0), row(30.0), row(306.0)], [row(5.0, "x")])
    want = ([True, False], [False, False], [False, False, True], [False])
    for rows, flags in zip(cases, want):
        t, j = [dict(r) for r in rows], [dict(r) for r in rows]
        tharness._flag_transport_noise(t)
        jharness._flag_transport_noise(j)
        assert [r["suspect_transport_noise"] for r in t] == flags
        assert json.dumps(t) == json.dumps(j)


def test_write_aggregates_identical_json(tmp_path):
    """_write_aggregates writes the JAX package's JSON byte for byte on a
    synthetic summary (flagged rows excluded from the moments, k from N,
    the reference cap's rounding)."""
    scene = types.SimpleNamespace(
        name="Synth", config=types.SimpleNamespace(num_particles_xz=128))
    rng = np.random.default_rng(0)
    summary = []
    for method, cam in (("spatial", "A"), ("hybrid", "A"), ("hybrid", "B")):
        for n in (16384, 2097120):
            for run in range(3):
                summary.append({"method": method, "camera": cam,
                                "num_particles": n, "run": run,
                                "mean_ms_per_step": float(rng.uniform(1, 9)),
                                "cameras_deduped": method == "spatial"})
    summary[4]["mean_ms_per_step"] = 400.0
    paths = []
    for tag, mod in (("t", tharness), ("j", jharness)):
        rows = [dict(r) for r in summary]
        mod._flag_transport_noise(rows)
        os.makedirs(tmp_path / tag)
        mod._write_aggregates(scene, rows, str(tmp_path / tag))
        paths.append(tmp_path / tag / "aggregate_Synth.json")
    assert paths[0].read_bytes() == paths[1].read_bytes()
    agg = json.loads(paths[0].read_text())
    assert len(agg) == 6 and sum(r["runs_quarantined"] for r in agg) == 1
    assert {r["k"] for r in agg} == {0, 7}


def test_per_step_timing_one_time_per_step():
    """per_step_timing: one synchronized time per step on the per-step
    path (spatial too, whatever ``persistent`` says)."""
    sc = _fast(sample_scene)
    res = tharness.run_episode(sc, "spatial", num_steps=12, per_step_timing=True,
                               persistent=True, device="cpu")
    assert res.num_steps == 11 and len(res.step_ms) == 11
    assert len(set(res.step_ms)) > 1 and res.steps_per_sec > 0


@pytest.mark.parametrize("persistent,method,want", [
    (None, "spatial", False), (None, "hybrid", False),
    (True, "spatial", True), (True, "screen_space", False),
])
def test_persistent_default_follows_device(monkeypatch, persistent, method, want):
    """persistent=None means the runner for spatial and hybrid when the
    device is CUDA: on the CPU the per-step path.  The screen-space
    method never runs on the runner."""
    called = []
    monkeypatch.setattr(tharness, "_run_episode_persistent",
                        lambda *a, **k: called.append(a) or "runner")
    monkeypatch.setattr(tharness, "make_method_step",
                        lambda *a, **k: (_ for _ in ()).throw(LookupError("per step")))
    sc = sample_scene(width=96, height=64)
    if want:
        assert tharness.run_episode(sc, method, persistent=persistent,
                                    device="cpu") == "runner"
    else:
        with pytest.raises(LookupError, match="per step"):
            tharness.run_episode(sc, method, persistent=persistent, device="cpu")
    assert bool(called) == want


def test_method_names_match_jax():
    assert tharness.METHOD_NAMES == jharness.METHOD_NAMES
    assert [f.name for f in dataclasses.fields(tharness.EpisodeResult)] == \
        [f.name for f in dataclasses.fields(jharness.EpisodeResult)]
