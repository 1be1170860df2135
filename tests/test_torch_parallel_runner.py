"""PyTorch port, the persistent sorted runner with ``mesh=`` on gloo
ranks on the CPU (spatial, ``camera=`` and ``resort_every="auto"``),
mirroring ``tests/test_window_kernel.py::
test_persistent_runner_sharded_matches_single_device`` (``:619``).
Inputs, helpers and tolerances are ``test_torch_parallel.py``'s; the
runner has a file of its own so that the two spread over test workers.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import snapshot
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp
from test_torch_parallel import (  # noqa: F401  (fixtures)
    WORLDS,
    _assert_bitwise,
    _assert_near_jax,
    _fast_scene,
    _jax_snap,
    _jax_state,
    _mask,
    _save,
    _slices,
    _spawn,
    _state,
    _warm_state,
    bake_cache,
    jax_steps,
    scene,
)

torch.set_num_threads(1)


def _runner_rank(rank, world, in_path, out_path, steps):
    """The persistent runner with mesh=: resort_every=3 spatial and with
    camera=, then "auto" (threshold 0, so both branches run), each with
    every rank's per-step overflow."""
    scene = _fast_scene()
    mesh = dp.make_mesh(device_type="cpu")
    local = dp.shard_state(_state(dict(np.load(in_path))), mesh)
    out = {}
    for tag, kw in (("spatial", dict(resort_every=3)),
                    ("camera", dict(resort_every=3, camera=scene.cameras[0])),
                    ("auto", dict(resort_every="auto", resort_threshold=0))):
        runner = tstep.make_sorted_episode_runner(
            scene.triangles, scene.config, mesh=mesh, device="cpu", **kw)
        r, ovf = runner(local, steps, with_stats=True)
        g = snapshot(dp.gather_state(r, mesh))
        out.update({f"{tag}_{f}": g[f] for f in ("pos", "vel", "collisions")})
        ovf_ranks = [None] * world
        dist.all_gather_object(ovf_ranks, ovf)
        out[f"{tag}_ovf"] = np.asarray(ovf_ranks)
    if rank == 0:
        _save(out_path, **out)


def _auto_world1_rank(rank, world, in_path, out_path, steps):
    """The persistent runner with mesh= under "auto" (threshold 0) on a
    one-rank mesh: its state, its per-step overflows (summed over the
    mesh on the device) and its host reads."""
    scene = _fast_scene()
    mesh = dp.make_mesh(device_type="cpu")
    local = dp.shard_state(_state(dict(np.load(in_path))), mesh)
    runner = tstep.make_sorted_episode_runner(
        scene.triangles, scene.config, mesh=mesh, device="cpu",
        resort_every="auto", resort_threshold=0)
    r, ovf = runner(local, steps, with_stats=True)
    g = snapshot(dp.gather_state(r, mesh))
    _save(out_path, **{f: g[f] for f in ("pos", "vel", "collisions")},
          ovf=np.asarray(ovf), syncs=np.asarray(runner.syncs.count),
          graphed=np.asarray(runner.graphed))


RUNNER_STEPS = 11  # from step 36: the overflow rises at steps 37 and 43


def _runner_kw(scene, tag):
    return {"spatial": dict(resort_every=3),
            "camera": dict(resort_every=3, camera=scene.cameras[0]),
            "auto": dict(resort_every="auto", resort_threshold=0)}[tag]


@pytest.fixture(scope="module")
def warm36(scene):
    return _warm_state(scene, 36)


@pytest.fixture(scope="module")
def runner_ref(scene, warm36, jax_steps):
    """Single-device runners from step 36 over 11 steps (resort_every=3
    spatial and with camera=, "auto" at threshold 0), and the JAX
    package's per-step path over the same 11 steps (its runner's
    semantics: the same collisions and per-id trajectories)."""
    ref = {}
    for tag in ("spatial", "camera", "auto"):
        runner = tstep.make_sorted_episode_runner(
            scene.triangles, scene.config, device="cpu", **_runner_kw(scene, tag))
        ref[tag] = snapshot(runner(_state(warm36), RUNNER_STEPS))
    for tag in ("spatial", "camera"):
        js = _jax_state(warm36)
        for _ in range(RUNNER_STEPS):
            js = jax_steps[tag](js)
        ref[f"jax_{tag}"] = _jax_snap(js)
    return ref


def _auto_resorts(ovf, threshold=0):
    """The re-sort steps that "auto" takes from an overflow sequence."""
    steps, do_sort, base = [], True, 0
    for i, n_over in enumerate(ovf):
        if do_sort:
            steps.append(i)
            base = n_over
        do_sort = n_over > base + threshold
    return steps


@pytest.mark.parametrize("world", WORLDS)
def test_persistent_runner_sharded_matches_single_device(tmp_path, scene, warm36,
                                                         runner_ref, world):
    """mesh= on the persistent runner, 11 steps from step 36: per-rank
    persistent order and rank-local id restore reproduce the
    single-device runner bit for bit, spatial and hybrid (camera=), and
    stay within tolerance of the JAX package.  With resort_every=3 each
    step's overflow is the sum of single-device runners on the ranks'
    slices, and every rank reports it.  Under "auto" every rank reports
    the same summed overflow, so every rank re-sorts at the steps that
    sum decides, and both branches run."""
    out = _spawn(tmp_path, _runner_rank, world, warm36, RUNNER_STEPS)
    mask = _mask(warm36)
    for tag in ("spatial", "camera", "auto"):
        got = {f: out[f"{tag}_{f}"] for f in ("pos", "vel", "collisions")}
        _assert_bitwise(got, runner_ref[tag], tag)
        jax_tag = "camera" if tag == "camera" else "spatial"
        _assert_near_jax(got, runner_ref[f"jax_{jax_tag}"], mask, tag)
        ovf_ranks = out[f"{tag}_ovf"].tolist()
        ovf = ovf_ranks[0]
        assert ovf_ranks == [ovf] * world, tag
        if tag == "auto":
            assert 1 < len(_auto_resorts(ovf)) < RUNNER_STEPS
            continue
        want = np.zeros(RUNNER_STEPS, dtype=np.int64)
        for sl in _slices(warm36, world):
            runner = tstep.make_sorted_episode_runner(
                scene.triangles, scene.config, device="cpu",
                **_runner_kw(scene, tag))
            want += runner(sl, RUNNER_STEPS, with_stats=True)[1]
        assert ovf == want.tolist(), tag
        assert max(ovf) > 0, tag
    assert runner_ref["spatial"]["collisions"].sum() > 0


def test_persistent_runner_world1_auto_sums_on_device(tmp_path, scene, warm36,
                                                      runner_ref):
    """mesh= at world 1 (gloo on the CPU) under "auto": the overflow is
    summed over the mesh on the device and the host reads only the
    re-sort flag, one a step after the first (the host-summed runner read
    the overflow and summed it on the host every step).  Its per-step
    overflows are those of the single-device runner on the same slice
    (the sum over one rank), its state the single-device runner's bit for
    bit, and both re-sort branches run.  CPU ranks step eagerly."""
    out = _spawn(tmp_path, _auto_world1_rank, 1, warm36, RUNNER_STEPS)
    _assert_bitwise(out, runner_ref["auto"], "auto, world 1")
    single = tstep.make_sorted_episode_runner(
        scene.triangles, scene.config, device="cpu", **_runner_kw(scene, "auto"))
    want = single(_state(warm36), RUNNER_STEPS, with_stats=True)[1]
    ovf = out["ovf"].tolist()
    assert ovf == want and max(ovf) > 0
    assert 1 < len(_auto_resorts(ovf)) < RUNNER_STEPS
    assert int(out["syncs"]) == RUNNER_STEPS - 1 == single.syncs.count
    assert not bool(out["graphed"])
