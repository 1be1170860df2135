"""PyTorch port, data parallelism over the particle axis (``mesh=``) on
gloo ranks on the CPU: the sorted step and the hybrid sorted step with
``mesh=``, ``make_dp_step`` over the hybrid method step,
``dryrun_multichip`` and the one-rank helpers.  Mirrors the sharded
tests of ``tests/test_window_kernel.py`` (``:585``, ``:653``); the
persistent runner's (``:619``) is in ``test_torch_parallel_runner.py``,
which shares this file's helpers.

Each mesh test spawns its ranks once (``parallel/dryrun.py::run_ranks``:
spawn start method, file rendezvous in a new temporary directory, one
thread per rank) and checks several things from that one run.  The
gathered mesh output is held bit for bit against the port's own
single-device path, and against the JAX package on the same NumPy inputs
at ``rtol=1e-5, atol=1e-6`` with hits and collision counts exact
(ROADMAP C1: XLA on the CPU contracts multiply-adds).

The input is the fast sample scene (49 particles) 40-42 steps in, just
before the first impacts (step 45), padded to 4096 slots and permuted
with a seeded permutation so that every rank of 2 or 4 holds active
particles.  One padding serves both world sizes, so the single-device
references are computed once.

The JAX package is imported inside the functions that use it: the
spawned ranks import this module to find their body and need only the
port.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
    snapshot,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp
from particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    run_ranks,
)

torch.set_num_threads(1)

N_SLOTS = 4096  # divides by 2 x 1024 and by 4 x 1024
TOL = dict(rtol=1e-5, atol=1e-6)
WORLDS = [2, 4]


def _fast_scene():
    """sample_scene with 20x dt: first impacts at step 45."""
    scene = sample_scene(width=128, height=128)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


def _warm_state(scene, steps: int) -> dict:
    """The 7 x 7 spawn in 4096 slots after ``steps`` single-device sorted
    steps, its slots permuted (seed 0): a numpy snapshot."""
    s = spawn_grid(scene.config, 1, pad_multiple=N_SLOTS, device="cpu")
    step = tstep.make_spatial_step_sorted(scene.triangles, scene.config,
                                          device="cpu")
    for _ in range(steps):
        s = step(s)
    perm = np.random.default_rng(0).permutation(N_SLOTS)
    return {k: v[..., perm] for k, v in snapshot(s).items()}


def _state(d: dict) -> ParticleState:
    return convert.state_from_numpy(d, device="cpu")


def _save(path, **arrays) -> None:
    np.savez(path, **arrays)


# ---- rank bodies (run in spawned processes) --------------------------------

def _sorted_rank(rank, world, in_path, out_path, steps):
    """``steps`` sorted steps with mesh= and with_stats; rank 0 saves
    each gathered state and the summed overflow each rank reported."""
    scene = _fast_scene()
    mesh = dp.make_mesh(device_type="cpu")
    step = tstep.make_spatial_step_sorted(scene.triangles, scene.config,
                                          with_stats=True, mesh=mesh,
                                          device="cpu")
    s = dp.shard_state(_state(dict(np.load(in_path))), mesh)
    out = {}
    for k in range(steps):
        s, st = step(s)
        g = snapshot(dp.gather_state(s, mesh))
        ovf = [None] * world
        dist.all_gather_object(ovf, st["window_overflow"])
        out.update({f"{f}{k}": g[f] for f in ("pos", "vel", "collisions")})
        out[f"ovf{k}"] = np.asarray(ovf)
    if rank == 0:
        _save(out_path, **out)


def _hybrid_rank(rank, world, in_path, out_path):
    """One hybrid sorted step with mesh=; rank 0 saves the gathered
    state."""
    scene = _fast_scene()
    mesh = dp.make_mesh(device_type="cpu")
    step = tstep.make_hybrid_step_sorted(scene.triangles, scene.config,
                                         scene.cameras[0], mesh=mesh,
                                         device="cpu")
    g = snapshot(dp.gather_state(
        step(dp.shard_state(_state(dict(np.load(in_path))), mesh)), mesh))
    if rank == 0:
        _save(out_path, **g)


def _dp_rank(rank, world, in_path, out_path):
    """make_dp_step over make_method_step(..., "hybrid"): one step on the
    rank's slice, collisions summed over the mesh."""
    scene = _fast_scene()
    mesh = dp.make_mesh(device_type="cpu")
    step = dp.make_dp_step(tstep.make_method_step(scene, "hybrid",
                                                  device="cpu"), mesh)
    out = step(dp.shard_state(_state(dict(np.load(in_path))), mesh))
    total = dp.sum_ints(int(out.collisions.sum()), mesh)
    g = snapshot(dp.gather_state(out, mesh))
    if rank == 0:
        _save(out_path, total=np.asarray(total), **g)


# ---- fixtures -------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    return _fast_scene()


@pytest.fixture(scope="module")
def bake_cache(tmp_path_factory):
    """A bake cache of this module's own, baked here once so the ranks
    only read it (they inherit the environment)."""
    import os

    from particlesystemhybridcollisiondetection_tpu_torch.ops.screenspace import (
        bake_camera,
    )

    path = str(tmp_path_factory.mktemp("bake"))
    old = os.environ.get("PSYS_BAKE_CACHE")
    os.environ["PSYS_BAKE_CACHE"] = path
    sc = _fast_scene()
    # the sorted factories bake without corner normals, the method step
    # with the scene's
    for normals in (None, getattr(sc, "corner_normals", None)):
        bake_camera(sc.triangles, sc.cameras[0], normals, device="cpu")
    yield path
    if old is None:
        del os.environ["PSYS_BAKE_CACHE"]
    else:
        os.environ["PSYS_BAKE_CACHE"] = old


@pytest.fixture(scope="module")
def warm42(scene):
    return _warm_state(scene, 42)


@pytest.fixture(scope="module")
def warm40(scene):
    return _warm_state(scene, 40)


def _spawn(tmp_path, body, world, inp, *args) -> dict:
    in_path, out_path = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(in_path, **inp)
    run_ranks(body, world, str(in_path), str(out_path), *args,
              device_type="cpu")
    return dict(np.load(out_path))


def _mask(d):
    return np.abs(d["pos"][0]) < 1e37


def _assert_bitwise(got: dict, want: dict, msg=""):
    for f in ("pos", "vel", "collisions"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{msg} {f}")


def _assert_near_jax(got: dict, want: dict, mask, msg=""):
    np.testing.assert_array_equal(got["collisions"], want["collisions"],
                                  err_msg=msg)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(got[f][:, mask], want[f][:, mask], **TOL,
                                   err_msg=f"{msg} {f}")


def _jax_state(d: dict):
    import jax.numpy as jnp

    from particlesystemhybridcollisiondetection_tpu.core.state import ParticleState as JState

    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def _jax_snap(s) -> dict:
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _slices(d: dict, world: int):
    m = N_SLOTS // world
    return [_state({k: np.ascontiguousarray(v[..., r * m:(r + 1) * m])
                    for k, v in d.items()}) for r in range(world)]


# ---- tests ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(scene, bake_cache):
    """The JAX package's sorted spatial and hybrid steps (interpret mode,
    gather plan), built once: every test here feeds them 4096 slots."""
    from particlesystemhybridcollisiondetection_tpu.core import step as jstep

    spatial = jstep.make_spatial_step_sorted(
        scene.triangles, scene.config, interpret=True, cells_lookup="gather")
    hybrid = jstep.make_hybrid_step_sorted(
        scene.triangles, scene.config, scene.cameras[0], interpret=True,
        cells_lookup="gather")
    return {"spatial": spatial, "camera": hybrid}


@pytest.fixture(scope="module")
def sorted_ref(scene, warm42, jax_steps):
    """The single-device step with stats, its states over 3 steps from
    step 42, and the JAX package's step fed the port's state each step."""
    single = tstep.make_spatial_step_sorted(scene.triangles, scene.config,
                                            with_stats=True, device="cpu")
    snaps, jax_snaps = [warm42], []
    s = _state(warm42)
    for _ in range(3):
        jax_snaps.append(_jax_snap(jax_steps["spatial"](_jax_state(snaps[-1]))))
        s = single(s)[0]
        snaps.append(snapshot(s))
    return single, snaps, jax_snaps


@pytest.mark.parametrize("world", WORLDS)
def test_sorted_sharded_matches_single_device(tmp_path, warm42, sorted_ref, world):
    """3 sorted steps with mesh= from step 42 (impacts and rescue at step
    45): every gathered state equal bit for bit to the single-device
    step's and within tolerance of the JAX package's.  Every rank
    reports the same ``window_overflow``: the sum over the ranks of what
    the single-device step reports for each rank's slice (which lanes
    overflow depends on which particles share a block, so the sum over
    slices, not the whole-state count, is the reference)."""
    out = _spawn(tmp_path, _sorted_rank, world, warm42, 3)
    single, snaps, jax_snaps = sorted_ref
    mask = _mask(warm42)
    assert snaps[-1]["collisions"].sum() > 0
    for k in range(3):
        got = {f: out[f"{f}{k}"] for f in ("pos", "vel", "collisions")}
        _assert_bitwise(got, snaps[k + 1], f"step {k}")
        _assert_near_jax(got, jax_snaps[k], mask, f"step {k}")
        want = sum(single(sl)[1]["window_overflow"]
                   for sl in _slices(snaps[k], world))
        assert want > 0
        assert out[f"ovf{k}"].tolist() == [want] * world, f"step {k}"


@pytest.fixture(scope="module")
def hybrid_ref(scene, warm40, jax_steps):
    single = tstep.make_hybrid_step_sorted(scene.triangles, scene.config,
                                           scene.cameras[0], device="cpu")
    return (snapshot(single(_state(warm40))),
            _jax_snap(jax_steps["camera"](_jax_state(warm40))))


@pytest.mark.parametrize("world", WORLDS)
def test_hybrid_sorted_sharded_matches_single_device(tmp_path, warm40,
                                                     hybrid_ref, world):
    """One hybrid sorted step with mesh= from step 40 (the screen-space
    stage has work): equal bit for bit to the single-device step, within
    tolerance of the JAX package's."""
    out = _spawn(tmp_path, _hybrid_rank, world, warm40)
    single, jax_out = hybrid_ref
    _assert_bitwise(out, single)
    _assert_near_jax(out, jax_out, _mask(warm40))


@pytest.fixture(scope="module")
def dp_ref(scene, warm42, bake_cache):
    """make_method_step(…, "hybrid") on one device (the packed hybrid
    step on the CPU, as in the JAX package) from step 42, and the JAX
    package's method step without jit (ROADMAP C3)."""
    import jax

    from particlesystemhybridcollisiondetection_tpu.core import step as jstep

    single = snapshot(tstep.make_method_step(scene, "hybrid", device="cpu")(
        _state(warm42)))
    with jax.disable_jit():
        j_out = _jax_snap(jstep.make_method_step(scene, "hybrid")(
            _jax_state(warm42)))
    return single, j_out


@pytest.mark.parametrize("world", WORLDS)
def test_dp_step_hybrid_method_matches_single_device(tmp_path, warm42, dp_ref,
                                                     world):
    """make_dp_step over the hybrid method step: the gathered slices
    equal the single-device step bit for bit, the summed collision count
    is the global one, and the JAX package agrees within tolerance."""
    out = _spawn(tmp_path, _dp_rank, world, warm42)
    single, jax_out = dp_ref
    _assert_bitwise(out, single)
    _assert_near_jax(out, jax_out, _mask(warm42))
    assert int(out["total"]) == int(single["collisions"].sum())


def test_dryrun_multichip_two_ranks(bake_cache, capfd):
    dryrun_multichip(2, device_type="cpu")
    assert "dryrun_multichip OK: 2 gloo ranks on cpu" in capfd.readouterr().out


def test_one_rank_helpers_and_refusals(scene):
    """In this process, a group of one rank: shard_state / gather_state
    round trip, sum_ints and sum_int_list, the divisibility check, the
    refusal of a mesh over more ranks than the world holds, the backend
    choice and the mesh type check of the sorted factories."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = dp.make_mesh(device_type="cpu")
        s = spawn_grid(scene.config, 1, device="cpu")
        s = s._replace(collisions=torch.arange(s.pos.shape[-1], dtype=torch.int32))
        back = dp.gather_state(dp.shard_state(s, mesh), mesh)
        for a, b in zip(back, s):
            assert torch.equal(a, b)
        assert dp.sum_ints(7, mesh) == 7
        assert dp.sum_int_list([3, 0, 5], mesh) == [3, 0, 5]
        with pytest.raises(ValueError, match="divide"):
            dp.shard_state(ParticleState(*(x[..., :1000] for x in s)), mesh)
        # a mesh takes the first n ranks: n above the world's raises
        # (the n below it is in test_torch_partial_mesh.py)
        with pytest.raises(ValueError, match="mesh over 2 ranks, but the world has 1"):
            dp.make_mesh(2, device_type="cpu")
        assert dp.choose_backend("cpu", 4) == "gloo"
        with pytest.raises(TypeError, match="DeviceMesh"):
            tstep.make_spatial_step_sorted(scene.triangles, scene.config,
                                           mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="match the mesh"):
            tstep.make_sorted_episode_runner(scene.triangles, scene.config,
                                             mesh=mesh, device="meta")
        assert active_mask(back).sum() == 49
    finally:
        dist.destroy_process_group()
