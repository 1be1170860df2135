"""PyTorch port, a mesh over the first n ranks of a larger world, as the
JAX package's ``make_mesh(n)`` takes the first n devices
(``parallel/data_parallel.py:34-38``), on gloo ranks on the CPU.

One spawn of 3 ranks meshes the first 2: the sorted step with ``mesh=``
(3 steps from step 42), the persistent runner with ``mesh=``
(``resort_every=3`` and "auto", 11 steps from step 36), the domain step
(``test_torch_domain.py``'s parity run) and ``config_5(n_shards=2)``;
rank 2 takes part in building each group and sits out.  One spawn of 2
ranks runs the same body over the whole world: the partial mesh must
equal it bit for bit.  Both are held to the JAX package's runs on
``Mesh(jax.devices()[:2])`` (the virtual CPU devices of
``tests/conftest.py``) at ``test_torch_parallel.py``'s tolerance
(``rtol=1e-5, atol=1e-6``, hits and collision counts exact; ROADMAP C1)
and the domain step as ``test_torch_domain.py::
test_domain_step_matches_jax`` holds it.  A third spawn runs the dry run
on the first 2 of 3 ranks.

The JAX package is imported inside the functions that use it: the
spawned ranks import this module to find their body and need only the
port.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import config_5
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import snapshot
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp
from particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    run_ranks,
)
from test_torch_domain import _parity_rank, assert_domain_matches_jax
from test_torch_parallel import (  # noqa: F401  (fixtures)
    _assert_bitwise,
    _assert_near_jax,
    _fast_scene,
    _jax_snap,
    _jax_state,
    _mask,
    _state,
    scene,
    warm42,
)
from test_torch_parallel_runner import (  # noqa: F401  (fixtures)
    RUNNER_STEPS,
    _auto_resorts,
    _runner_kw,
    warm36,
)

torch.set_num_threads(1)

N_MESH = 2  # the mesh: the first 2 ranks
SORTED_STEPS = 3
RUNNER_TAGS = ("spatial", "auto")
FIELDS = ("pos", "vel", "collisions")


# ---- the rank body (run in spawned processes) -------------------------------

def _first_ranks_rank(rank, world, n, in42, in36, out_dir):
    """On a mesh over the first ``n`` of ``world`` ranks: the sorted step
    and the runners with mesh=, gathered to mesh rank 0 (global rank 0,
    which saves them); the domain parity run; config 5 on ``n`` shards.
    Every rank saves a record of what it got."""
    scene = _fast_scene()
    mesh = dp.make_mesh(n, device_type="cpu")
    rec = {"rank": rank, "member": mesh is not None}
    out = {}
    if mesh is not None:
        group = mesh.get_group()
        rec.update(mesh_ranks=dist.get_process_group_ranks(group),
                   mesh_rank=mesh.get_local_rank(), mesh_size=mesh.size(),
                   backend=dist.get_backend(group))
        step = tstep.make_spatial_step_sorted(
            scene.triangles, scene.config, with_stats=True, mesh=mesh,
            device="cpu")
        s = dp.shard_state(_state(dict(np.load(in42))), mesh)
        for k in range(SORTED_STEPS):
            s, st = step(s)
            g = snapshot(dp.gather_state(s, mesh))
            ovf = [None] * n
            dist.all_gather_object(ovf, st["window_overflow"], group=group)
            out.update({f"step_{f}{k}": g[f] for f in FIELDS})
            out[f"step_ovf{k}"] = np.asarray(ovf)
        local = dp.shard_state(_state(dict(np.load(in36))), mesh)
        for tag in RUNNER_TAGS:
            runner = tstep.make_sorted_episode_runner(
                scene.triangles, scene.config, mesh=mesh, device="cpu",
                **_runner_kw(scene, tag))
            r, ovf = runner(local, RUNNER_STEPS, with_stats=True)
            g = snapshot(dp.gather_state(r, mesh))
            out.update({f"{tag}_{f}": g[f] for f in FIELDS})
            ovf_ranks = [None] * n
            dist.all_gather_object(ovf_ranks, ovf, group=group)
            out[f"{tag}_ovf"] = np.asarray(ovf_ranks)
    # collective in every rank of the world: each builds its own group
    _parity_rank(rank, world, f"{out_dir}/domain.npz", n)
    rec["config5"] = config_5(steps=2, n=5000, n_shards=n, device="cpu")
    rec["initialized"] = dist.is_initialized()
    if rank == 0:
        np.savez(f"{out_dir}/states.npz", **out)
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(rec, f)


def _run(tmp_path_factory, world, warm42, warm36) -> dict:
    d = tmp_path_factory.mktemp(f"world{world}")
    in42, in36 = d / "in42.npz", d / "in36.npz"
    np.savez(in42, **warm42)
    np.savez(in36, **warm36)
    run_ranks(_first_ranks_rank, world, N_MESH, str(in42), str(in36), str(d),
              device_type="cpu")
    recs = []
    for r in range(world):
        with open(d / f"rank{r}.json") as f:
            recs.append(json.load(f))
    return {"states": dict(np.load(d / "states.npz")),
            "domain": dict(np.load(d / "domain.npz")), "ranks": recs}


# ---- fixtures -------------------------------------------------------------

@pytest.fixture(scope="module")
def partial(tmp_path_factory, warm42, warm36):
    """The first 2 of 3 ranks."""
    return _run(tmp_path_factory, 3, warm42, warm36)


@pytest.fixture(scope="module")
def full(tmp_path_factory, warm42, warm36):
    """The same body on a world of 2: the mesh spans it."""
    return _run(tmp_path_factory, N_MESH, warm42, warm36)


@pytest.fixture(scope="module")
def jax_first_devices(scene, warm42, warm36, full):
    """The JAX package's sorted step and ``resort_every=3`` runner on
    ``Mesh(jax.devices()[:2])``, interpret mode, gather plan: the step
    fed the port's 2-rank state of each step before (as
    ``test_torch_parallel.py`` feeds the JAX step), the runner the state
    at step 36."""
    import jax
    from jax.sharding import Mesh

    from particlesystemhybridcollisiondetection_tpu.core import step as jstep

    mesh = Mesh(np.asarray(jax.devices()[:N_MESH]), ("data",))
    kw = dict(interpret=True, cells_lookup="gather", mesh=mesh)
    step = jstep.make_spatial_step_sorted(scene.triangles, scene.config,
                                          with_stats=True, **kw)
    ref, prev = {}, warm42
    for k in range(SORTED_STEPS):
        s, st = step(_jax_state(prev))
        ref[f"step{k}"] = _jax_snap(s)
        ref[f"step_ovf{k}"] = int(st["window_overflow"])
        prev = {**prev, **{f: full["states"][f"step_{f}{k}"] for f in FIELDS}}
    runner = jstep.make_sorted_episode_runner(
        scene.triangles, scene.config, **kw, **_runner_kw(scene, "spatial"))
    ref["spatial"] = _jax_snap(runner(_jax_state(warm36), RUNNER_STEPS))
    return ref


# ---- tests ----------------------------------------------------------------

def _got(run: dict, prefix: str) -> dict:
    return {f: run["states"][f"{prefix}{f}"] for f in FIELDS}


def test_partial_mesh_sorted_step_matches_full_world(partial, full):
    """3 sorted steps with mesh= on the first 2 of 3 ranks from step 42
    (impacts and rescue at step 45): every gathered state equal bit for
    bit to the 2-rank world's, and each member reports the same summed
    ``window_overflow`` as the world's ranks do."""
    assert full["states"]["step_collisions2"].sum() > 0
    for k in range(SORTED_STEPS):
        got = {f: partial["states"][f"step_{f}{k}"] for f in FIELDS}
        want = {f: full["states"][f"step_{f}{k}"] for f in FIELDS}
        _assert_bitwise(got, want, f"step {k}")
        ovf = partial["states"][f"step_ovf{k}"].tolist()
        assert ovf == full["states"][f"step_ovf{k}"].tolist() == [ovf[0]] * N_MESH
    assert sum(partial["states"][f"step_ovf{k}"][0] for k in range(SORTED_STEPS)) > 0


def test_partial_mesh_sorted_step_matches_jax_first_devices(partial, warm42,
                                                            jax_first_devices):
    """The same 3 steps against the JAX package's sorted step on
    ``Mesh(jax.devices()[:2])``, fed the same state each step: within
    tolerance, hits exact.  The summed overflow is the JAX mesh's."""
    mask = _mask(warm42)
    for k in range(SORTED_STEPS):
        got = {f: partial["states"][f"step_{f}{k}"] for f in FIELDS}
        _assert_near_jax(got, jax_first_devices[f"step{k}"], mask, f"step {k}")
        assert (partial["states"][f"step_ovf{k}"][0]
                == jax_first_devices[f"step_ovf{k}"]), f"step {k}"


def test_partial_mesh_runner_matches_full_world(partial, full):
    """The persistent runner with mesh= on the first 2 of 3 ranks, 11
    steps from step 36, ``resort_every=3`` and "auto" (threshold 0: the
    overflow summed over the subgroup on every step decides the
    re-sort): equal bit for bit to the 2-rank world's runner, the same
    per-step overflows on every member, and both re-sort branches."""
    for tag in RUNNER_TAGS:
        _assert_bitwise(_got(partial, f"{tag}_"), _got(full, f"{tag}_"), tag)
        ovf = partial["states"][f"{tag}_ovf"].tolist()
        assert ovf == full["states"][f"{tag}_ovf"].tolist(), tag
        assert ovf == [ovf[0]] * N_MESH and max(ovf[0]) > 0, tag
    assert 1 < len(_auto_resorts(partial["states"]["auto_ovf"][0])) < RUNNER_STEPS


def test_partial_mesh_runner_matches_jax_first_devices(partial, warm36,
                                                       jax_first_devices):
    """The ``resort_every=3`` runner against the JAX package's on
    ``Mesh(jax.devices()[:2])`` over the same 11 steps: within
    tolerance, collision counts exact ("auto" is held bit for bit to the
    2-rank world's runner above, which ``test_torch_parallel_runner.py``
    holds to one device)."""
    _assert_near_jax(_got(partial, "spatial_"), jax_first_devices["spatial"],
                     _mask(warm36), "spatial")
    assert partial["states"]["spatial_collisions"].sum() > 0


def test_partial_mesh_domain_step_matches_jax_first_devices(partial, full):
    """The domain step on the first 2 of 3 ranks (``n_shards=2``): equal
    bit for bit to the 2-rank world's, and held to the JAX package's on
    ``jax.devices()[:2]`` as ``test_domain_step_matches_jax`` holds the
    2-rank world's."""
    assert partial["domain"].keys() == full["domain"].keys()
    for k, v in full["domain"].items():
        np.testing.assert_array_equal(partial["domain"][k], v, err_msg=k)
    assert_domain_matches_jax(partial["domain"], N_MESH)


def test_partial_mesh_members_and_non_member(partial, full):
    """Ranks 0 and 1 hold the mesh over global ranks [0, 1] (gloo, their
    mesh rank their global rank); rank 2 got ``None`` from every
    ``make_mesh`` and sat out, and every rank left its group whole (the
    spawn raises if a rank fails)."""
    recs = partial["ranks"]
    assert [r["rank"] for r in recs] == [0, 1, 2]
    for r in recs[:N_MESH]:
        assert r["member"] and r["mesh_ranks"] == [0, 1]
        assert r["mesh_rank"] == r["rank"] and r["mesh_size"] == N_MESH
        assert r["backend"] == "gloo"
    assert not recs[2]["member"] and "mesh_ranks" not in recs[2]
    assert recs[2]["config5"] == {"config": 5, "shards": N_MESH, "rank": 2,
                                  "sat_out": True}
    assert all(r["initialized"] for r in recs)
    assert [r["member"] for r in full["ranks"]] == [True, True]


def test_config_5_on_first_shards(partial, full):
    """``config_5(n_shards=2)`` on a world of 3: the members return the
    keys of the full world's result, with every particle kept, no
    overflow, the subgroup's backend, and the full world's counts."""
    c5 = [r["config5"] for r in partial["ranks"][:N_MESH]]
    want = full["ranks"][0]["config5"]
    assert want["active_particles"] == 5000
    for c in c5:
        assert c.keys() == want.keys()
        assert c["shards"] == N_MESH and c["particles"] == 5000
        assert c["active_particles"] == 5000 and c["backend"] == "gloo"
        for k in ("halo_overflow", "migrate_overflow",
                  "cell_overflow"):
            assert c[k] == want[k] == 0, k


def test_dryrun_first_ranks_of_world(tmp_path, monkeypatch, capfd):
    """``dryrun_multichip(2, "cpu", world=3)``: the dry run on the first
    2 of 3 ranks, each member's output slice the one ``shard_state``
    lays out; rank 2 idles.  A mesh over more ranks than spawned
    raises before any spawn."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path))
    dryrun_multichip(N_MESH, device_type="cpu", world=3)
    assert ("dryrun_multichip OK: 2 gloo ranks on cpu (the first 2 of 3)"
            in capfd.readouterr().out)
    with pytest.raises(ValueError, match="mesh over 3 ranks in a world of 2"):
        dryrun_multichip(3, device_type="cpu", world=2)


def test_choose_backend_for_first_ranks(monkeypatch):
    """The backend of a mesh over the first n ranks is decided for its
    members: on one card a mesh over 1 of 3 ranks is NCCL, over 2 gloo;
    on 4 cards 4 ranks are NCCL, 8 sharing them gloo; a launcher's
    ``LOCAL_WORLD_SIZE`` caps the members counted on this host; CPU
    ranks are gloo."""
    monkeypatch.setattr(dp, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dp.choose_backend("cuda", 1) == "nccl"
    assert dp.choose_backend("cuda", 2) == "gloo"
    assert dp.choose_backend("cuda", 3) == "gloo"
    assert dp.choose_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert dp.choose_backend("cuda", 8) == "nccl"  # 4 on this host
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert dp.choose_backend("cuda", 4) == "nccl"
    assert dp.choose_backend("cuda", 8) == "gloo"
