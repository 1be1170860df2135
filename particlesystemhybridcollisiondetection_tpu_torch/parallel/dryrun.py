"""Multi-rank dry run, and the helper that spawns ranks.

``dryrun_multichip(n)`` spawns ``n`` ranks (or ``world`` ranks, of which
the first ``n`` make the meshes, as the JAX package's dry run meshes the
first n devices of a host with more), on the card unless the caller
asks for the CPU (there gloo ranks, as the JAX package runs the same dry
run on a virtual CPU mesh), and drives, in each rank of the mesh: the
data-parallel hybrid step on the 16 x 16 sample scene, with a check that
each rank's output slice is the one ``shard_state`` lays out, a
collision count summed over the ranks, one domain-decomposed p2p step
(halo exchange and migration), the sorted step with ``mesh=`` and the
persistent runner with ``mesh=`` (``resort_every=2``, 2 steps).  The
ranks past the first ``n`` take part in building the meshes' groups and
then idle.  The backend is ``data_parallel.choose_backend``'s for the
mesh's ranks: on one card several ranks share it over gloo.

    python -m particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun 4
    python -m particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun 4 --device cpu
    python -m particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun 2 --world 3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp


def _rank_main(rank: int, fn, world: int, init_method: str, device_type: str,
               args: tuple) -> None:
    # every spawned rank is on this host
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(world)
    if device_type == "cpu":
        # ranks share the host's cores; one thread each keeps them from
        # contending for all of them
        torch.set_num_threads(1)
    dp.init_ranks(rank, world, init_method, device_type)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device_type: str = "cuda") -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes on this
    host (spawn start method), each a rank of the default process group
    with the backend ``data_parallel.choose_backend`` picks for
    ``device_type``.  ``fn`` must be importable (a module-level
    function).  Rendezvous through a file in a new temporary directory,
    so concurrent callers never share a port.  Raises if any rank
    fails."""
    with tempfile.TemporaryDirectory(prefix="psys_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(fn, world, init_method,
                                             device_type, args),
                           nprocs=world, start_method="spawn", join=True)


def _sample_scene():
    """The sample scene at 16 x 16 particles and 64 x 64 textures."""
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        sample_scene,
    )

    scene = sample_scene(width=64, height=64)
    cfg = dataclasses.replace(scene.config, num_particles_xz=16)
    return dataclasses.replace(scene, config=cfg)


def _dryrun_rank(rank: int, world: int, n: int, device_type: str) -> None:
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
        ParticleState,
        active_mask,
        spawn_grid,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
        make_method_step,
        make_sorted_episode_runner,
        make_spatial_step_sorted,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.parallel import domain as dom

    # every rank of the world builds both meshes' groups; a rank outside
    # them has nothing more to do
    mesh = dp.make_mesh(n, device_type=device_type)
    dmesh = dp.make_mesh(n, axis_name=dom.AXIS, device_type=device_type)
    if mesh is None:
        return
    scene = _sample_scene()
    cfg = scene.config
    dev = dp.rank_device(mesh)
    # one 1024 block per rank: the padding the sorted pipeline needs
    state = spawn_grid(cfg, layers_y=1, pad_multiple=n * 1024, device=dev)

    # --- path 1: data parallel hybrid step, replicated scene tables ---
    step = dp.make_dp_step(make_method_step(scene, "hybrid", camera_index=0,
                                            device=dev), mesh)
    local = dp.shard_state(state, mesh)
    out = step(local)
    # the output is this rank's contiguous slice, where shard_state cut
    # the input (the JAX dry run's check of the output's sharding)
    m, r = state.pos.shape[-1] // n, mesh.get_local_rank()
    whole = dp.gather_state(out, mesh)
    if (out.pos.shape[-1] != m or out.pos.device != dev
            or not torch.equal(local.pos, state.pos[:, r * m:(r + 1) * m])
            or not all(torch.equal(a[..., r * m:(r + 1) * m], b)
                       for a, b in zip(whole, out))):
        raise RuntimeError(f"rank {rank}: the output is not the slice "
                           f"[{r * m}, {(r + 1) * m}) that shard_state lays out")
    total = dp.sum_ints(int(out.collisions.sum()), mesh)
    if total < 0 or not torch.isfinite(out.pos[:, active_mask(out)]).all():
        raise RuntimeError(f"rank {rank}: hybrid step gave collisions {total} "
                           "or non-finite positions")

    # --- path 2: domain decomposition, halo exchange and migration ---
    rng = np.random.default_rng(0)
    n_tiny = 32 * n
    tiny = ParticleState(
        pos=torch.from_numpy(np.stack([
            rng.uniform(0.5, 4.0 * n - 0.5, n_tiny),
            rng.uniform(2, 7, n_tiny),
            rng.uniform(0.5, 3.5, n_tiny),
        ]).astype(np.float32)),
        vel=torch.from_numpy(rng.normal(size=(3, n_tiny)).astype(np.float32)),
        collisions=torch.zeros((n_tiny,), dtype=torch.int32),
        radius=torch.full((n_tiny,), 0.3, dtype=torch.float32),
        restitution=torch.full((n_tiny,), 0.4, dtype=torch.float32),
    )
    dcfg = dom.DomainConfig(
        box_lo=(0.0, 0.0, 0.0), box_hi=(4.0 * n, 8.0, 4.0),
        n_shards=n, shard_capacity=128, halo_capacity=64,
        migrate_capacity=64, cell_size=0.7,
    )
    dstate = dom.shard_domain_state(dom.distribute(tiny, dcfg), dmesh)
    dstate, stats = dom.make_domain_step(dcfg, cfg, dmesh)(dstate)
    if int(stats[1]) != 0:
        raise RuntimeError(f"rank {rank}: migration overflow on tiny shapes")

    # --- path 3: the sorted pipeline with mesh=, then the persistent
    # runner (per-rank persistent order, rank-local id restore) ---
    sout = make_spatial_step_sorted(scene.triangles, cfg, mesh=mesh,
                                    device=dev)(local)
    runner = make_sorted_episode_runner(scene.triangles, cfg, resort_every=2,
                                        mesh=mesh, device=dev)
    pout = runner(local, 2)
    for name, s in (("sorted step", sout), ("runner", pout)):
        if not torch.isfinite(s.pos[:, active_mask(s)]).all():
            raise RuntimeError(f"rank {rank}: {name} gave non-finite positions")
    if rank == 0:
        of = "" if n == world else f" (the first {n} of {world})"
        print(f"dryrun_multichip OK: {n} {dist.get_backend(mesh.get_group())} "
              f"ranks on {device_type}{of}; data "
              f"parallel hybrid step (collisions summed: {total}) + "
              f"domain-decomposed p2p step (halo exchange + migration, stats "
              f"{stats.tolist()}) + sorted step with mesh= + persistent "
              f"runner with mesh= all executed", flush=True)


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     world: int | None = None) -> None:
    """Spawn ``world`` ranks (default ``n_devices``) on ``device_type``
    and run the dry run on a mesh over the first ``n_devices`` of them;
    the others take part in building its groups and idle.  Raises if
    any rank fails, or if ``n_devices`` exceeds ``world``.  The kernels
    are built and the camera baked here first, so the ranks only load
    the builds and read the bake cache."""
    from particlesystemhybridcollisiondetection_tpu_torch.ops.screenspace import (
        bake_camera,
    )

    n = int(n_devices)
    world = n if world is None else int(world)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh over {n} ranks in a world of {world}")
    if device_type == "cuda":
        from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

        build.build_all()
    scene = _sample_scene()
    bake_camera(scene.triangles, scene.cameras[0],
                getattr(scene, "corner_normals", None), device=device_type)
    run_ranks(_dryrun_rank, world, n, device_type, device_type=device_type)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn (default n_devices); the first "
                         "n_devices make the mesh, the rest idle")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device, a.world)
