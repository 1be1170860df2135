"""Multi-rank dry run, and the helper that spawns ranks.

``dryrun_multichip(n)`` spawns ``n`` ranks, on the card unless the
caller asks for the CPU (there gloo ranks, as the JAX package runs the
same dry run on a virtual CPU mesh), and drives, in each rank: the
data-parallel hybrid step on the 16 x 16 sample scene, a collision count
summed over the ranks, one domain-decomposed p2p step (halo exchange and
migration), the sorted step with ``mesh=`` and the persistent runner with
``mesh=`` (``resort_every=2``, 2 steps).  The backend is
``data_parallel.choose_backend``'s: on one card several ranks share it
over gloo.

    python -m particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun 4
    python -m particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun 4 --device cpu
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


def _dryrun_rank(rank: int, world: int, device_type: str) -> None:
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

    scene = _sample_scene()
    cfg = scene.config
    mesh = dp.make_mesh(world, device_type=device_type)
    dev = dp.rank_device(mesh)
    # one 1024 block per rank: the padding the sorted pipeline needs
    state = spawn_grid(cfg, layers_y=1, pad_multiple=world * 1024, device=dev)

    # --- path 1: data parallel hybrid step, replicated scene tables ---
    step = dp.make_dp_step(make_method_step(scene, "hybrid", camera_index=0,
                                            device=dev), mesh)
    out = step(dp.shard_state(state, mesh))
    total = dp.sum_ints(int(out.collisions.sum()), mesh)
    if total < 0 or not torch.isfinite(out.pos[:, active_mask(out)]).all():
        raise RuntimeError(f"rank {rank}: hybrid step gave collisions {total} "
                           "or non-finite positions")

    # --- path 2: domain decomposition, halo exchange and migration ---
    rng = np.random.default_rng(0)
    n = 32 * world
    tiny = ParticleState(
        pos=torch.from_numpy(np.stack([
            rng.uniform(0.5, 4.0 * world - 0.5, n),
            rng.uniform(2, 7, n),
            rng.uniform(0.5, 3.5, n),
        ]).astype(np.float32)),
        vel=torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)),
        collisions=torch.zeros((n,), dtype=torch.int32),
        radius=torch.full((n,), 0.3, dtype=torch.float32),
        restitution=torch.full((n,), 0.4, dtype=torch.float32),
    )
    dcfg = dom.DomainConfig(
        box_lo=(0.0, 0.0, 0.0), box_hi=(4.0 * world, 8.0, 4.0),
        n_shards=world, shard_capacity=128, halo_capacity=64,
        migrate_capacity=64, cell_size=0.7,
    )
    dmesh = dp.make_mesh(world, axis_name=dom.AXIS, device_type=device_type)
    dstate = dom.shard_domain_state(dom.distribute(tiny, dcfg), dmesh)
    dstate, stats = dom.make_domain_step(dcfg, cfg, dmesh)(dstate)
    if int(stats[1]) != 0:
        raise RuntimeError(f"rank {rank}: migration overflow on tiny shapes")

    # --- path 3: the sorted pipeline with mesh=, then the persistent
    # runner (per-rank persistent order, rank-local id restore) ---
    local = dp.shard_state(state, mesh)
    sout = make_spatial_step_sorted(scene.triangles, cfg, mesh=mesh,
                                    device=dev)(local)
    runner = make_sorted_episode_runner(scene.triangles, cfg, resort_every=2,
                                        mesh=mesh, device=dev)
    pout = runner(local, 2)
    for name, s in (("sorted step", sout), ("runner", pout)):
        if not torch.isfinite(s.pos[:, active_mask(s)]).all():
            raise RuntimeError(f"rank {rank}: {name} gave non-finite positions")
    if rank == 0:
        print(f"dryrun_multichip OK: {world} {dist.get_backend()} ranks on "
              f"{device_type}; data "
              f"parallel hybrid step (collisions summed: {total}) + "
              f"domain-decomposed p2p step (halo exchange + migration, stats "
              f"{stats.tolist()}) + sorted step with mesh= + persistent "
              f"runner with mesh= all executed", flush=True)


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Spawn ``n_devices`` ranks on ``device_type`` and run the dry run in
    each; raises if any rank fails.  The kernels are built and the camera
    baked here first, so the ranks only load the builds and read the bake
    cache."""
    from particlesystemhybridcollisiondetection_tpu_torch.ops.screenspace import (
        bake_camera,
    )

    if device_type == "cuda":
        from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

        build.build_all()
    scene = _sample_scene()
    bake_camera(scene.triangles, scene.cameras[0],
                getattr(scene, "corner_normals", None), device=device_type)
    run_ranks(_dryrun_rank, int(n_devices), device_type,
              device_type=device_type)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device)
