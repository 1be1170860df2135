"""The benchmark configurations of the gravity box, runnable by
number (port of the JAX package's ``bench/configs.py``).  Each returns a
metrics dict.

  1. brute-force O(n^2) sphere-sphere vs the grid path, ~2k particles
  2. uniform grid broad phase, 50k particles, walls + restitution
  3. hybrid (screen-space + exact fallback), 262k on the bunny scene
  4. 1M particles, on-device grid build + narrow phase + integrate
  5. heterogeneous radii and restitution, the box split into slabs over
     the ranks of a process group with a halo exchange (1M per rank)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.bench.harness import run_episode
from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
    resolve_device,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    _walls_integrate,
    make_p2p_step,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import bunny_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p as p2p_ops
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence


def _box_state(n, box_lo, box_hi, radius, restitution, seed=0, hetero=False,
               device="cuda") -> ParticleState:
    """``n`` particles in the upper half of the box, from
    ``np.random.default_rng(seed)``: the arrays are made in NumPy, draw
    for draw as the JAX package makes them, then moved to ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lo = np.asarray(box_lo)
    hi = np.asarray(box_hi)
    pos = np.stack(
        [
            rng.uniform(lo[0] + radius, hi[0] - radius, n),
            rng.uniform((lo[1] + hi[1]) / 2, hi[1] - radius, n),
            rng.uniform(lo[2] + radius, hi[2] - radius, n),
        ]
    ).astype(np.float32)
    r = (
        rng.uniform(0.7 * radius, 1.3 * radius, n).astype(np.float32)
        if hetero
        else np.full(n, radius, dtype=np.float32)
    )
    e = (
        rng.uniform(0.2, 0.6, n).astype(np.float32)
        if hetero
        else np.full(n, restitution, dtype=np.float32)
    )
    vel = (rng.normal(size=(3, n)) * 0.5).astype(np.float32)
    return ParticleState(
        pos=torch.from_numpy(pos).to(dev),
        vel=torch.from_numpy(vel).to(dev),
        collisions=torch.zeros((n,), dtype=torch.int32, device=dev),
        radius=torch.from_numpy(r).to(dev),
        restitution=torch.from_numpy(e).to(dev),
    )


def _time_steps(step, state, steps, chunk=50):
    """Python-loop dispatch after one warm step, fenced per chunk (a
    device synchronize).  Returns (state, steps/s, seconds)."""
    state = step(state)
    fence(state.pos)
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        k = min(chunk, steps - done)
        for _ in range(k):
            state = step(state)
        done += k
        fence(state.pos)
    dt = time.perf_counter() - t0
    return state, done / dt, dt


def config_1(steps: int = 500, n: int = 2048, device="cuda") -> dict:
    """Brute-force O(n^2) sphere-sphere vs the grid path.

    The "reference path" here is the literal O(n^2) evaluation (every
    pair tested densely); the grid path must agree statistically and
    beat it.
    """
    box_lo, box_hi = (0.0, 0.0, 0.0), (24.0, 32.0, 24.0)
    cfg = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)
    state = _box_state(n, box_lo, box_hi, 0.4, 0.3, device=device)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32,
                           device=state.pos.device)

    def brute_step(s):
        return _walls_integrate(p2p_ops.p2p_collide_allpairs(s), box_lo,
                                box_hi, gravity, cfg.dt)

    grid_step = make_p2p_step(box_lo, box_hi, cfg, capacity=12, device=device)

    _, brute_sps, _ = _time_steps(brute_step, state, min(steps, 100))
    out, grid_sps, _ = _time_steps(grid_step, state, steps)
    return {
        "config": 1,
        "particles": n,
        "brute_steps_per_sec": brute_sps,
        "grid_steps_per_sec": grid_sps,
        "speedup": grid_sps / brute_sps,
        "particle_steps_per_sec": grid_sps * n,
        "contacts": int(out.collisions.sum()),
    }


def _config_box(config: int, steps: int, n: int, box_hi, chunk: int,
                device) -> dict:
    """Configs 2 and 4: ``n`` particles in a box, variant "auto"."""
    box_lo = (0.0, 0.0, 0.0)
    cfg = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)
    state = _box_state(n, box_lo, box_hi, 0.4, 0.3, device=device)
    step = make_p2p_step(
        box_lo, box_hi, cfg, capacity=8, variant="auto", with_stats=True,
        device=device,
    )
    out, sps, _ = _time_steps(lambda s: step(s)[0], state, steps, chunk=chunk)
    _, stats = step(out)
    return {
        "config": config,
        "particles": n,
        "variant": step.variant,
        "steps_per_sec": sps,
        "particle_steps_per_sec": sps * n,
        "contacts": int(out.collisions.sum()),
        "cell_overflow_last_step": int(stats["cell_overflow"]),
    }


def config_2(steps: int = 500, n: int = 50_000, device="cuda") -> dict:
    """50k particles, uniform grid, walls + restitution."""
    side = round(n ** (1 / 3) * 4 * 0.4)  # ~4r spacing at fill
    return _config_box(2, steps, n, (side, side, side), 50, device)


def config_3(steps: int = 300, layers: int = 16, device="cuda") -> dict:
    """Hybrid method at 128^2*16 = 262k on the bunny benchmark scene
    (960 x 540 camera).  Raises FileNotFoundError where the bunny mesh
    is absent."""
    scene = bunny_scene(width=960, height=540)
    # pinned coded plan: a 300-step spawn-phase run is the coded plan's
    # best regime and too short to amortize the adaptive probe
    r = run_episode(scene, "hybrid", layers_y=layers, num_steps=steps,
                    plan="kernel", device=device)
    return {
        "config": 3,
        "particles": r.num_particles,
        "steps_per_sec": r.steps_per_sec,
        "particle_steps_per_sec": r.particle_steps_per_sec,
        "mean_ms": r.mean_ms,
    }


def config_4(steps: int = 200, n: int = 1_000_000, device="cuda") -> dict:
    """1M particles, on-device grid build + narrow phase + integrate."""
    side = round(n ** (1 / 3) * 4 * 0.4)
    return _config_box(4, steps, n, (side, side / 2, side), 20, device)


@contextlib.contextmanager
def _process_group(device_type: str):
    """The default process group: the caller's if it made one; under
    ``torchrun`` (``WORLD_SIZE`` in the environment) one joined from the
    environment; else a group of one rank in this process.  A group made
    here is destroyed on the way out."""
    import torch.distributed as dist

    from particlesystemhybridcollisiondetection_tpu_torch.parallel import (
        data_parallel as dp,
    )

    if dist.is_initialized():
        yield
        return
    if "WORLD_SIZE" in os.environ:
        dp.init_ranks(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                      "env://", device_type)
    else:
        backend = dp.choose_backend(device_type, 1)
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def config_5(steps: int = 100, n: Optional[int] = None,
             n_shards: Optional[int] = None, device="cuda") -> dict:
    """Heterogeneous radii/restitution, the box split into one slab per
    rank with a halo exchange and migration, on the domain episode runner
    (``parallel/domain.py``; B3's cells route for the local contacts):
    1,000,000 particles per rank in config 4's box (160 x 80 x 160) once
    per rank, stacked along x; radii 0.4 x U(0.7, 1.3), restitution
    U(0.2, 0.6), cells 1.04 = 2 x the largest radius.  The ranks are the
    first ``n_shards`` of the process group's (``torchrun
    --nproc-per-node=N``; all of them by default), as the JAX package
    meshes its first ``n_shards`` devices; run alone, a group of one.

    The JAX package's config 5 puts 500,000 particles a rank in a slab of
    40 x 80 x 40 = 128,000 units^3.  The spheres' mean volume is
    4/3 pi 0.4^3 E[u^3] = 0.268 x 1.09 = 0.292 units^3 (u ~ U(0.7, 1.3)),
    so they add up to 146,000 units^3: 1.14 times the slab's volume and
    2.3 times the upper half they are dropped into, a box that cannot
    settle.  Here a rank's spheres fill 14.3% of its slab (config 4's
    equal spheres 13.1%).

    Every rank of the group calls it.  Every rank of the mesh returns
    the same dict; ``active_particles`` counts the particles alive after
    the last step, over all of them (conservation), the overflows are the
    runner's (halo, migration, cell) over every step run, summed over the
    ranks, and ``backend`` is the mesh's.  A rank outside the mesh builds
    nothing and returns ``{"config": 5, "shards": ..., "rank": ...,
    "sat_out": True}``."""
    import torch.distributed as dist

    from particlesystemhybridcollisiondetection_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.parallel import domain as dom

    dev = resolve_device(device)
    with _process_group(dev.type):
        world = dist.get_world_size()
        shards = world if n_shards is None else n_shards
        if shards > world:
            raise ValueError(f"n_shards={shards} on a group of {world} ranks")
        mesh = dp.make_mesh(shards, axis_name=dom.AXIS, device_type=dev.type)
        if mesh is None:
            return {"config": 5, "shards": shards, "rank": dist.get_rank(),
                    "sat_out": True}
        n = n or 1_000_000 * shards
        box_lo, box_hi = (0.0, 0.0, 0.0), (160.0 * shards, 80.0, 160.0)
        cfg = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)
        cap = int(np.ceil(n / shards * 2 / 128)) * 128
        dcfg = dom.DomainConfig(
            box_lo=box_lo, box_hi=box_hi, n_shards=shards,
            shard_capacity=cap,
            halo_capacity=max(2048, cap // 8),
            migrate_capacity=max(2048, cap // 8),
            cell_size=2 * 0.4 * 1.3,
        )
        # every rank draws the same global state from the seed and keeps
        # its own slab's slots
        state = _box_state(n, box_lo, box_hi, 0.4, 0.3, hetero=True,
                           device="cpu")
        shard = dom.shard_spawn(state, dcfg, mesh)
        runner = dom.make_domain_episode_runner(dcfg, cfg, mesh)
        # the eager first step and, on NCCL, the capture
        shard = runner(shard, 2)
        fence(shard.state.pos)
        t0 = time.perf_counter()
        shard = runner(shard, steps)
        fence(shard.state.pos)
        dt = time.perf_counter() - t0
        alive = dp.sum_ints(int(active_mask(shard.state).sum()), mesh)
        halo, migrate, cell = runner.drops.tolist()
        return {
            "config": 5,
            "particles": n,
            "shards": shards,
            "backend": dist.get_backend(mesh.get_group()),
            "graphed": runner.graphed,
            "steps_per_sec": steps / dt,
            "particle_steps_per_sec": steps / dt * n,
            "halo_overflow": halo,
            "migrate_overflow": migrate,
            "cell_overflow": cell,
            "active_particles": alive,
        }


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    """``python3 -m <package>.bench.configs 1 2 4``: run the numbered
    configurations on the GPU and print one JSON line each, with the
    card's name and power limit."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("ids", type=int, nargs="+", choices=sorted(CONFIGS))
    args = ap.parse_args(argv)
    card = card_line()
    for i in args.ids:
        print(json.dumps({**CONFIGS[i](), "card": card}), flush=True)


if __name__ == "__main__":
    main()
