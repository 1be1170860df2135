"""The system under test of the domain-decomposed box cells: the port's
domain episode runner (``parallel/domain.py::make_domain_episode_runner``),
one slab a rank, on a mesh over the run's group, at the configuration's
cell size, capacities and window.  This adapter is the only file that
imports the program for these cells.  Its state is a rank's slots and
their spawn ids (``DomainShard``); it hands the program the benchmark's
own inputs and reads back:

  * ``whole``: the whole state in the spawn's order, on rank 0;
  * ``reset``: the rank's slots of the spawn, each particle's collision
    counter carried by id from wherever it is (one all_reduce an
    episode);
  * ``run``: with ``with_stats``, the per-step window overflow of B3
    summed over the ranks;
  * ``counters``: the rank's stage sums and counts from the runner's
    telemetry, call by call, its bytes sent a step, and the drops
    (``portbench/rank_stamps.py`` reads them);
  * ``runner``: this rank's runner, whose telemetry ``portbench/stamps.py``
    reads on rank 0.
"""

from __future__ import annotations

import gc

import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp
from particlesystemhybridcollisiondetection_tpu_torch.parallel.domain import (
    AXIS,
    DomainConfig,
    carry_collisions,
    gather_whole,
    make_domain_episode_runner,
    shard_spawn,
)

from portbench import harness

#: the stages and counters of the runner's stamps that ``counters`` sums
STAGES = ("halo", "end")
COUNTS = ("ghosts", "migrants")


class System:
    def __init__(self, scene: dict, cfg: dict, device, group=None):
        sim, d, run = cfg["sim"], cfg["domain"], cfg["runner"]
        world = 1 if group is None else group.world
        if world != d["n_shards"]:
            raise ValueError(f"{d['n_shards']} slabs on {world} ranks")
        self.cfg = SimConfig(particle_radius=sim["particle_radius"], dt=sim["dt"],
                             bounciness=sim["bounciness"], gravity=tuple(sim["gravity"]))
        self.dcfg = DomainConfig(
            box_lo=tuple(scene["box_lo"]), box_hi=tuple(scene["box_hi"]), n_shards=world,
            shard_capacity=d["shard_capacity"], halo_capacity=d["halo_capacity"],
            migrate_capacity=d["migrate_capacity"], cell_size=sim["cell_size"],
            grid_capacity=run["capacity"])
        self.n = cfg["particles"]["n"]
        self.rank = 0 if group is None else group.rank
        self.mesh = dp.make_mesh(world, axis_name=AXIS,
                                 device_type=torch.device(device).type)
        self.runner = make_domain_episode_runner(self.dcfg, self.cfg, self.mesh,
                                                 window=run["window"])

    def state(self, pos, vel, collisions, radius, restitution):
        """This rank's slots of the whole spawn."""
        return shard_spawn(ParticleState(pos=pos, vel=vel, collisions=collisions,
                                         radius=radius, restitution=restitution),
                           self.dcfg, self.mesh)

    def reset(self, spawn_state, out):
        return carry_collisions(spawn_state, out, self.mesh, self.n)

    def whole(self, state):
        return gather_whole(state, self.mesh, self.n)

    def run(self, state, steps: int, with_stats: bool = False):
        if with_stats:
            return self.runner(state, steps, with_stats=True)
        return self.runner(state, steps), None

    def host_reads(self) -> int:
        return self.runner.syncs.count

    def counters(self) -> dict:
        """Per ``with_stats`` call (its index, steps, each stage's ms and
        each counter summed over its steps), the bytes this rank sends a
        step and the drops summed over the ranks."""
        calls = [(r.call, len(r.counters["n_over"]),
                  {k: float(r.stages_ms[k].sum()) for k in STAGES if k in r.stages_ms},
                  {k: int(r.counters[k].sum()) for k in COUNTS})
                 for r in self.runner.telemetry.records]
        return {"calls": calls, "exchange_bytes_per_step": self.runner.exchange_bytes_per_step,
                "drops": self.runner.drops.tolist()}

    def close(self) -> None:
        r = self.runner
        harness.log(f"[portbench] rank {self.rank}: {r.steps} steps; overflow over the "
                    f"ranks (halo, migration, cell) {r.drops.tolist()}; graphed "
                    f"{r.graphed}")
        self.runner = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build(scene: dict, cfg: dict, device, group=None) -> System:
    return System(scene, cfg, device, group)
