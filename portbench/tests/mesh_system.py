"""A system on more than one rank, for the tests of the multi-rank path:
the port's persistent sorted runner with ``mesh=`` (``core/step.py::
make_sorted_episode_runner``, bit for bit the single-device runner),
each rank on its contiguous slice of the particle axis
(``parallel/data_parallel.py``).  A configuration names it as its
``system`` (``"../tests/mesh_system"``).

The configuration's optional ``fault`` plants one fault on one rank, at
its ``at_call``-th call (the warm calls counted) and after:
``answer`` alters one particle's position in that rank's output,
``raise`` raises, ``kill`` ends the rank's process with SIGKILL,
``hang`` sleeps for an hour.
"""

from __future__ import annotations

import gc
import os
import signal
import time

import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import GridConfig, SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_sorted_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp


class System:
    def __init__(self, scene: dict, cfg: dict, device, group):
        sim = cfg["sim"]
        simcfg = SimConfig(
            particle_radius=sim["particle_radius"], lifetime_steps=sim["lifetime_steps"],
            num_particles_xz=sim["num_particles_xz"], offset_xz=sim["offset_xz"],
            dt=sim["dt"], bounciness=sim["bounciness"],
            spawn_origin=tuple(sim["spawn_origin"]), gravity=tuple(sim["gravity"]),
            grid=GridConfig(cell_size=sim["cell_size"], expand=sim["expand"]),
            backoff=sim["backoff"])
        self.rank = group.rank
        self.mesh = dp.make_mesh(group.world, device_type=torch.device(device).type)
        self.runner = make_sorted_episode_runner(scene["triangles"], simcfg, device=device,
                                                 mesh=self.mesh, **cfg["runner"])
        self.fault = cfg.get("fault", {})
        self.calls = 0

    def state(self, pos, vel, collisions, radius, restitution):
        """This rank's slice of the whole spawn."""
        return dp.shard_state(ParticleState(pos=pos, vel=vel, collisions=collisions,
                                            radius=radius, restitution=restitution),
                              self.mesh)

    def reset(self, spawn_state, out):
        return spawn_state._replace(collisions=out.collisions)

    def whole(self, state):
        whole = dp.gather_state(state, self.mesh)
        return whole if self.rank == 0 else None

    def run(self, state, steps: int, with_stats: bool = False):
        self.calls += 1
        kind = self.fault.get("kind") if (
            self.fault.get("rank") == self.rank and self.calls >= self.fault["at_call"]) else None
        if kind == "raise":
            raise RuntimeError(f"a fault planted on rank {self.rank}")
        if kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        if kind == "hang":
            time.sleep(3600)
        if with_stats:
            out, ovf = self.runner(state, steps, with_stats=True)
        else:
            out, ovf = self.runner(state, steps), None
        if kind == "answer":
            pos = out.pos.clone()
            pos[1, 7] += state.radius[7]
            out = out._replace(pos=pos)
        return out, ovf

    def host_reads(self) -> int:
        return self.runner.syncs.count

    def counters(self) -> dict:
        return {"steps": self.runner.steps}

    def close(self) -> None:
        self.runner = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build(scene: dict, cfg: dict, device, group) -> System:
    return System(scene, cfg, device, group)
