"""The system under test of the gravity-box cells: the port's persistent
sorted p2p episode runner (``core/step.py::make_p2p_episode_runner``) at
the configuration's cell size, capacity and window, its fallback on the
device.  This adapter is the only file that imports the program for
these cells; it hands the program the benchmark's own inputs and reads
back its states, its per-step overflow (``with_stats``) and its
host-read counter.  The runner's telemetry is read by
``portbench/stamps.py`` from ``runner.telemetry`` where the program has
it.
"""

from __future__ import annotations

import gc

import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_p2p_episode_runner,
)


class System:
    def __init__(self, scene: dict, cfg: dict, device):
        sim = cfg["sim"]
        self.cfg = SimConfig(particle_radius=sim["particle_radius"], dt=sim["dt"],
                             bounciness=sim["bounciness"], gravity=tuple(sim["gravity"]))
        run = cfg["runner"]
        self.runner = make_p2p_episode_runner(
            scene["box_lo"], scene["box_hi"], self.cfg, cell_size=sim["cell_size"],
            capacity=run["capacity"], window=run["window"], device=device)

    def state(self, pos, vel, collisions, radius, restitution):
        return ParticleState(pos=pos, vel=vel, collisions=collisions, radius=radius,
                             restitution=restitution)

    def run(self, state, steps: int, with_stats: bool = False):
        """``steps`` steps from ``state``: (state, per-step window
        overflow counts or None)."""
        if with_stats:
            return self.runner(state, steps, with_stats=True)
        return self.runner(state, steps), None

    def host_reads(self) -> int:
        return self.runner.syncs.count

    def close(self) -> None:
        self.runner = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build(scene: dict, cfg: dict, device) -> System:
    return System(scene, cfg, device)
