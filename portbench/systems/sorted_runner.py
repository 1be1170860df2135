"""The system under test of the DragonScene cells: the port's persistent
sorted episode runner (``core/step.py::make_sorted_episode_runner``),
spatial, or hybrid with the configuration's camera and the scene's corner
normals.  This adapter is the only file that imports the program for
these cells; it hands the program the benchmark's own inputs and reads
back its states, its host-read counter and its screen-space stage.
"""

from __future__ import annotations

import gc

import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import GridConfig, SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_sorted_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.geometry.mesh import Transform
from particlesystemhybridcollisiondetection_tpu_torch.ops.screenspace import (
    screen_space_collide,
)


class System:
    def __init__(self, scene: dict, cfg: dict, device):
        sim = cfg["sim"]
        self.cfg = SimConfig(
            particle_radius=sim["particle_radius"], lifetime_steps=sim["lifetime_steps"],
            num_particles_xz=sim["num_particles_xz"], offset_xz=sim["offset_xz"],
            dt=sim["dt"], bounciness=sim["bounciness"],
            spawn_origin=tuple(sim["spawn_origin"]), gravity=tuple(sim["gravity"]),
            grid=GridConfig(cell_size=sim["cell_size"], expand=sim["expand"]),
            backoff=sim["backoff"])
        kw = dict(cfg["runner"])
        if cfg["method"] == "hybrid":
            cam = scene["cameras"][cfg["scene"]["camera"]]
            kw["camera"] = Camera(
                Transform(position=tuple(cam["position"]), rotation=tuple(cam["rotation"])),
                fov_deg=cam["fov_deg"], near=cam["near"], far=cam["far"],
                width=cam["width"], height=cam["height"], name=cam["name"])
            kw["normals"] = scene["corner_normals"]
        self.runner = make_sorted_episode_runner(scene["triangles"], self.cfg,
                                                 device=device, **kw)

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

    def screen_space_stage(self, state):
        """The hybrid's screen-space stage on ``state``: (undecided lanes,
        real lanes), or None for the spatial method."""
        if self.runner.tex is None:
            return None
        sp = self.runner.sp
        _, undecided = screen_space_collide(state, self.runner.tex, sp.gravity,
                                            sp.cfg.dt, hybrid=True)
        real = active_mask(state)
        return undecided & real, real

    def close(self) -> None:
        self.runner = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build(scene: dict, cfg: dict, device) -> System:
    return System(scene, cfg, device)
