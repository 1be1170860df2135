"""Accuracy visualization harness (port of the JAX package's
``viz/accuracy.py``: the steps on the device, the renders on the host).

Reference: ACCURACY_VISUALIZATION mode (ParticleSys.cs:121-129, :763-830)
freezes the simulation at chosen steps (dt = 0 for that frame), switches to
dedicated inspection cameras -- including an "occluded" camera placed to
expose the screen-space method's blind spots
(DragonAccVisualizationScene.unity, CameraAccVisualizationOcluded) -- and
saves 1920x1080 PNGs named ``<camera>_<method>_step_<n>.png``.

Here the harness runs each method to the snapshot steps and renders the
state from the inspection cameras offline; colors encode per-particle
collision counts so the methods' disagreement is visible directly.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    active_mask,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import make_method_step
from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.geometry.mesh import Transform
from particlesystemhybridcollisiondetection_tpu_torch.utils.io import write_png
from particlesystemhybridcollisiondetection_tpu_torch.viz.render import (
    collision_colormap,
    render_state,
)


def inspection_cameras(width: int = 1920, height: int = 1080) -> list[Camera]:
    """The DragonAccVisualizationScene inspection cameras, with the exact
    transforms from the scene YAML (DragonAccVisualizationScene.unity:
    CameraAccVisualizationBack ~:2557, CameraAccVisualizationOcluded
    ~:2881, CameraBenchmarkAccVisualization ~:2989 -- the third is the
    same pose as benchmark "Main Camera (1)")."""
    mk = lambda name, pos, rot: Camera(  # noqa: E731
        Transform(position=pos, rotation=rot), width=width, height=height, name=name
    )
    return [
        mk(
            "CameraAccVisualizationBack",
            (-291.0, 364.0, 645.0),
            (0.03132285, 0.96836823, -0.1621754, 0.18703249),
        ),
        mk(
            "CameraAccVisualizationOcluded",
            (-392.7, 376.4, -97.4),
            (0.1841648, 0.5919906, -0.072377354, 0.781276),
        ),
        mk(
            "CameraBenchmarkAccVisualization",
            (-626.7, 230.0, -486.7),
            (0.0, 0.42261827, 0.0, 0.9063079),
        ),
    ]


def bug_report_cameras(width: int = 1920, height: int = 1080) -> list[Camera]:
    """The DragonScene's pinned Bug/NoBug comparison views
    (DragonScene.unity ~:2209 "Main Camera (Bug)" and ~:1668
    "Main Camera (NoBug)"): straight-down views the author used to
    document the hybrid stale-index race (see core/step.py's hybrid
    notes).  Bug is the same pose as benchmark camera (2); NoBug is far
    overhead, nearly nadir."""
    mk = lambda name, pos, rot: Camera(  # noqa: E731
        Transform(position=pos, rotation=rot), width=width, height=height, name=name
    )
    return [
        mk("Main Camera (Bug)", (0.0, 800.0, 50.0), (0.7071068, 0.0, 0.0, 0.7071068)),
        mk(
            "Main Camera (NoBug)",
            (0.0, 1536.0, -23.4),
            (0.67559016, 0.0, 0.0, 0.7372774),
        ),
    ]


def run_accuracy_visualization(
    scene,
    methods: Sequence[str] = ("screen_space", "spatial", "hybrid"),
    steps_to_visualize: Sequence[int] = (1600,),
    layers_y: int = 1,
    cameras: Optional[Sequence[Camera]] = None,
    out_dir: str = "BenchmarkResults",
    method_camera_index: int = 0,
    device="cuda",
) -> list[str]:
    """Returns the list of written PNG paths."""
    cams = list(cameras) if cameras is not None else inspection_cameras()
    written = []
    snapshots = sorted(steps_to_visualize)
    for method in methods:
        step = make_method_step(scene, method, method_camera_index,
                                device=device)
        state = spawn_grid(scene.config, layers_y=layers_y, device=device)
        mask = active_mask(state).cpu().numpy()
        cur = 0
        for snap in snapshots:
            for _ in range(snap - cur):
                state = step(state)
            cur = snap
            pos = state.pos.cpu().numpy()[:, mask].T
            colors = collision_colormap(state.collisions.cpu().numpy()[mask])
            radius = state.radius.cpu().numpy()[mask]
            for cam in cams:
                img = render_state(scene.triangles, pos, radius, cam, colors)
                name = f"{cam.name}_{method}_step_{snap}.png"
                path = os.path.join(out_dir, name)
                write_png(path, img)
                written.append(path)
    return written
