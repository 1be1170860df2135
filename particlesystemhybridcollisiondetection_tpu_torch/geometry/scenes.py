"""Scene presets.

Each preset reproduces one of the reference's Unity scenes
(Assets/Scenes/*.unity) as explicit data: a SimConfig, a set of
(mesh, transform) collider instances, and the benchmark cameras.  All
transform constants below were extracted from the scene YAML files.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.config import (
    PRESETS,
    SimConfig,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.geometry.mesh import (
    Transform,
    TriangleMesh,
    cube_sphere,
    flatten_scene,
    flatten_scene_normals,
    load_fbx,
    unity_cube,
    unity_plane,
    uv_sphere,
)

#: Directory holding the reference Unity project's mesh assets
#: (stanford_bunny.fbx); override with PSYS_REFERENCE_MESH_DIR.
_REFERENCE_MESH_DIR = os.environ.get(
    "PSYS_REFERENCE_MESH_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference", "Assets", "Meshes"),
)


@dataclasses.dataclass
class Scene:
    name: str
    config: SimConfig
    instances: list  # [(TriangleMesh, Transform)]
    cameras: list  # [Camera]

    @functools.cached_property
    def triangles(self) -> np.ndarray:
        """World-space triangle soup f32[T, 3, 3]."""
        return flatten_scene(self.instances)

    @functools.cached_property
    def corner_normals(self) -> np.ndarray:
        """World-space per-corner shading normals f32[T, 3, 3] (smooth
        where the source mesh has them, face normals elsewhere)."""
        return flatten_scene_normals(self.instances)

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])


# The 4 benchmark cameras (DragonScene.unity / BunnyScene.unity; the
# BenchmarkManager sweeps Main Camera, (1), (2), (3) in order --
# BenchmarkManager.cs sweep + scene camera list).
def benchmark_cameras(width: int = 1920, height: int = 1080) -> list[Camera]:
    mk = lambda name, pos, rot: Camera(  # noqa: E731
        Transform(position=pos, rotation=rot), width=width, height=height, name=name
    )
    return [
        mk("Main Camera", (0.0, 470.6, -678.7), (0.17364816, 0.0, 0.0, 0.9848078)),
        mk("Main Camera (1)", (-626.7, 230.0, -486.7), (0.0, 0.42261827, 0.0, 0.9063079)),
        mk("Main Camera (2)", (0.0, 800.0, 50.0), (0.7071068, 0.0, 0.0, 0.7071068)),
        mk("Main Camera (3)", (0.0, 16.3, 364.0), (0.0, 0.949133, 0.31487557, 0.0)),
    ]


#: Ground plane shared by the benchmark scenes: Unity Plane scaled 100x
#: -> 1000x1000 units at y=0 (DragonScene.unity "Plane", scale 100).
_GROUND = (unity_plane(), Transform(scale=(100.0, 100.0, 100.0)))


def _bunny_mesh() -> TriangleMesh:
    return load_fbx(os.path.join(_REFERENCE_MESH_DIR, "stanford_bunny.fbx"), "bunny")


def _dragon_standin(tri_budget: int = 400_000) -> TriangleMesh:
    """Procedural stand-in for dragon.fbx (the binary blob is not part of
    the reference mirror): a ridged, displaced cube-sphere scaled to the
    dragon's world footprint (scale 2800 at (25, -2, 0), DragonScene.unity
    prefab modifications) so the triangle count and density are
    comparable.

    A single closed surface is used deliberately: self-overlapping shapes
    (e.g. torus knots) stack several surface layers into individual broad-
    phase cells and blow up the per-cell candidate bound.
    """
    n = max(16, int(np.sqrt(tri_budget / 12.0)))
    m = cube_sphere(n)
    v = m.vertices.copy()
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    # low-frequency ridged displacement ("dragon back" lumps)
    disp = (
        0.18 * np.sin(1.7 * d[:, 0:1] * np.pi + 1.0) * np.sin(1.3 * d[:, 2:3] * np.pi)
        + 0.10 * np.sin(2.9 * d[:, 1:2] * np.pi) * np.cos(2.1 * d[:, 0:1] * np.pi)
        + 0.05 * np.cos(4.1 * d[:, 2:3] * np.pi + 0.5) * np.sin(3.3 * d[:, 1:2] * np.pi)
    )
    v = v * (1.0 + disp)
    v[:, 0] *= 1.6  # elongate like a crouched dragon
    v[:, 2] *= 0.9
    vmin, vmax = v.min(0), v.max(0)
    target = np.array([500.0, 400.0, 320.0])
    v = (v - (vmin + vmax) / 2) / (vmax - vmin) * target
    v[:, 1] -= v[:, 1].min()  # rest on ground
    # smooth shading normals, like the scanned dragon Unity imports
    return TriangleMesh(v, m.faces, "dragon_standin").with_smooth_normals()


def sample_scene(width: int = 1920, height: int = 1080) -> Scene:
    """SampleScene.unity: a 4x-scaled ground plane, 8 tilted wall planes
    forming a bowl, and a unit cube; 7x7 particles from y=6."""
    plane = unity_plane()
    cube = unity_cube()
    instances = [
        (plane, Transform(scale=(4.0, 4.0, 4.0))),
        (cube, Transform()),
        (plane, Transform((-1.5, 0.5, 0.0), (-0.27059805, -0.6532815, -0.27059805, 0.6532815), (0.4,) * 3)),
        (plane, Transform((1.5, 0.5, 0.0), (-0.27059805, 0.6532815, 0.27059805, 0.6532815), (0.4,) * 3)),
        (plane, Transform((0.0, 0.5, 1.5), (-0.38268343, 0.0, 0.0, 0.92387956), (0.4,) * 3)),
        (plane, Transform((0.0, 0.5, -1.5), (0.0, 0.92387956, 0.38268343, 0.0), (0.4,) * 3)),
        (plane, Transform((-1.1587272, 0.30999994, 0.7598094), (-0.33135977, -0.46216577, -0.19143513, 0.7999726), (0.4,) * 3)),
        (plane, Transform((0.89, 0.31, 1.31), (-0.3696728, 0.23886602, 0.09894163, 0.892466), (0.4,) * 3)),
        (plane, Transform((1.4401903, 0.30999994, -0.7387273), (-0.19143513, 0.7999726, 0.33135977, 0.46216577), (0.4,) * 3)),
        (plane, Transform((-0.60853684, 0.30999994, -1.2889175), (0.09894163, 0.892466, 0.3696728, -0.23886602), (0.4,) * 3)),
    ]
    cam = Camera(
        Transform(position=(0.0, 3.0, -8.0), rotation=(0.13052619, 0.0, 0.0, 0.99144486)),
        width=width,
        height=height,
        name="Sample Camera",
    )
    return Scene("SampleScene", PRESETS["sample"], instances, [cam])


def bunny_scene(width: int = 1920, height: int = 1080) -> Scene:
    """BunnyScene.unity: ground plane + stanford bunny at (-0.049, 237.8, 27)
    rotated 180 deg about Y."""
    instances = [
        _GROUND,
        (_bunny_mesh(), Transform((-0.049, 237.8, 27.0), (0.0, 1.0, 0.0, 0.0))),
    ]
    return Scene("BunnyScene", PRESETS["bunny"], instances, benchmark_cameras(width, height))


def dragon_scene(width: int = 1920, height: int = 1080, tri_budget: int = 400_000) -> Scene:
    """DragonScene.unity: ground plane + dragon (stand-in, see
    _dragon_standin) at (25, -2, 0) rotated 180 deg about Y."""
    instances = [
        _GROUND,
        (_dragon_standin(tri_budget), Transform((25.0, -2.0, 0.0), (0.0, 1.0, 0.0, 0.0))),
    ]
    return Scene("DragonScene", PRESETS["dragon"], instances, benchmark_cameras(width, height))


def dragons_scene(width: int = 1920, height: int = 1080, tri_budget: int = 400_000) -> Scene:
    """DragonsScene.unity: two dragons rotated 90 deg about Y."""
    d = _dragon_standin(tri_budget)
    rot90 = (0.0, 0.7071068, 0.0, 0.7071068)
    instances = [
        _GROUND,
        (d, Transform((150.0, -2.0, 20.0), rot90)),
        (d, Transform((-191.0, -2.0, 20.0), rot90)),
    ]
    return Scene("DragonsScene", PRESETS["dragon"], instances, benchmark_cameras(width, height))


def sphere_scene(width: int = 1920, height: int = 1080) -> Scene:
    """SphereScene.unity: a 16x-scaled sphere and a 2x-scaled plane at the
    origin, camera at (0, 1, -23.02) looking +z; all ParticleSys params
    are class defaults and particles spawn from the origin (the scene is
    the reference's early dev/demo scene, not a tuned benchmark)."""
    instances = [
        (unity_plane(), Transform(scale=(2.0, 2.0, 2.0))),
        (uv_sphere(), Transform(scale=(16.0, 16.0, 16.0))),
    ]
    cam = Camera(
        Transform(position=(0.0, 1.0, -23.02)),
        width=width,
        height=height,
        name="Main Camera",
    )
    return Scene("SphereScene", PRESETS["sphere"], instances, [cam])


SCENES: dict[str, Callable[..., Scene]] = {
    "sample": sample_scene,
    "bunny": bunny_scene,
    "dragon": dragon_scene,
    "dragons": dragons_scene,
    "sphere": sphere_scene,
}
