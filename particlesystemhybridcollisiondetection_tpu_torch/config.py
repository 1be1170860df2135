"""Simulation configuration.

The reference spreads configuration over three layers (compile-time
``#define``s, per-scene serialized Unity fields, and runtime UI --
ParticleSys.cs:1-3, :41-47; DragonScene.unity:1818-1823).  Here it is a
single frozen dataclass, plus a preset table reproducing the reference's
scene constants.  A copy of the JAX package's config.py: the PyTorch port
imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

# The reference pads particle counts to its 32-wide thread groups
# (ParticleSys.cs:90, :247-255).  The sorted pipeline works on blocks of
# 8 rows x 128 particles = 1024 (the JAX package's partition, kept so the
# two packages' window plans compare lane for lane), so N pads to a
# multiple of 1024.
PARTICLE_PAD = 1024

# Sentinel position for padding particles (ParticleSys.cs:102).
FLOAT_SENTINEL = 1.0e38

# Hard cap in the reference: 65535 thread groups * 32 threads
# (ParticleSys.cs:236).  We keep it as a default sanity cap only; this
# build has no dispatch-size limit.
REFERENCE_PARTICLE_CAP = 65535 * 32


class Method(enum.Enum):
    """Collision detection method (ParticleSys.cs:667-698)."""

    SCREEN_SPACE = "screen_space"
    SPATIAL = "spatial"
    HYBRID = "hybrid"

    @staticmethod
    def display_names() -> list[str]:
        # Parity with ParticleSys.GetCollisionDetectionMethodsNames()
        # (ParticleSys.cs:700-708).
        return [
            "Screen Space Depth Collision Detection",
            "Spatial Data Structure Collision Detection",
            "Hybrid Collision Detection",
        ]


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static triangle-grid broad phase parameters.

    Replaces the reference BVH (numLevelsBVHMorton / maxLevelBvh /
    maxTrisPerBvhNode, ParticleSys.cs:77-82) with a uniform grid: triangles
    are binned once per scene into cells, expanded by ``expand`` so that a
    particle only ever needs to read its own cell (see ops/grid.py).
    """

    cell_size: float = 8.0
    # Binning expansion radius: must be >= particle_radius + max_travel/2,
    # because queries look up the cell of the travel-segment MIDPOINT
    # (ops.grid.lookup_pos).  Benchmark scenes: particles spawn at rest,
    # so within a 2001-step episode speed <= g*T = 9.81*20.01 = 196.3 ->
    # travel <= 1.963 -> expand >= 2 + 0.982 = 2.982 (3.1 with margin).
    expand: float = 3.1
    # Max triangle candidates per cell (K of the dense [N, K] narrow phase).
    # Measured at build time; this is only a default ceiling.
    max_tris_per_cell: int = 64


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Scene + integration constants.

    Field-for-field parity with the reference's serialized fields
    (ParticleSys.cs:41-47) plus spawn transform (scene YAML).
    """

    # --- particle system (ParticleSys.cs:41-47) ---
    particle_radius: float = 2.0
    lifetime_steps: int = 2001
    num_particles_xz: int = 128
    offset_xz: float = 4.0
    dt: float = 0.01
    bounciness: float = 0.25
    # spawn origin = ParticleObject transform position (DragonScene.unity:1792)
    spawn_origin: Tuple[float, float, float] = (0.0, 525.0, 0.0)
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)

    # --- broad phase ---
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)

    # Back-off factor in the spatial response
    # (SpatialStructureCollisionDetection.compute:345).
    backoff: float = 0.0015

    def spawn_count(self, layers_y: int) -> int:
        n = self.num_particles_xz * self.num_particles_xz * layers_y
        return min(n, REFERENCE_PARTICLE_CAP)


# --- Scene presets (Assets/Scenes/*.unity constants) -----------------------

#: DragonScene.unity:1818-1823 — the shipped benchmark scene.  The dragon
#: collider is much denser than the bunny, so its broad-phase grid uses
#: finer cells.  expand=3.1 is the midpoint-lookup episode bound (see
#: GridConfig); round 3's p-anchored expand=3.2 only covered travel
#: <= 1.2/step and silently under-covered fast top-layer particles at
#: k >= 4 (speeds reach g*T = 196 u/s within the 2001-step episode).
DRAGON_PRESET = SimConfig(grid=GridConfig(cell_size=4.0, expand=3.1))

#: BunnyScene parity (same benchmark constants, bunny collider).
BUNNY_PRESET = SimConfig()

#: SampleScene.unity:806-813 — small box scene: 7x7 particles, 9 planes + cube.
SAMPLE_PRESET = SimConfig(
    particle_radius=0.2,
    lifetime_steps=4001,
    num_particles_xz=7,
    offset_xz=1.0,
    dt=0.001,
    bounciness=0.5,
    spawn_origin=(0.0, 6.0, 0.0),
    grid=GridConfig(cell_size=1.0, expand=0.5, max_tris_per_cell=16),
)

#: SphereScene.unity — dev/demo scene: 16x-scaled sphere + 2x plane at the
#: origin; its ParticleSys MonoBehaviour serializes NO overrides, so every
#: parameter is the ParticleSys.cs:41-47 class default, and the spawn
#: origin is the ParticleObject transform at (0, 0, 0)
#: (SphereScene.unity ParticleObject transform).
SPHERE_PRESET = SimConfig(
    spawn_origin=(0.0, 0.0, 0.0),
    grid=GridConfig(cell_size=2.0, expand=3.1),
)

PRESETS = {
    "dragon": DRAGON_PRESET,
    "bunny": BUNNY_PRESET,
    "sample": SAMPLE_PRESET,
    "sphere": SPHERE_PRESET,
}
