"""The benchmark's frozen inputs equal the program's, bit for bit: the
DragonScene soup, its corner normals and cameras, and the spawn with the
seed's jitter at the protocol's cap."""

import numpy as np
import pytest

from particlesystemhybridcollisiondetection_tpu_torch.config import DRAGON_PRESET
from particlesystemhybridcollisiondetection_tpu_torch.core.state import spawn_grid
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import dragon_scene
from portbench import scene, spawn


@pytest.mark.parametrize("size", [(1920, 1080, 400_000), (96, 54, 6000)])
def test_dragon_scene_equals_the_programs(size):
    w, h, budget = size
    mine = scene.dragon_scene(w, h, tri_budget=budget)
    theirs = dragon_scene(w, h, tri_budget=budget)
    assert np.array_equal(mine["triangles"], theirs.triangles)
    assert np.array_equal(mine["corner_normals"], theirs.corner_normals)
    assert [c.name for c in theirs.cameras] == list(mine["cameras"])
    for cam in theirs.cameras:
        c = mine["cameras"][cam.name]
        assert np.array_equal(scene.view_matrix(c), cam.view_matrix())
        assert np.array_equal(scene.projection_matrix(c), cam.projection_matrix())
        assert np.array_equal(scene.forward(c), cam.forward)


@pytest.mark.parametrize("layers_y,jitter,seed", [
    (128, 0.05, 2**31 + 17), (128, 0.05, 3), (2, 0.0, 0)])
def test_spawn_equals_the_programs(layers_y, jitter, seed):
    sim = {"num_particles_xz": 128, "offset_xz": 4.0, "spawn_origin": (0.0, 525.0, 0.0),
           "particle_radius": 2.0, "bounciness": 0.25}
    mine = spawn.spawn(sim, layers_y, 65535 * 32, 1024, jitter, seed)
    theirs = spawn_grid(DRAGON_PRESET, layers_y, jitter=jitter, seed=seed, device="cpu")
    for k in ("pos", "vel", "radius", "restitution"):
        assert np.array_equal(mine[k], getattr(theirs, k).numpy()), k
    assert mine["n_real"] == min(128 * 128 * layers_y, 65535 * 32)
