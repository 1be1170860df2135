"""PyTorch port, screen-space method on the CPU: the host rasterizer
bit for bit against the JAX package's, the bake and its disk cache, and
``screen_space_collide`` against the JAX package's function and the
scalar NumPy oracle (``reference_impl.screen_space_collide``).  Small
sizes: the 96 x 160 overhead camera, 128 random particles."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from particlesystemhybridcollisiondetection_tpu.core.state import (
    ParticleState as JParticleState,
)
from particlesystemhybridcollisiondetection_tpu.geometry import mesh as jmesh
from particlesystemhybridcollisiondetection_tpu.geometry.camera import Camera as JCamera
from particlesystemhybridcollisiondetection_tpu.ops import raster as jraster
from particlesystemhybridcollisiondetection_tpu.ops import screenspace as jss
from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as tharness
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.geometry import mesh as tmesh
from particlesystemhybridcollisiondetection_tpu_torch.geometry.camera import Camera
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import raster as traster
from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as tss

import reference_impl as ref

F = np.float32
OVERHEAD_ROT = (0.7071068, 0.0, 0.0, 0.7071068)  # looks straight down


def _cameras(y=10.0, h=128, w=128):
    """The overhead camera of tests/test_screenspace.py, in both packages."""
    return (Camera(tmesh.Transform(position=(0.0, y, 0.0), rotation=OVERHEAD_ROT),
                   width=w, height=h, name="overhead"),
            JCamera(jmesh.Transform(position=(0.0, y, 0.0), rotation=OVERHEAD_ROT),
                    width=w, height=h, name="overhead"))


def _quad(m):
    return m.TriangleMesh(
        np.array([[-1, 5.0, -1], [1, 5.0, -1], [1, 5.0, 1], [-1, 5.0, 1]],
                 dtype=np.float64),
        np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int64),
    )


def _instances(m, case):
    """Scene instances of each rasterizer case of tests/test_screenspace.py."""
    if case == "ground_plane":
        return [(m.unity_plane(), m.Transform())]
    if case == "occlusion":
        return [(m.unity_plane(), m.Transform()), (_quad(m), m.Transform())]
    if case == "interpolated_normals":
        sphere = m.uv_sphere(radius=2.0, rings=10, sectors=14)
        return [(sphere.with_smooth_normals(), m.Transform(position=(0, 5.0, 0)))]
    return [(m.unity_plane(), m.Transform()), (m.unity_cube(), m.Transform())]


@pytest.mark.parametrize("case", ["ground_plane", "occlusion",
                                  "interpolated_normals", "flat_mesh"])
def test_rasterizer_bitwise(case):
    """Depth and normal equal the JAX package's bit for bit, with and
    without corner normals."""
    y = 12.0 if case == "interpolated_normals" else 10.0
    cam, jcam = _cameras(y=y)
    t_inst, j_inst = _instances(tmesh, case), _instances(jmesh, case)
    tris = tmesh.flatten_scene(t_inst)
    cnorms = tmesh.flatten_scene_normals(t_inst)
    np.testing.assert_array_equal(tris, jmesh.flatten_scene(j_inst))
    np.testing.assert_array_equal(cnorms, jmesh.flatten_scene_normals(j_inst))
    for normals in (None, cnorms):
        depth, normal = traster.rasterize_depth_normal(tris, cam, normals)
        j_depth, j_normal = jraster.rasterize_depth_normal(tris, jcam, normals)
        assert depth.dtype == np.float32 and normal.shape == depth.shape + (3,)
        assert (depth > 0).sum() > 200
        np.testing.assert_array_equal(depth, j_depth)
        np.testing.assert_array_equal(normal, j_normal)
    if case == "occlusion":
        np.testing.assert_allclose(depth[64, 64], 5.0, rtol=1e-3)  # quad on top


def test_bake_disk_cache_roundtrip(tmp_path, monkeypatch):
    """A second bake of the same (mesh, camera) comes from the disk cache
    under PSYS_BAKE_CACHE, bit-identical, planar table included; the file
    name is the JAX package's content key."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path))
    monkeypatch.setattr(tss, "_BAKE_CACHE", {})
    scene = sample_scene(width=96, height=54)
    cam = scene.cameras[0]

    tex1 = tss.bake_camera(scene.triangles, cam, device="cpu")
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
    assert files[0].name == f"{jss._disk_key(scene.triangles, None, cam)}.npz"
    assert tss.bake_path(scene.triangles, cam) == str(files[0])
    assert tss.bake_camera(scene.triangles, cam, device="cpu") is tex1  # memo

    tss._BAKE_CACHE.clear()  # force the disk path
    files[0].touch()
    mtime = files[0].stat().st_mtime_ns
    tex2 = tss.bake_camera(scene.triangles, cam, device="cpu")
    assert files[0].stat().st_mtime_ns == mtime  # read, not rewritten
    for f in ("depth", "normal", "planar"):
        assert torch.equal(getattr(tex1, f), getattr(tex2, f)), f

    pl = tex1.planar.numpy()
    assert pl.shape == (4, 96 * 54) and tex1.screen_size == (54, 96)
    np.testing.assert_array_equal(pl[0], tex1.depth.numpy().reshape(-1))
    np.testing.assert_array_equal(pl[1:4], tex1.normal.numpy().reshape(-1, 3).T)
    want_d, want_n = jraster.rasterize_depth_normal(scene.triangles, cam)
    np.testing.assert_array_equal(tex1.depth.numpy(), want_d)
    np.testing.assert_array_equal(tex1.normal.numpy(), want_n)


def _oracle_inputs(n=128, seed=7, near_surface=False):
    """The scene, camera and random particles of
    test_screenspace.py::test_kernel_matches_scalar_oracle;
    ``near_surface``: heights within 0.6 of the ground instead, so that
    many particles touch it."""
    rng = np.random.default_rng(seed)
    inst = [(tmesh.unity_plane(), tmesh.Transform()),
            (tmesh.unity_cube(), tmesh.Transform())]
    tris = tmesh.flatten_scene(inst)
    cam, jcam = _cameras(y=10.0, h=96, w=160)
    pos = rng.uniform(-6, 6, size=(n, 3)).astype(F)
    pos[:, 1] = rng.uniform(-1, 9, size=n)
    vel = rng.normal(size=(n, 3)).astype(F) * 12
    vel[0] = 0
    if near_surface:
        pos[:, 1] = rng.uniform(0.0, 0.6, size=n)
    return tris, cam, jcam, pos, vel


def _tstate(pos, vel, radius, bounce):
    n = pos.shape[1]
    return ParticleState(
        pos=torch.from_numpy(np.ascontiguousarray(pos)),
        vel=torch.from_numpy(np.ascontiguousarray(vel)),
        collisions=torch.zeros((n,), dtype=torch.int32),
        radius=torch.full((n,), float(radius)),
        restitution=torch.full((n,), float(bounce)),
    )


@pytest.mark.parametrize("near_surface", [False, True])
@pytest.mark.parametrize("hybrid", [False, True])
def test_screen_space_collide_matches_jax_and_oracle(hybrid, near_surface,
                                                     tmp_path, monkeypatch):
    """Collisions and the undecided mask exact; pos within rtol 1e-5 /
    atol 1e-5 and vel within rtol 1e-5 / atol 1e-4, against both the JAX
    package's function and the scalar oracle (seed 7)."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path))
    monkeypatch.setattr(jss, "_BAKE_DISK_DIR", str(tmp_path))
    tris, cam, jcam, pos, vel = _oracle_inputs(near_surface=near_surface)
    n = len(pos)
    radius, bounce, dt = F(0.3), F(0.25), F(0.01)
    gravity = np.array([0, -9.81, 0], dtype=F)
    tex = tss.bake_camera(tris, cam, device="cpu")
    jtex = jss.bake_camera(tris, jcam)
    np.testing.assert_array_equal(tex.planar.numpy(), np.asarray(jtex.planar))
    for f in ("view", "proj", "cam_pos", "cam_fwd"):
        np.testing.assert_array_equal(getattr(tex, f).numpy(), np.asarray(getattr(jtex, f)))

    out, und = tss.screen_space_collide(
        _tstate(pos.T, vel.T, radius, bounce), tex, torch.from_numpy(gravity),
        float(dt), hybrid=hybrid)
    j_out, j_und = jss.screen_space_collide(
        JParticleState(pos=jnp.asarray(pos.T), vel=jnp.asarray(vel.T),
                       collisions=jnp.zeros((n,), dtype=jnp.int32),
                       radius=jnp.full((n,), radius), restitution=jnp.full((n,), bounce)),
        jtex, jnp.asarray(gravity), float(dt), hybrid=hybrid)
    o_pos, o_vel, o_nc, o_und = ref.screen_space_collide(
        pos, vel, radius, bounce, gravity, dt, tex.view.numpy(), tex.proj.numpy(),
        tex.cam_pos.numpy(), tex.cam_fwd.numpy(), tex.depth.numpy(),
        tex.normal.numpy(), hybrid=hybrid)

    got_c, got_u = out.collisions.numpy(), und.numpy()
    assert (got_c.sum() > 10) == near_surface
    # the oracle's ``v = vel[i]`` (reference_impl.py:224) is a view that
    # :248 overwrites before :249 reads it, so it leaves a hit particle's
    # position unmoved; hold the port to the position update
    # pos + vel' dt - vel dt that the oracle's code means
    hit = o_nc > 0
    o_pos[hit] = (pos[hit] + o_vel[hit] * dt - vel[hit] * dt).astype(F)
    assert got_u.any() == hybrid and not got_u[0]  # lane 0 is at rest
    for tag, want_c, want_u, want_p, want_v in (
            ("jax", np.asarray(j_out.collisions), np.asarray(j_und),
             np.asarray(j_out.pos).T, np.asarray(j_out.vel).T),
            ("oracle", o_nc, o_und, o_pos, o_vel)):
        np.testing.assert_array_equal(got_c, want_c, err_msg=tag)
        np.testing.assert_array_equal(got_u, want_u, err_msg=tag)
        np.testing.assert_allclose(out.pos.numpy().T, want_p, rtol=1e-5, atol=1e-5,
                                   err_msg=tag)
        np.testing.assert_allclose(out.vel.numpy().T, want_v, rtol=1e-5, atol=1e-4,
                                   err_msg=tag)


def test_padding_lanes_inert(tmp_path, monkeypatch):
    """Pad lanes at 1e38, at rest or falling (the integrator moves them),
    never collide, leave the active lanes' results unchanged and finite,
    and are undecided only in hybrid mode and only while moving."""
    monkeypatch.setenv("PSYS_BAKE_CACHE", str(tmp_path))
    tris, cam, _, pos, vel = _oracle_inputs()
    n, n_pad = len(pos), 64
    tex = tss.bake_camera(tris, cam, device="cpu")
    gravity = torch.tensor([0, -9.81, 0], dtype=torch.float32)
    p_pad = np.full((3, n_pad), 1e38, dtype=F)
    p_pad[1, n_pad // 2:] = -1e38
    v_pad = np.zeros((3, n_pad), dtype=F)
    v_pad[1, n_pad // 2:] = -3.0
    state = _tstate(np.concatenate([pos.T, p_pad], 1),
                    np.concatenate([vel.T, v_pad], 1), 0.3, 0.25)
    for hybrid in (False, True):
        alone, und_a = tss.screen_space_collide(
            _tstate(pos.T, vel.T, 0.3, 0.25), tex, gravity, 0.01, hybrid=hybrid)
        out, und = tss.screen_space_collide(state, tex, gravity, 0.01, hybrid=hybrid)
        assert torch.equal(out.collisions[:n], alone.collisions)
        assert torch.equal(und[:n], und_a)
        assert torch.equal(out.pos[:, :n], alone.pos)
        assert torch.equal(out.vel[:, :n], alone.vel)
        assert torch.isfinite(out.pos[:, :n]).all() and torch.isfinite(out.vel[:, :n]).all()
        assert (out.collisions[n:] == 0).all()
        assert torch.equal(out.pos[:, n:], state.pos[:, n:])
        assert torch.equal(out.vel[:, n:], state.vel[:, n:])
        assert not und[n:n + n_pad // 2].any()  # at rest
        assert bool(und[n + n_pad // 2:].all()) == hybrid  # falling, off screen


def test_pixel_index_in_range():
    """The texture index clamps after the integer cast: NaN, infinite,
    huge and negative screen coordinates all index inside the table."""
    h, w = 96, 160
    sx = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30,
                       -0.5, 0.0, 0.5, 1.0, 2.0])
    flat = tss._pixel_index(sx, sx.flip(0), h, w)
    assert flat.dtype == torch.int64
    assert ((flat >= 0) & (flat < h * w)).all()
    on_screen = tss._pixel_index(torch.tensor([0.0, 0.5, 1.0]),
                                 torch.tensor([0.0, 0.5, 1.0]), h, w)
    assert on_screen.tolist() == [0, 48 * w + 80, (h - 1) * w + w - 1]


_ENTRY_POINTS = {
    "bake_camera": lambda sc: tss.bake_camera(sc.triangles, sc.cameras[0]),
    "make_spatial_step_grid": lambda sc: tstep.make_spatial_step_grid(
        sc.triangles, sc.config),
    "make_screenspace_step": lambda sc: tstep.make_screenspace_step(
        sc.triangles, sc.config, sc.cameras[0]),
    "make_hybrid_step": lambda sc: tstep.make_hybrid_step(
        sc.triangles, sc.config, sc.cameras[0]),
    "make_hybrid_step_sorted": lambda sc: tstep.make_hybrid_step_sorted(
        sc.triangles, sc.config, sc.cameras[0]),
    "runner_camera": lambda sc: tstep.make_sorted_episode_runner(
        sc.triangles, sc.config, camera=sc.cameras[0]),
    **{f"make_method_step_{m}": (lambda sc, m=m: tstep.make_method_step(sc, m))
       for m in ("spatial", "screen_space", "hybrid")},
    **{f"run_episode_{m}": (lambda sc, m=m: tharness.run_episode(sc, m, num_steps=2))
       for m in ("screen_space", "hybrid")},
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_need_cuda_by_default(monkeypatch, entry):
    """device defaults to "cuda": without a card the bake and the
    slice's entry points raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _ENTRY_POINTS[entry](sample_scene(width=32, height=32))
