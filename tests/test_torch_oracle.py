"""PyTorch port, the oracle paths on the CPU: the exact narrow phase
(``particle_vs_triangles``, ``nearest_hit``, ``swept_collide_stream``),
``spatial_collide`` and the brute-force step, ``gather_candidates`` and the
"dense" / "stream" / "packed" grid steps, each against the JAX package on
the same seeded numpy inputs and against the scalar oracle
``tests/reference_impl.py``.

Tolerances: against the JAX package ``rtol=1e-5, atol=1e-6`` with hits
exact (XLA on the CPU contracts multiply-adds); pure gathers bitwise;
inside the port the streaming and the dense reductions bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_impl as ref
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry import mesh as jmesh
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu.ops import grid as jgrid
from particlesystemhybridcollisiondetection_tpu.ops import narrow_phase as jnph
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.config import GridConfig, SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid
from particlesystemhybridcollisiondetection_tpu_torch.ops import narrow_phase as tnph

torch.set_num_threads(1)
F = np.float32
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_case(seed, n=16, k=12):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(F) * 3
    vel = rng.normal(size=(n, 3)).astype(F) * 5
    tris = rng.normal(size=(k, 3, 3)).astype(F) * 2
    radius, dt = F(0.4), F(0.05)
    speed2 = np.sum(vel.T * vel.T, axis=0)
    dirn = (vel.T / np.sqrt(speed2)[None]).astype(F)
    seg2 = (speed2 * dt * dt).astype(F)
    tv = np.ascontiguousarray(
        np.broadcast_to(tris.transpose(2, 0, 1)[:, None], (3, n, k, 3)))
    return pos, vel, tris, radius, dt, dirn, seg2, tv


@pytest.mark.parametrize("seed", [2, 5])
def test_particle_vs_triangles_matches_oracle_and_jax(seed):
    """Randomized swept sphere vs triangles: hit flags exact against the
    scalar oracle and the JAX package, winning distance within the
    oracle's 1e-4 and the JAX package's rtol 1e-5 / atol 1e-6."""
    pos, vel, tris, radius, dt, dirn, seg2, tv = _random_case(seed)
    n, k = len(pos), len(tris)
    got = tnph.particle_vs_triangles(
        _t(pos.T), _t(dirn), _t(seg2), _t(tv[..., 0]), _t(tv[..., 1]),
        _t(tv[..., 2]), torch.full((n,), float(radius)))
    want = jnph.particle_vs_triangles(
        jnp.asarray(pos.T), jnp.asarray(dirn), jnp.asarray(seg2),
        jnp.asarray(tv[..., 0]), jnp.asarray(tv[..., 1]),
        jnp.asarray(tv[..., 2]), jnp.full((n,), radius))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    hit = got.hit.numpy()
    for name in ("t", "t2"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a[hit], b[hit], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal),
                               rtol=RTOL, atol=ATOL)

    ref_hits = np.zeros((n, k), dtype=bool)
    for i in range(n):
        rd = ref.normalize(vel[i])
        p_end = (pos[i] + vel[i] * dt).astype(F)
        for j in range(k):
            h, pt = ref.particle_triangle(pos[i], p_end, rd, tris[j], radius)
            ref_hits[i, j] = h
            if h:
                d_ref = np.linalg.norm(pt - pos[i])
                assert np.isclose(abs(got.t.numpy()[i, j]), d_ref,
                                  rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(hit, ref_hits)


def test_nearest_hit_and_stream_agree():
    """nearest_hit against the JAX package's (first minimum wins ties,
    duplicated candidates included), and swept_collide_stream against
    particle_vs_triangles + nearest_hit bit for bit on the hit lanes."""
    pos, vel, tris, radius, dt, dirn, seg2, tv = _random_case(7, n=64, k=9)
    tv = np.concatenate([tv, tv[..., :3, :]], axis=2)  # exact ties
    n, k = len(pos), tv.shape[2]
    args = (_t(pos.T), _t(dirn), _t(seg2), _t(tv[..., 0]), _t(tv[..., 1]),
            _t(tv[..., 2]), torch.full((n,), float(radius)))
    hits = tnph.particle_vs_triangles(*args)
    near = tnph.nearest_hit(hits)
    jhits = jnph.TriangleHits(*(jnp.asarray(x.numpy()) for x in hits))
    jnear = jnph.nearest_hit(jhits)
    for a, b in zip(near, jnear):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(near.hit.sum()) > 3

    def gather_fn(j):
        return (args[3][:, :, j], args[4][:, :, j], args[5][:, :, j],
                torch.ones(n, dtype=torch.bool))

    stream = tnph.swept_collide_stream(args[0], args[1], args[2], args[6],
                                       gather_fn, k)
    np.testing.assert_array_equal(stream.hit.numpy(), near.hit.numpy())
    h = near.hit.numpy()
    np.testing.assert_array_equal(stream.t.numpy()[h], near.t.numpy()[h])
    np.testing.assert_array_equal(stream.normal.numpy()[:, h],
                                  near.normal.numpy()[:, h])


def _mini_state(pos, vel, radius, bounce):
    n = pos.shape[0]
    d = {"pos": pos.T.copy(), "vel": vel.T.copy(),
         "collisions": np.zeros(n, np.int32),
         "radius": np.full(n, radius, F), "restitution": np.full(n, bounce, F)}
    return d, convert.state_from_numpy(d, device="cpu"), jstate.ParticleState(
        **{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("chunk", [None, 7])
def test_spatial_collide_matches_oracle_and_jax(monkeypatch, chunk):
    """One collision pass over shared candidates: collisions exact against
    the oracle and the JAX package, pos/vel within the oracle's 2e-4 and
    the JAX package's tolerance.  With ``chunk`` the candidates and
    lanes are evaluated in chunks of 7 elements, which must not change a
    bit."""
    if chunk is not None:
        monkeypatch.setattr(tstep, "_CHUNK_ELEMS", chunk)
    rng = np.random.default_rng(3)
    n, k = 24, 10
    gravity = np.array([0.0, -9.81, 0.0], dtype=F)
    for trial in range(4):
        pos = rng.normal(size=(n, 3)).astype(F) * 2
        vel = rng.normal(size=(n, 3)).astype(F) * 8
        vel[0] = 0  # the vel == 0 guard
        tris = rng.normal(size=(k, 3, 3)).astype(F) * 3
        radius, dt, bounce = F(0.5), F(0.05), F(0.25)
        ref_pos, ref_vel, ref_nc = ref.spatial_collide(
            pos, vel, radius, bounce, gravity, dt, tris)
        _, ts, js = _mini_state(pos, vel, radius, bounce)
        vs = [tris[:, i].T.copy() for i in range(3)]
        out = tstep.spatial_collide(ts, *(_t(v) for v in vs), _t(gravity),
                                    float(dt), 0.0015)
        jout = jstep.spatial_collide(js, *(jnp.asarray(v) for v in vs),
                                     jnp.asarray(gravity), float(dt), 0.0015)
        np.testing.assert_array_equal(out.collisions.numpy(), ref_nc)
        np.testing.assert_array_equal(out.collisions.numpy(),
                                      np.asarray(jout.collisions))
        np.testing.assert_allclose(out.pos.numpy().T, ref_pos, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out.vel.numpy().T, ref_vel, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.vel.numpy(), np.asarray(jout.vel),
                                   rtol=RTOL, atol=ATOL)
        if chunk is not None:
            monkeypatch.undo()
            whole = tstep.spatial_collide(ts, *(_t(v) for v in vs), _t(gravity),
                                          float(dt), 0.0015)
            monkeypatch.setattr(tstep, "_CHUNK_ELEMS", chunk)
            for a, b in zip(out, whole):
                assert torch.equal(a, b)


def _small_scene(mesh):
    """Cube + 2x-scaled ground plane (212 triangles)."""
    return mesh.flatten_scene([
        (mesh.unity_plane(), mesh.Transform(scale=(2.0, 2.0, 2.0))),
        (mesh.unity_cube(), mesh.Transform(position=(0.3, 0.5, 0.2))),
    ])


def test_trajectory_matches_oracle_300_steps():
    """make_spatial_step_bruteforce, 300 steps of 4 particles on the cube
    and plane: collisions exact, pos within 1e-4 and vel within 1e-4 /
    1e-3 of the oracle, as the JAX package's own test holds it."""
    tris = _small_scene(jmesh)
    gravity = np.array([0.0, -9.81, 0.0], dtype=F)
    radius, bounce, dt = F(0.2), F(0.5), F(0.004)
    pos = np.array([[0.0, 2.0, 0.0], [0.35, 1.5, 0.21], [-1.2, 1.0, 0.8],
                    [0.9, 2.5, -0.7]], dtype=F)
    vel = np.array([[0.0, 0.0, 0.0], [0.5, -1.0, 0.2], [-0.3, 0.0, 0.1],
                    [0.0, -2.0, 0.0]], dtype=F)
    steps = 300
    ref_pos, ref_vel, ref_nc, _ = ref.run_episode(
        pos, vel, radius, bounce, gravity, dt, tris, steps)
    cfg = SimConfig(particle_radius=float(radius), dt=float(dt),
                    bounciness=float(bounce),
                    grid=GridConfig(cell_size=0.5, expand=0.3))
    step = tstep.make_spatial_step_bruteforce(tris, cfg, device="cpu")
    _, state, _ = _mini_state(pos, vel, radius, bounce)
    state = tstep.make_episode_runner(step, steps)(state)
    np.testing.assert_array_equal(state.collisions.numpy(), ref_nc)
    assert ref_nc.sum() > 0
    np.testing.assert_allclose(state.pos.numpy().T, ref_pos, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.vel.numpy().T, ref_vel, rtol=1e-4, atol=1e-3)


def test_bruteforce_step_matches_jax():
    """One brute-force step on the sample scene (1812 triangles) from a
    state with contacts: collisions exact, pos/vel within tolerance."""
    jsc = j_sample_scene()
    cfg = jsc.config
    rng = np.random.default_rng(11)
    n = 256
    pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(0.4, 0.9, n),
                    rng.uniform(-2, 2, n)], axis=1).astype(F)
    vel = (rng.normal(size=(n, 3)) * 20).astype(F)
    _, ts, js = _mini_state(pos, vel, F(cfg.particle_radius), F(cfg.bounciness))
    tcfg = sample_scene().config
    got = tstep.make_spatial_step_bruteforce(jsc.triangles, tcfg, device="cpu")(ts)
    want = jstep.make_spatial_step_bruteforce(jsc.triangles, cfg)(js)
    np.testing.assert_array_equal(got.collisions.numpy(), np.asarray(want.collisions))
    assert int(got.collisions.sum()) > 10
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel), rtol=RTOL, atol=ATOL)


def test_candidates_are_complete_and_match_jax():
    """gather_candidates: tid order, mask and vertices bitwise equal to the
    JAX package's; every triangle within ``expand`` (L2) of a query point
    is among the point's candidates."""
    rng = np.random.default_rng(0)
    scene = sample_scene()
    gcfg = scene.config.grid
    tris = scene.triangles
    grid, meta = tgrid.build_triangle_grid(tris, gcfg, device="cpu")
    jg, jm = jgrid.build_triangle_grid(tris, j_sample_scene().config.grid)
    pts = rng.uniform(-3, 3, size=(256, 3)).astype(F)
    pts[:, 1] = rng.uniform(0, 2, size=256)
    got = tgrid.gather_candidates(grid, meta, _t(pts.T))
    want = jgrid.gather_candidates(jg, jm, jnp.asarray(pts.T))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    mask = got[3].numpy()
    cid = tgrid.cell_index(_t(pts.T), meta).numpy()
    tids = grid.tri_ids.numpy()
    offs = grid.offsets.numpy()
    assert (mask.sum(1) == offs[cid + 1] - offs[cid]).all()
    lo, hi = tris.min(axis=1), tris.max(axis=1)
    for i in range(len(pts)):
        d = np.maximum(lo - pts[i], 0) + np.maximum(pts[i] - hi, 0)
        near = np.where(np.linalg.norm(d, axis=1) <= gcfg.expand - 1e-3)[0]
        cand = set(tids[offs[cid[i]]:offs[cid[i] + 1]])
        assert not set(near) - cand, f"point {pts[i]} misses {set(near) - cand}"


def _fast(make_scene):
    """sample_scene with 20x dt: first impacts within ~45 steps."""
    scene = make_scene(width=96, height=64)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


@pytest.fixture(scope="module")
def bf_states():
    """States of the fast sample scene (49 particles padded to 128) along
    the JAX package's brute-force trajectory: every 20th step and every
    step whose collisions changed, up to step 75 (at most 14), each with
    the JAX brute-force step's output."""
    jsc = _fast(j_sample_scene)
    jbf = jstep.make_spatial_step_bruteforce(jsc.triangles, jsc.config)
    s = jstate.spawn_grid(jsc.config, layers_y=1, pad_multiple=128)
    picked = []
    for k in range(75):
        nxt = jbf(s)
        changed = int(nxt.collisions.sum()) != int(s.collisions.sum())
        if (k % 20 == 0 or changed) and len(picked) < 14:
            picked.append((k, jstate.snapshot(s), jstate.snapshot(nxt)))
        s = nxt
    assert sum(1 for _, a, b in picked
               if b["collisions"].sum() != a["collisions"].sum()) >= 5
    return picked


@pytest.mark.parametrize("variant", ["dense", "stream", "packed"])
def test_grid_step_equals_bruteforce_step(bf_states, variant):
    """One grid step of each variant equals one brute-force step from the
    same state: the same hits as the port's and the JAX package's brute
    force, positions within rtol 1e-5 / atol 1e-6, and the three grid
    variants equal to one another bit for bit."""
    scene = _fast(sample_scene)
    cfg = scene.config
    bf = tstep.make_spatial_step_bruteforce(scene.triangles, cfg, device="cpu")
    step = tstep.make_method_step(scene, "spatial", spatial_variant=variant,
                                  device="cpu")
    other = tstep.make_spatial_step_grid(
        scene.triangles, cfg, "packed" if variant != "packed" else "dense",
        device="cpu")
    for k, s, want in bf_states:
        ts = convert.state_from_numpy(s, device="cpu")
        got, ref_bf = step(ts), bf(ts)
        mask = np.abs(s["pos"][0]) < 1e37
        np.testing.assert_array_equal(got.collisions.numpy(), ref_bf.collisions.numpy(),
                                      err_msg=f"step {k}: hit sets differ")
        np.testing.assert_array_equal(got.collisions.numpy(), want["collisions"],
                                      err_msg=f"step {k}: hits differ from JAX")
        np.testing.assert_allclose(got.pos.numpy()[:, mask], ref_bf.pos.numpy()[:, mask],
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {k}")
        np.testing.assert_allclose(got.pos.numpy()[:, mask], want["pos"][:, mask],
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {k} vs JAX")
        for a, b in zip(got, other(ts)):
            assert torch.equal(a, b), f"step {k}: grid variants differ"


def test_packed_lane_chunks_are_exact(monkeypatch):
    """The packed path evaluated in lane chunks (a small element budget)
    gives the unchunked result bit for bit, on a state with hits."""
    scene = _fast(sample_scene)
    step = tstep.make_spatial_step_grid(scene.triangles, scene.config, "packed",
                                        device="cpu")
    rng = np.random.default_rng(4)
    n = 1024
    pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(0.3, 1.0, n),
                    rng.uniform(-2, 2, n)], axis=1).astype(F)
    vel = (rng.normal(size=(n, 3)) * 8).astype(F)
    _, ts, _ = _mini_state(pos, vel, F(0.2), F(0.5))
    whole = step(ts)
    monkeypatch.setattr(tstep, "_CHUNK_ELEMS", 3000)
    chunked = step(ts)
    assert int(whole.collisions.sum()) > 20
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_grid_variants_reject_unknown():
    scene = sample_scene()
    with pytest.raises(ValueError, match="unknown spatial variant"):
        tstep.make_spatial_step_grid(scene.triangles, scene.config, "bvh",
                                     device="cpu")
