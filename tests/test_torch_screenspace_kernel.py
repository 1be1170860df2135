"""PyTorch port, the screen-space stage's hand-written CUDA kernel
(``ops/cuda/screenspace_kernel.py``, ``csrc/screenspace_kernel.cu``)
against its plain version (``ops/screenspace.py::
screen_space_collide_plain``), bit for bit.

On the CPU: ``screen_space_collide`` is its plain version, the runner's
in-place stage (``screen_space_collide_rows``) gives what the rows, the
count and the mask took from the former concatenate-and-copy stage, and
the kernel's wrappers refuse a wrong dtype, shape or layout before any
launch.  On the card (``-m cuda``): both entry points, hybrid and
screen-space only, equal the plain version on every lane of the sample
scene's states at free fall, first impact and in the settled pile, and
on lanes at rest, sentinel lanes (some with a NaN NDC), lanes behind the
camera and lanes on the screen's last texel; the in-place entry point
writes no lane that does not collide.  Small sizes: the sample scene at
128 x 128, 2,048 lanes a state."""

import dataclasses

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as tss
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    screenspace_kernel as tssk,
)

F = np.float32
N = 2048
KINDS = ["free_fall", "impact", "settled", "special"]
# the runner's states of the sample scene (20x dt) on the card: steps run
# (the stage's first collisions at step 47; 4 at step 49, 11 at step 399)
RUNNER_STATES = {"runner_free_fall": 10, "runner_first_impact": 49,
                 "runner_settled": 399}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSYS_BAKE_CACHE", str(tmp_path_factory.mktemp("bake")))
        sc = sample_scene(width=128, height=128)
        tss.bake_camera(sc.triangles, sc.cameras[0], device="cpu")
    return sc


def _screen(tex, pos):
    """(sx, sy, clip w) of f32[3, M] ``pos``, by the plain version's
    arithmetic."""
    view_pos = tss._transform(tex.view, pos, 1.0)
    clip = tss._transform(tex.proj, view_pos[:3], view_pos[3])
    ndc = clip[:3] / clip[3]
    return ndc[0] * 0.5 + 0.5, ndc[1] * 0.5 + 0.5, clip[3]


def _edge_lanes(tex, rng, m=16, spread=12):
    """Lanes around the screen's right and top edges: for each of ``m``
    rays, bisect the world x (right edge) or y (top edge) where sx or sy
    reaches 1, then take the ``spread`` floats on either side, so that
    some lanes land exactly on 1.0 (the index W, clamped to the last
    texel), some just inside (the last texel) and some just outside."""
    out = []
    for axis in (0, 1):
        for _ in range(m):
            base = np.array([rng.uniform(-1, 1), rng.uniform(0.2, 1.5),
                             rng.uniform(-2, 3)], dtype=F)
            lo, hi = F(-60.0), F(60.0)
            for _ in range(200):
                mid = F((float(lo) + float(hi)) / 2)
                if mid in (lo, hi):
                    break
                p = base.copy()
                p[axis] = mid
                s = _screen(tex, torch.from_numpy(p)[:, None])[axis]
                if float(s[0]) < 1.0:
                    lo = mid
                else:
                    hi = mid
            x = lo
            for _ in range(spread):
                x = np.nextafter(x, F(-np.inf))
            for _ in range(2 * spread + 2):
                p = base.copy()
                p[axis] = x
                out.append(p)
                x = np.nextafter(x, F(np.inf))
    return np.stack(out, axis=1)


def _lanes(kind: str, tex, cfg, seed: int = 11):
    """f32[3, N] pos and vel of one kind of state."""
    rng = np.random.default_rng(seed)
    r = cfg.particle_radius
    pos = np.empty((3, N), dtype=F)
    pos[0] = rng.uniform(-4, 4, N)
    pos[2] = rng.uniform(-4, 4, N)
    vel = (rng.normal(size=(3, N)) * 0.3).astype(F)
    if kind == "free_fall":
        pos[1] = rng.uniform(0.6, 6.0, N)
        vel[1] = -rng.uniform(0.0, 8.0, N)
    elif kind == "impact":  # on the ground and on the cube's top
        pos[1] = rng.uniform(0.0, 0.35, N)
        top = slice(0, N // 4)
        pos[0, top] = rng.uniform(-0.5, 0.5, N // 4)
        pos[2, top] = rng.uniform(-0.5, 0.5, N // 4)
        pos[1, top] = rng.uniform(0.5, 0.85, N // 4)
        vel[1] = -rng.uniform(0.5, 6.0, N)
    elif kind == "settled":  # resting on the ground, barely moving, some at rest
        pos[1] = r + rng.uniform(-0.01, 0.01, N)
        vel = (rng.normal(size=(3, N)) * 1e-3).astype(F)
        vel[:, rng.random(N) < 0.25] = 0.0
    else:  # special lanes
        pos[1] = rng.uniform(0.0, 3.0, N)
        vel[1] = -rng.uniform(0.5, 6.0, N)
        edges = _edge_lanes(tex, rng)
        k = edges.shape[1]
        pos[:, :k] = edges
        i = k
        # at rest, on and off the surface
        vel[:, i:i + 64] = 0.0
        pos[1, i:i + 32] = r
        i += 64
        # sentinels: x and z at 1e38 (at rest and falling), and lanes far
        # enough out that the projection overflows to a NaN NDC
        pos[0, i:i + 64] = 1e38
        pos[2, i:i + 64] = 1e38
        pos[:, i + 64:i + 96] = F(3e38)
        pos[:, i + 96:i + 128] = F(-3e38)
        vel[:, i:i + 128] = 0.0
        vel[1, i + 32:i + 128] = -3.0
        i += 128
        # behind the camera: some project inside [0, 1] through a negative w
        back = tex.cam_pos.numpy()[:, None] - tex.cam_fwd.numpy()[:, None] * rng.uniform(
            0.5, 20.0, 128)
        pos[:, i:i + 128] = back + rng.normal(size=(3, 128)).astype(F)
        i += 128
    return pos, vel


def _state(pos, vel, cfg, device="cpu", seed=3):
    rng = np.random.default_rng(seed)
    n = pos.shape[1]
    return ParticleState(
        pos=torch.from_numpy(np.ascontiguousarray(pos)).to(device),
        vel=torch.from_numpy(np.ascontiguousarray(vel)).to(device),
        collisions=torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(device),
        radius=torch.full((n,), float(cfg.particle_radius), device=device),
        restitution=torch.full((n,), float(cfg.bounciness), device=device),
    )


def _gravity(cfg, device="cpu"):
    return torch.tensor(cfg.gravity, dtype=torch.float32, device=device)


def _equal(a: ParticleState, b: ParticleState) -> bool:
    """Bit for bit (NaN payloads and the sign of zero included)."""
    return all(torch.equal(getattr(a, f).view(torch.int32), getattr(b, f).view(torch.int32))
               for f in ("pos", "vel")) and torch.equal(a.collisions, b.collisions)


def _old_rows_stage(rows8, aux, tex, gravity, dt):
    """The runner's former stage: the pass on views of the rows, then a
    concatenation, a stack and three copies back."""
    st = ParticleState(pos=rows8[0:3], vel=rows8[3:6], collisions=aux[0],
                       radius=rows8[6], restitution=rows8[7])
    st, und = tss.screen_space_collide_plain(st, tex, gravity, dt, hybrid=True)
    return (torch.cat([st.pos, st.vel, rows8[6:8]], dim=0),
            torch.stack([st.collisions, aux[1]]), und)


def _rows(st: ParticleState):
    rows8 = torch.cat([st.pos, st.vel, st.radius[None], st.restitution[None]], dim=0)
    aux = torch.stack([st.collisions, torch.arange(st.pos.shape[1], dtype=torch.int32,
                                                   device=st.pos.device)])
    return rows8, aux


def test_special_lanes_reach_what_they_stand_for(scene):
    """The special state holds lanes exactly on sx = 1 and sy = 1 (index
    W or H, clamped to the last texel) and just inside them, sentinel
    lanes with a NaN NDC, lanes behind the camera that project inside
    the screen, and lanes at rest."""
    tex = tss.bake_camera(scene.triangles, scene.cameras[0], device="cpu")
    pos, vel = _lanes("special", tex, scene.config)
    sx, sy, w = _screen(tex, torch.from_numpy(pos))
    h_px, w_px = tex.screen_size
    assert int((sx == 1.0).sum()) > 0 and int((sy == 1.0).sum()) > 0
    assert int(((sx * w_px).to(torch.int32) == w_px - 1).sum()) > 0
    assert int(((sy * h_px).to(torch.int32) == h_px - 1).sum()) > 0
    assert int(torch.isnan(sx).sum()) > 0
    inside = (sx >= 0) & (sx <= 1) & (sy >= 0) & (sy <= 1)
    behind = (tex.cam_fwd[:, None] * (torch.from_numpy(pos) - tex.cam_pos[:, None])).sum(0) < 0
    assert int((inside & behind).sum()) > 0
    assert int((torch.from_numpy(vel) == 0).all(0).sum()) >= 64


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_screen_space_collide_is_its_plain_version_on_cpu(scene, kind, hybrid):
    """For CPU tensors the wrapper returns what the plain version does,
    bit for bit, mask included; no kernel is launched."""
    cfg = scene.config
    tex = tss.bake_camera(scene.triangles, scene.cameras[0], device="cpu")
    st = _state(*_lanes(kind, tex, cfg), cfg)
    before = dict(tssk.LAUNCHES)
    out, und = tss.screen_space_collide(st, tex, _gravity(cfg), cfg.dt, hybrid=hybrid)
    want, want_und = tss.screen_space_collide_plain(st, tex, _gravity(cfg), cfg.dt,
                                                    hybrid=hybrid)
    assert _equal(out, want) and torch.equal(und, want_und)
    assert tssk.LAUNCHES == before
    assert bool(und.any()) == hybrid


@pytest.mark.parametrize("kind", KINDS)
def test_rows_stage_matches_the_former_copy_path_on_cpu(scene, kind):
    """The runner's in-place stage on the CPU leaves the rows, the count
    and the mask as the former concatenate, stack and copy stage did,
    bit for bit; radius, restitution and the ids stay as they were."""
    cfg = scene.config
    tex = tss.bake_camera(scene.triangles, scene.cameras[0], device="cpu")
    rows8, aux = _rows(_state(*_lanes(kind, tex, cfg), cfg))
    want8, want_aux, want_und = _old_rows_stage(rows8, aux, tex, _gravity(cfg), cfg.dt)
    und = torch.zeros(N, dtype=torch.bool)
    tss.screen_space_collide_rows(rows8, aux[0], und, tex, _gravity(cfg), cfg.dt)
    assert torch.equal(rows8.view(torch.int32), want8.view(torch.int32))
    assert torch.equal(aux, want_aux) and torch.equal(und, want_und)
    if kind in ("impact", "settled"):
        assert int((aux[0] != _rows(_state(*_lanes(kind, tex, cfg), cfg))[1][0]).sum()) > 0


def _bad_inputs(tex, cfg):
    """(entry point, arguments, what is wrong) for the kernel's wrappers."""
    st = _state(*_lanes("free_fall", tex, cfg), cfg)
    rows8, aux = _rows(st)
    und = torch.zeros(N, dtype=torch.bool)
    g = _gravity(cfg)
    wide = torch.zeros((8, 2 * N))
    cases = {
        "rows_dtype": (tssk.screen_space_collide_rows,
                       (rows8.double(), aux[0], und, tex, g, cfg.dt), "dtype"),
        "rows_shape": (tssk.screen_space_collide_rows,
                       (rows8[:7], aux[0], und, tex, g, cfg.dt), "shape"),
        "rows_strided": (tssk.screen_space_collide_rows,
                         (wide[:, ::2], aux[0], und, tex, g, cfg.dt), "contiguous"),
        "rows_mask_dtype": (tssk.screen_space_collide_rows,
                            (rows8, aux[0], und.to(torch.uint8), tex, g, cfg.dt), "dtype"),
        "rows_count_dtype": (tssk.screen_space_collide_rows,
                             (rows8, aux[0].long(), und, tex, g, cfg.dt), "dtype"),
        "pos_strided": (tssk.screen_space_collide,
                        (wide[0:3, ::2], st.vel, st.collisions, st.radius, st.restitution,
                         tex, g, cfg.dt), "contiguous"),
        "vel_shape": (tssk.screen_space_collide,
                      (st.pos, st.vel[:, 1:], st.collisions, st.radius, st.restitution,
                       tex, g, cfg.dt), "shape"),
        "radius_dtype": (tssk.screen_space_collide,
                         (st.pos, st.vel, st.collisions, st.radius.double(),
                          st.restitution, tex, g, cfg.dt), "dtype"),
        "gravity_shape": (tssk.screen_space_collide,
                          (st.pos, st.vel, st.collisions, st.radius, st.restitution, tex,
                           g[:2], cfg.dt), "shape"),
        "table_shape": (tssk.screen_space_collide,
                        (st.pos, st.vel, st.collisions, st.radius, st.restitution,
                         tex._replace(texels=tex.texels[:, :3]), g, cfg.dt), "shape"),
        "table_unaligned": (tssk.screen_space_collide_rows,
                            (rows8, aux[0], und, tex._replace(
                                texels=torch.zeros(tex.texels.numel() + 1)[1:].view(
                                    tex.texels.shape)), g, cfg.dt), "aligned"),
    }
    return cases


@pytest.mark.parametrize("case", ["rows_dtype", "rows_shape", "rows_strided",
                                  "rows_mask_dtype", "rows_count_dtype", "pos_strided",
                                  "vel_shape", "radius_dtype", "gravity_shape",
                                  "table_shape", "table_unaligned"])
def test_kernel_wrappers_refuse_bad_inputs(scene, case):
    """A wrong dtype, shape or a non-contiguous row raises before the
    kernel is built or launched."""
    cfg = scene.config
    tex = tss.bake_camera(scene.triangles, scene.cameras[0], device="cpu")
    fn, args, what = _bad_inputs(tex, cfg)[case]
    before = dict(tssk.LAUNCHES)
    kw = {"hybrid": True} if fn is tssk.screen_space_collide else {}
    with pytest.raises(ValueError, match=what):
        fn(*args, **kw)
    assert tssk.LAUNCHES == before


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def runner_states(scene):
    """The sample scene's hybrid runner (20x dt) on the card after each of
    RUNNER_STATES' step counts."""
    dev = _card()
    fast = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    runner = tstep.make_sorted_episode_runner(
        scene.triangles, fast, resort_every="auto", camera=scene.cameras[0],
        cells_lookup="kernel", device=dev)
    s, done, states = spawn_grid(fast, 8, device=dev), 0, {}
    for name, steps in sorted(RUNNER_STATES.items(), key=lambda kv: kv[1]):
        s = runner(s, steps - done)
        done = steps
        states[name] = s
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["out_of_place", "screen_space_only", "rows"])
@pytest.mark.parametrize("kind", KINDS + sorted(RUNNER_STATES))
def test_kernel_matches_plain_on_card(scene, runner_states, kind, entry):
    """On the card each entry point equals the plain version (run on the
    card) on every lane, bit for bit: pos, vel, count and mask; the
    in-place entry point leaves every lane that does not collide as it
    was, radius and restitution rows included, and launches once."""
    dev = _card()
    cfg = scene.config
    tex = tss.bake_camera(scene.triangles, scene.cameras[0], device=dev)
    g = _gravity(cfg, dev)
    if kind in runner_states:
        st = runner_states[kind]
    else:
        st = _state(*_lanes(kind, tss.bake_camera(scene.triangles, scene.cameras[0],
                                                  device="cpu"), cfg), cfg, device=dev)
    hybrid = entry != "screen_space_only"
    want, want_und = tss.screen_space_collide_plain(st, tex, g, cfg.dt, hybrid=hybrid)
    before = tssk.LAUNCHES["screen_space_collide"]
    if entry == "rows":
        rows8, aux = _rows(st)
        rows0 = rows8.clone()
        coll0 = aux[0].clone()
        und = torch.ones(rows8.shape[1], dtype=torch.bool, device=dev)
        tss.screen_space_collide_rows(rows8, aux[0], und, tex, g, cfg.dt)
        got = st._replace(pos=rows8[0:3], vel=rows8[3:6], collisions=aux[0])
        hit = aux[0] != coll0
        assert torch.equal(rows8[:, ~hit].view(torch.int32), rows0[:, ~hit].view(torch.int32))
        assert torch.equal(rows8[6:8].view(torch.int32), rows0[6:8].view(torch.int32))
    else:
        got, und = tss.screen_space_collide(st, tex, g, cfg.dt, hybrid=hybrid)
    torch.cuda.synchronize()
    assert tssk.LAUNCHES["screen_space_collide"] == before + 1
    assert _equal(got, want) and torch.equal(und, want_und)
    if kind in ("impact", "runner_first_impact"):
        assert int((got.collisions != st.collisions).sum()) > 0


def test_bake_interleaves_the_texel_table(scene):
    """The kernel's texel table holds the planar table's four values of
    each texel side by side, contiguous and 16-byte aligned."""
    tex = tss.bake_camera(scene.triangles, scene.cameras[0], device="cpu")
    h, w = tex.screen_size
    assert tex.texels.shape == (h * w, 4) and tex.texels.is_contiguous()
    assert tex.texels.data_ptr() % 16 == 0
    assert torch.equal(tex.texels, tex.planar.T)
