"""PyTorch port, the sorted runner's control flow on the device, on the
CPU: the runner's rescue (``_device_rescue``: one launch a phase, no host
read) against the rescue looped on the host (``_chunked_rescue``)
and the JAX package's ``_chunked_rescue`` in interpret mode; the window
kernel's worklist entry point (plain version) against the window kernel
run one lane per row; the runner under "auto" and a fixed
``resort_every`` against the JAX package's runner, with its host reads;
and a scene that needs the packed rescue phase.  Small sizes: the fast
sample scene (49 particles padded to 1024) and its dense probe.  The
captured graph itself runs only on the card (``-m cuda``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu.ops import grid as jgrid
from particlesystemhybridcollisiondetection_tpu.ops.pallas import window_kernel as jwk
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as tgraphed
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
    snapshot,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

# episode length of the comparison with the JAX package's runner (as in
# tests/test_torch_hybrid.py: at step 48 of this spawn a shared-edge
# near-tie rounds differently under XLA's fused multiply-adds, ROADMAP C)
JAX_RUNNER_STEPS = 47
SMALL_WINDOW = 128  # overflow everywhere on the dense probe


def _fast_scene():
    """sample_scene with 20x dt: first impacts within ~45 steps."""
    scene = sample_scene(width=128, height=128)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return dataclasses.replace(scene, config=cfg)


@pytest.fixture(scope="module")
def fast():
    return _fast_scene()


@pytest.fixture(scope="module")
def dense_probe(fast):
    """tests/test_torch_step.py's dense probe: 16 x 16 particles at
    spacing 0.25, numpy jitter from seed 1, 47 steps in (first impacts):
    its config and numpy state."""
    cfg = dataclasses.replace(fast.config, num_particles_xz=16, offset_xz=0.25)
    main = tstep.make_spatial_step_sorted(fast.triangles, cfg, device="cpu")
    s = spawn_grid(cfg, 1, jitter=0.35, seed=1, device="cpu")
    for _ in range(47):
        s = main(s)
    return cfg, snapshot(s)


def _sorted_inputs(triangles, cfg, probe, window):
    """The probe sorted and planned as a step does at ``window`` (gather
    plan): the tables, the sorted state, the main kernel's output and the
    plan's overflow, pre-zeroing counts and keys."""
    sp = tstep._build_sorted(triangles, cfg, window=window, fallback_capacity=1024,
                             cells_lookup="gather", dense_demote="auto",
                             device="cpu")
    s = convert.state_from_numpy(probe, device="cpu")
    key = tgrid.morton_key(tgrid.lookup_pos(s.pos, s.vel, cfg.dt), sp.meta)
    key_s, perm = torch.sort(key, stable=True)
    rows = torch.cat([s.pos, s.vel, s.radius[None], s.restitution[None]], 0)[:, perm]
    st = tuple(x.contiguous() for x in (rows[0:3], rows[3:6], rows[6], rows[7]))
    nb = s.pos.shape[-1] // twk.BLOCK
    cid = tgrid.cell_index(tgrid.lookup_pos(st[0], st[1], cfg.dt), sp.meta)
    rel, count, ws, k_cap, overflow, ovf_count = tstep._window_plan(
        cid, sp.tables.cells2, window, nb, demote=sp.demote)
    out = twk.window_collide_sorted(*st, rel, count, ws, k_cap, sp.tables, w=window,
                                    k_static=sp.meta.max_tris_per_cell,
                                    gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff)
    return sp, st, out, overflow, ovf_count, key_s


def test_device_rescue_matches_host_and_jax(fast, dense_probe, monkeypatch):
    """Window 128 on the dense probe: the runner's rescue takes every
    overflow lane through the worklist (no phase 1 runs) and equals the
    host-read rescue (B1 at the rescue window first, then phase 2) bit
    for bit with no host read, and the JAX package's rescue
    (interpret mode; its second phase is the packed path, which rounds
    differently) at rtol 1e-5 / atol 1e-6 with the hits exact."""
    cfg, probe = dense_probe
    sp, st, out, overflow, ovf_count, key_s = _sorted_inputs(
        fast.triangles, cfg, probe, SMALL_WINDOW)
    assert not tstep._phase3_possible(sp)
    listed = []
    worklist = tstep.window_collide_worklist

    def spy(*a, **k):
        listed.append(int(a[7]))  # n_lanes
        return worklist(*a, **k)

    monkeypatch.setattr(tstep, "window_collide_worklist", spy)
    syncs = tstep.HostSyncs()
    dev = tstep._device_rescue(tuple(x.clone() for x in out), st, overflow, sp,
                               key_s=key_s, ovf_count=ovf_count, syncs=syncs)
    assert syncs.count == 0 and listed and listed[0] > 0, listed
    host_syncs = tstep.HostSyncs()
    host = tstep._chunked_rescue(
        tuple(x.clone() for x in out), st, overflow, sp, key_s=key_s,
        ovf_count=ovf_count, syncs=host_syncs)
    assert host_syncs.count >= 3 and int(host[3]) == int(dev[3]) > 0
    for a, b in zip(dev[:3], host[:3]):
        assert torch.equal(a, b)

    jg, jm = jgrid.build_triangle_grid(fast.triangles, cfg.grid)
    packed, num_groups = jgrid.pack_grid(jg, jm, group=8)
    j = jstep._chunked_rescue(
        tuple(jnp.asarray(x.numpy()) for x in out),
        tuple(jnp.asarray(x.numpy()) for x in st), jnp.asarray(overflow.numpy()),
        jwk.build_window_tables(jg, jm, sp.rescue_window), packed, jm, num_groups, 8,
        jnp.asarray(cfg.gravity, dtype=jnp.float32), cfg, sp.m_cap,
        window=SMALL_WINDOW, rescue_window=sp.rescue_window,
        key_s=jnp.asarray(key_s.numpy()), ovf_count=jnp.asarray(ovf_count.numpy()),
        interpret=True)
    act = (st[0][0] < 1e37).numpy()
    assert int(j[3]) == int(dev[3])
    np.testing.assert_array_equal(dev[2].numpy(), np.asarray(j[2]))
    assert int(dev[2].sum()) > 0
    np.testing.assert_allclose(dev[0].numpy()[:, act], np.asarray(j[0])[:, act],
                               rtol=1e-5, atol=1e-6)
    # velocities reach 4 u/s: a component near 0 carries the rounding of
    # the whole vector, so their absolute tolerance is 1e-5
    np.testing.assert_allclose(dev[1].numpy()[:, act], np.asarray(j[1])[:, act],
                               rtol=1e-5, atol=1e-5)


def test_rescue_lists_every_overflow_lane(fast, dense_probe, monkeypatch):
    """Window 128 on the dense probe, a runner's steps with stats: the
    worklist lists every overflow lane of every step (the ring's
    ``n_lanes`` equals its ``n_over``, and the overflow is not 0), and
    no step launches B1 at the rescue window."""
    cfg, probe = dense_probe
    rescue_launches = []
    window_collide_sorted = tstep.window_collide_sorted

    def spy(*a, launch_key="window_collide_sorted", **k):
        if launch_key == tstep._RESCUE_LAUNCHES:
            rescue_launches.append(launch_key)
        return window_collide_sorted(*a, launch_key=launch_key, **k)

    monkeypatch.setattr(tstep, "window_collide_sorted", spy)
    runner = tstep.make_sorted_episode_runner(fast.triangles, cfg, window=SMALL_WINDOW,
                                              resort_every="auto", device="cpu")
    before = twk.LAUNCHES[tstep._RESCUE_LAUNCHES]
    _, ovf = runner(convert.state_from_numpy(probe, device="cpu"), 4, with_stats=True)
    counters = runner.telemetry.records[-1].counters
    assert min(ovf) > 0
    assert counters["n_lanes"].tolist() == counters["n_over"].tolist() == ovf
    assert not rescue_launches
    assert twk.LAUNCHES[tstep._RESCUE_LAUNCHES] == before


def test_phase3_takes_the_unfit_overflow_lanes(fast, dense_probe, monkeypatch):
    """With phase 3 let run and the fit refused on every third lane, phase
    3 receives exactly the overflow lanes that do not fit
    (``overflow & ~fit``) and the worklist lists the others."""
    cfg, probe = dense_probe
    sp, st, out, overflow, ovf_count, key_s = _sorted_inputs(
        fast.triangles, cfg, probe, SMALL_WINDOW)
    plan = tstep._phase2_plan
    seen = {}

    def refuse_some(*a, **k):
        start, count, fit = plan(*a, **k)
        seen["fit"] = fit & (torch.arange(fit.shape[0]) % 3 != 0)
        return start, count, seen["fit"]

    def listed(*a, **k):
        seen["listed"] = int(a[7])  # n_lanes
        return worklist(*a, **k)

    def packed(*a, **k):
        seen["still"] = a[3].clone()
        return packed_rescue(*a, **k)

    worklist, packed_rescue = tstep.window_collide_worklist, tstep._packed_rescue
    monkeypatch.setattr(tstep, "_phase2_plan", refuse_some)
    monkeypatch.setattr(tstep, "_phase3_possible", lambda sp: True)
    monkeypatch.setattr(tstep, "window_collide_worklist", listed)
    monkeypatch.setattr(tstep, "_packed_rescue", packed)
    tstep._device_rescue(tuple(x.clone() for x in out), st, overflow, sp, key_s=key_s,
                         ovf_count=ovf_count, syncs=tstep.HostSyncs())
    want = overflow & ~seen["fit"]
    assert want.any() and (overflow & seen["fit"]).any()
    assert torch.equal(seen["still"], want)
    assert seen["listed"] == int((overflow & seen["fit"]).sum())


def test_worklist_plain_matches_one_lane_per_row(fast, dense_probe):
    """The worklist entry point's plain version writes each listed lane
    with the bits of the window kernel's plain version run with the lane
    alone in a row of 128 (a plan built here by hand), and leaves every
    other lane as it was."""
    cfg, probe = dense_probe
    sp, st, out, overflow, _, _ = _sorted_inputs(fast.triangles, cfg, probe,
                                                 SMALL_WINDOW)
    start, count, fit = tstep._phase2_plan(st, sp)
    lanes, n_lanes = twk.compact_lanes(overflow & fit)
    m = int(n_lanes)
    pick = lanes[:m].long()
    assert m > 8 and bool((overflow & fit)[pick].all())
    assert torch.equal(pick, torch.nonzero(overflow & fit).flatten())
    pos_k, vel_k, hit_k = (x.clone() for x in out)
    kw = dict(w=sp.rescue_window, k_static=sp.meta.max_tris_per_cell,
              gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff)
    twk.window_collide_worklist(*st, start, count, lanes, n_lanes, sp.tables,
                                pos_k, vel_k, hit_k, **kw)

    rows = -(-m // twk.SUB) * twk.SUB
    pick_p = torch.cat([pick, pick[:1].expand(rows - m)])
    c_l, s_l = count[pick_p], start[pick_p]
    first = torch.arange(rows * twk.LANE) % twk.LANE == 0
    cnt = torch.zeros(rows * twk.LANE, dtype=torch.int32)
    cnt[first] = c_l
    rel = torch.zeros_like(cnt)
    rel[first] = s_l % twk.LANE
    ws = ((s_l // twk.LANE) * twk.LANE).reshape(-1, twk.SUB)
    k_cap = c_l.reshape(-1, twk.SUB).max(dim=1).values
    rep = [x[..., pick_p].repeat_interleave(twk.LANE, dim=-1) for x in st]
    pp, vp, hp = twk.window_collide_sorted_plain(*rep, rel, cnt, ws, k_cap,
                                                 sp.tables, **kw)
    assert int(hp[::twk.LANE][:m].sum()) > 0
    assert torch.equal(pos_k[:, pick], pp[:, ::twk.LANE][:, :m])
    assert torch.equal(vel_k[:, pick], vp[:, ::twk.LANE][:, :m])
    assert torch.equal(hit_k[pick], hp[::twk.LANE][:m])
    rest = torch.ones(hit_k.shape[0], dtype=torch.bool)
    rest[pick] = False
    for a, b in zip((pos_k, vel_k, hit_k), out):
        assert torch.equal(a[..., rest], b[..., rest])


@pytest.mark.parametrize("resort_every", ["auto", 3])
def test_runner_matches_jax_with_reads(fast, resort_every):
    """The runner (re-sort on "auto" with threshold 0, so both branches
    run, or every 3rd step) against the JAX package's runner over 47
    steps: state and per-step overflow.  Host reads: the re-sort flag
    under "auto", once a step after step 0; none with a fixed
    ``resort_every``."""
    cfg = fast.config
    kw = dict(resort_every=resort_every)
    if resort_every == "auto":
        kw["resort_threshold"] = 0
    j_run = jstep.make_sorted_episode_runner(fast.triangles, cfg, interpret=True, **kw)
    j_out, j_ovf = j_run(jstate.spawn_grid(cfg, layers_y=1), JAX_RUNNER_STEPS,
                         with_stats=True)
    j_out = jstate.snapshot(j_out)

    runner = tstep.make_sorted_episode_runner(fast.triangles, cfg, device="cpu", **kw)
    assert not runner.graphed and not runner.phase3
    state = spawn_grid(cfg, 1, device="cpu")
    r, ovf = runner(state, JAX_RUNNER_STEPS, with_stats=True)
    assert runner.syncs.count == (JAX_RUNNER_STEPS - 1 if resort_every == "auto" else 0)
    assert ovf == [int(x) for x in j_ovf] and sum(ovf) > 0
    got, mask = snapshot(r), active_mask(state).numpy()
    assert got["collisions"][mask].sum() > 0
    np.testing.assert_array_equal(got["collisions"], j_out["collisions"])
    np.testing.assert_allclose(got["pos"][:, mask], j_out["pos"][:, mask],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["vel"][:, mask], j_out["vel"][:, mask],
                               rtol=1e-5, atol=1e-6)


def _dense_cell_scene(cfg, n_dense: int):
    """A ground triangle and ``n_dense`` small triangles stacked in one
    spot, so one grid cell holds more candidates than the rescue window."""
    rng = np.random.default_rng(3)
    ground = np.array([[[-5.0, -5.0, -5.0], [5.0, -5.0, -5.0], [0.0, -5.0, 5.0]]])
    base = np.array([0.5, 0.0, 0.5]) + rng.uniform(-0.02, 0.02, (n_dense, 1, 3))
    base[:, :, 1] = rng.uniform(0.0, 0.4, (n_dense, 1))
    tri = base + np.array([[0.0, 0.0, 0.0], [0.03, 0.0, 0.0], [0.0, 0.0, 0.03]])
    return np.concatenate([ground, tri]).astype(np.float32)


def test_phase3_scene_keeps_its_reads(fast, monkeypatch):
    """A cell of 2100 candidates outgrows the rescue window (2048): the
    runner says so when it is built (``phase3``; it then steps eagerly,
    never captured) and its packed rescue phase reads its counts on the
    host; its step equals, bit for bit, the per-step step's with the
    rescue looped on the host (``_chunked_rescue``) in place of
    ``_device_rescue``."""
    cfg = fast.config
    tris = _dense_cell_scene(cfg, 2100)
    runner = tstep.make_sorted_episode_runner(tris, cfg, resort_every=1, device="cpu")
    assert runner.phase3 and not runner.graphed
    assert runner.sp.meta.max_tris_per_cell > runner.sp.rescue_window - 127
    n = twk.BLOCK
    pos = np.full((3, n), 1e38, np.float32)
    vel = np.zeros((3, n), np.float32)
    pos[:, :8] = np.array([0.5, 0.3, 0.5])[:, None] + np.linspace(-0.01, 0.01, 8)
    vel[1, :8] = -2.0
    state = ParticleState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                          collisions=torch.zeros(n, dtype=torch.int32),
                          radius=torch.full((n,), 0.2), restitution=torch.full((n,), 0.5))
    packed_lanes = []
    packed = tstep.spatial_collide_packed

    def spy(mini, *a, **k):
        packed_lanes.append(int(k["active"].sum()))
        return packed(mini, *a, **k)

    monkeypatch.setattr(tstep, "spatial_collide_packed", spy)
    r = runner(state, 1)
    assert sum(packed_lanes) >= 8, packed_lanes
    assert runner.syncs.count >= 2  # the still count and a group bound
    step = tstep.make_spatial_step_sorted(tris, cfg, device="cpu")
    monkeypatch.setattr(tstep, "_device_rescue", tstep._chunked_rescue)
    want = step(state)
    assert step.syncs.count >= 3  # the overflow, the still counts
    assert int(want.collisions.sum()) > 0
    for f in ("pos", "vel", "collisions"):
        assert torch.equal(getattr(r, f), getattr(want, f)), f


@pytest.mark.cuda
def test_captured_runner_matches_eager_on_card(fast, dense_probe):
    """On the card: the captured runner ("auto" with threshold 0, and
    every 3rd step) equals the same runner stepping eagerly
    (``uncaptured``) bit for bit, overflows included, with 0 host reads
    a step for a fixed ``resort_every`` and 1 for "auto"; and the
    worklist kernel equals its plain version on the dense probe's
    phase-2 lanes bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = fast.config
    state = spawn_grid(cfg, 1, device="cuda")
    for kw in ({"resort_every": "auto", "resort_threshold": 0}, {"resort_every": 3}):
        runs = []
        for captured in (True, False):
            runner = tstep.make_sorted_episode_runner(fast.triangles, cfg, **kw)
            assert runner.graphed
            if captured:
                runs.append(runner(state, 60, with_stats=True))
            else:
                with tgraphed.uncaptured():
                    runs.append(runner(state, 60, with_stats=True))
            want = 59 if kw["resort_every"] == "auto" else 0
            assert runner.syncs.count == want
        (a, ovf_a), (b, ovf_b) = runs
        assert ovf_a == ovf_b
        for f in ("pos", "vel", "collisions"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (kw, f)

    cfg_p, probe = dense_probe
    sp, st, out, overflow, _, _ = _sorted_inputs(fast.triangles, cfg_p, probe,
                                                 SMALL_WINDOW)
    dev_args = [x.cuda() for x in st]
    sp_c = sp._replace(tables=twk.WindowTables(*(t.cuda() for t in sp.tables)))
    start, count, fit = tstep._phase2_plan(tuple(dev_args), sp_c)
    lanes, n_lanes = twk.compact_lanes(overflow.cuda() & fit)
    kw = dict(w=sp.rescue_window, k_static=sp.meta.max_tris_per_cell,
              gravity=cfg_p.gravity, dt=cfg_p.dt, backoff=cfg_p.backoff)
    res = []
    for fn in (twk.window_collide_worklist, twk.window_collide_worklist_plain):
        o = [x.cuda().clone() for x in out]
        fn(*dev_args, start, count, lanes, n_lanes, sp_c.tables, *o, **kw)
        res.append(o)
    torch.cuda.synchronize()
    assert int(n_lanes) > 0
    for a, b in zip(*res):
        assert torch.equal(a, b)
