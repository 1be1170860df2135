"""PyTorch port, spatial domain decomposition (``parallel/domain.py``) on
gloo ranks on the CPU, mirroring ``tests/test_domain.py``: conservation
of particles through migration and settling (``:39``), the migration
counters at adequate and at tiny capacity (``:79``), ensemble statistics
against the single-device p2p step (``:139``).  Beside them: the port's
domain step against the JAX package's on a 2- and a 4-device ``Mesh``
(the virtual CPU devices of ``tests/conftest.py``) from the same
``distribute`` input, after 1 and 10 steps; ``_pack_subset`` and
``distribute`` against the JAX package's; ``config_5`` at one rank.

Parity tolerance: active masks, overflow statistics and contact counts
exact; positions and velocities at ``rtol=1e-5, atol=1e-6`` (ROADMAP C1:
XLA on the CPU contracts multiply-adds, the port does not).

Ranks are spawned once per test (``parallel/dryrun.py::run_ranks``).
The JAX package is imported inside the functions that use it: the
spawned ranks import this module to find their body and need only the
port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.bench import configs as tconfigs
from particlesystemhybridcollisiondetection_tpu_torch.config import (
    FLOAT_SENTINEL,
    SimConfig,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
    snapshot,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import make_p2p_step
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp
from particlesystemhybridcollisiondetection_tpu_torch.parallel import domain as dom
from particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun import run_ranks

torch.set_num_threads(1)

F = np.float32
TOL = dict(rtol=1e-5, atol=1e-6)


def _state(pos, vel, radius, rest, collisions=None) -> ParticleState:
    """Rows-major numpy inputs ([n, 3]) as a port state on the CPU."""
    n = pos.shape[0]
    if collisions is None:
        collisions = np.zeros((n,), dtype=np.int32)
    return ParticleState(
        pos=torch.from_numpy(np.ascontiguousarray(pos.T, dtype=F)),
        vel=torch.from_numpy(np.ascontiguousarray(vel.T, dtype=F)),
        collisions=torch.from_numpy(np.asarray(collisions, dtype=np.int32)),
        radius=torch.from_numpy(np.asarray(radius, dtype=F)),
        restitution=torch.from_numpy(np.asarray(rest, dtype=F)),
    )


def _active_np(d: dict):
    return np.abs(d["pos"][0]) < FLOAT_SENTINEL * 0.5


def _spawn(tmp_path, body, world, *args) -> dict:
    out_path = tmp_path / "out.npz"
    run_ranks(body, world, str(out_path), *args, device_type="cpu")
    return dict(np.load(out_path))


def _run_domain(dcfg, cfg, inputs, steps, keep=()):
    """In a rank: distribute ``inputs`` (numpy pos, vel, radius,
    restitution), run ``steps`` domain steps on a mesh over the first
    ``dcfg.n_shards`` ranks.  Returns the mesh, the final local state,
    the per-step stats and the gathered snapshots after the steps listed
    in ``keep``; ``None`` in a rank outside the mesh."""
    mesh = dp.make_mesh(dcfg.n_shards, axis_name=dom.AXIS, device_type="cpu")
    if mesh is None:
        return None
    s = dom.shard_domain_state(dom.distribute(_state(*inputs), dcfg), mesh)
    step = dom.make_domain_step(dcfg, cfg, mesh)
    stats, kept = [], {}
    for k in range(1, steps + 1):
        s, st = step(s)
        stats.append(st.numpy())
        if k in keep:
            kept[k] = snapshot(dp.gather_state(s, mesh))
    return mesh, s, np.asarray(stats), kept


# ---- conservation and settling (test_domain.py:39) --------------------------

def _settle_inputs():
    rng = np.random.default_rng(0)
    n = 1024
    pos = np.stack(
        [rng.uniform(1, 31, n), rng.uniform(6, 15, n), rng.uniform(1, 7, n)],
        axis=1,
    ).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    return pos, vel, np.full(n, 0.3, dtype=F), np.full(n, 0.3, dtype=F)


def _settle_rank(rank, world, out_path):
    dcfg = dom.DomainConfig(
        box_lo=(0.0, 0.0, 0.0), box_hi=(32.0, 16.0, 8.0), n_shards=world,
        shard_capacity=512, halo_capacity=128, migrate_capacity=128,
        cell_size=0.7,
    )
    cfg = SimConfig(particle_radius=0.3, dt=0.005, bounciness=0.3)
    _, _, stats, kept = _run_domain(dcfg, cfg, _settle_inputs(), 400,
                                    keep=(400,))
    if rank == 0:
        np.savez(out_path, stats=stats, **kept[400])


def test_domain_step_conserves_particles_and_settles(tmp_path):
    """400 steps of 1024 particles over 4 ranks: none lost, no halo or
    migration overflow, every particle finite and inside the box.  The
    JAX package's test runs 8 devices of one process; here each rank is
    a spawned process that pays an interpreter and PyTorch start-up on a
    host shared with the other test workers, so 4 ranks (slabs 8 units
    wide, twice the JAX test's) keep it inside its time."""
    out = _spawn(tmp_path, _settle_rank, 4)
    act = _active_np(out)
    assert act.sum() == 1024, f"lost particles: {act.sum()} != 1024"
    assert out["stats"][:, 1].sum() == 0, "migration overflow"
    assert out["stats"][:, 0].sum() == 0, "halo overflow"
    p = out["pos"][:, act]
    assert not np.isnan(p).any()
    assert (p[0] >= -0.01).all() and (p[0] <= 32.01).all()
    assert (p[1] >= -0.01).all() and (p[1] <= 16.01).all()
    # settling: the pile sits in the lower half of the box
    assert p[1].mean() < 4.0
    assert out["collisions"].sum() > 0


# ---- migration counters (test_domain.py:79) --------------------------------

def _migration_rank(rank, world, out_path):
    n = 64
    rng = np.random.default_rng(7)
    # no gravity + perfectly elastic walls: particles bounce between the
    # x walls forever, crossing the x=4 slab boundary every few steps
    cfg = SimConfig(particle_radius=0.1, dt=0.05, bounciness=1.0,
                    gravity=(0.0, 0.0, 0.0))
    pos = np.stack(
        [np.full(n, 1.0), rng.uniform(0.5, 3.5, n), rng.uniform(0.5, 3.5, n)],
        axis=1,
    ).astype(F)
    vel = np.zeros((n, 3), dtype=F)
    # identical x and vx: the whole block crosses the slab boundary on
    # the SAME step, so migrations arrive as one n-particle burst
    vel[:, 0] = 6.0
    inputs = (pos, vel, np.full(n, 0.1, dtype=F), np.full(n, 1.0, dtype=F))
    out = {}
    for cap in (128, 8):
        dcfg = dom.DomainConfig(
            box_lo=(0.0, 0.0, 0.0), box_hi=(8.0, 4.0, 4.0), n_shards=world,
            shard_capacity=256, halo_capacity=128, migrate_capacity=cap,
            cell_size=0.7,
        )
        mesh = dp.make_mesh(axis_name=dom.AXIS, device_type="cpu")
        s = dom.shard_domain_state(dom.distribute(_state(*inputs), dcfg), mesh)
        step = dom.make_domain_step(dcfg, cfg, mesh)
        mig_of, occupancy0 = 0, []
        for _ in range(150):
            s, st = step(s)
            mig_of += int(st[1])
            occupancy0.append(int(active_mask(s).sum()) if rank == 0 else 0)
        out[f"mig_of_{cap}"] = np.asarray(mig_of)
        out[f"alive_{cap}"] = np.asarray(dp.sum_ints(int(active_mask(s).sum()), mesh))
        out[f"occ_{cap}"] = np.asarray(occupancy0)
    if rank == 0:
        np.savez(out_path, **out)


def test_migration_stress_counters_zero_at_capacity_loud_below(tmp_path):
    """Particles ping-pong across the slab boundary for 150 steps.  At
    adequate ``migrate_capacity`` the overflow counters stay exactly zero
    and every particle survives; at a deliberately tiny capacity the
    counters go nonzero and account for every lost particle."""
    out = _spawn(tmp_path, _migration_rank, 2)
    assert int(out["mig_of_128"]) == 0, "unexpected migration overflow"
    assert int(out["alive_128"]) == 64, "lost particles at adequate capacity"
    assert len(set(out["occ_128"].tolist())) > 1, "no migration happened"
    lost = 64 - int(out["alive_8"])
    assert int(out["mig_of_8"]) > 0, "overflow was silent at tiny capacity"
    assert lost == int(out["mig_of_8"]), (lost, int(out["mig_of_8"]))


# ---- statistics against one device (test_domain.py:139) --------------------

def _stats_inputs():
    rng = np.random.default_rng(1)
    n = 512
    pos = np.stack(
        [rng.uniform(1, 15, n), rng.uniform(4, 11, n), rng.uniform(1, 7, n)],
        axis=1,
    ).astype(F)
    vel = (rng.normal(size=(n, 3)) * 1).astype(F)
    return pos, vel, np.full(n, 0.35, dtype=F), np.full(n, 0.4, dtype=F)


STATS_CFG = SimConfig(particle_radius=0.35, dt=0.005, bounciness=0.4)


def _stats_dcfg(world, **kw):
    return dom.DomainConfig(
        box_lo=(0.0, 0.0, 0.0), box_hi=(16.0, 12.0, 8.0), n_shards=world,
        shard_capacity=384, halo_capacity=128, migrate_capacity=128,
        cell_size=0.7, grid_capacity=12, **kw)


def _stats_rank(rank, world, out_path):
    _, _, _, kept = _run_domain(_stats_dcfg(world), STATS_CFG, _stats_inputs(),
                                300, keep=(300,))
    if rank == 0:
        np.savez(out_path, **kept[300])


def test_domain_matches_single_device_statistics(tmp_path):
    """The same scenario through 4 ranks and through the single-device
    p2p step: mean height and kinetic energy agree within the JAX test's
    bounds (trajectories diverge chaotically)."""
    pos, vel, radius, rest = _stats_inputs()
    step1 = make_p2p_step((0.0, 0.0, 0.0), (16.0, 12.0, 8.0), STATS_CFG,
                          cell_size=0.7, capacity=12, device="cpu")
    s1 = _state(pos, vel, radius, rest)
    for _ in range(300):
        s1 = step1(s1)
    s1 = snapshot(s1)
    sd = _spawn(tmp_path, _stats_rank, 4)
    ad = _active_np(sd)
    assert ad.sum() == 512
    y1 = s1["pos"][1][_active_np(s1)]
    yd = sd["pos"][1][ad]
    ke1 = (s1["vel"] ** 2).sum()
    ked = (sd["vel"][:, ad] ** 2).sum()
    assert abs(y1.mean() - yd.mean()) < 0.5, (y1.mean(), yd.mean())
    assert 0.5 < (ked + 1e-3) / (ke1 + 1e-3) < 2.0, (ke1, ked)


# ---- parity with the JAX package's domain step ------------------------------

ID_STRIDE = 1000  # collision counters start at id * 1000: slots name ids


def _parity_inputs():
    """The statistics scenario with 8x the velocities, so particles
    cross slab boundaries within 10 steps; each particle's collision
    counter starts at its id times ``ID_STRIDE``, so a slot's counter
    names the particle in it."""
    pos, vel, radius, rest = _stats_inputs()
    ids = np.arange(pos.shape[0], dtype=np.int32) * ID_STRIDE
    return pos, vel * 8, radius, rest, ids


PARITY_STEPS = 10


def _parity_rank(rank, world, out_path, n_shards=None):
    """The parity run on a mesh over the first ``n_shards`` ranks (all of
    them by default); mesh rank 0 saves the stats and the states."""
    run = _run_domain(_stats_dcfg(n_shards or world), STATS_CFG,
                      _parity_inputs(), PARITY_STEPS,
                      keep=range(1, PARITY_STEPS + 1))
    if run is None:
        return
    _, _, stats, kept = run
    if rank == 0:
        np.savez(out_path, stats=stats, **{f"{f}{k}": kept[k][f]
                                           for k in kept for f in kept[k]})


def assert_domain_matches_jax(out: dict, n_shards: int) -> None:
    """Hold the port's domain run of ``_parity_rank`` (``out``, saved by
    mesh rank 0) against the JAX package's domain step on the first
    ``n_shards`` devices: see ``test_domain_step_matches_jax``."""
    import jax
    import jax.numpy as jnp

    from particlesystemhybridcollisiondetection_tpu.config import SimConfig as JSim
    from particlesystemhybridcollisiondetection_tpu.core.state import (
        ParticleState as JState,
    )
    from particlesystemhybridcollisiondetection_tpu.parallel import domain as jdom

    pos, vel, radius, rest, ids = _parity_inputs()
    n = pos.shape[0]
    jcfg = JSim(particle_radius=0.35, dt=0.005, bounciness=0.4)
    dcfg = _stats_dcfg(n_shards)
    jdcfg = jdom.DomainConfig(**dataclasses.asdict(dcfg))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n_shards]), (jdom.AXIS,))
    j0 = jdom.distribute(JState(
        pos=jnp.asarray(pos.T), vel=jnp.asarray(vel.T),
        collisions=jnp.asarray(ids), radius=jnp.asarray(radius),
        restitution=jnp.asarray(rest)), jdcfg)
    jstep = jdom.make_domain_step(jdcfg, jcfg, mesh)

    fields = ("pos", "vel", "collisions", "radius", "restitution")
    port = [{f: np.asarray(getattr(j0, f)) for f in fields}] + [
        {f: out[f"{f}{k}"] for f in fields} for k in range(1, PARITY_STEPS + 1)]

    js = jdom.shard_domain_state(j0, mesh)
    for k in range(1, PARITY_STEPS + 1):
        # free running: exact fields
        js, st = jstep(js)
        want = {f: np.asarray(getattr(js, f)) for f in fields}
        act = _active_np(want)
        assert act.sum() == n
        np.testing.assert_array_equal(out["stats"][k - 1], np.asarray(st),
                                      err_msg=f"step {k}")
        np.testing.assert_array_equal(_active_np(port[k]), act, err_msg=f"step {k}")
        np.testing.assert_array_equal(port[k]["collisions"], want["collisions"],
                                      err_msg=f"step {k}")
        # fed the port's previous state: floats
        fed, _ = jstep(jdom.shard_domain_state(
            JState(**{f: jnp.asarray(v) for f, v in port[k - 1].items()}), mesh))
        for f in ("pos", "vel"):
            np.testing.assert_allclose(port[k][f][:, act],
                                       np.asarray(getattr(fed, f))[:, act],
                                       **TOL, err_msg=f"step {k} {f}")
    # particles migrated: some id sits in another rank's block than at
    # the start, and contacts were counted
    cap = dcfg.shard_capacity

    def owner(d):
        rank = np.full(n, -1)
        live = _active_np(d)
        rank[d["collisions"][live] // ID_STRIDE] = np.nonzero(live)[0] // cap
        return rank

    assert (owner(port[-1]) != owner(port[0])).sum() > 0
    assert (port[-1]["collisions"] % ID_STRIDE).sum() > 0


@pytest.mark.parametrize("world", [2, 4])
def test_domain_step_matches_jax(tmp_path, world):
    """The port's domain step over ``world`` gloo ranks against the JAX
    package's on a ``world``-device mesh, from the same ``distribute``
    input.  Free running for 10 steps, the slot layout (active masks),
    the contact counts and the overflow statistics of every step are
    exact; positions and velocities are within tolerance after step 1,
    and after each later step when the JAX step is fed the port's state
    of the step before (floats of free runs part by rounding over the
    steps: after 10 steps 5 of 1,536 velocity components were 2e-5
    apart).  Particles did migrate."""
    assert_domain_matches_jax(_spawn(tmp_path, _parity_rank, world), world)


# ---- host-side pieces, in this process ---------------------------------------

@pytest.mark.parametrize("case", ["truncate", "exact", "pad", "none", "raw"])
def test_pack_subset_matches_jax(case):
    """``_pack_rows`` (the port's pack, on a state's slot rows) bit for
    bit against the JAX package's ``_pack_subset``: capacity below the
    count (overflow), equal to n, above n (index-0 padding, sentinel
    fill), an empty mask, and no sentinel fill (``fill_sentinel=False``).
    The id row of a sentinel slot is -1; a packed slot keeps its id."""
    import jax.numpy as jnp

    from particlesystemhybridcollisiondetection_tpu.core.state import (
        ParticleState as JState,
    )
    from particlesystemhybridcollisiondetection_tpu.parallel import domain as jdom

    rng = np.random.default_rng(3)
    n = 40
    d = {"pos": rng.normal(size=(3, n)).astype(F),
         "vel": rng.normal(size=(3, n)).astype(F),
         "collisions": rng.integers(0, 9, n).astype(np.int32),
         "radius": rng.uniform(0.1, 0.5, n).astype(F),
         "restitution": rng.uniform(0, 1, n).astype(F)}
    mask = rng.uniform(size=n) < 0.4
    capacity, fill = {"truncate": (5, True), "exact": (n, True),
                      "pad": (64, True), "none": (16, True),
                      "raw": (64, False)}[case]
    if case == "none":
        mask[:] = False
    ids = np.arange(n, dtype=np.int32)
    rows = dom.state_rows(ParticleState(**{k: torch.from_numpy(v) for k, v in d.items()}),
                          torch.from_numpy(ids))
    packed, of = dom._pack_rows(rows, torch.from_numpy(mask), capacity,
                                dom.sentinel_bits("cpu") if fill else None)
    sub, sub_ids = dom.rows_state(packed)
    jsub, jof = jdom._pack_subset(JState(**{k: jnp.asarray(v) for k, v in d.items()}),
                                  jnp.asarray(mask), capacity, fill)
    assert int(of) == int(jof) == max(int(mask.sum()) - capacity, 0)
    for f in d:
        np.testing.assert_array_equal(getattr(sub, f).numpy(),
                                      np.asarray(getattr(jsub, f)), err_msg=f)
    k = min(int(mask.sum()), capacity)
    np.testing.assert_array_equal(sub_ids.numpy()[:k], np.nonzero(mask)[0][:k])
    if fill:
        assert (sub_ids.numpy()[k:] == -1).all()


def test_distribute_and_shard_match_jax():
    """``distribute`` bit for bit against the JAX package's (the same
    truncation and clip, sentinels and padding), its capacity check, and
    ``shard_domain_state`` / ``gather_state`` on a group of one rank."""
    import torch.distributed as dist

    import jax.numpy as jnp

    from particlesystemhybridcollisiondetection_tpu.core.state import (
        ParticleState as JState,
    )
    from particlesystemhybridcollisiondetection_tpu.parallel import domain as jdom

    pos, vel, radius, rest = _stats_inputs()
    pos[:3, 0] = [-1.0, 16.0, 15.999]  # outside and on the box's x range
    ts = _state(pos, vel, radius, rest)
    ts = ts._replace(pos=torch.cat([ts.pos, torch.full((3, 2), FLOAT_SENTINEL)], 1),
                     vel=torch.cat([ts.vel, torch.zeros((3, 2))], 1),
                     collisions=torch.arange(514, dtype=torch.int32),
                     radius=torch.cat([ts.radius, torch.ones(2)]),
                     restitution=torch.cat([ts.restitution, torch.zeros(2)]))
    js = JState(**{k: jnp.asarray(v.numpy()) for k, v in ts._asdict().items()})
    for world in (1, 3, 4):
        dcfg = dataclasses.replace(_stats_dcfg(world), n_shards=world,
                                   shard_capacity=1024)
        jdcfg = jdom.DomainConfig(**dataclasses.asdict(dcfg))
        got = snapshot(dom.distribute(ts, dcfg))
        want = jdom.distribute(js, jdcfg)
        for f in got:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                          err_msg=f"{world} {f}")
    with pytest.raises(ValueError, match="capacity"):
        dom.distribute(ts, dataclasses.replace(_stats_dcfg(1), shard_capacity=128))

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = dp.make_mesh(axis_name=dom.AXIS, device_type="cpu")
        glob = dom.distribute(ts, dataclasses.replace(_stats_dcfg(1),
                                                      shard_capacity=1024))
        local = dom.shard_domain_state(glob, mesh)
        for a, b in zip(dp.gather_state(local, mesh), glob):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="2 shards"):
            dom.make_domain_step(_stats_dcfg(2), STATS_CFG, mesh)
        # one rank: no exchange, the step runs and keeps every particle
        s, st = dom.make_domain_step(dataclasses.replace(
            _stats_dcfg(1), shard_capacity=1024), STATS_CFG, mesh)(local)
        assert st.tolist() == [0, 0, 0]
        assert int(active_mask(s).sum()) == 512
    finally:
        dist.destroy_process_group()


def test_config_5_one_rank():
    """``config_5`` run alone makes (and removes) a group of one rank:
    5,000 heterogeneous particles on the domain runner, 2 timed steps,
    every particle kept, no overflow over the steps run, the backend and
    the count alive."""
    import torch.distributed as dist

    out = tconfigs.config_5(steps=2, n=5000, device="cpu")
    assert not dist.is_initialized()
    assert out["config"] == 5 and out["particles"] == 5000
    assert out["shards"] == 1 and out["backend"] == "gloo"
    assert out["active_particles"] == 5000
    assert out["halo_overflow"] == 0
    assert out["migrate_overflow"] == 0
    assert out["cell_overflow"] == 0
    assert out["steps_per_sec"] > 0
    with pytest.raises(ValueError, match="n_shards"):
        tconfigs.config_5(steps=1, n=1000, n_shards=2, device="cpu")
