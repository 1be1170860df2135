"""PyTorch port, particle-particle collisions: the slot, all-pairs and
dense variants, the box walls, the gravity-box state and ``make_p2p_step``
(every variant) against the JAX package on the same NumPy inputs, and
against the O(N^2) NumPy oracle of the contact model.

Tolerances are those of the JAX package's own p2p tests
(tests/test_p2p.py): contact counts exact, pos rtol=1e-5 atol=1e-5, vel
rtol=1e-4 atol=1e-5 (XLA on the CPU fuses multiply-adds, the port does
not, so floats are not bitwise).  Integer results and the wall response
are bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.bench import configs as jconfigs
from particlesystemhybridcollisiondetection_tpu.config import SimConfig as JSimConfig
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core.step import (
    make_p2p_step as j_make_p2p_step,
)
from particlesystemhybridcollisiondetection_tpu.ops import p2p as jp2p
from particlesystemhybridcollisiondetection_tpu.ops import p2p_sorted as jp2ps
from particlesystemhybridcollisiondetection_tpu.ops import pgrid as jpg
from particlesystemhybridcollisiondetection_tpu.ops.integrate import (
    integrate as j_integrate,
)
from particlesystemhybridcollisiondetection_tpu.ops.p2p_dense import (
    p2p_collide_dense as j_p2p_collide_dense,
)
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.bench import configs as tconfigs
from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import snapshot as tstate_snapshot
from particlesystemhybridcollisiondetection_tpu_torch.core.step import make_p2p_step
from particlesystemhybridcollisiondetection_tpu_torch.geometry import scenes as tscenes
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p as tp2p
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as tpg
from particlesystemhybridcollisiondetection_tpu_torch.ops.p2p_dense import (
    p2p_collide_dense,
)

# The suite runs several workers side by side; with PyTorch's default of
# one thread per core in each of them, the many small CPU ops of the
# port's plain paths spend their time contending for cores.
torch.set_num_threads(1)

F = np.float32
POS_TOL = dict(rtol=1e-5, atol=1e-5)
VEL_TOL = dict(rtol=1e-4, atol=1e-5)


def brute_force_p2p(pos, vel, radius, restitution, beta=0.5):
    """O(N^2) NumPy oracle of the documented impulse model (float64
    accumulation), as in the JAX package's tests."""
    n = len(pos)
    mass = radius**3
    dv = np.zeros_like(vel)
    dp = np.zeros_like(pos)
    contacts = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            d = pos[i] - pos[j]
            dist2 = float(d @ d)
            rsum = radius[i] + radius[j]
            if dist2 >= rsum * rsum or dist2 == 0.0:
                continue
            dist = np.sqrt(dist2)
            nrm = d / dist
            vn = float((vel[i] - vel[j]) @ nrm)
            e = 0.5 * (restitution[i] + restitution[j])
            w = mass[j] / (mass[i] + mass[j])
            if vn < 0.0:
                dv[i] += nrm * (-(1.0 + e) * vn * w)
            dp[i] += nrm * (beta * (rsum - dist) * w)
            contacts[i] += 1
    return pos + dp, vel + dv, contacts


def snap(pos, vel, radius, rest):
    """State dict in the JAX package's snapshot form; pos, vel [n, 3]."""
    return dict(
        pos=np.ascontiguousarray(pos.T, dtype=F),
        vel=np.ascontiguousarray(vel.T, dtype=F),
        collisions=np.zeros((pos.shape[0],), dtype=np.int32),
        radius=np.asarray(radius, dtype=F),
        restitution=np.asarray(rest, dtype=F),
    )


def both(d):
    """(JAX state, port state on the CPU) from one snapshot dict."""
    j = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    return j, convert.state_from_numpy(d, device="cpu")


def hetero_cloud(seed, n=96):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, 7.5, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    radius = rng.uniform(0.15, 0.3, size=n).astype(F)
    rest = rng.uniform(0.2, 0.8, size=n).astype(F)
    return pos, vel, radius, rest


def assert_states_close(t, j, pos_tol=POS_TOL, vel_tol=VEL_TOL):
    np.testing.assert_array_equal(t.collisions.numpy(), np.asarray(j.collisions))
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), **pos_tol)
    np.testing.assert_allclose(t.vel.numpy(), np.asarray(j.vel), **vel_tol)


def assert_matches_oracle(t, ref_pos, ref_vel, ref_ct):
    np.testing.assert_array_equal(t.collisions.numpy(), ref_ct)
    np.testing.assert_allclose(t.pos.numpy().T, ref_pos, **POS_TOL)
    np.testing.assert_allclose(t.vel.numpy().T, ref_vel, **VEL_TOL)


META_ARGS = ((0, 0, 0), (8, 8, 8), 0.6, 6)  # no cell holds more than 6


@pytest.mark.parametrize("variant", ["slots", "dense", "allpairs"])
def test_variant_matches_jax_and_oracle(variant):
    cloud = hetero_cloud({"slots": 0, "dense": 4, "allpairs": 3}[variant])
    oracle = brute_force_p2p(*cloud)
    assert oracle[2].sum() > 0
    js, ts = both(snap(*cloud))
    jm, tm = jpg.make_meta(*META_ARGS), tpg.make_meta(*META_ARGS)
    if variant == "slots":
        (jo, jov), (to, tov) = jp2p.p2p_collide(js, jm), tp2p.p2p_collide(ts, tm)
    elif variant == "dense":
        (jo, jov), (to, tov) = j_p2p_collide_dense(js, jm), p2p_collide_dense(ts, tm)
    else:
        jo, to = jp2p.p2p_collide_allpairs(js), tp2p.p2p_collide_allpairs(ts)
        jov = tov = 0
    assert int(tov) == int(jov) == 0
    assert_states_close(to, jo)
    assert_matches_oracle(to, *oracle)


@pytest.mark.parametrize("variant", ["slots", "dense"])
def test_saturated_cells_drop_like_jax(variant):
    """Capacity 2 in a crowded box: both packages drop the same particles
    (equal overflow count, equal contact counts)."""
    cloud = hetero_cloud(5, n=160)
    js, ts = both(snap(*cloud))
    args = ((0, 0, 0), (8, 8, 8), 0.9, 2)
    jm, tm = jpg.make_meta(*args), tpg.make_meta(*args)
    act = np.ones(160, dtype=bool)
    act[150:] = False
    if variant == "slots":
        jo, jov = jp2p.p2p_collide(js, jm, active=jnp.asarray(act))
        to, tov = tp2p.p2p_collide(ts, tm, active=torch.from_numpy(act))
    else:
        jo, jov = j_p2p_collide_dense(js, jm, active=jnp.asarray(act))
        to, tov = p2p_collide_dense(ts, tm, active=torch.from_numpy(act))
    assert int(tov) == int(jov) > 0
    assert_states_close(to, jo)
    assert (to.collisions[150:] == 0).all()


def test_slots_momentum_conserved():
    rng = np.random.default_rng(1)
    n = 64
    pos = rng.uniform(0, 3, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 3).astype(F)
    radius = np.full(n, 0.35, dtype=F)
    _, ts = both(snap(pos, vel, radius, np.full(n, 0.9, dtype=F)))
    out, overflow = tp2p.p2p_collide(
        ts, tpg.make_meta((-1, -1, -1), (4, 4, 4), 0.7, capacity=32))
    assert int(overflow) == 0 and int(out.collisions.sum()) > 0
    m = radius**3
    np.testing.assert_allclose((m[None] * out.vel.numpy()).sum(axis=1),
                               (m[None] * vel.T).sum(axis=1), rtol=1e-3, atol=1e-3)


def test_box_walls_collide_bitwise():
    """Every wall and corner, hits and misses; 1e38 sentinels never count
    a hit on the low walls and bounce nowhere."""
    rng = np.random.default_rng(7)
    n = 2000
    pos = rng.uniform(-0.5, 6.5, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 3).astype(F)
    pos[-20:] = 1.0e38
    vel[-20:] = 0.0
    radius = rng.uniform(0.1, 0.4, size=n).astype(F)
    rest = rng.uniform(0.2, 0.9, size=n).astype(F)
    js, ts = both(snap(pos, vel, radius, rest))
    g = np.asarray([0.0, -9.81, 0.0], dtype=F)
    lo, hi = (0.0, 0.0, 0.0), (6.0, 5.0, 6.0)
    for dt in (0.005, 0.01):
        jo = jp2p.box_walls_collide(js, lo, hi, jnp.asarray(g), dt)
        to = tp2p.box_walls_collide(ts, lo, hi, torch.from_numpy(g), dt)
        np.testing.assert_array_equal(to.pos.numpy(), np.asarray(jo.pos))
        np.testing.assert_array_equal(to.vel.numpy(), np.asarray(jo.vel))
        np.testing.assert_array_equal(to.collisions.numpy(), np.asarray(jo.collisions))
        assert 0 < int(to.collisions.sum()) < n
        assert (to.collisions[-20:] == 0).all()


@pytest.mark.parametrize("kw", [
    dict(n=1000, box_hi=(16.0, 24.0, 16.0), radius=0.4, restitution=0.3),
    dict(n=777, box_hi=(40.0, 80.0, 40.0), radius=0.4, restitution=0.3,
         seed=3, hetero=True),
])
def test_box_state_bitwise(kw):
    kw = dict(kw)
    args = (kw.pop("n"), (0.0, 0.0, 0.0), kw.pop("box_hi"), kw.pop("radius"),
            kw.pop("restitution"))
    a = tstate_snapshot(tconfigs._box_state(*args, device="cpu", **kw))
    b = jstate.snapshot(jconfigs._box_state(*args, **kw))
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_kernel_step(box_lo, box_hi, cfg, meta):
    """make_p2p_step(variant="kernel") of the JAX package, composed by
    hand with the Pallas kernel in interpret mode (its jitted step runs
    the kernel compiled, which needs a TPU)."""
    gravity = jnp.asarray(cfg.gravity, dtype=jnp.float32)

    def step(s):
        s, _ = jp2ps.p2p_collide_window(s, meta, active=jstate.active_mask(s),
                                        interpret=True)
        s = jp2p.box_walls_collide(s, box_lo, box_hi, gravity, cfg.dt)
        p, v = j_integrate(s.pos, s.vel, gravity, cfg.dt)
        return s._replace(pos=p, vel=v)

    return step


@pytest.mark.parametrize("variant", ["kernel", "sorted", "slots", "dense"])
def test_make_p2p_step_matches_jax_over_4_steps(variant):
    """The slice as a whole: collide -> walls -> integrate, 4 steps, 500
    particles of which 20 are sentinels, some resting on walls.  pos
    rtol/atol 1e-4, vel rtol 1e-3 atol 1e-4 (the multi-step tolerances
    of the JAX package's runner test), counts exact."""
    rng = np.random.default_rng(13)
    n = 500
    pos = rng.uniform(0.05, 5.95, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    pos[-20:] = 1.0e38
    vel[-20:] = 0.0
    d = snap(pos, vel, np.full(n, 0.12, dtype=F), np.full(n, 0.7, dtype=F))
    js, ts = both(d)
    box = ((0, 0, 0), (6, 6, 6))
    kw = dict(particle_radius=0.12, dt=0.004)
    tstep = make_p2p_step(*box, SimConfig(**kw), variant=variant, capacity=4,
                          with_stats=True, device="cpu")
    assert tstep.variant == variant
    if variant == "kernel":
        jstep = _jax_kernel_step(*box, JSimConfig(**kw),
                                 jpg.make_meta(*box, 0.24, capacity=4))
    else:
        jstep = j_make_p2p_step(*box, JSimConfig(**kw), variant=variant,
                                capacity=4)
    for _ in range(4):
        js = jstep(js)
        ts, stats = tstep(ts)
        assert int(stats["cell_overflow"]) == 0
    assert_states_close(ts, js, pos_tol=dict(rtol=1e-4, atol=1e-4),
                        vel_tol=dict(rtol=1e-3, atol=1e-4))
    assert int(ts.collisions.sum()) > 0
    assert (ts.collisions[-20:] == 0).all()
    assert torch.isfinite(ts.vel).all()
    assert (ts.pos[0, -20:] == 1.0e38).all()


def test_make_p2p_step_auto_and_refusals():
    cfg = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)
    # on the CPU "auto" is the sorted variant; two cells in z -> slots
    assert make_p2p_step((0, 0, 0), (8, 8, 8), cfg, device="cpu").variant == "sorted"
    assert make_p2p_step((0, 0, 0), (8, 8, 1.6), cfg, device="cpu").variant == "slots"
    with pytest.raises(ValueError, match="z"):
        make_p2p_step((0, 0, 0), (8, 8, 1.6), cfg, variant="kernel", device="cpu")
    with pytest.raises(ValueError, match="cell_size"):
        make_p2p_step((0, 0, 0), (8, 8, 8), cfg, cell_size=0.5, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        make_p2p_step((0, 0, 0), (8, 8, 8), cfg, variant="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_p2p_step((0, 0, 0), (8, 8, 8), cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tconfigs._box_state(10, (0, 0, 0), (8, 8, 8), 0.4, 0.3)


def test_configs_run_small_and_unported_raise(monkeypatch, tmp_path):
    out = tconfigs.config_2(steps=3, n=400, device="cpu")
    assert out["config"] == 2 and out["particles"] == 400
    assert out["variant"] == "sorted" and out["cell_overflow_last_step"] == 0
    out = tconfigs.config_1(steps=2, n=128, device="cpu")
    assert out["config"] == 1 and out["grid_steps_per_sec"] > 0
    assert set(tconfigs.CONFIGS) == {1, 2, 3, 4, 5}
    # config 3 (hybrid) is ported; without the bunny mesh it cannot load
    monkeypatch.setattr(tscenes, "_REFERENCE_MESH_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tconfigs.CONFIGS[3](device="cpu")
    # config 5 (the domain-decomposed box) is ported: alone it runs as a
    # group of one rank (tests/test_torch_domain.py holds it further)
    out = tconfigs.CONFIGS[5](steps=1, n=2000, device="cpu")
    assert out["config"] == 5 and out["active_particles"] == 2000
