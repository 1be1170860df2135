"""PyTorch port, the gravity box's control flow on the device, on the CPU:
the window path's fallback sized on the device (``_p2p_device_fallback``:
one launch of the p2p kernel's worklist entry point over a list compacted
on the device; here its plain version) against the fallback looped on the
host (``_p2p_chunked_fallback``) bit for bit and against the JAX
package's ``_p2p_chunked_fallback`` (the Pallas kernel in interpret mode);
the CSR offsets without ``torch.bincount``; and the p2p runner and the
"kernel" step with no host read, against the JAX package's runner and
step.  Small sizes: the 1-2 block cases of ``test_torch_p2p_sorted.py``.
The captured graphs and the worklist kernel itself run only on the card
(``-m cuda``).

Tolerances against the JAX package are those of its own p2p tests
(tests/test_p2p.py): counts exact, pos rtol=1e-5 atol=1e-5, vel rtol=1e-4
atol=1e-5; over 4 steps pos 1e-4/1e-4, vel rtol=1e-3 atol=1e-4."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.config import SimConfig as JSimConfig
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core.step import (
    make_p2p_episode_runner as j_make_p2p_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu.ops import p2p as jp2p
from particlesystemhybridcollisiondetection_tpu.ops import p2p_sorted as jp2ps
from particlesystemhybridcollisiondetection_tpu.ops.integrate import (
    integrate as j_integrate,
)
from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as tgraphed
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan as tplan
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as tp2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as tpg
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    p2p_window_kernel as tk,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

from test_torch_p2p import (
    F,
    POS_TOL,
    VEL_TOL,
    assert_matches_oracle,
    assert_states_close,
    both,
    brute_force_p2p,
    hetero_cloud,
    snap,
)
from test_torch_p2p_sorted import CASES, metas

STEP_TOL = dict(pos_tol=dict(rtol=1e-4, atol=1e-4), vel_tol=dict(rtol=1e-3, atol=1e-4))


def _all_lanes_parts():
    """Every lane of one block marked as overflowed, the kernel's output
    thrown away (as in test_torch_p2p_sorted.py's clamped-chunk test)."""
    cloud = hetero_cloud(10, n=192)
    tm = tpg.make_meta((0, 0, 0), (8, 8, 8), 0.6, capacity=16)
    _, ts = both(snap(*cloud))
    parts = tp2ps.p2p_window_phase1(ts, tm)
    return ts, parts._replace(
        pos_k=torch.full_like(parts.pos_k, 7.0),
        vel_k=torch.full_like(parts.vel_k, 7.0),
        ncon_k=torch.full_like(parts.ncon_k, 7),
        overflow=torch.ones_like(parts.overflow)), cloud


def _case_parts(case, window):
    d, margs = CASES[case]()
    _, tm = metas(margs)
    _, ts = both(d)
    return ts, tp2ps.p2p_window_phase1(ts, tm, active=active_mask(ts), window=window)


def _own(parts):
    """The parts with their own copy of the results (both fallbacks write
    into them in place)."""
    return parts._replace(pos_k=parts.pos_k.clone(), vel_k=parts.vel_k.clone(),
                          ncon_k=parts.ncon_k.clone())


@pytest.mark.parametrize("case,window,chunk", [
    ("gradient", 64, 100), ("gradient", 128, 64),
    ("two_blocks", 64, 100), ("two_blocks", 128, 64),
    ("all_lanes", 512, 400),
])
def test_device_fallback_equals_host_looped_bitwise(case, window, chunk):
    """The device-sized fallback equals the host-looped one on every lane,
    bit for bit, whatever the host loop's chunk size: lanes are
    independent, and each sums its candidates in the same order.  In the
    "all_lanes" case the host loop's third chunk starts clamped to 624,
    overlapping the second.  Sentinel and pad lanes are never listed."""
    if case == "all_lanes":
        ts, parts, cloud = _all_lanes_parts()
    else:
        ts, parts = _case_parts(case, window)
    syncs = tstep.HostSyncs()
    *ref, n_ref = tp2ps._p2p_chunked_fallback(_own(parts), 0.5, chunk, syncs)
    before = dict(tk.LAUNCHES)
    *got, n_over = tp2ps._p2p_device_fallback(_own(parts), 0.5)
    assert tk.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert n_over.dtype == torch.int32 and n_over.dim() == 0
    assert int(n_over) == n_ref > chunk
    assert syncs.count == 1 + 9 * -(-n_ref // chunk)
    for a, b, what in zip(got, ref, ("pos", "vel", "ncon")):
        assert torch.equal(a, b), what
    if case == "all_lanes":
        assert_matches_oracle(tp2ps._unsort(ts, *got, parts.perm),
                              *brute_force_p2p(*cloud))
        return
    lanes, n_lanes = twk.compact_lanes(parts.overflow)
    parked = parts.cid_s == parts.meta.num_cells
    assert not (parts.overflow & parked).any()
    assert not parked[lanes[:int(n_lanes)].long()].any()
    if case == "two_blocks":
        assert int(parked.sum()) == 60 + (2048 - 1400)  # sentinels + pads


@pytest.mark.parametrize("case,window", [
    ("gradient", 128), ("two_blocks", 128),
])
def test_device_fallback_matches_jax_fallback(case, window):
    """Phase 1 and the device-sized fallback against the JAX package's
    phase 1 and ``_p2p_chunked_fallback`` on the same inputs: the same
    overflow count, contact counts exact, pos and vel within the JAX
    package's p2p tolerances on every lane.  (The Pallas kernel's window
    is at least 128.)"""
    d, margs = CASES[case]()
    jm, tm = metas(margs)
    js, ts = both(d)
    jparts = jp2ps.p2p_window_phase1(js, jm, active=jstate.active_mask(js),
                                     window=window, interpret=True)
    # one chunk (the JAX loop's chunk may not exceed the lanes)
    j_pos, j_vel, j_ncon, j_over = jp2ps._p2p_chunked_fallback(
        jparts[:3], *jparts[3:7], 0.5, jparts[3].shape[-1])
    parts = tp2ps.p2p_window_phase1(ts, tm, active=active_mask(ts), window=window)
    pos, vel, ncon, n_over = tp2ps._p2p_device_fallback(parts, 0.5)
    assert int(n_over) == int(j_over) > 0
    np.testing.assert_array_equal(ncon.numpy(), np.asarray(j_ncon))
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), **POS_TOL)
    np.testing.assert_allclose(vel.numpy(), np.asarray(j_vel), **VEL_TOL)
    assert int(ncon.sum()) > 0


@pytest.mark.parametrize("case,window,stride", [
    ("gradient", 128, 7), ("two_blocks", 128, 5), ("gradient", 128, 97),
])
def test_worklist_plain_matches_jax_fallback_on_sparse_list(case, window, stride):
    """The worklist entry point's plain version on a sparse list (every
    ``stride``-th overflow lane, so a chunk's runs lie far apart) against
    the JAX package's ``_p2p_chunked_fallback`` with only those lanes
    marked: the same lanes redone, the rest left as phase 1 wrote them;
    contact counts exact, pos and vel within the JAX package's p2p
    tolerances on every lane."""
    d, margs = CASES[case]()
    jm, tm = metas(margs)
    js, ts = both(d)
    jparts = jp2ps.p2p_window_phase1(js, jm, active=jstate.active_mask(js),
                                     window=window, interpret=True)
    parts = tp2ps.p2p_window_phase1(ts, tm, active=active_mask(ts), window=window)
    listed = parts.overflow.nonzero()[:, 0][::stride]
    keep = torch.zeros_like(parts.overflow)
    keep[listed] = True
    assert 0 < listed.numel() < int(parts.overflow.sum())
    j_pos, j_vel, j_ncon, j_over = jp2ps._p2p_chunked_fallback(
        jparts[:3], *jparts[3:6], jnp.asarray(keep.numpy()), 0.5, jparts[3].shape[-1])
    assert int(j_over) == listed.numel()
    lanes, n_lanes = twk.compact_lanes(keep)
    p = _own(parts)
    tk.p2p_collide_worklist_plain(p.rows_s, p.cid_s, p.offsets, p.meta, lanes, n_lanes,
                                  p.pos_k, p.vel_k, p.ncon_k, beta=0.5)
    np.testing.assert_array_equal(p.ncon_k.numpy(), np.asarray(j_ncon))
    np.testing.assert_allclose(p.pos_k.numpy(), np.asarray(j_pos), **POS_TOL)
    np.testing.assert_allclose(p.vel_k.numpy(), np.asarray(j_vel), **VEL_TOL)
    untouched = ~keep
    for a, b in zip((p.pos_k, p.vel_k, p.ncon_k), (parts.pos_k, parts.vel_k, parts.ncon_k)):
        assert torch.equal(a[..., untouched], b[..., untouched])
    assert int(p.ncon_k[listed].sum()) > 0


def test_worklist_wrapper_refuses_rows_past_32_bit_offsets():
    """The worklist kernel reads the rows [8, N] at 32-bit element
    offsets: the wrapper refuses an N whose 8 rows do not fit, on either
    route, and takes the largest that does (zero-stride views, nothing
    allocated at that size)."""
    _, parts = _case_parts("gradient", 64)
    lanes, n_lanes = twk.compact_lanes(parts.overflow)
    for n, ok in ((tk.MAX_WORKLIST_LANES + 1, False), (2**31 // 6, False),
                  (tk.MAX_WORKLIST_LANES, True)):
        f32, i32 = torch.zeros(1), torch.zeros(1, dtype=torch.int32)
        args = (f32.expand(8, n), i32.expand(n), parts.offsets, parts.meta,
                i32.expand(n), n_lanes.new_zeros(()), f32.expand(3, n),
                f32.expand(3, n), i32.expand(n))
        if ok:
            tk.p2p_collide_worklist(*args, beta=0.5)  # an empty list: no lane
        else:
            with pytest.raises(ValueError, match="32-bit"):
                tk.p2p_collide_worklist(*args, beta=0.5)
    with pytest.raises(ValueError, match="32-bit"):
        tk.p2p_collide_worklist(torch.empty(8, 2**28, device="meta"),
                                torch.empty(2**28, dtype=torch.int32, device="meta"),
                                *args[2:], beta=0.5)


@pytest.mark.parametrize("keys", ["random", "parked", "one_cell"])
def test_csr_offsets_bitwise(keys):
    """``csr_offsets`` (integer scatter-add and cumsum, no host read)
    equals the ``torch.bincount`` form it replaced and the JAX package's
    form (``ops/p2p_sorted.py::_phase1_core``) bit for bit, for keys in
    any order, empty cells and parked particles (key C) included."""
    c = 60
    rng = np.random.default_rng(5)
    key = {"random": rng.integers(0, c + 1, size=3000),
           "parked": np.full(1024, c),
           "one_cell": np.full(777, 17)}[keys].astype(np.int32)
    got = tplan.csr_offsets(torch.from_numpy(key), c)
    assert got.dtype == torch.int32 and tuple(got.shape) == (c + 2,)
    counts = torch.bincount(torch.from_numpy(key), minlength=c + 1)
    old = torch.cat([torch.zeros((1,), dtype=torch.int32),
                     torch.cumsum(counts, 0).to(torch.int32)])
    assert torch.equal(got, old)
    j_counts = jnp.zeros((c + 1,), jnp.int32).at[jnp.asarray(key)].add(1)
    j_off = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                             jnp.cumsum(j_counts, dtype=jnp.int32)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_off))
    assert int(got[c + 1]) == len(key)


def _box_cloud():
    """test_torch_p2p_sorted.py's runner inputs: 500 particles in a box of
    6, radius 0.12 (padded to one block inside)."""
    rng = np.random.default_rng(13)
    n = 500
    pos = rng.uniform(0.6, 5.4, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    return snap(pos, vel, np.full(n, 0.12, dtype=F), np.full(n, 0.7, dtype=F))


BOX = ((0, 0, 0), (6, 6, 6))
BOX_CFG = dict(particle_radius=0.12, dt=0.004)


@pytest.mark.parametrize("window", [512, 128])
def test_runner_reads_nothing_and_matches_jax_runner(window):
    """The p2p runner, 4 steps: no host read, the per-step overflows of
    the JAX package's runner (at window 128 lanes overflow every step),
    its state within the 4-step tolerances, and the port's own per-step
    "kernel" step bit for bit (the same code, the order restored per
    step instead of once)."""
    js, ts = both(_box_cloud())
    run = tstep.make_p2p_episode_runner(*BOX, SimConfig(**BOX_CFG), window=window,
                                        device="cpu")
    assert not run.graphed
    to, ovf = run(ts, 4, with_stats=True)
    assert run.steps == 4 and run.syncs.count == 0
    # chunks of one block: the JAX loop's chunk may not exceed the lanes
    jrun = j_make_p2p_episode_runner(*BOX, JSimConfig(**BOX_CFG), window=window,
                                     fallback_capacity=1024, interpret=True)
    jo = jrun(js, 4)
    assert_states_close(to, jo, **STEP_TOL)
    assert (min(ovf) > 0) == (window == 128)
    step = tstep.make_p2p_step(*BOX, SimConfig(**BOX_CFG), variant="kernel",
                               window=window, with_stats=True, device="cpu")
    ref, ref_ovf = ts, []
    for _ in range(4):
        ref, st = step(ref)
        ref_ovf.append(int(st["cell_overflow"]))
    assert step.syncs.count == 0
    assert ovf == ref_ovf
    np.testing.assert_array_equal(to.collisions.numpy(), ref.collisions.numpy())
    np.testing.assert_allclose(to.pos.numpy(), ref.pos.numpy(), **STEP_TOL["pos_tol"])
    np.testing.assert_allclose(to.vel.numpy(), ref.vel.numpy(), **STEP_TOL["vel_tol"])
    assert int(to.collisions.sum()) > 0



def _dense_box_cloud():
    """2,000 particles of radius 0.12 in a box of 4 (seed 13): cells of
    0.24 hold several particles, so the order within a cell decides the
    order of a particle's contact sums."""
    rng = np.random.default_rng(13)
    n = 2000
    pos = rng.uniform(0.6, 3.4, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    return snap(pos, vel, np.full(n, 0.12, dtype=F), np.full(n, 0.7, dtype=F))


def test_runner_split_calls_match_jax_split_calls():
    """The p2p runner called for 12 then 8 steps against the JAX
    package's runner called the same way, from one spawn: within the
    4-step tolerances, contacts exact.  Both runners restore the original
    order at the end of each call (the JAX package's
    ``core/step.py:554-569``), so the second call sorts each cell's
    particles from the original order instead of the carried one and
    sums some contacts in another order: in each package the split run
    differs from one call of 20 steps in some bits.  That is the
    reference's behaviour, not the port's."""
    box = ((0, 0, 0), (4, 4, 4))
    js, ts = both(_dense_box_cloud())
    run = tstep.make_p2p_episode_runner(*box, SimConfig(**BOX_CFG), window=512,
                                        device="cpu")
    jrun = j_make_p2p_episode_runner(*box, JSimConfig(**BOX_CFG), window=512,
                                     fallback_capacity=1024, interpret=True)
    split, j_split = run(run(ts, 12), 8), jrun(jrun(js, 12), 8)
    assert_states_close(split, j_split, **STEP_TOL)
    assert int(split.collisions.sum()) > 0
    one, j_one = run(ts, 20), jrun(js, 20)
    for a, b in ((split, one), (j_split, j_one)):
        np.testing.assert_array_equal(np.asarray(a.collisions), np.asarray(b.collisions))
        assert (np.asarray(a.vel) != np.asarray(b.vel)).any()
        np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                                   **STEP_TOL["vel_tol"])

def _jax_kernel_step(cfg, meta, window):
    """The JAX package's make_p2p_step(variant="kernel"), composed by hand
    with the Pallas kernel in interpret mode; returns its overflow."""
    gravity = jnp.asarray(cfg.gravity, dtype=jnp.float32)

    def step(s):
        s, n_over = jp2ps.p2p_collide_window(
            s, meta, active=jstate.active_mask(s), window=window,
            fallback_capacity=1024, interpret=True)
        s = jp2p.box_walls_collide(s, *BOX, gravity, cfg.dt)
        p, v = j_integrate(s.pos, s.vel, gravity, cfg.dt)
        return s._replace(pos=p, vel=v), n_over

    return step


@pytest.mark.parametrize("window", [512, 128])
def test_kernel_step_reads_nothing_and_matches_jax_step(window):
    """make_p2p_step(variant="kernel"), 4 steps: no host read, its overflow
    an i32 device scalar equal to the JAX step's each step, the state
    within the 4-step tolerances."""
    from particlesystemhybridcollisiondetection_tpu.ops import pgrid as jpg

    js, ts = both(_box_cloud())
    step = tstep.make_p2p_step(*BOX, SimConfig(**BOX_CFG), variant="kernel",
                               window=window, with_stats=True, device="cpu")
    jstep = _jax_kernel_step(JSimConfig(**BOX_CFG),
                             jpg.make_meta(*BOX, 0.24, capacity=8), window)
    for _ in range(4):
        ts, st = step(ts)
        js, j_over = jstep(js)
        ovf = st["cell_overflow"]
        assert ovf.dtype == torch.int32 and ovf.dim() == 0
        assert int(ovf) == int(j_over)
        assert (int(ovf) > 0) == (window == 128)
    assert step.syncs.count == 0
    assert_states_close(ts, js, **STEP_TOL)
    assert int(ts.collisions.sum()) > 0


@pytest.mark.cuda
def test_captured_p2p_matches_eager_on_card():
    """On the card: the captured runner (windows 512 and 128, where lanes
    overflow) and the captured "kernel" step equal the same code stepping
    eagerly (``uncaptured``) bit for bit, overflows included, with no host
    read; and the worklist kernel equals its plain version and the
    host-looped fallback on every lane, over every overflow lane, a sparse
    list, one lane and none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from particlesystemhybridcollisiondetection_tpu_torch import convert

    state = convert.state_from_numpy(_box_cloud(), device="cuda")
    cfg = SimConfig(**BOX_CFG)
    for window in (512, 128):
        runs = []
        for captured in (True, False):
            run = tstep.make_p2p_episode_runner(*BOX, cfg, window=window)
            assert run.graphed
            if captured:
                runs.append(run(state, 12, with_stats=True))
                assert sum(run.launches.values()) == 2  # the kernel, the worklist
            else:
                with tgraphed.uncaptured():
                    runs.append(run(state, 12, with_stats=True))
            assert run.syncs.count == 0
        (a, ovf_a), (b, ovf_b) = runs
        assert ovf_a == ovf_b and (min(ovf_a) > 0) == (window == 128)
        for f in ("pos", "vel", "collisions"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (window, f)

        outs = []
        for captured in (True, False):
            step = tstep.make_p2p_step(*BOX, cfg, window=window, with_stats=True)
            assert step.variant == "kernel"
            s, ovf = state, []
            with contextlib.nullcontext() if captured else tgraphed.uncaptured():
                for _ in range(12):
                    s, st = step(s)
                    ovf.append(st["cell_overflow"])
            assert step.syncs.count == 0
            outs.append((s, torch.stack(ovf).tolist()))
        (a, ovf_a), (b, ovf_b) = outs
        assert ovf_a == ovf_b
        for f in ("pos", "vel", "collisions"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (window, f)

    ts, parts = _case_parts("gradient", 64)
    parts = parts._replace(**{k: getattr(parts, k).cuda() for k in (
        "pos_k", "vel_k", "ncon_k", "rows_s", "overflow", "cid_s", "offsets")})
    # every overflow lane, every seventh (a batch's runs far apart), one,
    # none: the kernel against its plain version and the host-looped
    # fallback over the same lanes
    listed = parts.overflow.nonzero()[:, 0]
    assert listed.numel() > 0 and listed[::7].numel() > 1
    for pick in (listed, listed[::7], listed[:1], listed[:0]):
        keep = torch.zeros_like(parts.overflow)
        keep[pick] = True
        lanes, n_lanes = twk.compact_lanes(keep)
        res = []
        for fn in (tk.p2p_collide_worklist, tk.p2p_collide_worklist_plain):
            p = _own(parts)
            fn(p.rows_s, p.cid_s, p.offsets, p.meta, lanes, n_lanes, p.pos_k, p.vel_k,
               p.ncon_k, beta=0.5)
            res.append((p.pos_k, p.vel_k, p.ncon_k))
        res.append(tuple(tp2ps._p2p_chunked_fallback(
            _own(parts._replace(overflow=keep)), 0.5, 100)[:3]))
        torch.cuda.synchronize()
        assert int(n_lanes) == pick.numel()
        for other in res[1:]:
            for a, b in zip(res[0], other):
                assert torch.equal(a, b), pick.numel()
