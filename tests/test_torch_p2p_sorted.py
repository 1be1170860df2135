"""PyTorch port, sorted-segment p2p collisions: the run table, the run
bounds and the window plan are bit-identical to the JAX package's
``ops/p2p_sorted.py``; ``p2p_collide_sorted``, ``p2p_collide_window``
(with and without window overflow) and the persistent episode runner
agree with the JAX functions (the Pallas kernel in interpret mode) and
with the O(N^2) NumPy oracle.

Tolerances are those of the JAX package's own tests (tests/test_p2p.py):
counts exact, pos rtol=1e-5 atol=1e-5, vel rtol=1e-4 atol=1e-5; the
4-step runner pos 1e-4/1e-4, vel rtol=1e-3 atol=1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.config import SimConfig as JSimConfig
from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.core.step import (
    make_p2p_episode_runner as j_make_p2p_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu.ops import p2p_sorted as jp2ps
from particlesystemhybridcollisiondetection_tpu.ops import pgrid as jpg
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core import state as tstate
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    HostSyncs,
    make_p2p_episode_runner,
    make_p2p_step,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan as tplan
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as tp2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as tpg
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    p2p_window_kernel as tk,
)

from test_torch_p2p import (
    F,
    assert_matches_oracle,
    assert_states_close,
    both,
    brute_force_p2p,
    hetero_cloud,
    snap,
)


def gradient_block():
    """One 1024-particle block with a dense cluster and a sparse far
    tail (inputs of the JAX package's per-sublane-window test)."""
    rng = np.random.default_rng(12)
    n, n_dense = 1024, 768
    pos = np.empty((n, 3), dtype=F)
    pos[:n_dense] = rng.uniform(0.1, 2.3, size=(n_dense, 3))
    pos[n_dense:] = rng.uniform(6.0, 11.9, size=(n - n_dense, 3))
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    radius = rng.uniform(0.1, 0.2, size=n).astype(F)
    rest = rng.uniform(0.3, 0.9, size=n).astype(F)
    return snap(pos, vel, radius, rest), ((0, 0, 0), (12, 12, 12), 0.4, 64)


def two_blocks_with_sentinels():
    """n = 1400 (two kernel blocks) with 60 sentinels (inputs of the JAX
    package's multi-block test)."""
    rng = np.random.default_rng(11)
    n = 1400
    pos = rng.uniform(0.0, 6.0, size=(n, 3)).astype(F)
    pos[1340:] = 1e38
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    return (snap(pos, vel, np.full(n, 0.15, dtype=F), np.full(n, 0.5, dtype=F)),
            ((0, 0, 0), (6, 6, 6), 0.4, 16))


CASES = {"gradient": gradient_block, "two_blocks": two_blocks_with_sentinels}


def metas(args):
    lo, hi, h, cap = args
    return jpg.make_meta(lo, hi, h, capacity=cap), tpg.make_meta(lo, hi, h, capacity=cap)


def test_group_offsets_and_pad_columns_equal():
    jm, tm = metas(((0, 0, 0), (6, 5, 4), 0.4, 8))
    assert tplan.group_offsets(tm) == jp2ps._group_offsets(jm)
    np.testing.assert_array_equal(tp2ps._pad_columns(7, "cpu").numpy(),
                                  np.asarray(jp2ps._pad_columns(7)))
    with pytest.raises(ValueError):
        tp2ps.check_meta(tpg.make_meta((0, 0, 0), (4, 4, 0.8), 0.4))


@pytest.mark.parametrize("case", list(CASES))
def test_run_table_and_bounds_bitwise(case):
    d, margs = CASES[case]()
    jm, tm = metas(margs)
    js, ts = both(d)
    t_key = tp2ps._cell_key(ts.pos, tm, tstate.active_mask(ts))
    cid = jpg.linear_cell(*jpg.cell_coords(js.pos, jm), jm)
    j_key = jnp.where(jstate.active_mask(js), cid, jm.num_cells)
    np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key))

    t_off = tplan.csr_offsets(t_key, tm.num_cells)
    counts = np.bincount(np.asarray(j_key), minlength=jm.num_cells + 1)
    j_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    assert t_off.dtype == torch.int32
    np.testing.assert_array_equal(t_off.numpy(), j_off)

    j_tab = jp2ps._run_table(jnp.asarray(j_off), jm)
    t_tab = tplan.run_table(t_off, tm)
    assert tuple(t_tab.shape) == (18, tm.num_cells)
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))

    cid_s = np.sort(np.asarray(j_key), kind="stable")
    j_st, j_ct = jp2ps._run_bounds(jnp.asarray(cid_s), j_tab, jm)
    t_st, t_ct = tplan.run_bounds(torch.from_numpy(cid_s), t_tab, tm)
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))
    np.testing.assert_array_equal(t_ct.numpy(), np.asarray(j_ct))
    assert int(t_ct.sum()) > 0


@pytest.mark.parametrize("case,window", [
    ("gradient", 512), ("two_blocks", 512), ("two_blocks", 128),
])
def test_phase1_plan_bitwise_and_kernel_close(case, window):
    """Everything integer that phase 1 hands to phase 2 (sort order,
    sorted rows, run starts and counts, overflow mask) is bitwise equal;
    the kernel's outputs agree on the lanes that did not overflow (the
    others are redone by phase 2)."""
    d, margs = CASES[case]()
    jm, tm = metas(margs)
    js, ts = both(d)
    jparts = jp2ps.p2p_window_phase1(js, jm, active=jstate.active_mask(js),
                                     window=window, interpret=True)
    before = dict(tk.LAUNCHES)
    tparts = tp2ps.p2p_window_phase1(ts, tm, active=tstate.active_mask(ts),
                                     window=window)
    assert tk.LAUNCHES == before  # CPU tensors: the plain version, no launch
    names = ("pos_k", "vel_k", "ncon_k", "rows_s", "starts", "cnt", "overflow", "perm")
    # the port's kernel plans its own windows, so its parts carry the
    # sorted cell ids and the CSR offsets; run_bounds() rebuilds the runs
    t_starts, t_cnt = tparts.run_bounds()
    t = {k: getattr(tparts, k).numpy() for k in names if k not in ("starts", "cnt")}
    t.update(starts=t_starts.numpy(), cnt=t_cnt.numpy())
    j = dict(zip(names, (np.asarray(x) for x in jparts)))
    for k in ("rows_s", "starts", "cnt", "overflow", "perm"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    n_over = int(t["overflow"].sum())
    assert (n_over > 0) == (window == 128)
    ok = ~t["overflow"]
    np.testing.assert_array_equal(t["ncon_k"][ok], j["ncon_k"][ok])
    np.testing.assert_allclose(t["pos_k"][:, ok], j["pos_k"][:, ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t["vel_k"][:, ok], j["vel_k"][:, ok], rtol=1e-4, atol=1e-5)
    assert int(t["ncon_k"].sum()) > 0
    assert np.isfinite(t["vel_k"]).all()


@pytest.mark.parametrize("case", ["hetero", "outside", "one_cell"])
def test_sorted_matches_jax_and_oracle(case):
    rng = np.random.default_rng(6)
    if case == "hetero":
        cloud, margs = hetero_cloud(5), ((0, 0, 0), (8, 8, 8), 0.6, 16)
    elif case == "outside":  # straddles every face, a cluster outside
        n = 128
        pos = rng.uniform(-1.5, 5.5, size=(n, 3)).astype(F)
        pos[:16] = rng.uniform(-2.0, -1.2, size=(16, 3))
        cloud = (pos, (rng.normal(size=(n, 3)) * 2).astype(F),
                 rng.uniform(0.1, 0.25, size=n).astype(F), np.full(n, 0.5, dtype=F))
        margs = ((0, 0, 0), (4, 4, 4), 0.5, 64)
    else:  # 64 particles in ONE cell: a slot table would saturate
        n = 64
        cloud = (rng.uniform(2.0, 2.4, size=(n, 3)).astype(F),
                 rng.normal(size=(n, 3)).astype(F),
                 np.full(n, 0.12, dtype=F), np.full(n, 0.5, dtype=F))
        margs = ((0, 0, 0), (8, 8, 8), 0.5, 4)
    oracle = brute_force_p2p(*cloud)
    assert oracle[2].sum() > 0
    jm, tm = metas(margs)
    js, ts = both(snap(*cloud))
    jo, _ = jp2ps.p2p_collide_sorted(js, jm)
    syncs = HostSyncs()
    to, overflow = tp2ps.p2p_collide_sorted(ts, tm, syncs=syncs)
    assert int(overflow) == 0
    assert syncs.count == 9  # one loop bound per run
    assert_states_close(to, jo)
    assert_matches_oracle(to, *oracle)


@pytest.mark.parametrize("window", [512, 128])
def test_window_matches_jax_and_oracle(window):
    """Default window: nothing overflows.  window=128: the spread of runs
    in one block overflows it, and the chunked fallback (here in chunks
    of 64 lanes, the last one clamped) redoes those particles exactly."""
    cloud = hetero_cloud(10, n=192)
    oracle = brute_force_p2p(*cloud)
    jm, tm = metas(((0, 0, 0), (8, 8, 8), 0.6, 16))
    js, ts = both(snap(*cloud))
    jo, j_over = jp2ps.p2p_collide_window(js, jm, window=window, interpret=True)
    syncs = HostSyncs()
    to, t_over = tp2ps.p2p_collide_window(ts, tm, window=window, syncs=syncs,
                                          fallback_capacity=64)
    assert isinstance(t_over, int) and t_over == int(j_over)
    assert (t_over > 0) == (window == 128)
    if window == 512:
        assert syncs.count == 1  # the overflow count, nothing else
    else:
        assert t_over % 64 != 0 and syncs.count == 1 + 9 * (t_over // 64 + 1)
    assert_states_close(to, jo)
    assert_matches_oracle(to, *oracle)


def test_window_sentinels_multiblock_match_sorted():
    d, margs = two_blocks_with_sentinels()
    jm, tm = metas(margs)
    js, ts = both(d)
    act = tstate.active_mask(ts)
    ref, _ = tp2ps.p2p_collide_sorted(ts, tm, active=act)
    out, n_over = tp2ps.p2p_collide_window(ts, tm, active=act)
    jo, j_over = jp2ps.p2p_collide_window(js, jm, active=jstate.active_mask(js),
                                          interpret=True)
    assert n_over == int(j_over)
    assert_states_close(out, jo)
    np.testing.assert_array_equal(out.collisions.numpy(), ref.collisions.numpy())
    np.testing.assert_allclose(out.pos.numpy(), ref.pos.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.vel.numpy(), ref.vel.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out.pos.numpy()[:, 1340:], d["pos"][:, 1340:])


def test_sorted_sentinel_particles_inert():
    """Sentinel (inactive) particles neither move nor collide, and are
    no one's candidate."""
    rng = np.random.default_rng(8)
    n = 64
    pos = rng.uniform(0.5, 3.5, size=(n, 3)).astype(F)
    pos[48:] = 1e38
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    radius, rest = np.full(n, 0.2, dtype=F), np.full(n, 0.5, dtype=F)
    _, ts = both(snap(pos, vel, radius, rest))
    tm = tpg.make_meta((0, 0, 0), (4, 4, 4), 0.5, capacity=16)
    live = brute_force_p2p(pos[:48], vel[:48], radius[:48], rest[:48])
    for fn in (tp2ps.p2p_collide_sorted, tp2ps.p2p_collide_window):
        out, _ = fn(ts, tm, active=tstate.active_mask(ts))
        assert (out.collisions[48:] == 0).all()
        np.testing.assert_array_equal(out.pos.numpy()[:, 48:].T, pos[48:])
        np.testing.assert_array_equal(out.vel.numpy()[:, 48:].T, vel[48:])
        assert torch.isfinite(out.vel).all()
        np.testing.assert_array_equal(out.collisions.numpy()[:48], live[2])
        np.testing.assert_allclose(out.pos.numpy()[:, :48].T, live[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.vel.numpy()[:, :48].T, live[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", ["sorted", "window"])
def test_sorted_momentum_conserved(fn):
    rng = np.random.default_rng(9)
    n = 256
    pos = rng.uniform(0, 3, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 3).astype(F)
    radius = rng.uniform(0.2, 0.35, size=n).astype(F)
    _, ts = both(snap(pos, vel, radius, np.full(n, 0.9, dtype=F)))
    tm = tpg.make_meta((-1, -1, -1), (4, 4, 4), 0.7, capacity=32)
    collide = tp2ps.p2p_collide_sorted if fn == "sorted" else tp2ps.p2p_collide_window
    out, _ = collide(ts, tm)
    assert int(out.collisions.sum()) > 0
    m = radius**3
    np.testing.assert_allclose((m[None] * out.vel.numpy()).sum(axis=1),
                               (m[None] * vel.T).sum(axis=1), rtol=1e-3, atol=1e-3)


def test_episode_runner_matches_jax_runner_and_step_path():
    """make_p2p_episode_runner (persistent sorted order) against the JAX
    runner (Pallas kernel in interpret mode) and against the port's own
    per-step path, n = 500 (padded to one block inside), 4 steps."""
    rng = np.random.default_rng(13)
    n = 500
    pos = rng.uniform(0.6, 5.4, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    js, ts = both(snap(pos, vel, np.full(n, 0.12, dtype=F), np.full(n, 0.7, dtype=F)))
    box = ((0, 0, 0), (6, 6, 6))
    kw = dict(particle_radius=0.12, dt=0.004)

    jo = j_make_p2p_episode_runner(*box, JSimConfig(**kw), interpret=True)(js, 4)
    run = make_p2p_episode_runner(*box, SimConfig(**kw), device="cpu")
    to, overflows = run(ts, 4, with_stats=True)
    assert overflows == [0, 0, 0, 0]
    assert run.steps == 4 and run.syncs.count == 4  # one read per step
    tol = dict(pos_tol=dict(rtol=1e-4, atol=1e-4), vel_tol=dict(rtol=1e-3, atol=1e-4))
    assert_states_close(to, jo, **tol)
    assert int(to.collisions.sum()) > 0 and to.pos.shape == (3, n)

    step = make_p2p_step(*box, SimConfig(**kw), variant="sorted", device="cpu")
    ref = ts
    for _ in range(4):
        ref = step(ref)
    np.testing.assert_array_equal(to.collisions.numpy(), ref.collisions.numpy())
    np.testing.assert_allclose(to.pos.numpy(), ref.pos.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to.vel.numpy(), ref.vel.numpy(), rtol=1e-3, atol=1e-4)
    # a second call continues from the returned state
    again = run(to, 1)
    np.testing.assert_allclose(again.pos.numpy(), step(ref).pos.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_fallback_redoes_every_lane_with_clamped_last_chunk():
    """Mark EVERY lane as overflowed and throw the kernel's output away:
    the chunked fallback alone (chunks of 400 over 1024 lanes, the third
    chunk's start clamped to 624, overlapping the second) must rebuild
    the result of the sorted path."""
    cloud = hetero_cloud(10, n=192)
    tm = tpg.make_meta((0, 0, 0), (8, 8, 8), 0.6, capacity=16)
    _, ts = both(snap(*cloud))
    parts = tp2ps.p2p_window_phase1(ts, tm)
    assert parts.rows_s.shape[-1] == 1024 and not parts.overflow.any()
    syncs = HostSyncs()
    parts = parts._replace(
        pos_k=torch.full_like(parts.pos_k, 7.0),
        vel_k=torch.full_like(parts.vel_k, 7.0),
        ncon_k=torch.full_like(parts.ncon_k, 7),
        overflow=torch.ones_like(parts.overflow))
    out, n_over = tp2ps.p2p_window_phase2(ts, parts, fallback_capacity=400,
                                          syncs=syncs)
    assert n_over == 1024 and syncs.count == 1 + 9 * 3
    assert_matches_oracle(out, *brute_force_p2p(*cloud))
