"""PyTorch port, the p2p window kernel's second entry point
(``p2p_window_collide_cells``, the plan derived inside the kernel):

  * a NumPy transcription of the integer plan that the CUDA kernel
    computes per row (``csrc/p2p_window_kernel.cu``) equals
    ``ops/p2p_plan.py`` bit for bit, and its staged spans stay inside the
    shared-memory buffers and the padded rows;
  * on the CPU the entry point equals the explicit-plan path
    (``ops/p2p_plan.py`` + ``p2p_window_collide_sorted``) bit for bit, overflow mask included;
  * phase 1 built on it agrees with the JAX package's
    ``p2p_window_phase1`` (Pallas kernel in interpret mode) on the same
    NumPy inputs: integer parts bitwise, floats at the tolerances of
    tests/test_torch_p2p_sorted.py (counts exact, pos rtol=1e-5
    atol=1e-5, vel rtol=1e-4 atol=1e-5; XLA on the CPU fuses
    multiply-adds).

Cases: a window that overflows, particles in boundary cells and outside
the grid, parked (sentinel) particles, block padding columns.  The CUDA
kernel itself runs only on the card (``-m cuda``)."""

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.core import state as jstate
from particlesystemhybridcollisiondetection_tpu.ops import p2p_sorted as jp2ps
from particlesystemhybridcollisiondetection_tpu_torch.core import state as tstate
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan as tplan
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as tp2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    p2p_window_kernel as tk,
)

from test_torch_p2p import F, both, snap
from test_torch_p2p_sorted import metas, two_blocks_with_sentinels

LANE, BIG = 128, 1 << 30


def boundary_cloud():
    """n = 1024: particles in every face, edge and corner cell of a
    5 x 4 x 6 grid, a cluster outside the box (clamped to boundary
    cells) and a dense interior, so every group is out of grid for some
    particle and the clamped z-runs wrap into neighbouring y-rows."""
    rng = np.random.default_rng(21)
    n = 1024
    pos = rng.uniform(-0.3, 1.0, size=(n, 3)).astype(F) * np.array([2.5, 2.0, 3.0], F)
    pos[:64] = rng.uniform(-1.0, -0.4, size=(64, 3))
    pos[64:128] = rng.uniform(2.4, 3.4, size=(64, 3))
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    radius = rng.uniform(0.1, 0.25, size=n).astype(F)
    return (snap(pos, vel, radius, np.full(n, 0.6, dtype=F)),
            ((0, 0, 0), (2.5, 2.0, 3.0), 0.5, 64))


def parked_cloud():
    """n = 2048 of which 900 are parked sentinels, scattered through the
    particle order (they sort to the end and are no one's candidate)."""
    rng = np.random.default_rng(22)
    n = 2048
    pos = rng.uniform(0.0, 5.0, size=(n, 3)).astype(F)
    pos[rng.choice(n, 900, replace=False)] = 1e38
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    return (snap(pos, vel, np.full(n, 0.15, dtype=F), np.full(n, 0.5, dtype=F)),
            ((0, 0, 0), (5, 5, 5), 0.4, 16))


def padded_cloud():
    """n = 1500: 548 block padding columns behind the particles."""
    rng = np.random.default_rng(23)
    n = 1500
    pos = rng.uniform(0.0, 4.0, size=(n, 3)).astype(F)
    vel = (rng.normal(size=(n, 3)) * 2).astype(F)
    radius = rng.uniform(0.1, 0.2, size=n).astype(F)
    return (snap(pos, vel, radius, rng.uniform(0.3, 0.9, size=n).astype(F)),
            ((0, 0, 0), (4, 4, 4), 0.4, 16))


# name -> (inputs, window); "overflow" is the one whose window is too small
CASES = {
    "overflow": (two_blocks_with_sentinels, 128),
    "boundary": (boundary_cloud, 512),
    "boundary_w128": (boundary_cloud, 128),
    "parked": (parked_cloud, 512),
    "pads": (padded_cloud, 512),
}


def sorted_inputs(case):
    """(torch state, metas, window, rows_pad, cid_s, offsets, perm) as
    ``_phase1_core`` prepares them."""
    make, window = CASES[case]
    d, margs = make()
    jm, tm = metas(margs)
    js, ts = both(d)
    n = ts.pos.shape[-1]
    n_k = -(-n // tk.BLOCK) * tk.BLOCK
    key = torch.cat([
        tp2ps._cell_key(ts.pos, tm, tstate.active_mask(ts)),
        torch.full((n_k - n,), tm.num_cells, dtype=torch.int32)])
    rows = torch.cat([tp2ps._state_rows(ts), tp2ps._pad_columns(n_k - n, "cpu")], 1)
    cid_s, perm = torch.sort(key, stable=True)
    offsets = tplan.csr_offsets(key, tm.num_cells)
    rows_pad = torch.cat([rows[:, perm], tp2ps._pad_columns(window, "cpu")], dim=1)
    return dict(js=js, ts=ts, jm=jm, tm=tm, window=window, rows_pad=rows_pad,
                cid_s=cid_s, offsets=offsets, perm=perm, key=key, n=n, n_k=n_k)


def kernel_plan_numpy(cid_s, offsets, dims, num_cells, w, n_pad):
    """The integer plan as csrc/p2p_window_kernel.cu derives it, row by
    row: per group the window start of each row of 128, each lane's rel
    (clipped) and candidate bound, the overflow flag, and the staged span
    (first column in rows_pad, first column in the window, length)."""
    n = len(cid_s)
    dx, dy, dz = dims
    cid = cid_s.astype(np.int64)
    live = cid < num_cells
    cs = np.minimum(cid, num_cells - 1)
    cx = cs // (dy * dz)
    cy = (cs // dz) % dy
    rel = np.zeros((9, n), np.int64)
    bnd = np.zeros((9, n), np.int64)
    ws = np.zeros((9, n // LANE), np.int64)
    ovf = np.zeros(n, bool)
    spans = []
    for g in range(9):
        ox, oy = g // 3 - 1, g % 3 - 1
        off = (ox * dy + oy) * dz
        st = offsets[np.clip(cs + off - 1, 0, num_cells)].astype(np.int64)
        en = offsets[np.clip(cs + off + 2, 0, num_cells)].astype(np.int64)
        ok = live & (cx + ox >= 0) & (cx + ox < dx) & (cy + oy >= 0) & (cy + oy < dy)
        cnt = np.where(ok, en - st, 0)
        mn = np.where(cnt > 0, st, BIG).reshape(-1, LANE).min(axis=1)
        mn = np.where(mn == BIG, 0, mn)
        mn = np.clip((mn // LANE) * LANE, 0, n)
        ws[g] = mn
        rl = st - np.repeat(mn, LANE)
        ovf |= (cnt > 0) & ((rl < 0) | (rl + cnt > w))
        rel[g] = np.clip(rl, 0, w - 1)
        bnd[g] = np.minimum(cnt, w - rel[g])
        # the staged span of each row
        has = (bnd[g] > 0).reshape(-1, LANE)
        lo = np.where(has, rel[g].reshape(-1, LANE), BIG).min(axis=1)
        hi = np.where(has, (rel[g] + bnd[g]).reshape(-1, LANE), 0).max(axis=1)
        lo = np.where(hi > 0, lo & ~3, 0)
        length = np.where(hi > 0, hi - lo, 0)
        spans.append((mn + lo, lo, length))
        # every candidate column lies inside the span, the span inside
        # one [w] buffer row, and a 16 B copy inside the padded rows
        col = rel[g] - np.repeat(lo, LANE)
        assert (col[bnd[g] > 0] >= 0).all()
        assert ((col + bnd[g]) <= np.repeat(length, LANE))[bnd[g] > 0].all()
        assert (length <= w).all() and (lo % 4 == 0).all()
        assert (mn + lo + (length + 3) // 4 * 4 <= n_pad).all()
    return rel, bnd, ws, ovf, spans


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_plan_transcription_equals_plan_module(case):
    c = sorted_inputs(case)
    tm, w = c["tm"], c["window"]
    starts, cnt = tplan.run_bounds(c["cid_s"], tplan.run_table(c["offsets"], tm), tm)
    rel, ws, k_cap, overflow = tplan.window_geometry(starts, cnt, w)
    k_rel, k_bnd, k_ws, k_ovf, _ = kernel_plan_numpy(
        c["cid_s"].numpy(), c["offsets"].numpy(), tm.dims, tm.num_cells, w,
        c["rows_pad"].shape[1])
    nb = c["n_k"] // tk.BLOCK
    np.testing.assert_array_equal(k_rel, rel.numpy())
    # k_cap is the block maximum of cnt, so it never binds a lane
    bound = torch.minimum(torch.minimum(
        cnt, k_cap.t().repeat_interleave(tk.BLOCK, dim=1)), w - rel)
    np.testing.assert_array_equal(bound.numpy(), torch.minimum(cnt, w - rel).numpy())
    np.testing.assert_array_equal(k_bnd, bound.numpy())
    np.testing.assert_array_equal(
        k_ws, ws.permute(1, 0, 2).reshape(9, nb * tk.SUB).numpy())
    np.testing.assert_array_equal(k_ovf, overflow.numpy())
    assert bool(overflow.any()) == (w == 128)
    assert int(cnt.sum()) > 0
    if case.startswith("boundary"):
        # some live particle has an out-of-grid group, and some run is
        # clamped by the table's padding
        live = c["cid_s"] < tm.num_cells
        assert bool(((cnt == 0) & live[None]).any())
    if case == "parked":
        assert int((c["cid_s"] == tm.num_cells).sum()) == 900


@pytest.mark.parametrize("case", list(CASES))
def test_cells_entry_equals_explicit_plan_bitwise(case):
    c = sorted_inputs(case)
    tm, w = c["tm"], c["window"]
    before = dict(tk.LAUNCHES)
    pos_b, vel_b, ncon_b, ovf_b = tk.p2p_window_collide_cells(
        c["rows_pad"], c["cid_s"], c["offsets"], tm, w=w, beta=0.5)
    assert tk.LAUNCHES == before  # CPU tensors: the plain version, no launch
    perm, starts, cnt = tp2ps._sorted_runs(c["key"], tm)
    assert torch.equal(perm, c["perm"])
    rel, ws, k_cap, overflow = tplan.window_geometry(starts, cnt, w)
    rows_s = c["rows_pad"][:, :c["n_k"]].contiguous()
    pos_a, vel_a, ncon_a = tk.p2p_window_collide_sorted(
        rows_s[0:3], rows_s[3:6], rows_s[6], rows_s[7], c["rows_pad"], rel, cnt,
        ws, k_cap, w=w, beta=0.5)
    assert ovf_b.dtype == torch.bool and torch.equal(ovf_b, overflow)
    assert torch.equal(ncon_b, ncon_a)
    assert torch.equal(pos_b, pos_a) and torch.equal(vel_b, vel_a)
    assert int(ncon_b.sum()) > 0 and torch.isfinite(vel_b).all()
    # parked particles and block padding: no contact, nothing moves
    parked = c["cid_s"] == tm.num_cells
    assert (ncon_b[parked] == 0).all()
    assert torch.equal(pos_b[:, parked], rows_s[0:3, parked])
    assert torch.equal(vel_b[:, parked], rows_s[3:6, parked])


@pytest.mark.parametrize("case", list(CASES))
def test_phase1_on_cells_entry_matches_jax(case):
    c = sorted_inputs(case)
    js, ts, jm, tm, w = c["js"], c["ts"], c["jm"], c["tm"], c["window"]
    jparts = jp2ps.p2p_window_phase1(js, jm, active=jstate.active_mask(js),
                                     window=w, interpret=True)
    parts = tp2ps.p2p_window_phase1(ts, tm, active=tstate.active_mask(ts), window=w)
    names = ("pos_k", "vel_k", "ncon_k", "rows_s", "starts", "cnt", "overflow", "perm")
    j = dict(zip(names, (np.asarray(x) for x in jparts)))
    starts, cnt = parts.run_bounds()
    np.testing.assert_array_equal(parts.rows_s.numpy(), j["rows_s"])
    np.testing.assert_array_equal(parts.perm.numpy(), j["perm"])
    np.testing.assert_array_equal(parts.overflow.numpy(), j["overflow"])
    np.testing.assert_array_equal(starts.numpy(), j["starts"])
    np.testing.assert_array_equal(cnt.numpy(), j["cnt"])
    assert torch.equal(parts.cid_s, c["cid_s"]) and torch.equal(parts.offsets, c["offsets"])
    ok = ~j["overflow"]
    assert (not ok.all()) == (w == 128)
    np.testing.assert_array_equal(parts.ncon_k.numpy()[ok], j["ncon_k"][ok])
    np.testing.assert_allclose(parts.pos_k.numpy()[:, ok], j["pos_k"][:, ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(parts.vel_k.numpy()[:, ok], j["vel_k"][:, ok],
                               rtol=1e-4, atol=1e-5)
    assert int(parts.ncon_k.sum()) > 0


def test_fallback_builds_run_bounds_only_on_overflow(monkeypatch):
    """Phase 2 never asks for the [9, N] run bounds: its device-sized
    fallback derives each listed lane's runs in the worklist entry point,
    and redoes the overflow lanes exactly.  The host-looped reference
    fallback rebuilds them only when a lane overflowed."""
    calls = []
    real = tp2ps.WindowParts.run_bounds
    monkeypatch.setattr(tp2ps.WindowParts, "run_bounds",
                        lambda parts: calls.append(1) or real(parts))
    c = sorted_inputs("pads")
    act = tstate.active_mask(c["ts"])
    out, n_over = tp2ps.p2p_collide_window(c["ts"], c["tm"], active=act, window=512)
    assert n_over == 0 and not calls
    out128, n_over = tp2ps.p2p_collide_window(c["ts"], c["tm"], active=act, window=128)
    assert n_over > 0 and not calls
    for w, want in ((512, 0), (128, 1)):
        calls.clear()
        parts = tp2ps.p2p_window_phase1(c["ts"], c["tm"], active=act, window=w)
        tp2ps._p2p_chunked_fallback(parts, 0.5, 8192)
        assert len(calls) == want, w
    np.testing.assert_array_equal(out128.collisions.numpy(), out.collisions.numpy())
    np.testing.assert_allclose(out128.pos.numpy(), out.pos.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out128.vel.numpy(), out.vel.numpy(), rtol=1e-4, atol=1e-5)


def test_step_equals_explicit_plan_composition():
    """Three steps of make_p2p_step (variant "kernel", the plan derived
    by the kernel's entry point) equal, bit for bit, the same steps with
    the collision pass composed by hand from ops/p2p_plan.py and the
    kernel's explicit-plan entry point."""
    from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep

    c = sorted_inputs("pads")
    tm, w, n, n_k = c["tm"], c["window"], c["n"], c["n_k"]
    cfg = SimConfig(particle_radius=0.2, dt=0.004)
    lo, hi = (0, 0, 0), (4, 4, 4)
    step = tstep.make_p2p_step(lo, hi, cfg, cell_size=0.4, capacity=16,
                               variant="kernel", with_stats=True, window=w,
                               device="cpu")
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32)

    def explicit(s):
        key = torch.cat([
            tp2ps._cell_key(s.pos, tm, tstate.active_mask(s)),
            torch.full((n_k - n,), tm.num_cells, dtype=torch.int32)])
        rows = torch.cat([tp2ps._state_rows(s), tp2ps._pad_columns(n_k - n, "cpu")], 1)
        perm, starts, cnt = tp2ps._sorted_runs(key, tm)
        rel, ws, k_cap, overflow = tplan.window_geometry(starts, cnt, w)
        assert not bool(overflow.any())
        rows_s = rows[:, perm]
        rows_pad = torch.cat([rows_s, tp2ps._pad_columns(w, "cpu")], dim=1)
        out = tk.p2p_window_collide_sorted(
            rows_s[0:3], rows_s[3:6], rows_s[6], rows_s[7], rows_pad, rel, cnt,
            ws, k_cap, w=w, beta=0.5)
        return tstep._walls_integrate(tp2ps._unsort(s, *out, perm), lo, hi,
                                      gravity, cfg.dt)

    a = b = c["ts"]
    for _ in range(3):
        a, st = step(a)
        b = explicit(b)
        assert st == {"cell_overflow": 0}
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    assert torch.equal(a.collisions, b.collisions) and int(a.collisions.sum()) > 0


def test_cells_wrapper_refuses_bad_inputs():
    c = sorted_inputs("pads")
    args = (c["rows_pad"], c["cid_s"], c["offsets"], c["tm"])
    with pytest.raises(ValueError, match="1024"):
        tk.p2p_window_collide_cells(args[0], args[1][:1000], *args[2:], w=512, beta=0.5)
    with pytest.raises(ValueError, match="rows_pad"):
        tk.p2p_window_collide_cells(args[0][:, :2048], *args[1:], w=512, beta=0.5)
    with pytest.raises(ValueError, match="window"):
        tk.p2p_window_collide_cells(*args, w=tk.MAX_WINDOW + 1, beta=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_cells_entry_matches_plain(case):
    """On the card: the kernel's second entry point against its plain
    version, bit for bit (same operations, --fmad=false), overflow mask
    included; one launch per call; bad inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = sorted_inputs(case)
    tm, w = c["tm"], c["window"]
    args = tuple(c[k].cuda() for k in ("rows_pad", "cid_s", "offsets"))
    before = tk.LAUNCHES["p2p_window_collide_cells"]
    out_k = tk.p2p_window_collide_cells(*args, tm, w=w, beta=0.5)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["p2p_window_collide_cells"] == before + 1
    out_p = tk.p2p_window_collide_cells_plain(*args, tm, w=w, beta=0.5)
    assert int(out_p[2].sum()) > 0
    for a, b in zip(out_k, out_p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        tk.p2p_window_collide_cells(args[0], args[1].long(), args[2], tm, w=w, beta=0.5)
