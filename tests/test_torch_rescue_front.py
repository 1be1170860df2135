"""PyTorch port, the sorted rescue's front: what ``_device_rescue`` does over
all N sorted lanes before its worklist -- each lane's (start, count) by
the midpoint lookup, the fit test, the overflow count and the list of the
lanes that overflow and fit.  On CUDA one launch of
``ops/cuda/window_kernel.py::rescue_front`` (``csrc/window_kernel.cu``);
on the CPU its plain version (``_rescue_front_plain``: ``_phase2_plan``,
``compact_lanes``, the overflow's sum).

On the CPU: the plain front's contract on a hand-made grid (the fit at
its boundary, the midpoint lookup, the list in lane order, the overflow
count, the phase-3 lanes) and the wrapper's refusal of CPU tensors.  On
the card (``-m cuda``): the kernel bit for bit against the plain front
run on the card, on the sample scene's dense probe sorted at window 128
(many overflow lanes), its spawn (none), every lane overflowing,
sentinel and infinite lanes, a hybrid undecided mask, each with and
without the fit mask and at one and at 37 blocks of 1024 lanes (a
ragged last tile); and the kernel replayed from a captured graph on new
inputs.  Small sizes; no JAX."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import spawn_grid
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

SMALL_WINDOW = 128  # overflow everywhere on the dense probe
RESCUE_WINDOW = 2048
CASES = ["dense", "spawn", "all", "sentinel", "hybrid"]
REPS = [1, 37]  # blocks of 1024 lanes: one tile of the kernel, and 18.5

# the hand-made grid: 2 x 2 x 4 unit cells at the origin, (start, count)
# by cell; cells 0, 3, 4 fit at the boundary (start % 128 + count == the
# rescue window), 1, 5 and 7 by one row too many, 2 and 15 hold nothing
GRID_DIMS = (2, 2, 4)
CELLS = {0: (389, 2043), 1: (389, 2044), 2: (127, 0), 3: (0, 2048), 4: (255, 1921),
         5: (255, 1922), 6: (7, 3), 7: (0, 4000)}
# a lane's cell (its position's; lane 3 moves into cell 7 by its midpoint),
# and whether it overflows
LANE_CELLS = [3, 1, 0, 6, 5, 2, 4, 9, 1, 0, 12, 5, 6, 3, 2, 15]
OVERFLOW = [1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1, 1]
DT = 0.01


def _hand_made():
    """A rescue's arguments on the hand-made grid: (sp, sorted state,
    overflow, the fit each lane should get)."""
    meta = tgrid.GridMeta(origin=(0.0, 0.0, 0.0), cell_size=1.0, dims=GRID_DIMS,
                          max_tris_per_cell=1, num_pairs=0, num_triangles=0)
    cells2 = torch.zeros((2, meta.num_cells), dtype=torch.int32)
    for cid, (s, c) in CELLS.items():
        cells2[:, cid] = torch.tensor([s, c], dtype=torch.int32)
    n = len(LANE_CELLS)
    dy, dz = GRID_DIMS[1:]
    cid = torch.tensor(LANE_CELLS)
    pos = torch.stack([cid // (dy * dz), (cid // dz) % dy, cid % dz]).float() + 0.5
    vel = torch.zeros((3, n))
    vel[2, 3] = 120.0  # cell 6 at z 2.5, its midpoint at z 3.1: cell 7
    pos[:, 15] = 1e38  # a sentinel: the far border cell, 15
    pos[:, 9] = -1e38  # clamps to cell 0
    looked_up = cid.clone()
    looked_up[3] = 7
    fit = torch.tensor([c == 0 or s % 128 + c <= RESCUE_WINDOW for s, c in
                        (CELLS.get(int(k), (0, 0)) for k in looked_up)])
    cfg = types.SimpleNamespace(dt=DT, gravity=(0.0, -9.81, 0.0), backoff=0.0)
    sp = types.SimpleNamespace(
        tables=types.SimpleNamespace(cells2=cells2, pairs=None), meta=meta, cfg=cfg,
        rescue_window=RESCUE_WINDOW, packed=None, num_groups=0, group=8, gravity=None,
        m_cap=1024)
    sorted_state = (pos, vel, torch.full((n,), 0.2), torch.full((n,), 0.5))
    return sp, sorted_state, torch.tensor(OVERFLOW, dtype=torch.bool), fit


@pytest.mark.parametrize("phase3", [False, True])
def test_plain_front_contract(monkeypatch, phase3):
    """The CPU route of ``_device_rescue`` on the hand-made grid: a lane
    fits when its cell holds nothing or start % 128 + count is at most the
    rescue window (the boundary fits, one row more does not), looked up at
    its midpoint; the worklist gets the overflow lanes that fit in lane
    order, their count and their cells' (start, count); the overflow count
    is every overflow lane's; with phase 3 let run, the packed phase gets
    the overflow lanes that do not fit."""
    sp, st, overflow, fit = _hand_made()
    seen = {}

    def worklist(*a, **k):
        seen["start"], seen["count"], seen["lanes"], seen["n_lanes"] = a[4:8]

    def packed(*a, **k):
        seen["still"] = a[3].clone()

    monkeypatch.setattr(tstep, "window_collide_worklist", worklist)
    monkeypatch.setattr(tstep, "_packed_rescue", packed)
    monkeypatch.setattr(tstep, "_phase3_possible", lambda sp: phase3)
    n = overflow.shape[0]
    out = (torch.zeros((3, n)), torch.zeros((3, n)), torch.zeros(n, dtype=torch.int32))
    res = tstep._device_rescue(out, st, overflow, sp, key_s=None, ovf_count=None,
                               syncs=tstep.HostSyncs())
    assert fit.tolist() == [True, False, True, False, False, True, True, True, False,
                            True, True, False, True, True, True, True]
    want = torch.nonzero(overflow & fit).flatten()
    m = int(seen["n_lanes"])
    assert m == len(want) == 8 and torch.equal(seen["lanes"][:m].long(), want)
    assert (seen["lanes"][m:] == 0).all()
    cells = torch.tensor(LANE_CELLS)[want]
    assert seen["start"][want].tolist() == [CELLS.get(int(c), (0, 0))[0] for c in cells]
    assert seen["count"][want].tolist() == [CELLS.get(int(c), (0, 0))[1] for c in cells]
    assert int(res[3]) == int(overflow.sum()) == 13
    assert ("still" in seen) == phase3
    if phase3:
        assert torch.equal(seen["still"], overflow & ~fit)


def test_rescue_front_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: the CPU route is the
    plain front, never a launch."""
    sp, st, overflow, _ = _hand_made()
    before = dict(twk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        twk.rescue_front(*st[:2], overflow, sp.tables.cells2, sp.meta, dt=DT,
                         w=RESCUE_WINDOW, with_fit=False)
    assert twk.LAUNCHES == before


# ---------------------------------------------------------------- card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted(sp, pos, vel, dt):
    """Lanes in the order of their Morton keys, as a sort step leaves them."""
    key = tgrid.morton_key(tgrid.lookup_pos(pos, vel, dt), sp.meta)
    perm = torch.sort(key, stable=True)[1]
    return pos[:, perm].contiguous(), vel[:, perm].contiguous()


def _overflow(sp, pos_s, vel_s, dt, active_s=None):
    """The main plan's overflow at ``sp``'s window (gather plan)."""
    cid = tgrid.cell_index(tgrid.lookup_pos(pos_s, vel_s, dt), sp.meta)
    return tstep._window_plan(cid, sp.tables.cells2, sp.window,
                              pos_s.shape[-1] // twk.BLOCK, active_s=active_s,
                              demote=sp.demote)[4]


@pytest.fixture(scope="module")
def probe_cases():
    """The sample scene with 20x dt, its tables at window 128, and each
    case's sorted (pos, vel, overflow) on the CPU: the dense probe of
    tests/test_torch_device_loop.py (16 x 16 particles at spacing 0.25,
    jitter from seed 1, 47 steps in), the spawn, every lane overflowing,
    the sentinel lanes overflowing with lanes at +-inf and -1e38, and an
    undecided mask (numpy seed 5)."""
    _card()
    scene = sample_scene(width=128, height=128)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20,
                              num_particles_xz=16, offset_xz=0.25)
    sp = tstep._build_sorted(scene.triangles, cfg, window=SMALL_WINDOW,
                             fallback_capacity=1024, cells_lookup="gather",
                             dense_demote="auto", device="cpu")
    step = tstep.make_spatial_step_sorted(scene.triangles, cfg, device="cpu")
    s = spawn_grid(cfg, 1, jitter=0.35, seed=1, device="cpu")
    spawn = _sorted(sp, s.pos, s.vel, cfg.dt)
    for _ in range(47):
        s = step(s)
    pos, vel = _sorted(sp, s.pos, s.vel, cfg.dt)
    dense = _overflow(sp, pos, vel, cfg.dt)
    odd = pos.clone()
    odd[:, 3], odd[0, 5], odd[1, 7] = -1e38, float("inf"), -float("inf")
    undecided = torch.from_numpy(np.random.default_rng(5).random(pos.shape[-1]) < 0.5)
    cases = {
        "dense": (pos, vel, dense),
        "spawn": (*spawn, _overflow(sp, *spawn, cfg.dt)),
        "all": (pos, vel, torch.ones_like(dense)),
        "sentinel": (odd, vel, dense | (pos[0] > 1e37) | ~torch.isfinite(odd).all(0)
                     | (odd[0] < -1e37)),
        "hybrid": (pos, vel, _overflow(sp, pos, vel, cfg.dt, active_s=undecided)),
    }
    assert int(dense.sum()) > 8 and not cases["spawn"][2].any()
    assert cases["hybrid"][2].any() and not torch.equal(cases["hybrid"][2], dense)
    return sp, cases


def _on_card(sp, dev):
    return sp._replace(tables=twk.WindowTables(*(t.to(dev) for t in sp.tables)))


def _front(sp, pos, vel, overflow, with_fit):
    return twk.rescue_front(pos, vel, overflow, sp.tables.cells2, sp.meta, dt=sp.cfg.dt,
                            w=sp.rescue_window, with_fit=with_fit)


def _assert_same(got, want, overflow, with_fit):
    """The kernel's front equals the plain front: the list and both
    counts, (start, count) at the listed lanes, the mask where asked."""
    start, count, fit, lanes, n_lanes, n_over = got
    p_start, p_count, p_fit, p_lanes, p_n, p_over = want
    m = int(p_n)
    assert int(n_lanes) == m and int(n_over) == int(p_over)
    assert torch.equal(lanes[:m], p_lanes[:m])
    pick = p_lanes[:m].long()
    assert torch.equal(start[pick], p_start[pick]) and torch.equal(count[pick], p_count[pick])
    assert (fit is not None) == with_fit
    if with_fit:
        assert torch.equal(fit, p_fit)
    if bool(p_fit[overflow].all()):
        assert m == int(p_over)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("with_fit", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_kernel_is_the_plain_front_on_card(probe_cases, case, with_fit, reps):
    """On the card, each case tiled ``reps`` times along the lanes: the
    kernel's front equals the plain front bit for bit, and adds one launch."""
    dev = _card()
    sp, cases = probe_cases
    sp = _on_card(sp, dev)
    pos, vel, overflow = (torch.cat([x] * reps, -1).contiguous().to(dev)
                          for x in cases[case])
    before = twk.LAUNCHES["rescue_front"]
    got = _front(sp, pos, vel, overflow, with_fit)
    torch.cuda.synchronize()
    assert twk.LAUNCHES["rescue_front"] == before + 1
    want = tstep._rescue_front_plain((pos, vel), overflow, sp)
    _assert_same(got, want, overflow, with_fit)
    if case == "all":
        assert int(got[4]) == pos.shape[-1]
    if case == "spawn":
        assert int(got[4]) == int(got[5]) == 0


@pytest.mark.cuda
def test_kernel_replays_from_a_graph(probe_cases):
    """The front captured in a CUDA graph over fixed buffers, then replayed
    on two cases' inputs copied in (the dense probe, the hybrid mask at
    37 blocks): each replay gives the plain front's list and counts."""
    dev = _card()
    sp, cases = probe_cases
    sp = _on_card(sp, dev)

    def tiled(case):
        return [torch.cat([x] * 37, -1).contiguous().to(dev) for x in cases[case]]

    bufs = tiled("all")
    _front(sp, *bufs, False)  # warm: the library and its function
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _front(sp, *bufs, False)
    for case in ("dense", "hybrid"):
        for b, x in zip(bufs, tiled(case)):
            b.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        want = tstep._rescue_front_plain(bufs[:2], bufs[2], sp)
        _assert_same(out, want, bufs[2], False)
        assert 0 < int(out[4]) < bufs[2].shape[0]
