"""Sorted-segment particle-particle collisions.

Port of the JAX package's ``ops/p2p_sorted.py``.  The slot-table path
(``ops/p2p.py``) walks 27 cells x capacity slots with one [N] gather per
slot and drops particles from full cells.  This module sorts instead:

  1. stable sort of the particles by linear cell id (z fastest);
  2. CSR offsets over cells: histogram + cumsum;
  3. the 27-cell neighbourhood = NINE contiguous runs of the sorted
     order: for each (dx, dy) in {-1,0,1}^2 the three z-neighbours are
     consecutive linear cells, so the candidates are one [start, end)
     interval of sorted particle indices;
  4. per run, a loop over k < max(end - start), each iteration one planar
     [8, N] column gather + the masked pair math (``p2p_collide_sorted``),
     or all nine runs inside the window kernel (``p2p_collide_window``,
     ``ops/cuda/p2p_window_kernel.py``), which derives step 3's runs and
     its own windows from the sorted cell ids and the CSR offsets (the
     same plan in plain PyTorch: ``ops/p2p_plan.py``);
  5. impulses and pushes accumulate in sorted order; one un-sort.

Exact for any occupancy: candidate runs are CSR segments, not
capacity-clipped slots, so no contact is dropped and momentum stays
two-sided.

Correctness of the run construction:

  * Clamped/boundary z-runs may include *wrapped* cells from an adjacent
    y-row; those extras are rejected by the exact distance test (a pair
    can only touch if dist < r_i + r_j <= 2*max_r <= cell_size, which
    forces per-axis cell adjacency), so runs are a superset filter.
  * Pair double-counting is impossible iff simultaneously-valid runs
    never overlap.  Runs of distinct valid (dx, dy) offsets target
    distinct cell rows, whose linear offsets differ by >= dims[2]; with
    ``dims[2] >= 3`` (checked) the 3-cell intervals are disjoint.
    Out-of-range rows are masked per particle.
  * Symmetry (momentum conservation): if i and j touch, their cells are
    per-axis adjacent, so j is in one of i's valid runs and i is in one
    of j's: both sides apply mirrored impulses.

Where the JAX package loops and branches on the device (``while_loop``,
``cond``), the window path sizes its work on the device too: the exact
redo of the lanes that overflowed their windows (``_p2p_device_fallback``)
is one launch of the window kernel's worklist entry point over a list
compacted on the device, and ``p2p_collide_window`` reads nothing back,
so a step can be captured as a CUDA graph.  ``p2p_collide_sorted`` and
``_p2p_chunked_fallback`` (the host-looped fallback, kept as the
reference the tests and ``chip_smoke.py`` hold the device route to)
read their loop bounds back to the host; pass a ``HostSyncs``
(``core/step.py``) as ``syncs`` to count those reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan as plan
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.p2p_window_kernel import (
    BLOCK,
    N_GROUPS,
    p2p_collide_worklist,
    p2p_window_collide_cells,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import (
    compact_lanes,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.p2p import pair_contact


def _read(syncs, t: torch.Tensor) -> int:
    """Device scalar -> host int, counted when the caller tracks syncs."""
    return int(t.item()) if syncs is None else syncs.read(t)


def check_meta(meta: pg.PGridMeta) -> None:
    """Static requirements of the run construction."""
    if meta.dims[2] < 3:
        raise ValueError(
            f"sorted p2p needs >= 3 cells on the fastest (z) axis, got "
            f"dims={meta.dims}; use the slot path or a finer cell_size"
        )


def _pad_columns(k: int, device) -> torch.Tensor:
    """[8, k] padding rows: sentinel positions but SANE radius/velocity.
    An all-1e38 column poisons masked lanes that gather it: radius 1e38
    -> mass inf -> weight inf/inf = NaN -> 0 * NaN = NaN leaks through
    the masks.  The 1e38 positions alone guarantee the distance test
    rejects every pad."""
    pad = torch.zeros((8, k), dtype=torch.float32, device=device)
    pad[0:3] = 1.0e38
    pad[6] = 1.0
    return pad


def _state_rows(state: ParticleState) -> torch.Tensor:
    """[8, N] planar rows: pos3, vel3, radius, restitution."""
    return torch.cat(
        [state.pos, state.vel, state.radius[None], state.restitution[None]], dim=0
    )


def _cell_key(pos, meta: pg.PGridMeta, active=None) -> torch.Tensor:
    """i32[N] sort key: linear cell id; inactive (sentinel) particles
    park past the last cell, sorted to the end and excluded from every
    run by the offsets[C] clamp."""
    cid = pg.linear_cell(*pg.cell_coords(pos, meta), meta)
    return cid if active is None else torch.where(active, cid, meta.num_cells)


def _run_accumulate(rows_s, lanes, p_i, v_i, r_i, e_i, start, count, acc,
                    beta: float, syncs):
    """Add one run's contacts to ``acc`` = (dv, dp, ncon): candidates
    ``start + k`` for k < count (full run bounds, no window), one column
    gather of the sorted rows per k, up to the run's longest count (one
    host read).  ``lanes`` are the sorted indices of the particles
    themselves (the self pair is skipped by index)."""
    dv, dp, ncon = acc
    n = rows_s.shape[-1]
    m_i = r_i * r_i * r_i
    k_max = _read(syncs, count.max())
    for k in range(k_max):
        idx = torch.clamp(start + k, 0, n - 1)
        cand = rows_s[:, idx]
        rj = cand[6]
        ddv, ddp, touching = pair_contact(
            p_i, v_i, r_i, e_i, m_i,
            cand[0:3], cand[3:6], rj, cand[7], rj * rj * rj,
            (k < count) & (idx != lanes), beta,
        )
        dv = dv + ddv
        dp = dp + ddp
        ncon = ncon + touching.to(torch.int32)
    return dv, dp, ncon


def p2p_collide_sorted(
    state: ParticleState,
    meta: pg.PGridMeta,
    *,
    beta: float = 0.5,
    active=None,
    syncs=None,
) -> tuple[ParticleState, torch.Tensor]:
    """One exact particle-particle collision pass (sorted-segment, the
    "sorted" variant; nine host reads per call, one per run).

    Drop-in for ops.p2p.p2p_collide: returns (new_state, overflow) with
    overflow == 0 by construction (CSR runs cannot saturate).
    """
    check_meta(meta)
    n = state.pos.shape[-1]
    dev = state.pos.device
    perm, starts, cnt = _sorted_runs(_cell_key(state.pos, meta, active), meta)
    rows_s = _state_rows(state)[:, perm]

    pos_s, vel_s = rows_s[0:3], rows_s[3:6]
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    acc = (torch.zeros_like(vel_s), torch.zeros_like(pos_s),
           torch.zeros((n,), dtype=torch.int32, device=dev))
    for g in range(N_GROUPS):
        acc = _run_accumulate(rows_s, lanes, pos_s, vel_s, rows_s[6], rows_s[7],
                              starts[g], cnt[g], acc, beta, syncs)
    dv, dp, ncon = acc
    return (
        _unsort(state, pos_s + dp, vel_s + dv, ncon, perm),
        torch.zeros((), dtype=torch.int32, device=dev),
    )


def _unsort(state: ParticleState, pos_k, vel_k, ncon_k, perm) -> ParticleState:
    """Scatter sorted-order results back to the caller's particle order
    (dropping the kernel's block padding) and add the contact counts."""
    n = state.pos.shape[-1]
    pos = torch.empty_like(pos_k)
    vel = torch.empty_like(vel_k)
    ncon = torch.empty_like(ncon_k)
    pos[:, perm] = pos_k
    vel[:, perm] = vel_k
    ncon[perm] = ncon_k
    return state._replace(
        pos=pos[:, :n], vel=vel[:, :n],
        collisions=state.collisions + ncon[:n],
    )


class WindowParts(NamedTuple):
    """What phase 1 hands to phase 2, in sorted order and padded to the
    kernel's block multiple.  The [9, N] run bounds are not among them:
    the kernel and its worklist entry point derive the runs themselves,
    and ``run_bounds`` rebuilds them for the host-looped reference
    fallback when a window overflowed."""

    pos_k: torch.Tensor  # f32[3, n_k] kernel results
    vel_k: torch.Tensor
    ncon_k: torch.Tensor  # i32[n_k]
    rows_s: torch.Tensor  # f32[8, n_k] the sorted input rows
    overflow: torch.Tensor  # bool[n_k] lanes with a run outside its window
    perm: torch.Tensor  # i64[n_k] the sort order
    cid_s: torch.Tensor  # i32[n_k] sorted cell ids
    offsets: torch.Tensor  # i32[C + 2] CSR offsets over cells
    meta: pg.PGridMeta

    def run_bounds(self):
        """(starts, cnt) i32[9, n_k]: every sorted particle's nine full
        runs (``ops/p2p_plan.py``)."""
        return plan.run_bounds(
            self.cid_s, plan.run_table(self.offsets, self.meta), self.meta)


def p2p_window_phase1(
    state: ParticleState,
    meta: pg.PGridMeta,
    *,
    beta: float = 0.5,
    active=None,
    window: int = 512,
) -> WindowParts:
    """Sort and CSR offsets, then the 9-run window kernel, which derives
    runs and windows itself from the sorted cell ids and the offsets.
    Returns the parts phase 2 consumes.

    Window granularity is one row of 128 sorted particles: each row and
    group has its own window of ``window`` columns of the sorted rows.
    Particles whose run does not fit are flagged in ``overflow`` and
    redone exactly by phase 2.
    """
    check_meta(meta)
    n = state.pos.shape[-1]
    n_k = ((n + BLOCK - 1) // BLOCK) * BLOCK
    cid_key = _cell_key(state.pos, meta, active)
    rows = _state_rows(state)
    if n_k > n:
        cid_key = torch.cat([
            cid_key,
            torch.full((n_k - n,), meta.num_cells, dtype=torch.int32,
                       device=rows.device),
        ])
        rows = torch.cat([rows, _pad_columns(n_k - n, rows.device)], dim=1)
    return _phase1_core(rows, cid_key, meta, beta=beta, window=window)


def _sorted_runs(cid_key, meta: pg.PGridMeta):
    """Stable sort by cell + CSR + run bounds.  Returns (perm, starts,
    cnt): the sort order and each sorted particle's nine full runs,
    i32[9, N] each."""
    cid_s, perm = torch.sort(cid_key, stable=True)
    run_tab = plan.run_table(plan.csr_offsets(cid_key, meta.num_cells), meta)
    starts, cnt = plan.run_bounds(cid_s, run_tab, meta)
    return perm, starts, cnt


def _phase1_core(
    rows,  # f32[8, n_k] (n_k a BLOCK multiple; sentinel columns allowed)
    cid_key,  # i32[n_k]: linear cell id, parked particles = num_cells
    meta: pg.PGridMeta,
    *,
    beta: float,
    window: int,
    tap=None,
) -> WindowParts:
    """Sort + CSR offsets + kernel, rows-level (shared by the state-based
    phase 1 and the persistent-order episode runner).  ``tap`` (a
    runner's ``with_stats`` step, ``core/telemetry.py::StepRing``) stamps
    "order" before the kernel's launch and "main" after it."""
    n_k = rows.shape[-1]
    if n_k % BLOCK:
        raise ValueError(f"rows hold {n_k} columns, not a multiple of {BLOCK}")
    cid_s, perm = torch.sort(cid_key, stable=True)
    offsets = plan.csr_offsets(cid_key, meta.num_cells)
    rows_s = rows[:, perm]
    rows_pad = torch.cat([rows_s, _pad_columns(window, rows.device)], dim=1)
    if tap is not None:
        tap.stamp("order")
    pos_k, vel_k, ncon_k, overflow = p2p_window_collide_cells(
        rows_pad, cid_s, offsets, meta, w=window, beta=beta)
    if tap is not None:
        tap.stamp("main")
    return WindowParts(pos_k, vel_k, ncon_k, rows_s, overflow, perm, cid_s,
                       offsets, meta)


def p2p_window_phase2(
    state: ParticleState,
    parts: WindowParts,
    *,
    beta: float = 0.5,
) -> tuple[ParticleState, torch.Tensor]:
    """Exact redo of the overflow lanes (``_p2p_device_fallback``) +
    unsort back to the caller's order; no host read.  Returns (new_state,
    n_over), n_over an i32 device scalar."""
    pos_k, vel_k, ncon_k, n_over = _p2p_device_fallback(parts, beta)
    return _unsort(state, pos_k, vel_k, ncon_k, parts.perm), n_over


def p2p_collide_window(
    state: ParticleState,
    meta: pg.PGridMeta,
    *,
    beta: float = 0.5,
    active=None,
    window: int = 512,
) -> tuple[ParticleState, torch.Tensor]:
    """Exact particle-particle collision pass via the 9-run window kernel
    (the "kernel" variant), with no host read.

    Drop-in for p2p_collide_sorted; returns (new_state, window_overflow)
    where window_overflow (an i32 device scalar, as in the JAX package)
    counts the particles redone exactly by the fallback: results are
    exact for ANY overflow count.
    """
    parts = p2p_window_phase1(state, meta, beta=beta, active=active,
                              window=window)
    return p2p_window_phase2(state, parts, beta=beta)


def _p2p_device_fallback(parts: WindowParts, beta: float, tap=None):
    """Exact redo for window-overflow particles, sized on the device: the
    overflow lanes compacted (cumsum and scatter) and one launch of the
    worklist entry point over them, each lane's nine full runs with no
    window.  Gives ``_p2p_chunked_fallback``'s bits.  Writes into the
    kernel's results in place and returns (pos_k, vel_k, ncon_k, n_over),
    n_over an i32 device scalar, also the listed lanes' count, which goes
    to ``tap.lanes`` (a runner's ``with_stats`` step).  Sentinel and pad
    lanes park in cell C, have no runs and never overflow, so they are
    never listed."""
    lanes, n_over = compact_lanes(parts.overflow)
    if tap is not None:
        tap.lanes = n_over
    p2p_collide_worklist(parts.rows_s, parts.cid_s, parts.offsets, parts.meta,
                         lanes, n_over, parts.pos_k, parts.vel_k, parts.ncon_k,
                         beta=beta)
    return parts.pos_k, parts.vel_k, parts.ncon_k, n_over


def _p2p_chunked_fallback(parts: WindowParts, beta: float,
                          fallback_capacity: int, syncs=None):
    """Exact redo for window-overflow particles, in chunks of at most
    ``fallback_capacity`` lanes, looped on the host: the reference that
    the tests and ``chip_smoke.py`` hold ``_p2p_device_fallback`` to
    (the JAX package's ``_p2p_chunked_fallback``, with its device loops
    read back to the host).

    Walks the compacted overflow list; each chunk recomputes its
    particles' impulses from the FULL run bounds (no window clipping)
    with small-index gathers.  No chunk, no run bounds and no argsort
    when nothing overflows (one host read of the overflow count).  Chunk
    starts clamp to ``n - m``, so the last chunk may overlap the one
    before: its lanes are recomputed from the unchanged ``rows_s``, and
    the result is the same.  Writes into the kernel's results in place
    and returns (pos_k, vel_k, ncon_k, n_over).
    """
    pos_k, vel_k, ncon_k = parts.pos_k, parts.vel_k, parts.ncon_k
    rows_s, overflow = parts.rows_s, parts.overflow
    n = rows_s.shape[-1]
    m = min(int(fallback_capacity), n)
    n_over = _read(syncs, overflow.sum())
    if n_over == 0:
        return pos_k, vel_k, ncon_k, 0
    starts, cnt = parts.run_bounds()
    ord2 = torch.argsort(~overflow, stable=True)
    c = 0
    while c * m < n_over:
        s0 = min(c * m, n - m)
        pick = ord2[s0:s0 + m]
        p_i = rows_s[0:3, pick]
        v_i = rows_s[3:6, pick]
        redo = overflow[pick]
        st_i = starts[:, pick]  # [9, m]
        ct_i = torch.where(redo[None], cnt[:, pick], 0)
        acc = (torch.zeros_like(v_i), torch.zeros_like(p_i),
               torch.zeros((m,), dtype=torch.int32, device=rows_s.device))
        for g in range(N_GROUPS):
            acc = _run_accumulate(rows_s, pick, p_i, v_i, rows_s[6, pick],
                                  rows_s[7, pick], st_i[g], ct_i[g], acc,
                                  beta, syncs)
        dv, dp, ncon = acc
        pos_k[:, pick] = torch.where(redo[None], p_i + dp, pos_k[:, pick])
        vel_k[:, pick] = torch.where(redo[None], v_i + dv, vel_k[:, pick])
        ncon_k[pick] = torch.where(redo, ncon, ncon_k[pick])
        c += 1
    return pos_k, vel_k, ncon_k, n_over
