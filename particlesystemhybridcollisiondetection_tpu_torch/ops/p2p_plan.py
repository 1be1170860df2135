"""The plan of the sorted 9-run particle-particle pass, in plain PyTorch.

Port of the plan functions of the JAX package's ``ops/p2p_sorted.py``:
from particles sorted by linear cell id (z fastest) to, per particle, its
nine candidate runs and their per-row windows.  ``ops/p2p_sorted.py``
builds its paths from them, and the plain version of the window kernel's
second entry point (``ops/cuda/p2p_window_kernel.py``) is their
composition: on the card that kernel derives the same plan itself.

  * ``csr_offsets``: histogram (integer scatter-add) + cumsum over cells;
  * ``run_table`` / ``run_bounds``: for each (dx, dy) in {-1,0,1}^2 the
    three z-neighbours are consecutive linear cells, so a group's
    candidates are one [start, end) interval of sorted particle indices;
  * ``window_geometry``: one window of ``window`` columns per row of 128
    sorted particles per group; runs that do not fit are flagged.
"""

from __future__ import annotations

import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import (
    BLOCK,
    LANE,
    SUB,
)

N_GROUPS = 9


def group_offsets(meta: pg.PGridMeta):
    """The nine (dx, dy) linear-cell offsets of the 3-cell z-runs."""
    dy, dz = meta.dims[1], meta.dims[2]
    return [(ox, oy, (ox * dy + oy) * dz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)]


def csr_offsets(cid_key: torch.Tensor, num_cells: int) -> torch.Tensor:
    """i32[C+2] CSR offsets over cells plus the parked pseudo-cell C;
    offsets[C] = number of active particles.  ``cid_key`` (in any order)
    holds ids in [0, C].  An integer scatter-add and a cumsum: no host
    read (``torch.bincount`` reads the maximum on CUDA), so a captured
    step can hold it."""
    offsets = torch.zeros((num_cells + 2,), dtype=torch.int32,
                          device=cid_key.device)
    ones = torch.ones(cid_key.shape, dtype=torch.int32, device=cid_key.device)
    offsets[1:].scatter_add_(0, cid_key.long(), ones)
    return torch.cumsum(offsets, 0, dtype=torch.int32)


def run_table(offsets: torch.Tensor, meta: pg.PGridMeta) -> torch.Tensor:
    """Stacked [18, C] run-bounds table: row g = start of group g's
    3-cell run for every cell, row 9+g = its end.  Built from SLICES of
    the CSR offsets (static starts, in range by the pad), so the
    per-particle bounds of all nine runs cost one stacked gather."""
    num_cells = meta.num_cells
    pad = meta.dims[1] * meta.dims[2] + meta.dims[2] + 2
    o_act = offsets[: num_cells + 1]  # offsets[C] = active count
    opad = torch.cat([
        torch.zeros((pad,), dtype=torch.int32, device=offsets.device),
        o_act,
        o_act[-1:].expand(pad),
    ])
    offs = [off for _, _, off in group_offsets(meta)]
    rows = [opad[pad + off - 1: pad + off - 1 + num_cells] for off in offs]
    rows += [opad[pad + off + 2: pad + off + 2 + num_cells] for off in offs]
    return torch.stack(rows)  # [18, C]


def run_bounds(cid_s, run_tab, meta: pg.PGridMeta):
    """Per-particle (start, count) of each of the nine runs, with
    out-of-grid rows and parked particles masked to count 0.
    Returns (starts i32[9, N], cnt i32[9, N])."""
    num_cells = meta.num_cells
    dy, dz = meta.dims[1], meta.dims[2]
    live = cid_s < num_cells
    cs = torch.clamp(cid_s, max=num_cells - 1)
    bounds = run_tab[:, cs]  # [18, N]: the one stacked planar gather
    starts = bounds[:N_GROUPS]
    ends = bounds[N_GROUPS:]
    cx_s = cs // (dy * dz)
    cy_s = (cs // dz) % dy
    ok = []
    for ox, oy, _ in group_offsets(meta):
        ok.append(
            live
            & (cx_s + ox >= 0)
            & (cx_s + ox < meta.dims[0])
            & (cy_s + oy >= 0)
            & (cy_s + oy < dy)
        )
    cnt = torch.where(torch.stack(ok), ends - starts, 0)
    return starts, cnt


def window_geometry(starts, cnt, window: int):
    """Per-row windows of the kernel over the runs of ``run_bounds``.
    Returns (rel, ws, k_cap, overflow): each run's start relative to its
    row's window (clipped to [0, window-1]), the window starts
    i32[NB, 9, 8], the per-block candidate bound i32[NB, 9] and the
    bool[n_k] mask of particles with a run outside its window."""
    n_k = starts.shape[-1]
    nb = n_k // BLOCK
    # one window per row of 128 sorted particles per group (runs with
    # cnt == 0 do not constrain it)
    big = 1 << 30
    sb = torch.where(cnt > 0, starts, big).reshape(N_GROUPS, nb * SUB, LANE)
    ws = sb.min(dim=2).values  # [9, NB*8]
    ws = torch.where(ws == big, 0, ws)
    ws = (ws // LANE) * LANE
    ws = torch.clamp(ws, 0, n_k)  # rows_pad has n_k + window columns
    k_cap = cnt.reshape(N_GROUPS, nb, BLOCK).max(dim=2).values  # [9, NB]
    rel = starts - ws.repeat_interleave(LANE, dim=1)  # [9, n_k]
    overflow = ((cnt > 0) & ((rel < 0) | (rel + cnt > window))).any(dim=0)
    rel = torch.clamp(rel, 0, window - 1)
    return (rel, ws.reshape(N_GROUPS, nb, SUB).permute(1, 0, 2).contiguous(),
            k_cap.t().contiguous(), overflow)
