"""The reference's broad phase: the uniform triangle grid, built again
from the benchmark's triangle soup in plain PyTorch (float64 on the run's
device).  Every triangle's AABB grows by ``expand`` (+ a 1e-3 margin) and
is binned into each cell it overlaps whose box lies within that distance
of it; the grid is padded by one cell beyond the reach; each cell lists
its triangles in ascending index.  The rule and its floating-point
expressions are the semantics the program documents for its grid
(``ops/grid.py``), so a particle's candidates, and their order, are the
program's.
"""

from __future__ import annotations

import torch

MARGIN = 1e-3


def build(triangles, cell_size: float, expand: float, device) -> dict:
    """CSR grid of ``triangles`` f32[T, 3, 3]: ``offsets`` i64[C + 1],
    ``tri_ids`` i64[P], ``origin`` (3 Python floats), ``dims``
    (3 ints), and the vertices ``v0, v1, v2`` f32[3, T]."""
    f64 = dict(dtype=torch.float64, device=device)
    tris32 = torch.as_tensor(triangles, dtype=torch.float32).to(device)
    tris = tris32.to(torch.float64)
    t_count = tris.shape[0]
    h, r = float(cell_size), float(expand)

    lo_w = tris.min(dim=1).values - r - MARGIN
    hi_w = tris.max(dim=1).values + r + MARGIN
    flat = tris.reshape(-1, 3)
    origin = flat.min(dim=0).values - r - h
    top = flat.max(dim=0).values + r + h
    dims = torch.clamp(torch.ceil((top - origin) / h).to(torch.int64), min=1)

    lo = torch.minimum(torch.clamp(torch.floor((lo_w - origin) / h).to(torch.int64),
                                   min=0), dims - 1)
    hi = torch.minimum(torch.clamp(torch.floor((hi_w - origin) / h).to(torch.int64),
                                   min=0), dims - 1)
    span = hi - lo + 1
    counts = span.prod(dim=1)
    p_total = int(counts.sum())

    pair_tri = torch.repeat_interleave(torch.arange(t_count, device=device), counts)
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(p_total, device=device) - starts[pair_tri]
    sz = span[pair_tri]
    dz = local % sz[:, 2]
    dy = (local // sz[:, 2]) % sz[:, 1]
    dx = local // (sz[:, 2] * sz[:, 1])
    cc = (lo[pair_tri, 0] + dx, lo[pair_tri, 1] + dy, lo[pair_tri, 2] + dz)
    del local, sz, dx, dy, dz

    # keep a pair when the triangle's AABB lies within expand (+ margin)
    # of the cell's box
    tlo = tris.min(dim=1).values
    thi = tris.max(dim=1).values
    ee = r + MARGIN
    d2 = torch.zeros(p_total, **f64)
    for a in range(3):
        box_lo = origin[a] + cc[a].to(torch.float64) * h
        box_hi = origin[a] + (cc[a] + 1).to(torch.float64) * h
        g = torch.clamp(torch.maximum(tlo[pair_tri, a] - box_hi,
                                      box_lo - thi[pair_tri, a]), min=0.0)
        d2 = d2 + g * g
    keep = d2 <= ee * ee
    d1, d2_ = int(dims[1]), int(dims[2])
    cell = (cc[0][keep] * d1 + cc[1][keep]) * d2_ + cc[2][keep]
    cell_sorted, order = torch.sort(cell, stable=True)
    tri_ids = pair_tri[keep][order]

    num_cells = int(dims.prod())
    offsets = torch.zeros(num_cells + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(torch.bincount(cell_sorted, minlength=num_cells), 0)
    return {
        "offsets": offsets,
        "tri_ids": tri_ids,
        "origin": tuple(float(x) for x in origin.tolist()),
        "dims": tuple(int(x) for x in dims.tolist()),
        "cell_size": h,
        "v0": tris32[:, 0, :].T.contiguous(),
        "v1": tris32[:, 1, :].T.contiguous(),
        "v2": tris32[:, 2, :].T.contiguous(),
    }
