"""Static uniform triangle grid: the broad phase.

Port of the JAX package's ``ops/grid.py``.  The reference builds a
sphere-BVH on the CPU and traverses it per particle with a 128-deep stack
(SpatialStructureCollisionDetection.compute:235-356); here, as in the JAX
package, a uniform grid replaces it:

  * Build (host, once per scene): every triangle's AABB is expanded by
    ``expand`` and binned into all cells it overlaps (with an L2
    prefilter), producing a CSR table (cell -> triangle ids).
  * Query (device, per step): each particle reads the candidates of the
    cell of its travel-segment MIDPOINT only -- one gather, no traversal.
    ``expand >= r + max_travel/2`` makes that single cell sufficient.

Particles outside the grid clamp to a border cell, provably out of reach
of every triangle (wasted candidates, never wrong results).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import GridConfig
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    device_constant,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class GridMeta:
    """Static grid geometry."""

    origin: tuple  # (3,) world position of cell (0,0,0) corner
    cell_size: float
    dims: tuple  # (3,) cells per axis
    max_tris_per_cell: int
    num_pairs: int
    num_triangles: int

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims))


class TriangleGrid(NamedTuple):
    """Device-side CSR grid + planar triangle soup."""

    offsets: torch.Tensor  # i32[C + 1]
    tri_ids: torch.Tensor  # i32[P] triangle index per (cell, tri) pair
    v0: torch.Tensor  # f32[3, T]
    v1: torch.Tensor  # f32[3, T]
    v2: torch.Tensor  # f32[3, T]


def _to_grid(offsets, tri_ids, tris32, device) -> TriangleGrid:
    dev = resolve_device(device)
    return TriangleGrid(
        offsets=torch.from_numpy(np.ascontiguousarray(offsets, dtype=np.int32)).to(dev),
        tri_ids=torch.from_numpy(np.ascontiguousarray(tri_ids, dtype=np.int32)).to(dev),
        v0=torch.from_numpy(np.ascontiguousarray(tris32[:, 0, :].T)).to(dev),
        v1=torch.from_numpy(np.ascontiguousarray(tris32[:, 1, :].T)).to(dev),
        v2=torch.from_numpy(np.ascontiguousarray(tris32[:, 2, :].T)).to(dev),
    )


def build_triangle_grid(
    triangles: np.ndarray,
    cfg: GridConfig,
    *,
    margin: float = 1e-3,
    use_native: bool = True,
    device="cuda",
) -> tuple[TriangleGrid, GridMeta]:
    """Host-side one-time build.  triangles: f32[T, 3, 3] world soup.

    Vectorized NumPy (per-triangle cell ranges -> pair expansion -> L2
    prefilter -> stable sort -> bincount CSR); with ``use_native`` the
    multithreaded C++ binner (native/psys_native.cpp) is used when it
    builds.  Both paths produce bit-identical tables.
    """
    if use_native:
        built = _build_native(triangles, cfg, margin, device)
        if built is not None:
            return built
    tris = np.asarray(triangles, dtype=np.float64)
    t_count = len(tris)
    h = float(cfg.cell_size)
    r = float(cfg.expand)

    lo_w = tris.min(axis=1) - r - margin  # [T, 3]
    hi_w = tris.max(axis=1) + r + margin

    origin = tris.reshape(-1, 3).min(axis=0) - r - h  # pad one cell
    top = tris.reshape(-1, 3).max(axis=0) + r + h
    dims = np.maximum(np.ceil((top - origin) / h).astype(np.int64), 1)

    lo = np.clip(np.floor((lo_w - origin) / h).astype(np.int64), 0, dims - 1)
    hi = np.clip(np.floor((hi_w - origin) / h).astype(np.int64), 0, dims - 1)
    span = hi - lo + 1  # [T, 3]
    counts = span.prod(axis=1)  # cells per triangle
    p_total = int(counts.sum())

    # expand (tri, cell) pairs: decode pair k's local (dx, dy, dz) from
    # its rank within the triangle
    pair_tri = np.repeat(np.arange(t_count, dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local = np.arange(p_total, dtype=np.int64) - starts[pair_tri]
    sz = span[pair_tri]  # [P, 3]
    dz = local % sz[:, 2]
    dy = (local // sz[:, 2]) % sz[:, 1]
    dx = local // (sz[:, 2] * sz[:, 1])
    cx = lo[pair_tri, 0] + dx
    cy = lo[pair_tri, 1] + dy
    cz = lo[pair_tri, 2] + dz

    # L2 prefilter: keep a pair only when the Euclidean distance between
    # the triangle's AABB and the cell box is <= expand (+ margin); the
    # native binner evaluates the identical double-precision expression
    tlo = tris.min(axis=1)
    thi = tris.max(axis=1)
    ee = r + margin
    d2 = np.zeros(p_total, dtype=np.float64)
    for a, ca in ((0, cx), (1, cy), (2, cz)):
        box_lo = origin[a] + ca * h
        box_hi = origin[a] + (ca + 1) * h
        g = np.maximum(
            np.maximum(tlo[pair_tri, a] - box_hi, box_lo - thi[pair_tri, a]),
            0.0,
        )
        d2 = d2 + g * g
    keep = d2 <= ee * ee
    pair_tri = pair_tri[keep]
    cell = (cx[keep] * dims[1] + cy[keep]) * dims[2] + cz[keep]
    p_total = int(keep.sum())

    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    tri_sorted = pair_tri[order].astype(np.int32)

    num_cells = int(dims.prod())
    cell_counts = np.bincount(cell_sorted, minlength=num_cells)
    offsets = np.zeros(num_cells + 1, dtype=np.int64)
    np.cumsum(cell_counts, out=offsets[1:])
    k_max = int(cell_counts.max()) if num_cells else 0

    meta = GridMeta(
        origin=tuple(float(x) for x in origin),
        cell_size=h,
        dims=tuple(int(d) for d in dims),
        max_tris_per_cell=max(k_max, 1),
        num_pairs=p_total,
        num_triangles=t_count,
    )
    return _to_grid(offsets, tri_sorted, tris.astype(np.float32), device), meta


def _build_native(triangles, cfg: GridConfig, margin: float, device):
    """C++ binning path; returns None when the native tier is missing."""
    from particlesystemhybridcollisiondetection_tpu_torch import native

    lib = native.load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    t_count = len(tris)
    if t_count == 0:
        return None
    handle = lib.psys_grid_build(
        tris.reshape(-1), t_count, float(cfg.cell_size), float(cfg.expand),
        float(margin), 8,
    )
    dims = np.empty(3, dtype=np.int64)
    origin = np.empty(3, dtype=np.float64)
    n_pairs = np.empty(1, dtype=np.int64)
    lib.psys_grid_info(handle, dims, origin, n_pairs)
    num_cells = int(dims.prod())
    offsets = np.empty(num_cells + 1, dtype=np.int64)
    tri_ids = np.empty(int(n_pairs[0]), dtype=np.int32)
    lib.psys_grid_export(handle, offsets, tri_ids)
    lib.psys_grid_free(handle)

    counts = np.diff(offsets)
    meta = GridMeta(
        origin=tuple(float(x) for x in origin),
        cell_size=float(cfg.cell_size),
        dims=tuple(int(d) for d in dims),
        max_tris_per_cell=max(int(counts.max()) if num_cells else 0, 1),
        num_pairs=int(n_pairs[0]),
        num_triangles=t_count,
    )
    return _to_grid(offsets, tri_ids, tris, device), meta


class PackedGrid(NamedTuple):
    """Planar packed layout of the CSR grid for the phase-3 rescue path.

    rows:  f32[group * 9, Pg]  (v0 v1 v2 xyz per candidate slot;
           sentinel 1e38 columns beyond each cell's count)
    cells: i32[2, C] = (first packed row, pair count) per cell
    """

    rows: torch.Tensor
    cells: torch.Tensor


def pack_grid(grid: TriangleGrid, meta: GridMeta, group: int = 8):
    """Build the packed layout (host side, once per scene) on the grid's
    device.  Returns (PackedGrid, num_groups_max) where num_groups_max =
    ceil(max_tris_per_cell / group) bounds the per-step gather loop."""
    dev = grid.offsets.device
    offsets = grid.offsets.cpu().numpy().astype(np.int64)
    tri_ids = grid.tri_ids.cpu().numpy()
    counts = np.diff(offsets)
    groups = (counts + group - 1) // group  # packed rows per cell
    row_start = np.concatenate([[0], np.cumsum(groups)])
    pg_rows = int(row_start[-1])

    verts = np.concatenate(
        [grid.v0.cpu().numpy().T, grid.v1.cpu().numpy().T, grid.v2.cpu().numpy().T],
        axis=1,
    ).astype(np.float32)  # [T, 9]

    rows = np.full((max(pg_rows, 1), group, 9), 1.0e38, dtype=np.float32)
    cell_of_pair = np.repeat(np.arange(len(counts)), counts)
    rank = np.arange(len(tri_ids)) - np.repeat(offsets[:-1], counts)
    dst_row = row_start[cell_of_pair] + rank // group
    dst_slot = rank % group
    rows[dst_row, dst_slot] = verts[tri_ids]

    cells = np.stack([row_start[:-1], counts], axis=0).astype(np.int32)  # [2, C]
    packed = PackedGrid(
        rows=torch.from_numpy(
            np.ascontiguousarray(rows.reshape(max(pg_rows, 1), group * 9).T)
        ).to(dev),
        cells=torch.from_numpy(cells).to(dev),
    )
    num_groups_max = int(groups.max()) if len(groups) else 1
    return packed, max(num_groups_max, 1)


def lookup_pos(pos: torch.Tensor, vel: torch.Tensor, dt: float) -> torch.Tensor:
    """Swept-lookup anchor: the midpoint of this step's travel segment.

    Every grid query keys on this, not on ``pos``: ``expand`` only covers
    ``r + travel/2`` around the midpoint.  Sentinels stay put: in float32
    ``1e38 + v*dt/2 == 1e38``, so they land in the clamped border cell.
    """
    return pos + vel * (dt * 0.5)


def cell_coords(pos: torch.Tensor, meta: GridMeta):
    """(cx, cy, cz) i32[N] clamped cell coordinates for positions [3, N]."""
    origin = device_constant(meta.origin, pos.dtype, pos.device)
    inv_h = 1.0 / meta.cell_size
    dims = meta.dims
    # floor + clip per axis; sentinel positions (1e38) clamp to the border
    c = torch.floor((pos - origin[:, None]) * inv_h)
    cx = torch.clamp(c[0], 0, dims[0] - 1).to(torch.int32)
    cy = torch.clamp(c[1], 0, dims[1] - 1).to(torch.int32)
    cz = torch.clamp(c[2], 0, dims[2] - 1).to(torch.int32)
    return cx, cy, cz


def cell_index(pos: torch.Tensor, meta: GridMeta) -> torch.Tensor:
    """i32[N] linear cell id for particle positions [3, N] (clamped)."""
    cx, cy, cz = cell_coords(pos, meta)
    dims = meta.dims
    return (cx * dims[1] + cy) * dims[2] + cz


def _morton_spread(x):
    """Spread the low 10 bits of x to every 3rd bit (int32 tensors or
    NumPy int32 arrays; stays int32)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key(pos: torch.Tensor, meta: GridMeta) -> torch.Tensor:
    """i32[N] Morton (z-order) code of each particle's cell: the sort key
    of the sorted pipeline (3D-adjacent cells stay id-adjacent, so a row
    of 128 sorted particles maps to a compact range of the Morton-ordered
    pair table)."""
    cx, cy, cz = cell_coords(pos, meta)
    return (
        _morton_spread(cx)
        | (_morton_spread(cy) << 1)
        | (_morton_spread(cz) << 2)
    )


def morton_cell_codes(meta: GridMeta) -> np.ndarray:
    """Host-side i64[C] Morton code of every linear cell id."""
    dims = meta.dims
    allc = np.arange(meta.num_cells, dtype=np.int64)
    cz = allc % dims[2]
    cy = (allc // dims[2]) % dims[1]
    cx = allc // (dims[2] * dims[1])
    return (
        _morton_spread(cx.astype(np.int32)).astype(np.int64)
        | (_morton_spread(cy.astype(np.int32)).astype(np.int64) << 1)
        | (_morton_spread(cz.astype(np.int32)).astype(np.int64) << 2)
    )


def gather_candidates(grid: TriangleGrid, meta: GridMeta, pos: torch.Tensor):
    """Per-particle candidate triangles of the cell holding ``pos``
    [3, N]: (v0, v1, v2, mask) with vertices f32[3, N, K] and validity
    bool[N, K], K = ``meta.max_tris_per_cell`` (the "dense" variant's
    broad phase: three gathers)."""
    k = meta.max_tris_per_cell
    cid = cell_index(pos, meta).long()
    start = grid.offsets[cid]
    count = grid.offsets[cid + 1] - start
    j = torch.arange(k, dtype=torch.int32, device=pos.device)[None, :]
    mask = j < count[:, None]
    pair_idx = torch.clamp(start[:, None] + j, 0, grid.tri_ids.shape[0] - 1)
    tid = grid.tri_ids[pair_idx.long()].long()
    return grid.v0[:, tid], grid.v1[:, tid], grid.v2[:, tid], mask
