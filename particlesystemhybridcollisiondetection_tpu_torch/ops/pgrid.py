"""Dynamic particle grid: a uniform grid over the particles, rebuilt on
the device every step.

Port of the JAX package's ``ops/pgrid.py``, the broad phase of
particle-particle interaction (a capability the reference Unity project
does not have: its particles only collide with static scene geometry).

Build, static shapes throughout:
  1. ``cid = cell(pos)``, elementwise;
  2. stable sort of (cid, particle id);
  3. rank within the cell from a running maximum of segment starts;
  4. scatter particle ids into a dense ``[C, M]`` occupancy table
     (M = cell capacity); overflow is counted, never silent.

Queries walk the 27 neighbour cells x M slots with masked dense ops.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import device_constant


@dataclasses.dataclass(frozen=True)
class PGridMeta:
    """Static geometry of the dynamic particle grid."""

    origin: tuple  # world position of cell (0,0,0) corner
    cell_size: float  # must be >= 2 * max particle radius
    dims: tuple  # cells per axis
    capacity: int  # M: max particles per cell stored

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims))


class PGrid(NamedTuple):
    """One step's occupancy table."""

    table: torch.Tensor  # i32[C * M] particle ids, -1 = empty
    cid: torch.Tensor  # i32[N] cell id per particle
    overflow: torch.Tensor  # i32[] particles dropped from full cells


def make_meta(lo, hi, cell_size: float, capacity: int = 8) -> PGridMeta:
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    dims = np.maximum(np.ceil((hi - lo) / cell_size).astype(np.int64), 1)
    return PGridMeta(
        origin=tuple(float(x) for x in lo),
        cell_size=float(cell_size),
        dims=tuple(int(d) for d in dims),
        capacity=int(capacity),
    )


def cell_coords(pos: torch.Tensor, meta: PGridMeta):
    """[3, N] positions -> clamped integer cell coords (cx, cy, cz).
    The floored float is clamped before the cast, so sentinel positions
    (1e38) land in the last cell instead of overflowing int32."""
    origin = device_constant(meta.origin, pos.dtype, pos.device)
    c = torch.floor((pos - origin[:, None]) * (1.0 / meta.cell_size))
    cx = torch.clamp(c[0], 0, meta.dims[0] - 1).to(torch.int32)
    cy = torch.clamp(c[1], 0, meta.dims[1] - 1).to(torch.int32)
    cz = torch.clamp(c[2], 0, meta.dims[2] - 1).to(torch.int32)
    return cx, cy, cz


def linear_cell(cx, cy, cz, meta: PGridMeta) -> torch.Tensor:
    return (cx * meta.dims[1] + cy) * meta.dims[2] + cz


def rank_in_cell(cid_s: torch.Tensor) -> torch.Tensor:
    """i32[N]: position of each entry of the sorted cell ids within its
    run of equal ids (i minus the running maximum of segment starts)."""
    n = cid_s.shape[0]
    i = torch.arange(n, dtype=torch.int32, device=cid_s.device)
    is_start = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=cid_s.device),
        cid_s[1:] != cid_s[:-1],
    ])
    seg_start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    return i - seg_start


def build(pos: torch.Tensor, meta: PGridMeta, active=None) -> PGrid:
    """Build the occupancy table for this step.  pos: [3, N].

    ``active``: bool[N]; inactive (sentinel) particles are not inserted.
    """
    m = meta.capacity
    num_cells = meta.num_cells
    cx, cy, cz = cell_coords(pos, meta)
    cid = linear_cell(cx, cy, cz, meta)
    # inactive particles park in a virtual cell id C (sorted to the end,
    # scattered nowhere)
    cid_key = cid if active is None else torch.where(active, cid, num_cells)

    cid_s, ids_s = torch.sort(cid_key, stable=True)
    rank = rank_in_cell(cid_s)

    keep = (rank < m) & (cid_s < num_cells)
    slot = torch.where(keep, cid_s * m + rank, num_cells * m)
    # one spare slot takes every dropped write and is cut off
    table = torch.full((num_cells * m + 1,), -1, dtype=torch.int32,
                       device=pos.device)
    table[slot.long()] = torch.where(keep, ids_s.to(torch.int32), -1)
    overflow = ((rank >= m) & (cid_s < num_cells)).sum().to(torch.int32)
    return PGrid(table=table[:-1], cid=cid, overflow=overflow)


NEIGHBOR_OFFSETS = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def neighbor_cells(grid: PGrid, meta: PGridMeta, pos: torch.Tensor):
    """Per-particle neighbour cell bases.

    Returns (bases i32[27, N], in_grid bool[27, N]): the table base index
    of each of the 27 neighbour cells, in NEIGHBOR_OFFSETS order.
    """
    cx, cy, cz = cell_coords(pos, meta)
    m = meta.capacity
    bases = []
    valids = []
    for (dx, dy, dz) in NEIGHBOR_OFFSETS:
        nx = cx + dx
        ny = cy + dy
        nz = cz + dz
        in_grid = (
            (nx >= 0) & (nx < meta.dims[0])
            & (ny >= 0) & (ny < meta.dims[1])
            & (nz >= 0) & (nz < meta.dims[2])
        )
        ncell = linear_cell(
            torch.clamp(nx, 0, meta.dims[0] - 1),
            torch.clamp(ny, 0, meta.dims[1] - 1),
            torch.clamp(nz, 0, meta.dims[2] - 1),
            meta,
        )
        bases.append(ncell * m)
        valids.append(in_grid)
    return torch.stack(bases), torch.stack(valids)
