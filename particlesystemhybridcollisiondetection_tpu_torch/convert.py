"""Carry particle state and grid tables across from NumPy.

The dicts and arrays here are what the JAX package produces (its
``core/state.py::snapshot``, which the port's ``snapshot`` gives back;
the fields of its ``TriangleGrid``, ``GridMeta`` and ``PGridMeta``), so
a test can feed both packages the same inputs.  Only NumPy crosses the
boundary: nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    resolve_device,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import (
    GridMeta,
    TriangleGrid,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.pgrid import PGridMeta

_STATE_DTYPES = {
    "pos": np.float32,
    "vel": np.float32,
    "collisions": np.int32,
    "radius": np.float32,
    "restitution": np.float32,
}


def state_from_numpy(d: dict, device="cuda") -> ParticleState:
    """ParticleState from a dict of numpy arrays (pos, vel, collisions,
    radius, restitution).  Dtypes are checked, not converted."""
    dev = resolve_device(device)
    fields = {}
    for k, dt in _STATE_DTYPES.items():
        a = np.asarray(d[k])
        if a.dtype != dt:
            raise ValueError(f"{k} has dtype {a.dtype}, expected {np.dtype(dt)}")
        fields[k] = torch.tensor(a, device=dev)  # a copy
    return ParticleState(**fields)


def grid_from_numpy(offsets, tri_ids, v0, v1, v2, meta_fields: dict,
                    device="cuda") -> tuple[TriangleGrid, GridMeta]:
    """(TriangleGrid, GridMeta) from numpy CSR tables (offsets i32[C+1],
    tri_ids i32[P], planar vertices f32[3, T]) and the GridMeta fields
    (origin, cell_size, dims, max_tris_per_cell, num_pairs,
    num_triangles)."""
    dev = resolve_device(device)

    def t(a, dt):
        return torch.tensor(np.asarray(a, dtype=dt), device=dev)  # a copy

    grid = TriangleGrid(
        offsets=t(offsets, np.int32), tri_ids=t(tri_ids, np.int32),
        v0=t(v0, np.float32), v1=t(v1, np.float32), v2=t(v2, np.float32),
    )
    meta = GridMeta(
        origin=tuple(float(x) for x in meta_fields["origin"]),
        cell_size=float(meta_fields["cell_size"]),
        dims=tuple(int(x) for x in meta_fields["dims"]),
        max_tris_per_cell=int(meta_fields["max_tris_per_cell"]),
        num_pairs=int(meta_fields["num_pairs"]),
        num_triangles=int(meta_fields["num_triangles"]),
    )
    return grid, meta


def pgrid_meta_from_fields(meta_fields: dict) -> PGridMeta:
    """The particle grid's PGridMeta from the fields of the JAX
    package's (origin, cell_size, dims, capacity)."""
    return PGridMeta(
        origin=tuple(float(x) for x in meta_fields["origin"]),
        cell_size=float(meta_fields["cell_size"]),
        dims=tuple(int(x) for x in meta_fields["dims"]),
        capacity=int(meta_fields["capacity"]),
    )
