"""Broad-phase structure visualization (the BVH-viz analog; port of the
JAX package's ``viz/grid_viz.py``, host NumPy over the grid tables).

The reference instantiates translucent spheres for BVH nodes -- all of
them, per-level, or leaves only -- in a dedicated scene
(ParticleSys.cs:1310-1427, SphericalBVHNode.shader, BVHVisualizationScene).
The acceleration structure here is a uniform triangle grid, so its
debug views are:

  * occupancy heatmaps: triangle count per cell, projected along an axis
    (one PNG per requested Y-slab = the "per-level" analog),
  * a text summary of build statistics (the analog of the reference's
    Debug.Log node counts / byte sizes, ParticleSys.cs:396-405).
"""

from __future__ import annotations

import os

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import GridMeta, TriangleGrid
from particlesystemhybridcollisiondetection_tpu_torch.utils.io import write_png


def _heat_rgb(v: np.ndarray) -> np.ndarray:
    """0..1 -> dark blue -> cyan -> yellow -> red."""
    v = np.clip(v, 0.0, 1.0)
    r = np.clip(3.0 * v - 1.2, 0, 1)
    g = np.clip(2.2 * v - 0.1, 0, 1) * (1 - 0.55 * r)
    b = np.clip(1.0 - 2.2 * v, 0.08, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def cell_counts(grid: TriangleGrid, meta: GridMeta) -> np.ndarray:
    """i64[dims] triangles per cell."""
    offs = grid.offsets.cpu().numpy()
    return np.diff(offs).reshape(meta.dims)


def occupancy_heatmap(
    grid: TriangleGrid,
    meta: GridMeta,
    axis: int = 1,
    slab: slice | None = None,
    upscale: int = 4,
) -> np.ndarray:
    """Project per-cell triangle counts along ``axis`` -> uint8 RGB image.

    ``slab`` restricts the projected range (the per-level analog).
    """
    counts = cell_counts(grid, meta).astype(np.float64)
    if slab is not None:
        counts = np.take(counts, np.r_[slab], axis=axis)
    proj = counts.sum(axis=axis)
    img = _heat_rgb(proj / max(proj.max(), 1.0))
    img = np.kron(img, np.ones((upscale, upscale, 1), dtype=np.uint8))
    return img


def write_grid_report(
    grid: TriangleGrid,
    meta: GridMeta,
    out_dir: str,
    name: str = "grid",
    y_slabs: int = 4,
) -> list[str]:
    """Write heatmap PNGs + a build-stats text file.  Returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    top = os.path.join(out_dir, f"{name}_occupancy_top.png")
    write_png(top, occupancy_heatmap(grid, meta, axis=1))
    paths.append(top)
    ny = meta.dims[1]
    for s in range(y_slabs):
        lo = s * ny // y_slabs
        hi = (s + 1) * ny // y_slabs
        p = os.path.join(out_dir, f"{name}_occupancy_y{lo:03d}-{hi:03d}.png")
        write_png(p, occupancy_heatmap(grid, meta, axis=1, slab=slice(lo, hi)))
        paths.append(p)
    side = os.path.join(out_dir, f"{name}_occupancy_side.png")
    write_png(side, occupancy_heatmap(grid, meta, axis=2))
    paths.append(side)

    counts = cell_counts(grid, meta)
    nz = counts[counts > 0]
    stats = os.path.join(out_dir, f"{name}_stats.txt")
    with open(stats, "w") as f:
        f.write(
            f"dims: {meta.dims}  cell_size: {meta.cell_size}\n"
            f"cells: {meta.num_cells}  nonempty: {nz.size}"
            f" ({100.0 * nz.size / max(meta.num_cells, 1):.2f}%)\n"
            f"triangles: {meta.num_triangles}  pairs: {meta.num_pairs}\n"
            f"tris/cell: mean {nz.mean() if nz.size else 0:.2f}"
            f"  p50 {np.percentile(nz, 50) if nz.size else 0:.0f}"
            f"  p99 {np.percentile(nz, 99) if nz.size else 0:.0f}"
            f"  max {nz.max() if nz.size else 0}\n"
            f"table bytes: offsets {grid.offsets.nbytes}"
            f" + tri_ids {grid.tri_ids.nbytes}"
            f" + verts {grid.v0.nbytes * 3}\n"
        )
    paths.append(stats)
    return paths
