"""Python-facing sphere-BVH API over the native tier (port of the JAX
package's ``native/bvh.py``; the C++ is a copy of that package's).

Capability parity with the reference's BVH construction + traversal (build
ParticleSys.cs:1103-1305; GPU node layout BvhSphereNodeGpu
ParticleSys.cs:993-1015; traversal SpatialStructureCollisionDetection
.compute:235-356).  It is deliberately NOT the hot path (the uniform grid
on the device is); the BVH exists on the host as

  * the exact CPU oracle for large-scene validation (the role the BVH
    method plays in the reference's own accuracy benchmark), and
  * parity tooling: node export in the reference's flat layout
    {center, radius, childOrStartNegated, childOrSize} for inspection
    and visualization.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch import native


@dataclasses.dataclass
class SphereBvh:
    """Flat sphere-BVH over a triangle soup."""

    nodes: np.ndarray  # f32[num_nodes, 6]: cx, cy, cz, r, a, b
    order: np.ndarray  # i64[T] sorted-position -> original triangle index
    triangles: np.ndarray  # f32[T, 3, 3] (original order)
    _handle: int = 0

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def node_levels(self) -> np.ndarray:
        """Depth of every node (for per-level visualization, the analog of
        VisualizeBvhNodes' level stepping, ParticleSys.cs:1373-1427)."""
        depth = np.zeros(self.num_nodes, dtype=np.int64)
        stack = [(0, 0)]
        while stack:
            i, d = stack.pop()
            depth[i] = d
            a = int(self.nodes[i, 4])
            b = int(self.nodes[i, 5])
            if a > 0:  # internal
                stack.append((a, d + 1))
                stack.append((b, d + 1))
        return depth

    def query(self, pos, vel, radius, dt, threads: int = 8):
        """Exact swept-sphere nearest hit for [N] particles.

        pos, vel: [N, 3] or [3, N] NumPy arrays (or tensors, copied to
        the host); radius scalar or [N].
        Returns (hit_tri i64[N] (-1 = none), t f32[N]).
        """
        lib = native.load()
        assert lib is not None and self._handle
        pos = np.ascontiguousarray(_rows(pos), dtype=np.float32)
        vel = np.ascontiguousarray(_rows(vel), dtype=np.float32)
        n = len(pos)
        r = np.ascontiguousarray(
            np.broadcast_to(np.asarray(radius, dtype=np.float32), (n,))
        )
        hit = np.empty(n, dtype=np.int64)
        t = np.empty(n, dtype=np.float32)
        lib.psys_bvh_query(self._handle, pos, vel, n, r, float(dt), hit, t, threads)
        return hit, t

    def free(self) -> None:
        lib = native.load()
        if lib is not None and self._handle:
            lib.psys_bvh_free(self._handle)
            self._handle = 0

    def __del__(self):  # pragma: no cover
        try:
            self.free()
        except Exception:
            pass


def _rows(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.ndim == 2 and x.shape[0] == 3 and x.shape[1] != 3:
        return x.T
    return x


def build_bvh(
    triangles: np.ndarray,
    max_level: int = 25,
    max_leaf_tris: int = 16,
    sah_samples: int = 64,
) -> SphereBvh:
    """Build the sphere-BVH (defaults = the reference's dragon-scene
    constants: maxLevelBvh 25, maxTrisPerBvhNode 16, maxSahSamples 64,
    ParticleSys.cs:77-82).  Requires the native library."""
    lib = native.load()
    if lib is None:
        raise RuntimeError("native tier unavailable (g++ build failed)")
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    handle = lib.psys_bvh_build(
        tris.reshape(-1), len(tris), max_level, max_leaf_tris, sah_samples
    )
    n_nodes = lib.psys_bvh_num_nodes(handle)
    nodes = np.empty((n_nodes, 6), dtype=np.float32)
    order = np.empty(len(tris), dtype=np.int64)
    lib.psys_bvh_export(handle, nodes.reshape(-1), order)
    return SphereBvh(nodes=nodes, order=order, triangles=tris, _handle=handle)
