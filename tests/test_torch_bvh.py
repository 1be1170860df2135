"""PyTorch port, the native sphere-BVH oracle (``native/bvh.py`` over the
port's copy of ``psys_native.cpp``) on the CPU: node arrays and ``order``
bitwise equal to the JAX package's build, queries with hits exact and
``t`` within rtol 1e-5, the oracle agreeing with the port's grid narrow
phase, and the node invariants traversal relies on."""

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu import native as jnative
from particlesystemhybridcollisiondetection_tpu.native import bvh as jbvh
from particlesystemhybridcollisiondetection_tpu_torch import native as tnative
from particlesystemhybridcollisiondetection_tpu_torch.core import vec
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.native import bvh as tbvh
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid
from particlesystemhybridcollisiondetection_tpu_torch.ops import narrow_phase as tnph

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()), reason="no g++/native lib")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return sample_scene()


def _particles(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.0, 2.0, n),
                    rng.uniform(-6, 6, n)], axis=1).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("params", [(20, 8, 16), (25, 16, 64)])
def test_bvh_nodes_and_order_match_jax(scene, params):
    """The same build parameters give the JAX package's node array,
    triangle order and node levels bit for bit."""
    got = tbvh.build_bvh(scene.triangles, *params)
    want = jbvh.build_bvh(scene.triangles, *params)
    assert got.num_nodes == want.num_nodes > 1
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.node_levels(), want.node_levels())


def test_bvh_query_matches_jax(scene):
    """Nearest-hit queries of 2048 random swept spheres: hit triangles
    exact, t within rtol 1e-5 of the JAX package's; planar [3, N] tensors
    are accepted."""
    pos, vel = _particles(2048, seed=3)
    got = tbvh.build_bvh(scene.triangles, 20, 8, 16)
    want = jbvh.build_bvh(scene.triangles, 20, 8, 16)
    hit, t = got.query(torch.from_numpy(pos.T.copy()), torch.from_numpy(vel.T.copy()),
                       0.2, 0.004)
    jhit, jt = want.query(pos, vel, 0.2, 0.004)
    np.testing.assert_array_equal(hit, jhit)
    assert (hit >= 0).sum() > 20
    m = hit >= 0
    np.testing.assert_allclose(t[m], jt[m], rtol=1e-5)
    got.free()
    want.free()


def test_bvh_oracle_agrees_with_grid_narrow_phase(scene):
    """Random particle states: the BVH nearest-hit oracle and the port's
    grid candidates + narrow phase agree on hit / no hit and, where both
    hit, on the distance (the JAX package's own tolerances)."""
    tris = scene.triangles
    bvh = tbvh.build_bvh(tris, max_level=20, max_leaf_tris=8, sah_samples=16)
    grid, meta = tgrid.build_triangle_grid(tris, scene.config.grid, device="cpu")
    n = 512
    radius, dt = np.float32(0.2), np.float32(0.004)
    pos, velo = _particles(n)
    hit_cc, t_cc = bvh.query(pos, velo, radius, dt)

    p = torch.from_numpy(pos.T.copy())
    v = torch.from_numpy(velo.T.copy())
    speed2 = vec.dot(v, v)
    dirn = v / torch.sqrt(speed2)[None]
    seg2 = speed2 * dt * dt
    v0, v1, v2, mask = tgrid.gather_candidates(grid, meta, p)
    hits = tnph.particle_vs_triangles(p, dirn, seg2, v0, v1, v2,
                                      torch.full((n,), float(radius)))
    hm = (hits.hit & mask).numpy()
    t2 = np.where(hm, hits.t2.numpy(), np.inf)
    gr_hit = hm.any(axis=1)
    gr_t = np.take_along_axis(hits.t.numpy(), np.argmin(t2, axis=1)[:, None], 1)[:, 0]

    cc_hit = hit_cc >= 0
    assert (cc_hit == gr_hit).mean() > 0.995, np.where(cc_hit != gr_hit)[0][:10]
    both = cc_hit & gr_hit
    assert both.sum() > 20
    np.testing.assert_allclose(np.abs(t_cc[both]), np.abs(gr_t[both]),
                               rtol=1e-3, atol=1e-4)


def test_bvh_node_invariants(scene):
    """Every triangle sits in exactly one leaf; every node's sphere holds
    all vertices of its triangles."""
    bvh = tbvh.build_bvh(scene.triangles, max_level=18, max_leaf_tris=16,
                         sah_samples=16)
    nodes = bvh.nodes
    seen = np.zeros(len(scene.triangles), dtype=np.int64)
    for i in range(len(nodes)):
        a, b = int(nodes[i, 4]), int(nodes[i, 5])
        if a <= 0:
            seen[np.asarray(bvh.order[-a:-a + b])] += 1
    np.testing.assert_array_equal(seen, 1)

    def node_tris(i):
        a, b = int(nodes[i, 4]), int(nodes[i, 5])
        if a <= 0:
            return np.asarray(bvh.order[-a:-a + b])
        return np.concatenate([node_tris(a), node_tris(b)])

    rng = np.random.default_rng(0)
    for i in rng.choice(len(nodes), size=min(64, len(nodes)), replace=False):
        verts = scene.triangles[node_tris(int(i))].reshape(-1, 3)
        d = np.linalg.norm(verts - nodes[i, :3], axis=1)
        assert (d <= nodes[i, 3] + 1e-3).all(), (i, d.max(), nodes[i, 3])
