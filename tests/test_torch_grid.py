"""PyTorch port, grid broad phase: CSR tables, GridMeta, the packed
layout and the per-particle grid queries are bit-identical to the JAX
package's on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.geometry import scenes as jscenes
from particlesystemhybridcollisiondetection_tpu.ops import grid as jgrid
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid


def _scene(name):
    kw = {"tri_budget": 3000} if name == "dragon" else {}
    return jscenes.SCENES[name](**kw)


@pytest.fixture(scope="module", params=["sample", "sphere", "dragon"])
def grids(request):
    scene = _scene(request.param)
    cfg = scene.config.grid
    jg, jm = jgrid.build_triangle_grid(scene.triangles, cfg)
    tg, tm = tgrid.build_triangle_grid(scene.triangles, cfg, device="cpu")
    return scene, (jg, jm), (tg, tm)


def test_csr_tables_and_meta_bitwise(grids):
    scene, (jg, jm), (tg, tm) = grids
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for f in ("offsets", "tri_ids", "v0", "v1", "v2"):
        a, b = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_numpy_builder_matches_native(grids):
    scene, _, (tg, tm) = grids
    ng, nm = tgrid.build_triangle_grid(
        scene.triangles, scene.config.grid, use_native=False, device="cpu")
    assert dataclasses.asdict(nm) == dataclasses.asdict(tm)
    for f in tg._fields:
        np.testing.assert_array_equal(getattr(ng, f).numpy(), getattr(tg, f).numpy())


def test_pack_grid_bitwise(grids):
    _, (jg, jm), (tg, tm) = grids
    jp, jn = jgrid.pack_grid(jg, jm, group=8)
    tp, tn = tgrid.pack_grid(tg, tm, group=8)
    assert tn == jn
    np.testing.assert_array_equal(tp.rows.numpy(), np.asarray(jp.rows))
    np.testing.assert_array_equal(tp.cells.numpy(), np.asarray(jp.cells))


def test_morton_cell_codes_equal(grids):
    _, (_, jm), (_, tm) = grids
    np.testing.assert_array_equal(tgrid.morton_cell_codes(tm),
                                  jgrid.morton_cell_codes(jm))


def test_grid_queries_bitwise(grids):
    """lookup_pos, cell_coords, cell_index, morton_key on random
    positions and velocities (inside, around and far outside the grid)
    plus 1e38 sentinels; JAX runs op by op, as the port does."""
    scene, (_, jm), (_, tm) = grids
    rng = np.random.default_rng(1)
    lo = np.asarray(jm.origin)
    hi = lo + np.asarray(jm.dims) * jm.cell_size
    span = hi - lo
    n = 4096
    pos = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, size=(n, 3)).T
    pos = pos.astype(np.float32)
    pos[:, :64] = 1.0e38
    pos[1, 64:128] = -1.0e6
    vel = rng.normal(scale=50.0, size=(3, n)).astype(np.float32)
    dt = scene.config.dt
    lp_j = jgrid.lookup_pos(jnp.asarray(pos), jnp.asarray(vel), dt)
    lp_t = tgrid.lookup_pos(torch.from_numpy(pos), torch.from_numpy(vel), dt)
    np.testing.assert_array_equal(lp_t.numpy(), np.asarray(lp_j))
    for cj, ct in zip(jgrid.cell_coords(lp_j, jm), tgrid.cell_coords(lp_t, tm)):
        assert ct.dtype == torch.int32
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    ci_t = tgrid.cell_index(lp_t, tm)
    np.testing.assert_array_equal(ci_t.numpy(), np.asarray(jgrid.cell_index(lp_j, jm)))
    mk_t = tgrid.morton_key(lp_t, tm)
    assert mk_t.dtype == torch.int32
    np.testing.assert_array_equal(mk_t.numpy(), np.asarray(jgrid.morton_key(lp_j, jm)))
    # the sentinels clamp to the border cell
    assert (ci_t[:64] == ci_t[0]).all()
