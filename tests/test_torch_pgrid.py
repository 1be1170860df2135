"""PyTorch port, dynamic particle grid: geometry, cell coordinates, the
occupancy table and the neighbour bases are bit-identical to the JAX
package's ``ops/pgrid.py`` on the same NumPy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.ops import pgrid as jpg
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as tpg

F = np.float32

BOXES = [
    ((0, 0, 0), (8, 8, 8), 0.6, 16),
    ((-1, -1, -1), (4, 4, 4), 0.7, 32),
    ((0.0, 0.0, 0.0), (160.0, 80.0, 160.0), 0.8, 8),  # the 1M-particle box
    ((-1, -1, -1), (1, 1, 1), 2.0, 8),  # one cell
    ((0.5, -2.0, 3.0), (6.1, 2.2, 3.4), 0.37, 4),
]


def _positions(seed, n, lo, hi, n_sentinel=0, n_outside=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, size=(3, n)).astype(F)
    if n_outside:
        pos[:, :n_outside] = rng.uniform(lo - 3.0, lo - 0.5, size=(3, n_outside))
    if n_sentinel:
        pos[:, n - n_sentinel:] = 1.0e38
    return pos


@pytest.mark.parametrize("lo,hi,h,cap", BOXES)
def test_make_meta_equal(lo, hi, h, cap):
    jm = jpg.make_meta(lo, hi, h, capacity=cap)
    tm = tpg.make_meta(lo, hi, h, capacity=cap)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tm.num_cells == jm.num_cells
    assert convert.pgrid_meta_from_fields(dataclasses.asdict(jm)) == tm


@pytest.mark.parametrize("lo,hi,h,cap", BOXES[:3])
def test_cell_coords_and_linear_cell_bitwise(lo, hi, h, cap):
    """Including particles outside the box (clamped) and 1e38 sentinels,
    which must be clamped before the cast to int32."""
    jm = jpg.make_meta(lo, hi, h, capacity=cap)
    tm = tpg.make_meta(lo, hi, h, capacity=cap)
    pos = _positions(0, 3000, min(lo), max(hi), n_sentinel=50, n_outside=100)
    jc = jpg.cell_coords(jnp.asarray(pos), jm)
    tc = tpg.cell_coords(torch.from_numpy(pos), tm)
    for a, b in zip(tc, jc):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tpg.linear_cell(*tc, tm).numpy(), np.asarray(jpg.linear_cell(*jc, jm)))
    assert int(tpg.linear_cell(*tc, tm)[-1]) == tm.num_cells - 1  # sentinel


@pytest.mark.parametrize("case", ["plain", "active", "overstuffed"])
def test_build_table_and_overflow_bitwise(case):
    if case == "overstuffed":  # every particle in one cell of capacity 8
        lo, hi, h, cap = BOXES[3]
        pos = np.zeros((3, 32), dtype=F)
    else:
        lo, hi, h, cap = (0, 0, 0), (4, 4, 4), 0.5, 4
        pos = _positions(1, 700, 0.0, 4.0,
                         n_sentinel=60 if case == "active" else 0)
    jm = jpg.make_meta(lo, hi, h, capacity=cap)
    tm = tpg.make_meta(lo, hi, h, capacity=cap)
    act = np.abs(pos[0]) < 5e37 if case == "active" else None
    jg = jpg.build(jnp.asarray(pos), jm,
                   active=None if act is None else jnp.asarray(act))
    tg = tpg.build(torch.from_numpy(pos), tm,
                   active=None if act is None else torch.from_numpy(act))
    assert tg.table.dtype == torch.int32 and tg.cid.dtype == torch.int32
    np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(tg.cid.numpy(), np.asarray(jg.cid))
    assert int(tg.overflow) == int(jg.overflow)
    if case == "overstuffed":
        assert int(tg.overflow) == 32 - 8
    if case == "active":  # sentinels are inserted nowhere
        assert not np.isin(np.arange(640, 700), tg.table.numpy()).any()
        assert int(tg.overflow) > 0


def test_neighbor_cells_bitwise():
    lo, hi, h, cap = BOXES[4]
    jm = jpg.make_meta(lo, hi, h, capacity=cap)
    tm = tpg.make_meta(lo, hi, h, capacity=cap)
    pos = _positions(2, 500, -2.0, 6.0)
    jg = jpg.build(jnp.asarray(pos), jm)
    tg = tpg.build(torch.from_numpy(pos), tm)
    jb, jv = jpg.neighbor_cells(jg, jm, jnp.asarray(pos))
    tb, tv = tpg.neighbor_cells(tg, tm, torch.from_numpy(pos))
    assert tpg.NEIGHBOR_OFFSETS == jpg.NEIGHBOR_OFFSETS
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (~tv.numpy()).any() and tv.numpy().any()
