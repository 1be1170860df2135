"""Gather-free particle-particle collisions: dense cell-table stencil.

Port of the JAX package's ``ops/p2p_dense.py`` (the "dense" variant of
``make_p2p_step``).  The whole interaction is a *stencil*:

  1. scatter packed particle rows into a dense cell table
     [Cx, Cy, Cz, M, F] (one row scatter);
  2. for each of the 27 neighbour offsets, *shift* the table (slices, no
     indices) and evaluate all M x M slot pairs per cell as broadcast
     arithmetic;
  3. gather results back to particle order (one row gather).

The cost is proportional to the number of *cells*, and the table holds
``M * 9`` floats per cell, so this is for small, well-occupied boxes.
The contact model is that of ``ops/p2p.py``, except the weight
``m_j / (m_i + m_j + 1e-30)`` (empty slots have mass 0).
"""

from __future__ import annotations

import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg

# packed row layout: px py pz vx vy vz radius restitution mass
_F = 9


def _shift(table: torch.Tensor, d: tuple[int, int, int]) -> torch.Tensor:
    """Shift cell axes by (dx, dy, dz), zero-filling at the borders.

    table: [Cx, Cy, Cz, ...]; returns the same shape where result[c] =
    table[c + d] (zeros outside).  Zero rows have mass 0 and radius 0:
    they can never produce a contact.
    """
    out = table
    for ax, dd in enumerate(d):
        if dd == 0:
            continue
        keep = max(out.shape[ax] - abs(dd), 0)
        shifted = torch.zeros_like(out)
        if dd > 0:
            shifted.narrow(ax, 0, keep).copy_(out.narrow(ax, out.shape[ax] - keep, keep))
        else:
            shifted.narrow(ax, out.shape[ax] - keep, keep).copy_(out.narrow(ax, 0, keep))
        out = shifted
    return out


def p2p_collide_dense(
    state: ParticleState,
    meta: pg.PGridMeta,
    *,
    beta: float = 0.5,
    active=None,
) -> tuple[ParticleState, torch.Tensor]:
    """Dense-stencil p2p pass; same contract as ops.p2p.p2p_collide."""
    pos, velo = state.pos, state.vel
    n = pos.shape[-1]
    dev = pos.device
    m = meta.capacity
    num_cells = meta.num_cells
    cid = pg.linear_cell(*pg.cell_coords(pos, meta), meta)
    cid_key = cid if active is None else torch.where(active, cid, num_cells)

    # sort -> rank-in-cell (same construction as pgrid.build)
    cid_s, ids_s = torch.sort(cid_key, stable=True)
    rank = pg.rank_in_cell(cid_s)
    keep = (rank < m) & (cid_s < num_cells)
    slot_of_sorted = torch.where(keep, cid_s * m + rank, num_cells * m).long()
    overflow = ((rank >= m) & (cid_s < num_cells)).sum().to(torch.int32)

    radius = state.radius
    rows = torch.stack(
        [pos[0], pos[1], pos[2], velo[0], velo[1], velo[2],
         radius, state.restitution, radius * radius * radius],
        dim=-1,
    )  # [N, F]

    # one spare row takes every dropped write and is cut off
    table = torch.zeros((num_cells * m + 1, _F), dtype=rows.dtype, device=dev)
    table[slot_of_sorted] = rows[ids_s]
    table = table[:-1].reshape(meta.dims[0], meta.dims[1], meta.dims[2], m, _F)

    p_t = table[..., 0:3]  # [Cx, Cy, Cz, M, 3]
    v_t = table[..., 3:6]
    r_t = table[..., 6]
    e_t = table[..., 7]
    m_t = table[..., 8]
    occ = m_t > 0.0

    dv = torch.zeros_like(v_t)
    dp = torch.zeros_like(p_t)
    ncon = torch.zeros(r_t.shape, dtype=torch.int32, device=dev)
    slot_ids = torch.arange(m, dtype=torch.int32, device=dev)

    for off in pg.NEIGHBOR_OFFSETS:
        nb = _shift(table, off)  # [Cx, Cy, Cz, M, F]
        same = off == (0, 0, 0)
        # loop the neighbour slot axis: [*, M, 3]-shaped bodies only (a
        # full M x M broadcast would hold M times the table)
        for j in range(m):
            row = nb[..., j, :]
            pj = row[..., None, 0:3]  # [*, 1, 3]
            vj = row[..., None, 3:6]
            rj = row[..., None, 6]
            ej = row[..., None, 7]
            mj = row[..., None, 8]

            d = p_t - pj  # [*, M, 3]
            dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            rsum = r_t + rj
            pair_ok = occ & (mj > 0.0)
            if same:
                pair_ok = pair_ok & (slot_ids != j)
            touching = pair_ok & (dist2 < rsum * rsum) & (dist2 > 0.0)

            dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
            nrm = d / dist[..., None]
            v_rel = v_t - vj
            vn = (v_rel[..., 0] * nrm[..., 0] + v_rel[..., 1] * nrm[..., 1]
                  + v_rel[..., 2] * nrm[..., 2])
            approaching = touching & (vn < 0.0)

            e = 0.5 * (e_t + ej)
            w = mj / (m_t + mj + 1e-30)
            imp = torch.where(approaching, -(1.0 + e) * vn * w, 0.0)
            dv = dv + nrm * imp[..., None]
            overlap = torch.where(touching, rsum - dist, 0.0)
            dp = dp + nrm * (beta * overlap * w)[..., None]
            ncon = ncon + touching.to(torch.int32)

    # map per-slot results back to particle order; dropped particles
    # read the spare zero row
    res = torch.cat([dv.reshape(-1, 3), dp.reshape(-1, 3),
                     ncon.reshape(-1, 1).to(rows.dtype)], dim=-1)
    res = torch.cat([res, torch.zeros((1, 7), dtype=res.dtype, device=dev)], dim=0)
    unsorted = torch.zeros((n, 7), dtype=res.dtype, device=dev)
    unsorted[ids_s] = res[slot_of_sorted]

    return (
        state._replace(
            pos=pos + unsorted[:, 3:6].t(),
            vel=velo + unsorted[:, 0:3].t(),
            collisions=state.collisions + unsorted[:, 6].to(torch.int32),
        ),
        overflow,
    )
