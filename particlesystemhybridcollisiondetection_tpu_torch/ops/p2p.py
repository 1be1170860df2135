"""Sphere-sphere particle collisions: impulse + positional correction.

Port of the JAX package's ``ops/p2p.py``.  A capability extension over
the reference Unity project (whose particles never interact with each
other), used by the gravity-box configurations (``bench/configs.py``).

Model:
  * mass m = r^3 (uniform density), written ``r * r * r`` everywhere so
    every path and the CUDA kernel round alike;
  * contact iff 0 < dist < r_i + r_j;
  * normal impulse with restitution only when approaching
    (dot(v_rel, n) < 0): dv = -(1 + e) * (v_rel . n) * m_j / (m_i + m_j),
    applied along n to particle i (j gets the mirror image when it
    processes i: every pair is visited from both sides, so momentum is
    conserved up to float roundoff);
  * Baumgarte-style positional de-penetration: each particle moves
    beta * overlap * m_other / (m_i + m_j) along the normal;
  * pair restitution e = 0.5 * (e_i + e_j).

``pair_contact`` is that model for one candidate per lane; the slot,
sorted and window paths (and the plain version of the CUDA kernel) all
call it, in their own candidate order.
"""

from __future__ import annotations

import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    device_constant,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg


def pair_contact(pos, vel, radius, restit, mass, pj, vj, rj, ej, mj, valid,
                 beta: float):
    """One candidate j per lane i, planar layout (axis 0 = xyz; the other
    axes broadcast).  Returns (dv, dp, touching): the impulse and the
    positional correction that j gives i (zero where they do not touch)
    and the contact mask.  ``dist2 > 0`` rejects the self pair.  The
    operation order is the one ``csrc/p2p_window_kernel.cu`` repeats."""
    d = pos - pj
    dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    rsum = radius + rj
    touching = valid & (dist2 < rsum * rsum) & (dist2 > 0.0)

    dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
    nrm = d / dist[None]  # from j to i
    v_rel = vel - vj
    vn = v_rel[0] * nrm[0] + v_rel[1] * nrm[1] + v_rel[2] * nrm[2]
    approaching = touching & (vn < 0.0)

    e = 0.5 * (restit + ej)
    wgt = mj / (mass + mj)
    imp = torch.where(approaching, -(1.0 + e) * vn * wgt, 0.0)
    overlap = torch.where(touching, rsum - dist, 0.0)
    return nrm * imp[None], nrm * (beta * overlap * wgt)[None], touching


def p2p_collide(
    state: ParticleState,
    meta: pg.PGridMeta,
    *,
    beta: float = 0.5,
    active=None,
) -> tuple[ParticleState, torch.Tensor]:
    """One particle-particle collision pass over the 27 cells x capacity
    slots of the occupancy table (the "slots" variant).

    Returns (new_state, overflow_count).  ``collisions`` counts contacts
    per particle (each pair counted once on each side).  Particles
    dropped from a full cell (``overflow_count``) are missed as
    candidates: raise ``capacity`` or use the sorted variants, which
    cannot saturate.
    """
    pos, velo = state.pos, state.vel
    n = pos.shape[-1]
    dev = pos.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    grid = pg.build(pos, meta, active=active)
    bases, in_grid = pg.neighbor_cells(grid, meta, pos)  # [27, N]

    radius, restit = state.radius, state.restitution
    mass = radius * radius * radius
    m_cap = meta.capacity

    dv = torch.zeros_like(velo)
    dp = torch.zeros_like(pos)
    ncontacts = torch.zeros((n,), dtype=torch.int32, device=dev)
    for k in range(27 * m_cap):
        cell_k, slot = divmod(k, m_cap)
        j_ids = grid.table[bases[cell_k] + slot]
        valid = in_grid[cell_k] & (j_ids >= 0) & (j_ids != ids)
        j = torch.clamp(j_ids, 0, n - 1)
        ddv, ddp, touching = pair_contact(
            pos, velo, radius, restit, mass,
            pos[:, j], velo[:, j], radius[j], restit[j], mass[j], valid, beta,
        )
        dv = dv + ddv
        dp = dp + ddp
        ncontacts = ncontacts + touching.to(torch.int32)

    if active is not None:
        dv = torch.where(active[None], dv, 0.0)
        dp = torch.where(active[None], dp, 0.0)
        ncontacts = torch.where(active, ncontacts, 0)

    return (
        state._replace(
            pos=pos + dp,
            vel=velo + dv,
            collisions=state.collisions + ncontacts,
        ),
        grid.overflow,
    )


def p2p_collide_allpairs(
    state: ParticleState,
    *,
    beta: float = 0.5,
    active=None,
) -> ParticleState:
    """Direct O(n^2) all-pairs evaluation of the same contact model (the
    brute-force path of ``bench.configs.config_1``, and the oracle for
    the grid variants).  Dense [N, N] broadcasting: for a few thousand
    particles."""
    pos, velo = state.pos, state.vel
    n = pos.shape[-1]
    radius, restit = state.radius, state.restitution
    mass = radius * radius * radius
    live = (active if active is not None
            else torch.ones((n,), dtype=torch.bool, device=pos.device))
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    valid = live[:, None] & live[None, :] & ~eye

    dv, dp, touching = pair_contact(  # [3, N, N] (i, j)
        pos[:, :, None], velo[:, :, None], radius[:, None], restit[:, None],
        mass[:, None],
        pos[:, None, :], velo[:, None, :], radius[None, :], restit[None, :],
        mass[None, :], valid, beta,
    )
    return state._replace(
        pos=pos + dp.sum(dim=-1),
        vel=velo + dv.sum(dim=-1),
        collisions=state.collisions + touching.sum(dim=-1).to(torch.int32),
    )


def box_walls_collide(
    state: ParticleState,
    lo,
    hi,
    gravity: torch.Tensor,
    dt: float,
) -> ParticleState:
    """Analytic AABB container walls (the gravity-box configurations).

    Reflect-with-restitution against the six planes, in the response
    style of the spatial method: post-bounce velocity pre-compensates the
    integrator (``- g*dt``), position clamped to the wall surface.
    """
    pos, velo = state.pos, state.vel
    lo, hi = (b if isinstance(b, torch.Tensor) else
              device_constant(b, pos.dtype, pos.device) for b in (lo, hi))
    r = state.radius
    e = state.restitution

    hit_any = torch.zeros(pos.shape[-1], dtype=torch.bool, device=pos.device)
    new_pos = []
    new_vel = []
    for axis in range(3):
        low = lo[axis] + r
        high = hi[axis] - r
        p = pos[axis]
        v = velo[axis]
        hit_lo = (p < low) & (v < 0.0)
        hit_hi = (p > high) & (v > 0.0)
        new_pos.append(torch.where(hit_lo, low, torch.where(hit_hi, high, p)))
        new_vel.append(torch.where(hit_lo | hit_hi, -v * e, v))
        hit_any = hit_any | hit_lo | hit_hi
    new_vel = torch.stack(new_vel)
    # integrator pre-compensation on bounced particles (the spatial
    # response's convention)
    new_vel = torch.where(hit_any[None], new_vel - gravity[:, None] * dt, new_vel)
    return state._replace(
        pos=torch.stack(new_pos),
        vel=new_vel,
        collisions=state.collisions + hit_any.to(torch.int32),
    )
