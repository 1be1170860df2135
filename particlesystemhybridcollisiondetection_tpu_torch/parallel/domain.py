"""Spatial domain decomposition across ranks (halo exchange).

For particle-particle interaction at multi-device scale, particles are
owned by the rank whose spatial slab contains them:

  * the world X range is split into ``n_shards`` equal slabs, one per
    rank of a 1-D ``DeviceMesh`` (the first ``n_shards`` ranks of the
    process group's world; ranks outside the mesh take no part);
  * each step, every rank runs the local p2p + integrate pipeline on its
    own particles plus *ghost* copies of its neighbours' boundary
    particles, received with ``batch_isend_irecv``, so cross-boundary
    contacts resolve symmetrically on both owners;
  * particles whose new position crossed into a neighbour slab migrate
    through fixed-capacity send buffers (static shapes; overflow is
    counted and surfaced, never silent).

Empty slots use the sentinel convention of the rest of the package
(pos = 1e38, vel = 0), so ghosts and unused capacity behave exactly
like the reference's padding threads.  Rank 0 and the last rank have no
neighbour on one side: they fill that block with sentinel rows, which is
what the JAX package's ring-wrapped ``ppermute`` leaves there once it
drops the wrapped block.

Port of the JAX package's ``parallel/domain.py``; the buffer layouts
(``own | ghosts_from_left | ghosts_from_right``, then ``kept |
arrivals_from_left | arrivals_from_right``) are its, since the sort and
the order in which contacts accumulate depend on them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from particlesystemhybridcollisiondetection_tpu_torch.config import (
    FLOAT_SENTINEL,
    SimConfig,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p as p2p_ops
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg
from particlesystemhybridcollisiondetection_tpu_torch.ops.integrate import integrate
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp

AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    box_lo: tuple
    box_hi: tuple
    n_shards: int
    shard_capacity: int  # per-rank particle slots (multiple of 128)
    halo_capacity: int  # ghosts sent per boundary per step
    migrate_capacity: int  # migrants sent per direction per step
    cell_size: float
    grid_capacity: int = 8

    @property
    def slab_width(self) -> float:
        return (self.box_hi[0] - self.box_lo[0]) / self.n_shards


def _take(state: ParticleState, idx: torch.Tensor) -> ParticleState:
    return ParticleState(
        pos=state.pos[:, idx],
        vel=state.vel[:, idx],
        collisions=state.collisions[idx],
        radius=state.radius[idx],
        restitution=state.restitution[idx],
    )


def _concat(*parts: ParticleState) -> ParticleState:
    return ParticleState(*(torch.cat(xs, dim=-1) for xs in zip(*parts)))


def _pack_subset(state: ParticleState, mask: torch.Tensor, capacity: int,
                 fill_sentinel: bool = True):
    """Compact masked particles to the front, truncate/pad to capacity.

    Returns (subset ParticleState[capacity], overflow i32 scalar).  A
    stable argsort of ``~mask`` moves the selected particles, in order,
    to the front (the replacement for the reference's atomic-append
    stream compaction, ScreenSpaceDepthCollisionDetection.compute:78-84);
    past ``n`` the order is padded with index 0, and with
    ``fill_sentinel`` every slot past the count holds a sentinel row.
    """
    n = mask.shape[0]
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    if capacity <= n:
        idx = order[:capacity]
    else:
        idx = torch.cat([order, order.new_zeros(capacity - n)])
    sub = _take(state, idx)
    count = mask.sum(dtype=torch.int32)
    live = torch.arange(capacity, dtype=torch.int32, device=mask.device) < count
    if fill_sentinel:
        sub = ParticleState(
            pos=torch.where(live[None], sub.pos, FLOAT_SENTINEL),
            vel=torch.where(live[None], sub.vel, 0.0),
            collisions=torch.where(live, sub.collisions, 0),
            radius=torch.where(live, sub.radius, 1.0),
            restitution=torch.where(live, sub.restitution, 0.0),
        )
    overflow = torch.clamp(count - capacity, min=0)
    return sub, overflow


def _empty_rows(n: int, device) -> ParticleState:
    return ParticleState(
        pos=torch.full((3, n), FLOAT_SENTINEL, dtype=torch.float32, device=device),
        vel=torch.zeros((3, n), dtype=torch.float32, device=device),
        collisions=torch.zeros((n,), dtype=torch.int32, device=device),
        radius=torch.ones((n,), dtype=torch.float32, device=device),
        restitution=torch.zeros((n,), dtype=torch.float32, device=device),
    )


def _exchange(mesh: DeviceMesh, to_left: ParticleState, to_right: ParticleState):
    """Send ``to_left`` to mesh rank - 1 and ``to_right`` to mesh rank
    + 1; return (from_left, from_right), each a block of sentinel rows
    where there is no neighbour.  Every rank of the mesh calls it at the
    same point of every step (torch requires every member of a group to
    take part in the group's first ``batch_isend_irecv``).  Under gloo
    the buffers go through host memory."""
    me, world = mesh.get_local_rank(), mesh.size()
    group = mesh.get_group()
    host = dp.through_host(mesh)
    dev = to_left.pos.device
    cap = to_left.pos.shape[-1]
    ops, recv = [], {}
    for peer, payload in ((me - 1, to_left), (me + 1, to_right)):
        if not 0 <= peer < world:
            continue
        send = dp.state_to_rows(payload)
        if host:
            send = send.cpu()
        recv[peer] = torch.empty_like(send)
        # P2POp names its peer by global rank; the mesh's ranks are its
        # group's
        to = dist.get_global_rank(group, peer)
        ops.append(dist.P2POp(dist.isend, send, to, group))
        ops.append(dist.P2POp(dist.irecv, recv[peer], to, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def block(peer):
        if peer not in recv:
            return _empty_rows(cap, dev)
        return dp.rows_to_state(recv[peer].to(dev))

    return block(me - 1), block(me + 1)


def make_domain_step(dcfg: DomainConfig, cfg: SimConfig, mesh: DeviceMesh):
    """Step ``(local_state) -> (local_state, stats)`` on this rank's
    ``shard_capacity`` slots.

    Returned stats: i32[3] = (halo_overflow, migrate_overflow,
    grid_cell_overflow), summed over the mesh (the same on every rank).
    Collectives per step: two neighbour exchanges and one all_reduce,
    reached by every rank of the mesh on every step.
    """
    dp.check_mesh(mesh)
    if mesh.size() != dcfg.n_shards:
        raise ValueError(f"{dcfg.n_shards} shards on a mesh of {mesh.size()} ranks")
    me = mesh.get_local_rank()
    n_sh = dcfg.n_shards
    dev = dp.rank_device(mesh)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)
    meta = pg.make_meta(dcfg.box_lo, dcfg.box_hi, dcfg.cell_size,
                        capacity=dcfg.grid_capacity)
    # sorted-segment p2p when the grid shape permits: CSR runs cannot
    # saturate, so no per-shard contact can be dropped one-sidedly (the
    # slot table clips at grid_capacity; its drops are only COUNTED)
    use_sorted = meta.dims[2] >= 3
    # the slab bounds in float32, as the JAX package computes them from
    # its int32 axis index
    f32 = np.float32
    slab_lo = f32(dcfg.box_lo[0]) + f32(dcfg.slab_width) * f32(me)
    slab_hi = slab_lo + f32(dcfg.slab_width)
    margin = f32(dcfg.cell_size)
    near_lo_x, near_hi_x = float(slab_lo + margin), float(slab_hi - margin)
    slab_lo, slab_hi = float(slab_lo), float(slab_hi)

    def step(state: ParticleState):
        if state.pos.device != dev:
            raise ValueError(f"the slice is on {state.pos.device}, this rank "
                             f"computes on {dev}")
        n_loc = state.pos.shape[-1]
        act = active_mask(state)

        # --- halo exchange: ship boundary particles to each neighbour ---
        near_lo = act & (state.pos[0] < near_lo_x)
        near_hi = act & (state.pos[0] >= near_hi_x)
        ghosts_for_left, of_l = _pack_subset(state, near_lo, dcfg.halo_capacity)
        ghosts_for_right, of_r = _pack_subset(state, near_hi, dcfg.halo_capacity)
        ghosts_from_left, ghosts_from_right = _exchange(
            mesh, ghosts_for_left, ghosts_for_right)

        # --- local p2p over own + ghost particles ---
        merged = _concat(state, ghosts_from_left, ghosts_from_right)
        act_m = active_mask(merged)
        if use_sorted:
            merged, grid_of = p2ps.p2p_collide_sorted(merged, meta, active=act_m)
        else:
            merged, grid_of = p2p_ops.p2p_collide(merged, meta, active=act_m)
        # ghosts' own updates are discarded; their owners compute the
        # mirrored response from their side of the exchange
        state = ParticleState(*(x[..., :n_loc] for x in merged))

        # --- walls + integrate (global box walls) ---
        state = p2p_ops.box_walls_collide(state, dcfg.box_lo, dcfg.box_hi,
                                          gravity, cfg.dt)
        new_pos, new_vel = integrate(state.pos, state.vel, gravity, cfg.dt)
        state = state._replace(pos=new_pos, vel=new_vel)

        # --- migration: reassign particles that crossed slab bounds ---
        act = active_mask(state)
        go_left = act & (state.pos[0] < slab_lo) & (me > 0)
        go_right = act & (state.pos[0] >= slab_hi) & (me < n_sh - 1)
        stay = act & ~go_left & ~go_right

        mig_left, ofm_l = _pack_subset(state, go_left, dcfg.migrate_capacity)
        mig_right, ofm_r = _pack_subset(state, go_right, dcfg.migrate_capacity)
        kept, of_cap = _pack_subset(state, stay, n_loc)
        arrivals_from_left, arrivals_from_right = _exchange(
            mesh, mig_left, mig_right)

        # merge kept + arrivals back into the fixed-size local buffer
        merged2 = _concat(kept, arrivals_from_left, arrivals_from_right)
        final, of_merge = _pack_subset(merged2, active_mask(merged2), n_loc)

        stats = torch.stack([
            of_l + of_r,
            ofm_l + ofm_r + of_cap + of_merge,
            # saturated-cell drops in the local p2p grid (dropped table
            # entries skip contacts one-sidedly: they must be observable)
            grid_of.to(torch.int32),
        ])
        return final, dp.all_sum(stats, mesh)

    return step


def distribute(state: ParticleState, dcfg: DomainConfig) -> ParticleState:
    """Host-side initial placement: bucket particles into their owning
    shard's slots (sentinel-padded), returning the concatenated global
    layout ``[*, n_shards * shard_capacity]`` on the state's device."""
    pos = state.pos.cpu().numpy()
    vel = state.vel.cpu().numpy()
    collisions = state.collisions.cpu().numpy()
    radius = state.radius.cpu().numpy()
    restitution = state.restitution.cpu().numpy()
    act = np.abs(pos[0]) < FLOAT_SENTINEL * 0.5
    x = pos[0]
    shard = np.clip(
        ((x - dcfg.box_lo[0]) / dcfg.slab_width).astype(np.int64),
        0,
        dcfg.n_shards - 1,
    )
    n_total = dcfg.n_shards * dcfg.shard_capacity
    out = {
        "pos": np.full((3, n_total), FLOAT_SENTINEL, dtype=np.float32),
        "vel": np.zeros((3, n_total), dtype=np.float32),
        "collisions": np.zeros((n_total,), dtype=np.int32),
        "radius": np.ones((n_total,), dtype=np.float32),
        "restitution": np.zeros((n_total,), dtype=np.float32),
    }
    for s in range(dcfg.n_shards):
        sel = np.where(act & (shard == s))[0]
        if len(sel) > dcfg.shard_capacity:
            raise ValueError(
                f"shard {s}: {len(sel)} particles > capacity {dcfg.shard_capacity}"
            )
        dst = slice(s * dcfg.shard_capacity, s * dcfg.shard_capacity + len(sel))
        out["pos"][:, dst] = pos[:, sel]
        out["vel"][:, dst] = vel[:, sel]
        out["collisions"][dst] = collisions[sel]
        out["radius"][dst] = radius[sel]
        out["restitution"][dst] = restitution[sel]
    dev = state.pos.device
    return ParticleState(**{k: torch.from_numpy(v).to(dev) for k, v in out.items()})


def shard_domain_state(state: ParticleState, mesh: DeviceMesh) -> ParticleState:
    """This rank's ``shard_capacity`` block of ``distribute``'s global
    layout, on the rank's device."""
    dp.check_mesh(mesh)
    n = state.pos.shape[-1]
    if n % mesh.size():
        raise ValueError(f"{n} slots do not divide over {mesh.size()} ranks")
    cap = n // mesh.size()
    r = mesh.get_local_rank()
    dev = dp.rank_device(mesh)
    return ParticleState(*(
        x[..., r * cap:(r + 1) * cap].contiguous().to(dev) for x in state))
