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

The local contacts take B3's cells route, as the p2p episode runner's
step does (``ops/p2p_sorted.py``: ``_phase1_core``, then
``_p2p_device_fallback``), wherever the grid has three cells or more on
its fastest axis (``check_meta``; the plain versions on the CPU), and
the slot-table pass (``ops/p2p.py::p2p_collide``) elsewhere.

A slot is ``ROWS`` float32 rows: pos3, vel3, radius, restitution, then
the bits of its int32 collision counter and of its spawn id.  The id
rides every exchange, so that a particle can be found after it changed
owner; ghosts' ids are carried and never read.  Empty slots use the
sentinel convention of the rest of the package (pos = 1e38, vel = 0;
id -1), so ghosts and unused capacity behave exactly like the
reference's padding threads.  Rank 0 and the last rank have no
neighbour on one side: they fill that block with sentinel rows, which is
what the JAX package's ring-wrapped ``ppermute`` leaves there once it
drops the wrapped block.

Two forms of one step body (``_Body``):
  * ``make_domain_step``: ``state -> (state, stats)`` on a rank's slots,
    the stats summed over the mesh every step (an all_reduce);
  * ``make_domain_episode_runner``: ``DomainEpisodeRunner`` on the
    graphed-runner core (``core/graphed.py``), which carries the rank's
    slots and their ids in place; on NCCL every step replays one
    captured CUDA graph, its two exchanges inside it, and the overflow
    counters are summed over the ranks once a call.

Port of the JAX package's ``parallel/domain.py``; the buffer layouts
(``own | ghosts_from_left | ghosts_from_right``, then ``kept |
arrivals_from_left | arrivals_from_right``, each compacted stably) are
its, since the sort and the order in which contacts accumulate depend on
them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from particlesystemhybridcollisiondetection_tpu_torch.config import (
    FLOAT_SENTINEL,
    SimConfig,
)
from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as gcore
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    device_constant,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.telemetry import StepRing
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p as p2p_ops
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import BLOCK
from particlesystemhybridcollisiondetection_tpu_torch.ops.integrate import integrate
from particlesystemhybridcollisiondetection_tpu_torch.parallel import data_parallel as dp

AXIS = "shard"
#: a slot's rows: pos3 vel3 radius restitution, then the bits of the
#: collision counter and of the spawn id
ROWS = 10
#: the B3 route's contact constant and default window (the p2p steps')
BETA = 0.5
WINDOW = 512


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


class DomainShard(NamedTuple):
    """A rank's slots and each slot's spawn id (-1 where it is empty)."""

    state: ParticleState
    ids: torch.Tensor  # i32[shard_capacity]


def state_rows(state: ParticleState, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32[ROWS, n]: a state's slots with their ids (-1 without)."""
    if ids is None:
        ids = torch.full_like(state.collisions, -1)
    return torch.cat([state.pos, state.vel, state.radius[None], state.restitution[None],
                      state.collisions.view(torch.float32)[None],
                      ids.view(torch.float32)[None]], dim=0)


def rows_state(rows: torch.Tensor) -> tuple:
    """The inverse of ``state_rows``: (state, ids), views of ``rows``."""
    bits = rows[8:10].view(torch.int32)
    return ParticleState(pos=rows[0:3], vel=rows[3:6], collisions=bits[0],
                         radius=rows[6], restitution=rows[7]), bits[1]


def _active(rows: torch.Tensor) -> torch.Tensor:
    """bool[n]: the real slots (``core/state.py::active_mask``)."""
    return torch.abs(rows[0]) < FLOAT_SENTINEL * 0.5


def sentinel_bits(device) -> torch.Tensor:
    """i32[ROWS]: an empty slot's bits (pos 1e38, vel 0, radius 1,
    restitution 0, no collision, id -1)."""
    f = torch.tensor([FLOAT_SENTINEL] * 3 + [0.0] * 3 + [1.0, 0.0], dtype=torch.float32)
    return torch.cat([f.view(torch.int32),
                      torch.tensor([0, -1], dtype=torch.int32)]).to(device)


def _pack_rows(rows: torch.Tensor, mask: torch.Tensor, capacity: int,
               sentinel: Optional[torch.Tensor]):
    """Compact the masked slots to the front, truncate/pad to capacity.

    Returns (rows f32[ROWS, capacity], overflow i32 scalar).  A stable
    argsort of ``~mask`` moves the selected slots, in order, to the front
    (the replacement for the reference's atomic-append stream
    compaction, ScreenSpaceDepthCollisionDetection.compute:78-84); past
    ``n`` the order is padded with index 0, and with ``sentinel``
    (``sentinel_bits``) every slot past the count holds a sentinel row.
    """
    n = mask.shape[0]
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    if capacity <= n:
        idx = order[:capacity]
    else:
        idx = torch.cat([order, order.new_zeros(capacity - n)])
    sub = rows[:, idx]
    count = mask.sum(dtype=torch.int32)
    if sentinel is not None:
        live = torch.arange(capacity, dtype=torch.int32, device=mask.device) < count
        sub = torch.where(live[None], sub.view(torch.int32), sentinel[:, None]).view(
            torch.float32)
    return sub, torch.clamp(count - capacity, min=0)


def _exchange(mesh: DeviceMesh, to_left, to_right, from_left, from_right) -> None:
    """Send ``to_left`` to mesh rank - 1 and ``to_right`` to mesh rank + 1;
    receive into ``from_left`` and ``from_right`` in place, each left as
    it is (sentinel rows) where there is no neighbour.  Every rank of the
    mesh calls it at the same point of every step (torch requires every
    member of a group to take part in the group's first
    ``batch_isend_irecv``).  Under gloo the buffers go through host
    memory."""
    me, world = mesh.get_local_rank(), mesh.size()
    group = mesh.get_group()
    host = dp.through_host(mesh)
    ops, back = [], []
    for peer, send, recv in ((me - 1, to_left, from_left), (me + 1, to_right, from_right)):
        if not 0 <= peer < world:
            continue
        if host:
            send = send.cpu()
            back.append((torch.empty_like(send), recv))
            recv = back[-1][0]
        # P2POp names its peer by global rank; the mesh's ranks are its
        # group's
        to = dist.get_global_rank(group, peer)
        ops.append(dist.P2POp(dist.isend, send, to, group))
        ops.append(dist.P2POp(dist.irecv, recv, to, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, recv in back:
        recv.copy_(buf)


class _Body:
    """One domain step on a rank's slots (f32[ROWS, shard_capacity]), in
    the parts that the exchanges separate: ``ghosts`` (pack), the halo
    exchange, ``local`` (contacts over the rank's slots and the ghosts,
    walls, integration, the migrants' pack), the migration exchange,
    ``merge``."""

    def __init__(self, dcfg: DomainConfig, cfg: SimConfig, mesh: DeviceMesh,
                 window: int):
        dp.check_mesh(mesh)
        if mesh.size() != dcfg.n_shards:
            raise ValueError(f"{dcfg.n_shards} shards on a mesh of {mesh.size()} ranks")
        self.dcfg, self.mesh, self.window = dcfg, mesh, window
        self.me, self.world = mesh.get_local_rank(), mesh.size()
        self.device = dp.rank_device(mesh)
        self.gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=self.device)
        self.dt = cfg.dt
        self.box = tuple(device_constant(b, torch.float32, self.device)
                         for b in (dcfg.box_lo, dcfg.box_hi))
        self.meta = pg.make_meta(dcfg.box_lo, dcfg.box_hi, dcfg.cell_size,
                                 capacity=dcfg.grid_capacity)
        # B3's cells route where the run construction allows it
        # (``p2ps.check_meta``): CSR runs cannot saturate, so no per-shard
        # contact can be dropped one-sidedly (the slot table clips at
        # grid_capacity; its drops are only COUNTED)
        self.use_window = self.meta.dims[2] >= 3
        # the slab bounds in float32, as the JAX package computes them from
        # its int32 axis index
        f32 = np.float32
        slab_lo = f32(dcfg.box_lo[0]) + f32(dcfg.slab_width) * f32(self.me)
        slab_hi = slab_lo + f32(dcfg.slab_width)
        margin = f32(dcfg.cell_size)
        self.near_lo_x, self.near_hi_x = float(slab_lo + margin), float(slab_hi - margin)
        self.slab_lo, self.slab_hi = float(slab_lo), float(slab_hi)
        self.sentinel = sentinel_bits(self.device)
        # the merged buffer, padded to B3's block
        merged = dcfg.shard_capacity + 2 * dcfg.halo_capacity
        self.n_k = -(-merged // BLOCK) * BLOCK
        #: neighbours this rank sends to
        self.peers = int(self.me > 0) + int(self.me < self.world - 1)

    def blank(self, n: int) -> torch.Tensor:
        """f32[ROWS, n] of sentinel slots."""
        return self.sentinel[:, None].expand(ROWS, n).contiguous().view(torch.float32)

    def exchange(self, to_left, to_right, from_left, from_right) -> None:
        _exchange(self.mesh, to_left, to_right, from_left, from_right)

    def ghosts(self, rows):
        """The ghosts this rank sends (to the left, to the right) and the
        halo overflow."""
        act = _active(rows)
        near_lo = act & (rows[0] < self.near_lo_x)
        near_hi = act & (rows[0] >= self.near_hi_x)
        cap = self.dcfg.halo_capacity
        to_left, of_l = _pack_rows(rows, near_lo, cap, self.sentinel)
        to_right, of_r = _pack_rows(rows, near_hi, cap, self.sentinel)
        return to_left, to_right, of_l + of_r

    def _window_contacts(self, merged, act, n: int, tap):
        """B3's cells route over the merged slots (sentinels parked past
        the last cell): the rank's own ``n`` slots' positions, velocities
        and contact counts, and the window overflow's listed lanes."""
        m = merged.shape[1]
        rows8 = merged[0:8]
        key = p2ps._cell_key(merged[0:3], self.meta, act)
        if self.n_k > m:
            rows8 = torch.cat([rows8, p2ps._pad_columns(self.n_k - m, merged.device)], dim=1)
            key = torch.cat([key, torch.full((self.n_k - m,), self.meta.num_cells,
                                             dtype=torch.int32, device=merged.device)])
        parts = p2ps._phase1_core(rows8, key, self.meta, beta=BETA, window=self.window,
                                  tap=tap)
        pos_k, vel_k, ncon_k, n_over = p2ps._p2p_device_fallback(parts, BETA, tap=tap)
        if tap is not None:
            tap.stamp("rescue")
        # the sorted position of each merged slot: the own slots' results
        inv = torch.empty_like(parts.perm)
        inv[parts.perm] = torch.arange(self.n_k, dtype=parts.perm.dtype,
                                       device=merged.device)
        own = inv[:n]
        return pos_k[:, own], vel_k[:, own], ncon_k[own], n_over

    def local(self, rows, from_left, from_right, tap=None):
        """Contacts over ``rows | from_left | from_right``, then the global
        box's walls and the integrator on the rank's own slots.  Returns
        (the slots advanced, the window overflow's listed lanes, the slot
        table's cell overflow, the ghost lanes received), the last three
        i32 device scalars."""
        n = rows.shape[1]
        merged = torch.cat([rows, from_left, from_right], dim=1)
        act = _active(merged)
        own, ids = rows_state(rows)
        zero = torch.zeros((), dtype=torch.int32, device=rows.device)
        if self.use_window:
            pos, vel, ncon, n_over = self._window_contacts(merged, act, n, tap)
            # ghosts' own updates are discarded; their owners compute the
            # mirrored response from their side of the exchange
            st, cell_of = own._replace(pos=pos, vel=vel,
                                       collisions=own.collisions + ncon), zero
        else:
            out, cell_of = p2p_ops.p2p_collide(rows_state(merged)[0], self.meta, active=act)
            st, n_over = ParticleState(*(x[..., :n] for x in out)), zero
        st = p2p_ops.box_walls_collide(st, *self.box, self.gravity, self.dt)
        pos, vel = integrate(st.pos, st.vel, self.gravity, self.dt)
        if tap is not None:
            tap.stamp("integrate")
        return (state_rows(st._replace(pos=pos, vel=vel), ids), n_over,
                cell_of.to(torch.int32), act[n:].sum(dtype=torch.int32))

    def migrants(self, rows):
        """(kept, migrants to the left, to the right, migration overflow,
        migrants sent): the slots that crossed the slab's bounds."""
        n = rows.shape[1]
        act = _active(rows)
        go_left = act & (rows[0] < self.slab_lo) & (self.me > 0)
        go_right = act & (rows[0] >= self.slab_hi) & (self.me < self.world - 1)
        stay = act & ~go_left & ~go_right
        cap = self.dcfg.migrate_capacity
        to_left, of_l = _pack_rows(rows, go_left, cap, self.sentinel)
        to_right, of_r = _pack_rows(rows, go_right, cap, self.sentinel)
        kept, of_cap = _pack_rows(rows, stay, n, self.sentinel)
        return (kept, to_left, to_right, of_l + of_r + of_cap,
                (go_left | go_right).sum(dtype=torch.int32))

    def merge(self, kept, from_left, from_right):
        """The kept slots and the arrivals back into the fixed-size slots:
        (slots, overflow)."""
        merged = torch.cat([kept, from_left, from_right], dim=1)
        return _pack_rows(merged, _active(merged), kept.shape[1], self.sentinel)


def make_domain_step(dcfg: DomainConfig, cfg: SimConfig, mesh: DeviceMesh):
    """Step ``(local_state) -> (local_state, stats)`` on this rank's
    ``shard_capacity`` slots.

    Returned stats: i32[3] = (halo_overflow, migrate_overflow,
    grid_cell_overflow), summed over the mesh (the same on every rank).
    Collectives per step: two neighbour exchanges and one all_reduce,
    reached by every rank of the mesh on every step.
    """
    body = _Body(dcfg, cfg, mesh, WINDOW)
    dev = body.device

    def step(state: ParticleState):
        if state.pos.device != dev:
            raise ValueError(f"the slice is on {state.pos.device}, this rank "
                             f"computes on {dev}")
        rows = state_rows(state)
        to_left, to_right, of_h = body.ghosts(rows)
        from_left, from_right = body.blank(dcfg.halo_capacity), body.blank(dcfg.halo_capacity)
        body.exchange(to_left, to_right, from_left, from_right)
        rows, _, cell_of, _ = body.local(rows, from_left, from_right)
        kept, to_left, to_right, of_m, _ = body.migrants(rows)
        from_left = body.blank(dcfg.migrate_capacity)
        from_right = body.blank(dcfg.migrate_capacity)
        body.exchange(to_left, to_right, from_left, from_right)
        final, of_merge = body.merge(kept, from_left, from_right)
        stats = torch.stack([of_h, of_m + of_merge, cell_of])
        return rows_state(final)[0], dp.all_sum(stats, mesh)

    return step


class _DomainCarry:
    """The domain runner's carried buffers for one slot count (the
    addresses its graphs read and write): the rank's slots, the exchanges'
    receive buffers (sentinel rows where no neighbour writes) and the
    call's overflow sums (halo, migration, cell) and window overflow."""

    def __init__(self, body: _Body, cap: int):
        dev = body.device
        self.rows = torch.empty((ROWS, cap), dtype=torch.float32, device=dev)
        self.halo_in = (body.blank(body.dcfg.halo_capacity),
                        body.blank(body.dcfg.halo_capacity))
        self.mig_in = (body.blank(body.dcfg.migrate_capacity),
                       body.blank(body.dcfg.migrate_capacity))
        self.acc = torch.zeros((3,), dtype=torch.int64, device=dev)
        self.n_over = torch.zeros((), dtype=torch.int32, device=dev)


class DomainEpisodeRunner(gcore.GraphedRunner):
    """The domain step as an episode runner on the graphed-runner core:
    ``runner(shard, num_steps)`` steps this rank's slots (a
    ``DomainShard``) in place and returns them with their ids.  Every
    rank of the mesh makes the same calls.

    A call starts from the rank's particles in id order, then the empty
    slots (the order ``distribute`` lays out from a state in id order),
    and returns the slots as the last step left them; the runner restores
    no order, since particles change owner.  No step reads the host
    (``syncs.count`` stays 0).  The overflow counters (halo, migration,
    cell) stay on the device, summed over the call's steps, and are
    summed over the ranks once a call into ``drops`` (i64[3]).

    On NCCL (``graphed``) every step replays one captured CUDA graph,
    its two exchanges and their ``batch_isend_irecv`` inside it (capture
    mode "thread_local", as the mesh runner's all_reduce).  Over gloo the
    runner steps eagerly.

    A ``with_stats`` call's ``StepRing`` stamps ``start``, ``halo`` (after
    the ghost exchange), ``order``, ``main``, ``rescue`` (as the p2p
    runner's), ``integrate`` (walls and integrator) and ``end``
    (migration and merge), and counts per step the window overflow's
    listed lanes (``n_over``, ``n_lanes``), the ghost lanes received, the
    migrants sent and the rank's drops; the call returns the listed
    lanes of each step summed over the ranks."""

    def __init__(self, dcfg: DomainConfig, cfg: SimConfig, mesh: DeviceMesh, window: int):
        self.body = _Body(dcfg, cfg, mesh, window)
        self.mesh = mesh
        super().__init__(self.body.device,
                         self.body.device.type == "cuda" and not dp.through_host(mesh),
                         error_mode="thread_local")
        #: halo, migration and cell overflow summed over the ranks and calls
        self.drops = torch.zeros((3,), dtype=torch.int64, device=self.device)
        #: bytes this rank sends a step: a ghost and a migrant buffer of
        #: fixed capacity to each neighbour
        self.exchange_bytes_per_step = self.body.peers * ROWS * 4 * (
            dcfg.halo_capacity + dcfg.migrate_capacity)

    def _new_carry(self, cap: int) -> _DomainCarry:
        return _DomainCarry(self.body, cap)

    def _load(self, shard: DomainShard) -> _DomainCarry:
        rows = state_rows(shard.state, shard.ids)
        b = self._carry_for(rows.shape[1])
        key = torch.where(_active(rows), shard.ids, torch.iinfo(torch.int32).max)
        b.rows.copy_(rows[:, torch.sort(key, stable=True).indices])
        return b

    def _step(self, b: _DomainCarry, branch=None, ring: Optional[StepRing] = None):
        """One step in place on the carried slots, the exchanges into the
        carried receive buffers; with ``ring`` its stamps and counters."""
        body = self.body
        if ring is not None:
            ring.stamp("start")
        to_left, to_right, of_h = body.ghosts(b.rows)
        body.exchange(to_left, to_right, *b.halo_in)
        if ring is not None:
            ring.stamp("halo")
        rows, n_over, cell_of, ghosts = body.local(b.rows, *b.halo_in, tap=ring)
        kept, to_left, to_right, of_m, sent = body.migrants(rows)
        body.exchange(to_left, to_right, *b.mig_in)
        final, of_merge = body.merge(kept, *b.mig_in)
        b.rows.copy_(final)
        of = torch.stack([of_h, of_m + of_merge, cell_of])
        b.acc += of
        b.n_over.copy_(n_over)
        if ring is not None:
            ring.count(ghosts, sent, of.sum(dtype=torch.int32))
            ring.end(b.n_over)

    def __call__(self, shard: DomainShard, num_steps: int, with_stats: bool = False):
        """``with_stats=True``: also return each step's window-overflow
        lanes summed over the ranks (host ints, read once after the
        call's last step)."""
        dev = shard.state.pos.device
        if dev != self.device:
            raise ValueError(f"the shard is on {dev}, the runner on {self.device}")
        b = self._load(shard)
        cap = b.rows.shape[1]
        graphed = self.graphed and gcore._CAPTURE
        call = self.telemetry.calls
        self.telemetry.calls += 1
        ring = None
        if with_stats:
            ring = self._rings.get(cap)
            if ring is None:
                ring = self._rings[cap] = StepRing(dev, hybrid=False)
        overflows = self.telemetry.steps(
            call, ring, num_steps, lambda i: self._advance(cap, b, None, graphed, ring))
        self.steps += num_steps
        self.drops += dp.all_sum(b.acc, self.mesh)
        b.acc.zero_()
        st, ids = rows_state(b.rows.clone())
        out = DomainShard(st, ids)
        if not with_stats:
            return out
        return out, (dp.sum_int_list(overflows, self.mesh) if overflows else overflows)


def make_domain_episode_runner(dcfg: DomainConfig, cfg: SimConfig, mesh: DeviceMesh, *,
                               window: int = WINDOW) -> DomainEpisodeRunner:
    """The domain step's episode runner (``DomainEpisodeRunner``) on this
    rank of ``mesh``; ``window``: B3's window."""
    return DomainEpisodeRunner(dcfg, cfg, mesh, window)


def distribute(state: ParticleState, dcfg: DomainConfig, with_ids: bool = False):
    """Host-side initial placement: bucket particles into their owning
    shard's slots (sentinel-padded), returning the concatenated global
    layout ``[*, n_shards * shard_capacity]`` on the state's device; with
    ``with_ids`` also each slot's index in ``state`` (i32, -1 where
    empty)."""
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
    ids = np.full((n_total,), -1, dtype=np.int32)
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
        ids[dst] = sel
    dev = state.pos.device
    placed = ParticleState(**{k: torch.from_numpy(v).to(dev) for k, v in out.items()})
    return (placed, torch.from_numpy(ids).to(dev)) if with_ids else placed


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


def shard_spawn(state: ParticleState, dcfg: DomainConfig, mesh: DeviceMesh) -> DomainShard:
    """This rank's slots of a whole state (``distribute``), each slot's
    id its particle's index in ``state``."""
    placed, ids = distribute(state, dcfg, with_ids=True)
    cap = dcfg.shard_capacity
    r = mesh.get_local_rank()
    return DomainShard(shard_domain_state(placed, mesh),
                       ids[r * cap:(r + 1) * cap].contiguous().to(dp.rank_device(mesh)))


def gather_whole(shard: DomainShard, mesh: DeviceMesh, n: int) -> Optional[ParticleState]:
    """The whole state of ``n`` particles in id order on mesh rank 0
    (None on the others), from every rank's slots (an all_gather, on
    every rank).  A particle that no slot holds reads NaN."""
    rows = state_rows(shard.state, shard.ids)
    if dp.through_host(mesh):
        rows = rows.cpu()
    parts = [torch.empty_like(rows) for _ in range(mesh.size())]
    dist.all_gather(parts, rows, group=mesh.get_group())
    if mesh.get_local_rank() != 0:
        return None
    dev = shard.ids.device
    every = torch.cat(parts, dim=1).to(dev)
    st, ids = rows_state(every)
    live = _active(every)
    at = ids[live].long()
    nan = float("nan")
    out = ParticleState(
        pos=torch.full((3, n), nan, device=dev), vel=torch.full((3, n), nan, device=dev),
        collisions=torch.zeros((n,), dtype=torch.int32, device=dev),
        radius=torch.full((n,), nan, device=dev),
        restitution=torch.full((n,), nan, device=dev))
    out.pos[:, at] = st.pos[:, live]
    out.vel[:, at] = st.vel[:, live]
    out.collisions[at] = st.collisions[live]
    out.radius[at] = st.radius[live]
    out.restitution[at] = st.restitution[live]
    return out


def carry_collisions(spawn: DomainShard, out: DomainShard, mesh: DeviceMesh,
                     n: int) -> DomainShard:
    """``spawn`` with each particle's collision counter taken from
    ``out`` by id, wherever the particle is now (one all_reduce of the
    ``n`` counters)."""
    dev = out.ids.device
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    live = torch.abs(out.state.pos[0]) < FLOAT_SENTINEL * 0.5
    counts[out.ids[live].long()] = out.state.collisions[live]
    counts = dp.all_sum(counts, mesh)
    mine = torch.abs(spawn.state.pos[0]) < FLOAT_SENTINEL * 0.5
    got = torch.where(mine, counts[spawn.ids.clamp(min=0).long()], 0)
    return DomainShard(spawn.state._replace(collisions=got), spawn.ids)
