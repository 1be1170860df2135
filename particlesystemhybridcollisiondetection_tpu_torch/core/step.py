"""The three collision methods' steps (``make_method_step``), the sorted
persistent episode runner, and the particle-particle gravity-box step
and its episode runner.

Port of the JAX package's ``core/step.py``: the brute-force oracle step
(``make_spatial_step_bruteforce``), the grid steps
(``make_spatial_step_grid``: packed, stream, dense), the screen-space and
hybrid steps, the episode and trajectory runners, the
sorted pipeline (spatial and hybrid), the runner with its ``camera=``
(hybrid) stage, and the p2p entry points (``make_p2p_step``,
``make_p2p_episode_runner``, at the end of this file).  The hybrid
method runs the screen-space stage first; its undecided mask zeroes the
candidate counts of decided particles in the exact stage.  One sorted
spatial step runs, in order: sort the particles on the Morton key of their
travel-segment midpoint; look up each particle's ``(start, count)`` (the
cells kernel, or a gather from ``cells2``); plan one candidate window per
row of 128 sorted particles; run the window kernel (exact narrow phase,
response and integration, fused); redo the lanes whose candidates did
not fit their window exactly, in up to three phases (``_chunked_rescue``).  The
response runs before integration and pre-compensates it with ``-g*dt``,
as in the reference's frame loop (ParticleSys.cs:445-527).

The JAX package decides its data-dependent branches on the device
(``lax.cond``/``while_loop``).  Eager PyTorch reads those scalars back to
the host (``.item()``); the branch sequence is the JAX package's, and
every read is counted in ``HostSyncs``.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import (
    FLOAT_SENTINEL,
    Method,
    SimConfig,
)
from particlesystemhybridcollisiondetection_tpu_torch.core import vec
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    active_mask,
    resolve_device,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops import narrow_phase as nphase
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p as p2p_ops
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import (
    BLOCK,
    LANE,
    SUB,
    _CODE_TABLE_MAX,
    build_code_table,
    build_window_tables,
    cells_window_lookup,
    window_collide_sorted,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import (
    _morton_spread,
    build_triangle_grid,
    cell_index,
    gather_candidates,
    lookup_pos,
    morton_key,
    pack_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.integrate import integrate
from particlesystemhybridcollisiondetection_tpu_torch.ops.p2p_dense import (
    p2p_collide_dense,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.screenspace import (
    bake_camera,
    screen_space_collide,
)


class HostSyncs:
    """Counts the device scalars read back to the host (each read waits
    for the device): the eager form of the JAX package's on-device
    branches."""

    def __init__(self):
        self.count = 0

    def read(self, t: torch.Tensor) -> int:
        self.count += 1
        return int(t.item())


# candidate-lane elements the oracle paths and the packed path evaluate
# at once: each of the narrow phase's temporaries is then 16 MiB of f32.
# Lanes are independent and chunks merge with the first-minimum rule, so
# the chunking never changes a result.
_CHUNK_ELEMS = 1 << 22


def _merge_nearest(best, cand):
    """Fold (t2, hit, t, normal) ``cand`` into ``best``: a later chunk of
    candidates wins only when strictly nearer (first minimum overall)."""
    if best is None:
        return cand
    take = cand[0] < best[0]
    return (
        torch.where(take, cand[0], best[0]),
        torch.where(take, cand[1], best[1]),
        torch.where(take, cand[2], best[2]),
        vec.where(take, cand[3], best[3]),
    )


def spatial_collide(
    state: ParticleState,
    v0: torch.Tensor,
    v1: torch.Tensor,
    v2: torch.Tensor,
    gravity: torch.Tensor,
    dt: float,
    backoff: float,
    cand_mask: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> ParticleState:
    """Spatial-structure collision detection + response on a candidate set.

    v0, v1, v2: [3, N, K] per-particle candidates, or [3, K] shared
    candidates (every particle tests all of them: the brute-force path).
    ``cand_mask``: bool[N, K] validity of each candidate.  ``active``:
    bool[N] collide these particles only.  Evaluated in chunks of lanes
    and candidates (``_CHUNK_ELEMS``), so a 400k-triangle brute force
    fits in memory; the result is the unchunked one.
    """
    pos, velo = state.pos, state.vel
    n, k = pos.shape[-1], v0.shape[-1]
    speed2 = vec.dot(velo, velo)
    dirn = vec.normalize(velo)  # NaN on vel == 0 lanes; masked below
    seg_len2 = speed2 * (dt * dt)

    lanes = max(1, min(n, _CHUNK_ELEMS // max(1, min(k, 1024))))
    kc = max(1, min(k, _CHUNK_ELEMS // lanes))
    parts = []
    for a in range(0, n, lanes):
        ln = slice(a, a + lanes)
        best = None
        for b in range(0, k, kc):
            kn = slice(b, b + kc)
            if v0.ndim == 2:  # shared candidates, broadcast over particles
                c0, c1, c2 = (v[:, None, kn] for v in (v0, v1, v2))
            else:
                c0, c1, c2 = (v[:, ln, kn] for v in (v0, v1, v2))
            hits = nphase.particle_vs_triangles(
                pos[:, ln], dirn[:, ln], seg_len2[ln], c0, c1, c2,
                state.radius[ln])
            hit_mask = hits.hit
            if cand_mask is not None:
                hit_mask = hit_mask & cand_mask[ln, kn]
            hits = hits._replace(
                hit=hit_mask, t2=torch.where(hit_mask, hits.t2, float("inf")))
            nh = nphase.nearest_hit(hits)
            best = _merge_nearest(
                best, (hits.t2.amin(dim=-1), nh.hit, nh.t, nh.normal))
        parts.append(best)
    _, hit, t, normal = (torch.cat(x, dim=-1) for x in zip(*parts))

    # vel == 0 guard (SpatialStructureCollisionDetection.compute:237)
    hit = hit & (speed2 != 0.0)
    if active is not None:
        hit = hit & active
    new_pos, new_vel = nphase.spatial_response(
        pos, velo, dirn, hit, t, normal, gravity, dt, state.radius,
        state.restitution, backoff,
    )
    return state._replace(
        pos=new_pos, vel=new_vel,
        collisions=state.collisions + hit.to(torch.int32),
    )


def _planar_triangles(triangles, device):
    """[T, 3, 3] host soup -> three [3, T] planar tensors on ``device``."""
    tris = np.asarray(triangles, dtype=np.float32)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(tris[:, i, :].T)).to(device)
        for i in range(3))


def make_spatial_step_bruteforce(triangles, cfg: SimConfig, *, device="cuda"):
    """Spatial method with every scene triangle as a candidate: O(N*T),
    the validation oracle (the role of the reference's BVH as ground
    truth).  Use the grid steps for real workloads."""
    dev = resolve_device(device)
    v0, v1, v2 = _planar_triangles(triangles, dev)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)

    def step(state: ParticleState) -> ParticleState:
        state = spatial_collide(state, v0, v1, v2, gravity, cfg.dt, cfg.backoff)
        new_pos, new_vel = integrate(state.pos, state.vel, gravity, cfg.dt)
        return state._replace(pos=new_pos, vel=new_vel)

    return step


def spatial_collide_stream(
    state: ParticleState,
    grid,
    meta,
    gravity: torch.Tensor,
    dt: float,
    backoff: float,
    active: Optional[torch.Tensor] = None,
) -> ParticleState:
    """Grid spatial collision via the streaming narrow phase: one
    candidate slot of every particle per iteration, [N]-shaped tensors
    only (``narrow_phase.swept_collide_stream``), over all
    ``meta.max_tris_per_cell`` slots."""
    pos, velo = state.pos, state.vel
    speed2 = vec.dot(velo, velo)
    dirn = vec.normalize(velo)
    seg_len2 = speed2 * (dt * dt)

    cid = cell_index(lookup_pos(pos, velo, dt), meta).long()
    start = grid.offsets[cid]
    count = grid.offsets[cid + 1] - start
    p_max = grid.tri_ids.shape[0] - 1

    def gather_fn(j):
        tid = grid.tri_ids[torch.clamp(start + j, 0, p_max).long()].long()
        return grid.v0[:, tid], grid.v1[:, tid], grid.v2[:, tid], j < count

    nearest = nphase.swept_collide_stream(
        pos, dirn, seg_len2, state.radius, gather_fn, meta.max_tris_per_cell)
    hit = nearest.hit & (speed2 != 0.0)
    if active is not None:
        hit = hit & active
    new_pos, new_vel = nphase.spatial_response(
        pos, velo, dirn, hit, nearest.t, nearest.normal,
        gravity, dt, state.radius, state.restitution, backoff,
    )
    return state._replace(
        pos=new_pos, vel=new_vel,
        collisions=state.collisions + hit.to(torch.int32),
    )


def spatial_collide_packed(
    state: ParticleState,
    packed,
    meta,
    num_groups: int,
    group: int,
    gravity: torch.Tensor,
    dt: float,
    backoff: float,
    active: Optional[torch.Tensor] = None,
    *,
    syncs: HostSyncs,
) -> ParticleState:
    """Grid spatial collision via the packed planar layout: one [2, N]
    cell gather + one row gather of the groups of candidates the densest
    occupied cell needs (the CPU spatial path and the phase-3 rescue;
    ops.grid.PackedGrid)."""
    pos, velo = state.pos, state.vel
    n = pos.shape[-1]
    dev = pos.device
    speed2 = vec.dot(velo, velo)
    dirn = vec.normalize(velo)
    seg_len2 = speed2 * (dt * dt)

    cid = cell_index(lookup_pos(pos, velo, dt), meta)
    info = packed.cells[:, cid]  # [2, N]
    row0 = info[0]
    count = info[1]
    max_row = packed.rows.shape[1] - 1

    # adaptive trip count: the densest cell these particles occupy (at
    # least one group, all masked invalid when every count is 0)
    g_bound = max(1, min(syncs.read((count.max() + group - 1) // group),
                         num_groups))
    # all g_bound groups at once: candidate j = g * group + slot on axis
    # 1 ([3, J, N]), particles on the last axis, in chunks of lanes.  The
    # first minimal t2 over j is what the JAX package's per-group argmin
    # + strict-< fold keeps.
    n_cand = g_bound * group
    g_idx = torch.arange(g_bound, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(n_cand, dtype=torch.int32, device=dev)[:, None]
    lanes = max(1, _CHUNK_ELEMS // n_cand)
    parts = []
    for a in range(0, n, lanes):
        ln = slice(a, a + lanes)
        m = min(n, a + lanes) - a
        rows = packed.rows[:, torch.clamp(row0[None, ln] + g_idx, 0, max_row)]
        r9 = rows.reshape(group, 9, g_bound, m).permute(1, 2, 0, 3).reshape(
            9, n_cand, m)
        valid = j < count[None, ln]  # [J, m]
        hits = nphase.particle_vs_triangles_pre(
            pos[:, None, ln], dirn[:, None, ln], seg_len2[None, ln],
            r9[0:3], r9[3:6], r9[6:9], state.radius[None, ln],
        )
        hit_j = hits.hit & valid
        t2_j = torch.where(hit_j, hits.t2, float("inf"))
        k_best = torch.argmin(t2_j, dim=0)[None]  # [1, m], first minimum
        best_t2 = torch.gather(t2_j, 0, k_best)[0]
        take = best_t2 < float("inf")
        parts.append((
            best_t2,
            torch.where(take, torch.gather(hits.t, 0, k_best)[0], float("inf")),
            vec.where(take, torch.gather(
                hits.normal, 1, k_best[None].expand(3, 1, m))[:, 0], 0.0),
            hit_j.any(dim=0),
        ))
    best_t2, best_t, best_n, any_hit = (torch.cat(x, dim=-1) for x in zip(*parts))

    hit = any_hit & (best_t2 < float("inf")) & (speed2 != 0.0)
    if active is not None:
        hit = hit & active

    new_pos, new_vel = nphase.spatial_response(
        pos, velo, dirn, hit, best_t, best_n,
        gravity, dt, state.radius, state.restitution, backoff,
    )
    return state._replace(
        pos=new_pos, vel=new_vel,
        collisions=state.collisions + hit.to(torch.int32),
    )


SPATIAL_GRID_VARIANTS = ("packed", "stream", "dense")


def make_spatial_step_grid(triangles, cfg: SimConfig, variant: str = "packed",
                           group: int = 8, *, device="cuda"):
    """Spatial method with the static CSR triangle grid broad phase: one
    cell lookup per particle, the narrow phase over the cell's
    candidates, then the integrator.

    Variants (identical semantics, different memory behaviour):
      * "packed": packed-row gathers (``spatial_collide_packed``), the
        CPU path;
      * "stream": one candidate slot per iteration, [N]-only shapes (an
        oracle: about 60 eager operations per slot);
      * "dense": the [3, N, K] candidate gather (``gather_candidates``,
        the testing baseline).
    The step's ``syncs`` attribute counts its host reads.
    """
    if variant not in SPATIAL_GRID_VARIANTS:
        raise ValueError(f"unknown spatial variant {variant!r}")
    dev = resolve_device(device)
    grid, meta = build_triangle_grid(triangles, cfg.grid, device=dev)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)
    syncs = HostSyncs()
    if variant == "dense":
        def collide(state):
            v0, v1, v2, mask = gather_candidates(
                grid, meta, lookup_pos(state.pos, state.vel, cfg.dt))
            return spatial_collide(state, v0, v1, v2, gravity, cfg.dt,
                                   cfg.backoff, cand_mask=mask)
    elif variant == "stream":
        def collide(state):
            return spatial_collide_stream(state, grid, meta, gravity, cfg.dt,
                                          cfg.backoff)
    else:
        packed, num_groups = pack_grid(grid, meta, group=group)

        def collide(state):
            return spatial_collide_packed(
                state, packed, meta, num_groups, group, gravity, cfg.dt,
                cfg.backoff, syncs=syncs)

    def step(state: ParticleState) -> ParticleState:
        state = collide(state)
        new_pos, new_vel = integrate(state.pos, state.vel, gravity, cfg.dt)
        return state._replace(pos=new_pos, vel=new_vel)

    step.syncs = syncs
    return step


def make_screenspace_step(triangles, cfg: SimConfig, camera, normals=None, *,
                          device="cuda"):
    """Screen-space depth collision method (ParticleSys.cs:455-459 path):
    the screen-space pass against the baked camera, then the integrator.

    ``normals``: optional per-corner shading normals f32[T, 3, 3] for the
    pre-pass (NormalPrePass.shader interpolation); face normals otherwise.
    """
    dev = resolve_device(device)
    tex = bake_camera(triangles, camera, normals, device=dev)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)

    def step(state: ParticleState) -> ParticleState:
        state, _ = screen_space_collide(state, tex, gravity, cfg.dt)
        new_pos, new_vel = integrate(state.pos, state.vel, gravity, cfg.dt)
        return state._replace(pos=new_pos, vel=new_vel)

    return step


def make_hybrid_step(triangles, cfg: SimConfig, camera, normals=None, *,
                     device="cuda"):
    """Hybrid method (ParticleSys.cs:622-639): the screen-space stage,
    then the exact packed spatial stage restricted to the undecided set,
    then the integrator.  The reference's atomic append + indirect
    dispatch (ComputeDispatchArgs.compute:9-21) is a boolean mask here.
    The step's ``syncs`` attribute counts its host reads."""
    dev = resolve_device(device)
    tex = bake_camera(triangles, camera, normals, device=dev)
    grid, meta = build_triangle_grid(triangles, cfg.grid, device=dev)
    group = 8
    packed, num_groups = pack_grid(grid, meta, group=group)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)
    syncs = HostSyncs()

    def step(state: ParticleState) -> ParticleState:
        state, undecided = screen_space_collide(
            state, tex, gravity, cfg.dt, hybrid=True)
        state = spatial_collide_packed(
            state, packed, meta, num_groups, group, gravity, cfg.dt,
            cfg.backoff, active=undecided, syncs=syncs,
        )
        new_pos, new_vel = integrate(state.pos, state.vel, gravity, cfg.dt)
        return state._replace(pos=new_pos, vel=new_vel)

    step.syncs = syncs
    return step


def _window_plan(cid_s, cells2, window: int, nb: int, active_s=None,
                 demote=None):
    """Per-row window plan with the (start, count) lookup as a gather
    from the planar ``cells2`` table (the "gather" plan)."""
    info = cells2[:, cid_s]  # [2, N]
    count = info[1]
    if active_s is not None:
        count = torch.where(active_s, count, 0)
    return _plan_tail(info[0], count, window, nb, demote=demote)


def _plan_tail(start, count, window: int, nb: int, miss=None, demote=None):
    """Window geometry: each row of 128 sorted particles gets its own
    window of ``window`` pair rows starting at its smallest candidate
    start (rounded down to 128).  Returns (rel, count, ws i32[nb, 8],
    k_cap i32[nb], overflow bool[N], ovf_count): each particle's start
    relative to its row's window, the per-block candidate bound, the
    lanes whose candidates do not fit (redone by the rescue), and the
    pre-zeroing counts (the phase-3 compaction order)."""
    big = 1 << 30
    sb = torch.where(count > 0, start, big).reshape(nb * SUB, LANE)
    ws = sb.min(dim=1).values
    ws = torch.where(ws == big, 0, ws)
    ws = (ws // 128) * 128
    rel = start - ws.repeat_interleave(LANE)
    rel = torch.where(count > 0, rel, 0)
    overflow = (count > 0) & ((rel < 0) | (rel + count > window))
    if miss is not None:
        overflow = overflow | miss
    if demote is not None:
        # dense-cell demotion: in the main kernel one dense cell would
        # inflate its whole block's trip count; the rescue packs such
        # lanes into their own blocks
        overflow = overflow | (count > demote)
    # overflow lanes are redone by the rescue, so the main kernel skips
    # them (zeroed counts tighten k_cap); ws stays anchored to the
    # pre-zeroing counts so the other lanes' rel values are unchanged
    ovf_count = count
    count = torch.where(overflow, 0, count)
    k_cap = count.reshape(nb, BLOCK).max(dim=1).values
    rel = torch.where(count > 0, rel, 0)
    rel = torch.clamp(rel, 0, window - 1)
    return rel, count, ws.reshape(nb, SUB), k_cap, overflow, ovf_count


_CODE_WC = 512  # per-row code-window size


def _window_plan_coded(key_s, ctab, window: int, nb: int, *,
                       active_s=None, demote=None):
    """_window_plan with the (start, count) lookup done by the cells
    kernel: sorted particles' Morton codes are row-compact, so two
    _CODE_WC-code windows per row (from the row minimum, and ending at
    the row maximum) hold almost every key.  Lookup misses fold into the
    overflow mask -> exact rescue."""
    rows = key_s.reshape(nb * SUB, LANE)
    lo = (rows.min(dim=1).values // 128) * 128
    hi = torch.clamp(
        ((rows.max(dim=1).values - _CODE_WC + 128) // 128) * 128, min=0
    )
    start, count = cells_window_lookup(key_s, lo, hi, ctab, wc=_CODE_WC)
    miss = count < 0
    count = torch.where(miss, 0, count)
    if active_s is not None:
        count = torch.where(active_s, count, 0)
        miss = miss & active_s
    return _plan_tail(start, count, window, nb, miss=miss, demote=demote)


def _maybe_code_table(grid, meta, cells_lookup: str):
    """Build the code-indexed cells table when the cells kernel is
    requested ("kernel") or auto-enabled ("auto": the device is CUDA,
    pair count under the 24-bit packed start, dims within the 10-bit
    Morton range, table under its size cap)."""
    pairs = int(grid.offsets[-1])
    dx, dy, dz = (int(d) - 1 for d in meta.dims)
    code_max = int(
        np.int64(_morton_spread(np.int32(dx)))
        | (np.int64(_morton_spread(np.int32(dy))) << 1)
        | (np.int64(_morton_spread(np.int32(dz))) << 2)
    )
    fits = (
        pairs < (1 << 24)
        and max(meta.dims) <= 1024
        and code_max + 1 + _CODE_WC + 128 <= _CODE_TABLE_MAX
    )
    if cells_lookup == "kernel":
        use = True  # explicit request: build_code_table's checks bind
    elif cells_lookup == "auto":
        use = grid.offsets.device.type == "cuda" and fits
    else:
        use = False
    return build_code_table(grid, meta, _CODE_WC) if use else None


# Bounded-compaction buffer for the phase-1 rescue order
# (_chunked_rescue(rescue_compact=True)); read at call time
_COMPACT_CAP = 65536


def _chunked_rescue(
    kernel_out,
    sorted_state,
    overflow,
    tables,
    packed,
    meta,
    num_groups: int,
    group: int,
    gravity,
    cfg: SimConfig,
    m_cap: int,
    *,
    rescue_window: int,
    key_s,
    ovf_count,
    syncs: HostSyncs,
    kernel_chunk: int = 8192,
    rescue_compact: bool = False,
):
    """Exact redo of the window-overflow lanes, in two phases.

    Phase 1 (window kernel, ``kernel_chunk``-lane chunks): compact the
    overflow lanes in CURRENT Morton-key order (``key_s``; pair rows are
    in Morton cell order, so consecutive lanes cover a compact row
    range), gather fresh (start, count) from ``cells2`` (this also
    repairs cells-lookup misses), and rerun the same window kernel with
    ``rescue_window``-row windows.  A chunk runs the kernel only when its
    windows decide a majority of its lanes.

    Phase 2 (window kernel, ``m_cap`` lanes per launch, one lane per
    row): lanes whose rescue window still overflows.  Alone in its row a
    lane fits whenever its cell holds at most ``rescue_window`` - 127
    candidates, so every route but the next computes a lane with the
    kernel's own arithmetic: the result does not depend on the sort
    order that sent the lane to the rescue.

    Phase 3 (packed path, ``m_cap``-lane chunks): lanes whose cell
    outgrows the rescue window (cells above 1920 candidates), densest
    first.

    Exact for any overflow count.  Chunk starts clamp to ``n - m`` like
    ``lax.dynamic_slice``: the last chunk may overlap the one before and
    recomputes those lanes from the same inputs.  Returns (pos_k, vel_k,
    hit_k, n_over), n_over a host int.
    """
    pos_k, vel_k, hit_k = kernel_out
    pos_s, vel_s, radius_s, restit_s = sorted_state
    n = pos_s.shape[-1]
    dev = pos_s.device
    n_over = syncs.read(overflow.sum())
    if n_over == 0:
        return pos_k, vel_k, hit_k, 0
    big = 1 << 30
    still = overflow.clone()

    # ---- phase 1: Morton-compacted kernel rescue ----
    m1 = max(BLOCK, (min(kernel_chunk, n) // BLOCK) * BLOCK)
    if rescue_compact and n >= 2 * _COMPACT_CAP and n_over <= _COMPACT_CAP:
        ord1 = _compact_order(overflow, key_s, n_over, _COMPACT_CAP)
    else:
        ord1 = _phase1_order(overflow, key_s)
    c = 0
    while c * m1 < n_over:
        s0 = min(c * m1, n - m1)
        pick = ord1[s0:s0 + m1]
        redo, (pos_c, vel_c, rad_c, res_c), (rel, cnt, ws, k_cap, unfit) = (
            _rescue_chunk(sorted_state, overflow, pick, tables, meta, cfg,
                          rescue_window)
        )
        n_redo = redo.sum()
        n_unfit = unfit.sum()
        if syncs.read(n_unfit * 2 < n_redo):
            pos_o, vel_o, hit_o = window_collide_sorted(
                pos_c, vel_c, rad_c, res_c, rel, cnt, ws, k_cap, tables,
                w=rescue_window, k_static=meta.max_tris_per_cell,
                gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff,
            )
            decided = redo & ~unfit
            pos_k[:, pick] = torch.where(decided[None], pos_o, pos_k[:, pick])
            vel_k[:, pick] = torch.where(decided[None], vel_o, vel_k[:, pick])
            hit_k[pick] = torch.where(decided, hit_o, hit_k[pick])
            still[pick] = redo & ~decided
        else:
            # every redo lane stays in ``still`` for phase 2
            still[pick] = redo
        c += 1

    # ---- phase 2: window kernel, one lane per row ----
    n_still = syncs.read(still.sum())
    if n_still == 0:
        return pos_k, vel_k, hit_k, n_over
    m2 = min(max(SUB, (min(m_cap, n) // SUB) * SUB), -(-n_still // SUB) * SUB)
    ord2 = torch.argsort((~still).to(torch.uint8), stable=True)  # still first
    c = 0
    while c * m2 < n_still:
        s0 = min(c * m2, n - m2)
        pick = ord2[s0:s0 + m2]
        redo = still[pick]
        args, fit = _isolated_plan(sorted_state, redo, pick, tables, meta, cfg,
                                   rescue_window)
        pos_o, vel_o, hit_o = window_collide_sorted(
            *args, tables, w=rescue_window, k_static=meta.max_tris_per_cell,
            gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff,
        )
        take = redo & fit
        pos_k[:, pick] = torch.where(take[None], pos_o[:, ::LANE], pos_k[:, pick])
        vel_k[:, pick] = torch.where(take[None], vel_o[:, ::LANE], vel_k[:, pick])
        hit_k[pick] = torch.where(take, hit_o[::LANE], hit_k[pick])
        still[pick] = redo & ~fit
        c += 1

    # ---- phase 3: packed path on lanes whose cell outgrows the window ----
    n_still = syncs.read(still.sum())
    if n_still == 0:
        return pos_k, vel_k, hit_k, n_over
    m2 = max(BLOCK, (min(m_cap, n) // BLOCK) * BLOCK)
    ord2 = torch.argsort(torch.where(still, -ovf_count, big), stable=True)
    c = 0
    while c * m2 < n_still:
        s0 = min(c * m2, n - m2)
        pick = ord2[s0:s0 + m2]
        redo = still[pick]
        pos_c = pos_s[:, pick]
        vel_c = vel_s[:, pick]
        # sentinel positions for non-redo lanes keep their (dense) cells
        # out of the packed pass's adaptive group bound
        mini = ParticleState(
            pos=torch.where(redo[None], pos_c, 1.0e38),
            vel=vel_c,
            collisions=torch.zeros((m2,), dtype=torch.int32, device=dev),
            radius=radius_s[pick],
            restitution=restit_s[pick],
        )
        mini = spatial_collide_packed(
            mini, packed, meta, num_groups, group, gravity, cfg.dt,
            cfg.backoff, active=redo, syncs=syncs,
        )
        fb_pos, fb_vel = integrate(mini.pos, mini.vel, gravity, cfg.dt)
        pos_k[:, pick] = torch.where(redo[None], fb_pos, pos_k[:, pick])
        vel_k[:, pick] = torch.where(redo[None], fb_vel, vel_k[:, pick])
        hit_k[pick] = torch.where(redo, mini.collisions, hit_k[pick])
        c += 1
    return pos_k, vel_k, hit_k, n_over


def _phase1_order(overflow, key_s):
    """Phase-1 rescue order: overflow lanes by current Morton key (ties
    by lane), then the other lanes."""
    return torch.argsort(torch.where(overflow, key_s, 1 << 30), stable=True)


def _rescue_chunk(sorted_state, overflow, pick, tables, meta, cfg,
                  rescue_window: int):
    """Inputs of one phase-1 rescue chunk (lanes ``pick`` of the sorted
    state): (redo mask, chunk state, window plan with ``unfit``)."""
    pos_s, vel_s, radius_s, restit_s = sorted_state
    redo = overflow[pick]
    pos_c = pos_s[:, pick]
    vel_c = vel_s[:, pick]
    # fresh (start, count): midpoint lookup, as in the main plan
    info = tables.cells2[:, cell_index(lookup_pos(pos_c, vel_c, cfg.dt), meta)]
    count_c = torch.where(redo, info[1], 0)  # padding lanes inert
    rel, cnt, ws, k_cap, unfit, _ = _plan_tail(
        info[0], count_c, rescue_window, pick.shape[0] // BLOCK
    )
    return (redo, (pos_c, vel_c, radius_s[pick], restit_s[pick]),
            (rel, cnt, ws, k_cap, unfit))


def _isolated_plan(sorted_state, redo, pick, tables, meta, cfg,
                   rescue_window: int):
    """Inputs of one phase-2 launch of the window kernel: lanes ``pick``
    of the sorted state, each alone in a row of LANE (its copies in the
    row carry count 0), so a lane fits whenever its cell holds at most
    ``rescue_window`` - 127 candidates.  Returns (the kernel's lane and
    plan arguments, fit bool[len(pick)]); lane i is row i's first."""
    pos_s, vel_s, radius_s, restit_s = sorted_state
    pos_c, vel_c = pos_s[:, pick], vel_s[:, pick]
    info = tables.cells2[:, cell_index(lookup_pos(pos_c, vel_c, cfg.dt), meta)]
    m = pick.shape[0]
    first = torch.arange(m * LANE, device=pos_s.device) % LANE == 0
    count = torch.where(first, torch.where(redo, info[1], 0).repeat_interleave(LANE), 0)
    rel, cnt, ws, k_cap, unfit, _ = _plan_tail(
        info[0].repeat_interleave(LANE), count, rescue_window, m // SUB)
    lanes = (pos_c.repeat_interleave(LANE, dim=1), vel_c.repeat_interleave(LANE, dim=1),
             radius_s[pick].repeat_interleave(LANE),
             restit_s[pick].repeat_interleave(LANE))
    return (*lanes, rel, cnt, ws, k_cap), ~unfit[::LANE]


def _compact_order(overflow, key_s, n_over: int, cap: int):
    """The phase-1 order without a full-N argsort: the overflow lanes (at
    most ``cap``) sorted by current Morton key, ties by lane (identical
    to the argsort restricted to overflow lanes), followed by
    non-overflow lanes whose chunk writes are no-ops."""
    n = overflow.shape[0]
    dev = overflow.device
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    ovf_i = overflow.to(torch.int32)
    rank = torch.cumsum(ovf_i, 0) - 1
    sel = overflow & (rank < cap)
    keys_c = torch.full((cap,), 1 << 30, dtype=key_s.dtype, device=dev)
    keys_c[rank[sel].long()] = key_s[sel]
    idx_c = torch.zeros((cap,), dtype=torch.int32, device=dev)
    idx_c[rank[sel].long()] = lanes[sel]
    _, o = torch.sort(keys_c, stable=True)
    ord_c = idx_c[o]
    rank_n = torch.cumsum(1 - ovf_i, 0) - 1
    sel_n = (~overflow) & (rank_n < cap)
    pad_c = torch.zeros((cap,), dtype=torch.int32, device=dev)
    pad_c[rank_n[sel_n].long()] = lanes[sel_n]
    pos_in = torch.arange(n, device=dev)
    tail = pad_c[torch.clamp(pos_in - n_over, min=0) % cap]
    return torch.where(
        pos_in < n_over, ord_c[torch.clamp(pos_in, max=cap - 1)], tail
    ).long()


def check_speed_cover(cfg: SimConfig, num_steps: int | None = None,
                      state: ParticleState | None = None,
                      strict: bool = False) -> float:
    """Binning-invariant guard: warn (or, ``strict``, raise) when an
    episode could outrun the midpoint swept lookup.  A particle is
    covered while ``radius + |v|*dt/2 <= expand``; the episode speed
    bound is ``|v_entry| + g*dt*num_steps`` (spawn at rest and
    restitution <= 1).  ``state`` adds its measured max speed (one device
    read).  Returns the speed bound (u/s)."""
    g = float(np.linalg.norm(np.asarray(cfg.gravity, dtype=np.float32)))
    steps = cfg.lifetime_steps if num_steps is None else num_steps
    v_entry = 0.0
    if state is not None:
        v_entry = float(torch.sqrt(torch.max(torch.sum(state.vel * state.vel, 0))))
    v_bound = v_entry + g * cfg.dt * steps
    covered = 2.0 * (cfg.grid.expand - cfg.particle_radius) / cfg.dt
    if v_bound > covered:
        msg = (
            f"episode speed bound {v_bound:.1f} u/s exceeds the midpoint "
            f"swept-lookup cover 2*(expand - radius)/dt = {covered:.1f} "
            f"u/s (expand={cfg.grid.expand}, radius={cfg.particle_radius}, "
            f"dt={cfg.dt}, steps={steps}, entry speed {v_entry:.1f}); "
            "raise grid.expand or shorten the episode -- particles above "
            "the cover speed silently miss binned triangles (tunneling)"
        )
        if strict:
            raise ValueError(msg)
        warnings.warn(msg)
    return v_bound


def _auto_demote(demote, meta) -> int | None:
    """Dense-cell demotion threshold: "auto" is 192 on scenes whose
    densest cell holds more than 255 candidates (dragon class), else
    off."""
    if demote != "auto":
        return demote
    if meta.max_tris_per_cell > 255:
        return 192
    return None


def _auto_window(window, meta, device: torch.device) -> int:
    """Row window size: the densest cell plus one 128-row segment,
    within [256, 2048]; on CUDA at least 1024 rows (the JAX package's
    accelerator floor: the window absorbs drift between lazy re-sorts).
    CPU keeps the small window, as the JAX package does off the TPU."""
    if window is not None:
        return window
    want = ((meta.max_tris_per_cell + 127) // 128) * 128 + 128
    w = max(256, min(2048, want))
    if device.type == "cuda":
        w = max(w, 1024)
    if meta.max_tris_per_cell > w:
        warnings.warn(
            f"grid cells hold up to {meta.max_tris_per_cell} candidates, "
            f"above the {w}-row block window; particles in those cells are "
            "handled by the exact fallback (capacity-bounded)"
        )
    return w


class _Sorted(NamedTuple):
    """Scene tables and plan constants shared by the step and runner."""

    cfg: SimConfig
    meta: object
    window: int
    rescue_window: int
    demote: Optional[int]
    tables: object
    ctab: object
    packed: object
    num_groups: int
    group: int
    gravity: torch.Tensor
    m_cap: int


def _build_sorted(triangles, cfg, *, window, fallback_capacity, cells_lookup,
                  dense_demote, device) -> _Sorted:
    dev = resolve_device(device)
    grid, meta = build_triangle_grid(triangles, cfg.grid, device=dev)
    window = _auto_window(window, meta, dev)
    # rescue window: covers the densest cell (the rescue re-windows
    # COMPACTED overflow lanes); never below the main window
    rescue_window = max(window, _auto_window(None, meta, dev), 2048)
    tables = build_window_tables(grid, meta, max(window, rescue_window))
    group = 8
    packed, num_groups = pack_grid(grid, meta, group=group)
    return _Sorted(
        cfg=cfg, meta=meta, window=window, rescue_window=rescue_window,
        demote=_auto_demote(dense_demote, meta), tables=tables,
        ctab=_maybe_code_table(grid, meta, cells_lookup), packed=packed,
        num_groups=num_groups, group=group,
        gravity=torch.tensor(cfg.gravity, dtype=torch.float32, device=dev),
        m_cap=fallback_capacity,
    )


def _collide_sorted(sp: _Sorted, pos_s, vel_s, radius_s, restit_s, key_s,
                    syncs: HostSyncs, *, active_s=None, rescue_chunk: int = 8192,
                    rescue_compact: bool = False):
    """Plan + window kernel + rescue on particles in (approximately)
    sorted order; ``key_s`` is their current Morton key.  ``active_s``
    (hybrid: the undecided mask in the same order) zeroes the candidate
    counts of the other lanes, so they neither collide nor overflow into
    the rescue; every lane is integrated.  Returns (pos', vel', hit
    i32[N], n_over) in the same order."""
    cfg = sp.cfg
    n = pos_s.shape[-1]
    if n % BLOCK:
        raise ValueError(f"the sorted pipeline needs N % {BLOCK} == 0 (got "
                         f"{n}); spawn with pad_multiple={BLOCK}")
    nb = n // BLOCK
    if sp.ctab is not None:
        rel, count, ws, k_cap, overflow, ovf_count = _window_plan_coded(
            key_s, sp.ctab, sp.window, nb, active_s=active_s, demote=sp.demote
        )
    else:
        cid_s = cell_index(lookup_pos(pos_s, vel_s, cfg.dt), sp.meta)
        rel, count, ws, k_cap, overflow, ovf_count = _window_plan(
            cid_s, sp.tables.cells2, sp.window, nb, active_s=active_s,
            demote=sp.demote
        )
    kernel_out = window_collide_sorted(
        pos_s, vel_s, radius_s, restit_s, rel, count, ws, k_cap, sp.tables,
        w=sp.window, k_static=sp.meta.max_tris_per_cell,
        gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff,
    )
    return _chunked_rescue(
        kernel_out, (pos_s, vel_s, radius_s, restit_s), overflow, sp.tables,
        sp.packed, sp.meta, sp.num_groups, sp.group, sp.gravity, cfg,
        sp.m_cap, rescue_window=sp.rescue_window,
        key_s=key_s, ovf_count=ovf_count, syncs=syncs,
        kernel_chunk=rescue_chunk, rescue_compact=rescue_compact,
    )


def _refuse(mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            "multi-device (mesh=) is not ported yet: ROADMAP.md queue A9")


def make_spatial_step_sorted(
    triangles,
    cfg: SimConfig,
    *,
    window: int | None = None,
    fallback_capacity: int = 1024,
    with_stats: bool = False,
    mesh=None,
    cells_lookup: str = "auto",
    dense_demote: "int | None | str" = "auto",
    device="cuda",
):
    """Spatial method via the sorted window pipeline: one step per call,
    state in and out in the caller's particle order.

    ``with_stats``: return ``(state, {"window_overflow": int})``.
    ``cells_lookup``: "kernel" (cells kernel B2), "gather" (``cells2``
    gather) or "auto" (kernel on CUDA when the grid fits the code table).
    The step's ``syncs`` attribute counts its host reads.
    """
    _refuse(mesh=mesh)
    sp = _build_sorted(
        triangles, cfg, window=window, fallback_capacity=fallback_capacity,
        cells_lookup=cells_lookup, dense_demote=dense_demote, device=device,
    )
    return _sorted_step(sp, None, with_stats)


def make_hybrid_step_sorted(
    triangles,
    cfg: SimConfig,
    camera,
    normals=None,
    *,
    window: int | None = None,
    fallback_capacity: int = 1024,
    with_stats: bool = False,
    mesh=None,
    cells_lookup: str = "auto",
    dense_demote: "int | None | str" = "auto",
    device="cuda",
):
    """Hybrid method with the sorted window pipeline as the exact stage:
    the screen-space stage, then the sorted spatial step with the
    candidate counts of decided particles zeroed (the undecided mask
    rides the sort as a payload row).  Integration is fused into the
    window kernel for every particle.  Options as in
    ``make_spatial_step_sorted``."""
    _refuse(mesh=mesh)
    sp = _build_sorted(
        triangles, cfg, window=window, fallback_capacity=fallback_capacity,
        cells_lookup=cells_lookup, dense_demote=dense_demote, device=device,
    )
    return _sorted_step(sp, bake_camera(triangles, camera, normals,
                                        device=sp.gravity.device), with_stats)


def _sorted_step(sp: _Sorted, tex, with_stats: bool):
    """One sorted step per call, state in and out in the caller's
    particle order; with camera textures ``tex``, the hybrid step."""
    cfg = sp.cfg
    syncs = HostSyncs()

    def step(state: ParticleState):
        parts = []
        if tex is not None:
            state, undecided = screen_space_collide(
                state, tex, sp.gravity, cfg.dt, hybrid=True)
            parts = [undecided[None].to(torch.float32)]
        pos, vel = state.pos, state.vel
        key = morton_key(lookup_pos(pos, vel, cfg.dt), sp.meta)
        key_s, perm = torch.sort(key, stable=True)
        rows = torch.cat(
            [pos, vel, state.radius[None], state.restitution[None], *parts],
            dim=0,
        )[:, perm]
        active_s = rows[8] > 0.5 if tex is not None else None
        pos_k, vel_k, hit_k, n_over = _collide_sorted(
            sp, rows[0:3], rows[3:6], rows[6], rows[7], key_s, syncs,
            active_s=active_s,
        )
        # unsort back to the caller's particle order
        new_pos = torch.empty_like(pos_k)
        new_vel = torch.empty_like(vel_k)
        hits = torch.empty_like(hit_k)
        new_pos[:, perm] = pos_k
        new_vel[:, perm] = vel_k
        hits[perm] = hit_k
        out = state._replace(
            pos=new_pos, vel=new_vel, collisions=state.collisions + hits
        )
        return (out, {"window_overflow": n_over}) if with_stats else out

    step.syncs = syncs
    return step


class SortedEpisodeRunner:
    """Episode runner with PERSISTENT sorted order (see
    make_sorted_episode_runner).  ``runner(state, num_steps)`` returns
    the state in the original particle order; ``syncs.count`` and
    ``steps`` count host reads and steps over all calls."""

    def __init__(self, sp: _Sorted, resort_every, resort_threshold: int,
                 rescue_chunk: int, rescue_compact: bool, tex=None):
        if resort_every != "auto" and (
                not isinstance(resort_every, int) or resort_every < 1):
            raise ValueError(f"resort_every must be a positive int or "
                             f"'auto', got {resort_every!r}")
        self.sp = sp
        self.resort_every = resort_every
        self.resort_threshold = resort_threshold
        self.rescue_chunk = rescue_chunk
        self.rescue_compact = rescue_compact
        self.tex = tex
        self.syncs = HostSyncs()
        self.steps = 0

    def _collide(self, rows8, key_s, active_s):
        return _collide_sorted(
            self.sp, rows8[0:3], rows8[3:6], rows8[6], rows8[7], key_s,
            self.syncs, active_s=active_s, rescue_chunk=self.rescue_chunk,
            rescue_compact=self.rescue_compact,
        )

    def _ss_stage(self, rows8, aux):
        """Screen-space stage on the carried rows (hybrid): returns
        (rows8', aux', undecided bool[N]) in the same order."""
        st = ParticleState(pos=rows8[0:3], vel=rows8[3:6], collisions=aux[0],
                           radius=rows8[6], restitution=rows8[7])
        st, undecided = screen_space_collide(
            st, self.tex, self.sp.gravity, self.sp.cfg.dt, hybrid=True)
        rows8 = torch.cat([st.pos, st.vel, rows8[6:8]], dim=0)
        return rows8, torch.stack([st.collisions, aux[1]]), undecided

    def _step(self, rows8, aux, do_sort: bool):
        """One step on the carried rows; with ``do_sort`` re-sort first,
        else keep the current (drifted) order -- sortedness is a locality
        hint, the rescue redoes whatever no longer fits its window.  In
        hybrid mode the screen-space stage runs first and its undecided
        mask follows the rows through the sort."""
        active_s = None
        if self.tex is not None:
            rows8, aux, active_s = self._ss_stage(rows8, aux)
        dt = self.sp.cfg.dt
        key = morton_key(lookup_pos(rows8[0:3], rows8[3:6], dt), self.sp.meta)
        if do_sort:
            key, perm = torch.sort(key, stable=True)
            rows8 = rows8[:, perm]
            if active_s is None:
                aux = aux[:, perm]
            else:
                # the mask rides the aux permute as a third row
                aux3 = torch.cat([aux, active_s[None].to(torch.int32)])[:, perm]
                aux, active_s = aux3[0:2], aux3[2] > 0
        pos_k, vel_k, hit_k, n_over = self._collide(rows8, key, active_s)
        out8 = torch.cat([pos_k, vel_k, rows8[6:8]], dim=0)
        out_aux = torch.stack([aux[0] + hit_k, aux[1]])
        return out8, out_aux, n_over

    def __call__(self, state: ParticleState, num_steps: int,
                 with_stats: bool = False):
        """``with_stats=True``: also return the per-step window-overflow
        counts (host ints)."""
        n = state.pos.shape[-1]
        if state.pos.device != self.sp.gravity.device:
            raise ValueError(f"state is on {state.pos.device}, the runner's "
                             f"tables on {self.sp.gravity.device}")
        if n % BLOCK:
            raise ValueError(f"N={n} is not a multiple of {BLOCK}")
        if os.environ.get("PSYS_SPEED_GUARD", "0") not in ("", "0"):
            check_speed_cover(self.sp.cfg, num_steps=num_steps, state=state,
                              strict=True)
        # carried: rows8 f32[8, N] = pos3 vel3 radius restitution;
        # aux i32[2, N] = (collisions, original ids)
        rows8 = torch.cat([state.pos, state.vel, state.radius[None],
                           state.restitution[None]], dim=0)
        aux = torch.stack([
            state.collisions,
            torch.arange(n, dtype=torch.int32, device=state.pos.device),
        ])
        overflows = []
        # "auto": re-sort when overflow exceeds the overflow measured
        # right after the most recent sort by resort_threshold (step 0
        # establishes the order)
        do_sort, base = True, 0
        for i in range(num_steps):
            if self.resort_every != "auto":
                do_sort = i % self.resort_every == 0
            rows8, aux, n_over = self._step(rows8, aux, do_sort)
            if self.resort_every == "auto":
                base = n_over if do_sort else base
                do_sort = n_over > base + self.resort_threshold
            overflows.append(n_over)
        self.steps += num_steps
        # restore the original order once
        ids = aux[1].long()
        out8 = torch.empty_like(rows8)
        out_aux = torch.empty_like(aux)
        out8[:, ids] = rows8
        out_aux[:, ids] = aux
        out = state._replace(pos=out8[0:3], vel=out8[3:6], collisions=out_aux[0])
        return (out, overflows) if with_stats else out


def make_sorted_episode_runner(
    triangles,
    cfg: SimConfig,
    *,
    window: int | None = None,
    fallback_capacity: int = 1024,
    resort_every: "int | str" = 1,
    camera=None,
    normals=None,
    mesh=None,
    cells_lookup: str = "auto",
    dense_demote: "int | None | str" = "auto",
    rescue_chunk: int = 8192,
    resort_threshold: int = 8192,
    rescue_compact: bool = False,
    device="cuda",
) -> SortedEpisodeRunner:
    """Episode runner with PERSISTENT sorted order: the state stays in
    each step's sorted order (original ids carried as a payload row) and
    the original order is restored once per call.  Semantics identical to
    repeated ``make_spatial_step_sorted`` steps.

    ``resort_every=k``: re-sort every k-th step (the rescue keeps steps
    in between exact).  ``"auto"``: re-sort when the previous step's
    overflow exceeds the overflow measured right after the most recent
    sort by ``resort_threshold``.  ``rescue_chunk``: phase-1 rescue
    chunk (lanes).  ``rescue_compact``: build the phase-1 order by
    bounded compaction instead of a full-N argsort (identical order).

    ``camera`` (with ``normals``, the per-corner shading normals of the
    pre-pass): each step runs the HYBRID method -- the screen-space stage
    on the carried rows first, its undecided mask gating the exact stage,
    as in ``make_hybrid_step_sorted`` without that step's sort and unsort
    of every step.  ``mesh`` (multi-device) is not ported yet and raises
    NotImplementedError.
    """
    _refuse(mesh=mesh)
    check_speed_cover(cfg)  # fail loudly if the episode outruns the grid
    sp = _build_sorted(
        triangles, cfg, window=window, fallback_capacity=fallback_capacity,
        cells_lookup=cells_lookup, dense_demote=dense_demote, device=device,
    )
    tex = None
    if camera is not None:
        tex = bake_camera(triangles, camera, normals, device=sp.gravity.device)
    return SortedEpisodeRunner(sp, resort_every, resort_threshold,
                               rescue_chunk, rescue_compact, tex=tex)


def make_method_step(scene, method, camera_index: int = 0,
                     spatial_variant: str = "auto", cells_lookup: str = "auto",
                     device="cuda"):
    """Factory over the three collision methods (ParticleSys.cs:667-698).

    ``spatial_variant`` (spatial and hybrid): "auto" is the sorted window
    pipeline when the device is CUDA (the kernels' path) and the packed
    path on the CPU; or name one of sorted / packed / stream / dense
    (hybrid: every variant but "sorted" is the packed hybrid step, as in
    the JAX package).  ``cells_lookup``: the sorted variant's
    (start, count) lookup plan ("auto" / "gather" / "kernel"); the packed
    path has none and ignores it.
    """
    method = Method(method)
    cfg = scene.config
    dev = resolve_device(device)
    check_speed_cover(cfg)  # fail loudly if the episode outruns the grid
    v = spatial_variant
    if v == "auto":
        v = "sorted" if dev.type == "cuda" else "packed"
    if method == Method.SPATIAL:
        if v == "sorted":
            return make_spatial_step_sorted(
                scene.triangles, cfg, cells_lookup=cells_lookup, device=dev)
        return make_spatial_step_grid(scene.triangles, cfg, variant=v, device=dev)
    camera = scene.cameras[camera_index]
    normals = getattr(scene, "corner_normals", None)
    if method == Method.SCREEN_SPACE:
        return make_screenspace_step(scene.triangles, cfg, camera, normals,
                                     device=dev)
    if v == "sorted":
        return make_hybrid_step_sorted(scene.triangles, cfg, camera, normals,
                                       cells_lookup=cells_lookup, device=dev)
    # as in the JAX package, every other variant is the packed hybrid step
    return make_hybrid_step(scene.triangles, cfg, camera, normals, device=dev)


def sorted_step_overflow_count(triangles, cfg: SimConfig, state: ParticleState,
                               window: int = 512) -> int:
    """Diagnostic: how many particles of ``state`` would exceed the row
    window of the sorted step (the rescue redoes them exactly).  The grid
    is built on the state's device."""
    dev = state.pos.device
    n = state.pos.shape[-1]
    if n % BLOCK:
        raise ValueError(f"N={n} is not a multiple of {BLOCK}")
    grid, meta = build_triangle_grid(triangles, cfg.grid, device=dev)
    tables = build_window_tables(grid, meta, window)
    lpos = lookup_pos(state.pos, state.vel, cfg.dt)
    _, perm = torch.sort(morton_key(lpos, meta), stable=True)
    cid_s = cell_index(lpos, meta)[perm]
    overflow = _window_plan(cid_s, tables.cells2, window, n // BLOCK)[4]
    return int(overflow.sum())


def make_episode_runner(step, num_steps: int):
    """Roll ``num_steps`` of ``step``: ``run(state) -> state``.  A Python
    loop over the step; the kernels run inside each step."""

    def run(state: ParticleState) -> ParticleState:
        for _ in range(num_steps):
            state = step(state)
        return state

    return run


def make_trajectory_runner(step, num_steps: int, stride: int = 1):
    """Roll ``num_steps // stride`` blocks of ``stride`` steps:
    ``run(state) -> (final, hist)`` with hist f32[S, 3, N] the positions
    after each block."""

    def run(state: ParticleState):
        hist = []
        for _ in range(num_steps // stride):
            for _ in range(stride):
                state = step(state)
            hist.append(state.pos)
        if not hist:
            return state, state.pos.new_empty((0,) + tuple(state.pos.shape))
        return state, torch.stack(hist)

    return run


# ------------------------------------------------- particle-particle ----

P2P_VARIANTS = ("kernel", "sorted", "slots", "dense")


def _p2p_meta(box_lo, box_hi, cfg: SimConfig, cell_size, capacity: int,
              max_radius) -> pg.PGridMeta:
    """Particle-grid geometry of a gravity box.  The 27-cell stencil
    misses contacts when cell_size < 2 * the largest radius, so that is
    refused here."""
    r_max = cfg.particle_radius if max_radius is None else float(max_radius)
    h = 2.0 * r_max if cell_size is None else cell_size
    if h < 2.0 * r_max - 1e-6:
        raise ValueError(
            f"cell_size {h} < 2 * max radius {r_max}: the 27-cell stencil "
            "would miss contacts between large particles in non-adjacent cells"
        )
    return pg.make_meta(box_lo, box_hi, h, capacity=capacity)


def _walls_integrate(state: ParticleState, box_lo, box_hi, gravity,
                     dt: float) -> ParticleState:
    """Wall response, then the integrator (both elementwise)."""
    state = p2p_ops.box_walls_collide(state, box_lo, box_hi, gravity, dt)
    new_pos, new_vel = integrate(state.pos, state.vel, gravity, dt)
    return state._replace(pos=new_pos, vel=new_vel)


def make_p2p_step(
    box_lo,
    box_hi,
    cfg: SimConfig,
    cell_size: Optional[float] = None,
    capacity: int = 8,
    variant: str = "auto",
    with_stats: bool = False,
    max_radius: Optional[float] = None,
    window: int = 512,
    fallback_capacity: int = 8192,
    device="cuda",
):
    """Gravity-box step with particle-particle collisions + container
    walls (``bench/configs.py``; a capability extension over the
    reference Unity project, which has no particle-particle interaction).

    Order per step: p2p impulses -> wall response -> integrate, keeping
    the collide-before-integrate convention.

    ``variant``: "kernel" (sorted 9-run window kernel B3, exact for any
    occupancy), "sorted" (the same runs evaluated by column gathers),
    "slots" (27 x capacity gather loop), "dense" (the gather-free
    cell-table stencil, for small boxes), or "auto": "kernel" when the
    device is CUDA and "sorted" on the CPU, when the grid has >= 3 cells
    in z; else "slots".  The step's ``variant`` attribute names the one
    chosen, its ``syncs`` attribute counts its host reads.

    ``with_stats``: return ``(state, {"cell_overflow": ...})`` so
    saturated-cell drops (one-sided impulses) are observable.  The
    sorted variant cannot saturate and always reports 0.  For the kernel
    variant it is a host int: the particles redone exactly by the
    window-overflow fallback (results stay exact).
    ``max_radius``: largest particle radius in the state
    (heterogeneous-radii runs must pass it).
    ``window``/``fallback_capacity``: kernel-variant tuning (per-row
    window size and exact-redo chunk size; see ops/p2p_sorted).
    """
    dev = resolve_device(device)
    meta = _p2p_meta(box_lo, box_hi, cfg, cell_size, capacity, max_radius)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)
    if variant == "auto":
        if meta.dims[2] >= 3:
            variant = "kernel" if dev.type == "cuda" else "sorted"
        else:
            variant = "slots"
    if variant not in P2P_VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {P2P_VARIANTS}")
    if variant in ("kernel", "sorted"):
        p2ps.check_meta(meta)
    syncs = HostSyncs()

    def collide(state: ParticleState):
        act = active_mask(state)
        if variant == "kernel":
            return p2ps.p2p_collide_window(
                state, meta, active=act, window=window,
                fallback_capacity=fallback_capacity, syncs=syncs)
        if variant == "sorted":
            return p2ps.p2p_collide_sorted(state, meta, active=act, syncs=syncs)
        if variant == "dense":
            return p2p_collide_dense(state, meta, active=act)
        return p2p_ops.p2p_collide(state, meta, active=act)

    def step(state: ParticleState):
        state, overflow = collide(state)
        out = _walls_integrate(state, box_lo, box_hi, gravity, cfg.dt)
        return (out, {"cell_overflow": overflow}) if with_stats else out

    step.variant = variant
    step.syncs = syncs
    return step


class P2PEpisodeRunner:
    """Gravity-box episode runner with PERSISTENT sorted order (see
    make_p2p_episode_runner).  ``runner(state, num_steps)`` returns the
    state in the original particle order; ``syncs.count`` and ``steps``
    count host reads and steps over all calls."""

    def __init__(self, box_lo, box_hi, cfg: SimConfig, meta: pg.PGridMeta,
                 window: int, fallback_capacity: int, device: torch.device):
        self.box_lo, self.box_hi = box_lo, box_hi
        self.cfg = cfg
        self.meta = meta
        self.window = window
        self.fallback_capacity = fallback_capacity
        self.gravity = torch.tensor(cfg.gravity, dtype=torch.float32,
                                    device=device)
        self.syncs = HostSyncs()
        self.steps = 0

    def _step(self, rows8, aux):
        """One step on the carried rows: plan + kernel, fallback, then
        walls and integration in sorted order."""
        active = torch.abs(rows8[0]) < FLOAT_SENTINEL * 0.5
        cid_key = p2ps._cell_key(rows8[0:3], self.meta, active)
        parts = p2ps._phase1_core(rows8, cid_key, self.meta, beta=0.5,
                                  window=self.window)
        pos_k, vel_k, ncon_k, n_over = p2ps._p2p_chunked_fallback(
            parts, 0.5, self.fallback_capacity, self.syncs)
        rows_s, perm = parts.rows_s, parts.perm
        aux_s = aux[:, perm]
        st = _walls_integrate(
            ParticleState(pos=pos_k, vel=vel_k, collisions=aux_s[0],
                          radius=rows_s[6], restitution=rows_s[7]),
            self.box_lo, self.box_hi, self.gravity, self.cfg.dt,
        )
        rows_out = torch.cat([st.pos, st.vel, rows_s[6:8]], dim=0)
        # as in the JAX package's runner, the carried counter takes the
        # particle contacts only: wall hits (st.collisions) are not added
        aux_out = torch.stack([aux_s[0] + ncon_k, aux_s[1]])
        return rows_out, aux_out, n_over

    def __call__(self, state: ParticleState, num_steps: int,
                 with_stats: bool = False):
        """``with_stats=True``: also return the per-step counts of lanes
        redone by the window-overflow fallback (host ints)."""
        n = state.pos.shape[-1]
        dev = state.pos.device
        if dev != self.gravity.device:
            raise ValueError(f"state is on {dev}, the runner on "
                             f"{self.gravity.device}")
        n_k = ((n + BLOCK - 1) // BLOCK) * BLOCK
        # carried: rows8 f32[8, n_k] = pos3 vel3 radius restitution;
        # aux i32[2, n_k] = (collisions, original ids)
        rows8 = p2ps._state_rows(state)
        coll = state.collisions
        if n_k > n:
            rows8 = torch.cat([rows8, p2ps._pad_columns(n_k - n, dev)], dim=1)
            coll = torch.cat([coll, torch.zeros((n_k - n,), dtype=torch.int32,
                                                device=dev)])
        aux = torch.stack([coll, torch.arange(n_k, dtype=torch.int32, device=dev)])
        overflows = []
        for _ in range(num_steps):
            rows8, aux, n_over = self._step(rows8, aux)
            overflows.append(n_over)
        self.steps += num_steps
        # restore the original order once
        ids = aux[1].long()
        out8 = torch.empty_like(rows8)
        out_aux = torch.empty_like(aux)
        out8[:, ids] = rows8
        out_aux[:, ids] = aux
        out = state._replace(pos=out8[0:3, :n], vel=out8[3:6, :n],
                             collisions=out_aux[0, :n])
        return (out, overflows) if with_stats else out


def make_p2p_episode_runner(
    box_lo,
    box_hi,
    cfg: SimConfig,
    cell_size: Optional[float] = None,
    capacity: int = 8,
    max_radius: Optional[float] = None,
    *,
    window: int = 512,
    fallback_capacity: int = 8192,
    device="cuda",
) -> P2PEpisodeRunner:
    """Gravity-box episode runner with PERSISTENT sorted order: the p2p
    analog of make_sorted_episode_runner (same contact model and step
    composition as make_p2p_step's kernel variant).

    Unlike the spatial runner there is no lazy re-sort: the p2p
    candidate runs are CSR segments over the PARTICLES themselves, so
    exact cell grouping is a correctness requirement, not a locality
    hint, and every step sorts.  What persisting the order removes is
    the per-step order RESTORATION and the per-step sentinel pad: the
    carried [8, n_k] rows stay in the previous step's sorted order and
    the original order is restored once, at the end of the call.
    """
    dev = resolve_device(device)
    meta = _p2p_meta(box_lo, box_hi, cfg, cell_size, capacity, max_radius)
    p2ps.check_meta(meta)
    return P2PEpisodeRunner(box_lo, box_hi, cfg, meta, window,
                            fallback_capacity, dev)
