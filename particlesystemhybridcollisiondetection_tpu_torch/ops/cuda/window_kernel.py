"""Sorted block-window kernels of the spatial pipeline, for CUDA.

Port of the JAX package's ``ops/pallas/window_kernel.py``: the host-built
tables (``WindowTables``, ``CodeTable``) and the wrappers of its two TPU
kernels, now hand-written CUDA (``csrc/``):

  * ``cells_window_lookup`` (kernel B2, ``csrc/cells_kernel.cu``): each
    sorted particle's ``(start, count)`` from the Morton-code table;
  * ``window_collide_sorted`` (kernel B1, ``csrc/window_kernel.cu``): the
    exact narrow phase over each particle's candidate rows, the response
    and the integrator, fused;
  * ``window_collide_worklist``: a second entry point of B1 for rescue
    phase 2, over a list of lanes compacted on the device
    (``compact_lanes``), each alone: two kernels, a scan of the listed
    lanes' candidate bounds and a grid sized from occupancy that walks
    the (lane, k) items in equal shares (``worklist_schedule`` is the
    schedule's plain version);
  * ``rescue_front`` (``csrc/window_kernel.cu``): that list, made in one
    pass over every sorted lane with the fit's lookup and the overflow
    count.

Each wrapper has its plain PyTorch version beside it (``*_plain``), but
``rescue_front``, whose plain version is ``core/step.py``'s
``_rescue_front_plain`` (the rescue's CPU route, which calls that
module's own helpers).  A wrapper runs the plain version only for
tensors on the CPU (``rescue_front`` refuses them); for CUDA tensors it
launches its kernel (on the current stream) or raises.  Each
launch adds one to ``LAUNCHES[<wrapper name>]`` (the window kernel's
rescue launches to ``LAUNCHES["window_collide_sorted_rescue"]``).

The window kernel spreads a row's candidates over the threads of its
block and reduces the nearest hit with a 64-bit minimum over the packed
keys ``(bits(t2) << 32) | k``; a launch with few rows (a rescue chunk) runs several
blocks per row (``row_split``) and a finishing kernel, still one launch
of the wrapper.

The TPU kernels' layout devices (16-row table padding, the MXU
permutation matmul, the in-register lane-gather cascade, flat
scalar-prefetch arrays) have no counterpart here; the plan semantics
(8 x 128 rows, ``ws/rel/count/k_cap``, miss and overflow rules, candidate
order) are the JAX package's, so plans compare lane for lane.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.build import LaunchCounter
from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import (
    GridMeta,
    TriangleGrid,
    morton_cell_codes,
)

# block geometry: 8 rows x 128 particles = 1024 particles per block
SUB, LANE = 8, 128
BLOCK = SUB * LANE
_INF = float("inf")
# candidate slots the plain window version evaluates per vectorized pass
_K_SLAB = 16

#: kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = LaunchCounter("cells_window_lookup", "window_collide_sorted",
                         "window_collide_sorted_rescue", "window_collide_worklist",
                         "rescue_front")
reset_launches = LAUNCHES.reset

# The window kernel stages [9][w] floats of pair rows in shared memory
# (an SM has 227 KB for a block); above this window it cannot launch
MAX_WINDOW = 4096
# threads per row block of the window kernel (128 own a particle, all
# walk the row's candidate list)
_ROW_THREADS = 256
# most blocks per row that a launch with few rows is split into
_MAX_SPLIT = 16
# blocks of the worklist entry point's scan kernel: each scans one chunk
# of the list (at most the kernels' 256 threads a block); the collide
# kernel's grid is its occupancy times the SMs, so neither depends on the
# list's length
WORKLIST_SCAN_BLOCKS = 256
# listed lanes a block of the collide kernel stages at a time (its threads)
WORKLIST_BATCH = 256
# lanes a block of the rescue front's kernels takes (RF_TILE in the source)
RESCUE_FRONT_TILE = 2048


class WindowTables(NamedTuple):
    """Host-built device tables for the window kernel."""

    # v0 v1 v2 xyz of every (cell, triangle) pair, cells in Morton order;
    # columns past the last pair hold 1e38 (a window read past the table
    # end stays in bounds)
    pairs: torch.Tensor  # f32[9, P_pad]
    # (start in the Morton-ordered pair table, count) per LINEAR cell id
    cells2: torch.Tensor  # i32[2, C]


def build_window_tables(grid: TriangleGrid, meta: GridMeta, w: int) -> WindowTables:
    """Build the pair table with the per-cell blocks of the CSR table in
    MORTON cell order (3D-adjacent cells sit adjacent in row space, so a
    row of 128 sorted particles covers a compact row range).  Within each
    cell the triangle order is the CSR's, so candidate order -- and with
    it tie-breaking between equal-t2 hits -- is the linear layout's."""
    dev = grid.offsets.device
    offsets = grid.offsets.cpu().numpy().astype(np.int64)
    tri = grid.tri_ids.cpu().numpy()
    p = len(tri)
    verts = np.concatenate(
        [grid.v0.cpu().numpy(), grid.v1.cpu().numpy(), grid.v2.cpu().numpy()],
        axis=0,
    )  # [9, T]

    counts = np.diff(offsets)
    order = np.argsort(morton_cell_codes(meta), kind="stable")  # cells
    counts_m = counts[order]
    off_m = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts_m, out=off_m[1:])
    # pair permutation: Morton rank r takes rows [offsets[order[r]], +cnt)
    src = np.repeat(offsets[:-1][order], counts_m)
    dst_base = np.repeat(off_m[:-1], counts_m)
    pair_perm = np.arange(p, dtype=np.int64) - dst_base + src
    start_by_cell = np.empty(len(counts), dtype=np.int64)
    start_by_cell[order] = off_m[:-1]

    p_pad = ((p + w) // LANE + 1) * LANE
    pt = np.full((9, p_pad), 1.0e38, dtype=np.float32)
    pt[:, :p] = verts[:, tri[pair_perm]]
    cells2 = np.stack([start_by_cell, counts], axis=0).astype(np.int32)
    return WindowTables(
        pairs=torch.from_numpy(pt).to(dev), cells2=torch.from_numpy(cells2).to(dev)
    )


class CodeTable(NamedTuple):
    """Morton-CODE-indexed (start, count) table for the cells lookup.

    ``packed[code] = (start_in_morton_pair_table << 8) | min(count, 255)``;
    empty codes hold 0.  Requires pair count < 2^24; count == 255 marks
    "clamped" and routes those particles to the exact rescue.
    """

    packed: torch.Tensor  # i32[CS_pad]


# code-table size cap (2^26 i32 entries = 256 MB): the table is sized by
# the largest Morton CODE (~ padded dims cubed), not by occupied cells
_CODE_TABLE_MAX = 1 << 26


def build_code_table(grid: TriangleGrid, meta: GridMeta, wc: int) -> CodeTable:
    """Host-build the Morton-code-indexed cells table (see CodeTable)."""
    offsets = grid.offsets.cpu().numpy().astype(np.int64)
    counts = np.diff(offsets)
    p = int(offsets[-1])
    if p >= (1 << 24):
        raise ValueError(f"{p} pair rows exceed the 24-bit packed start; use "
                         "the gather plan for this grid")
    # 10 bits per axis: larger dims would alias distinct cells onto one code
    if max(meta.dims) > 1024:
        raise ValueError(f"grid dims {meta.dims} exceed the 10-bit Morton "
                         "range; use the gather plan for this grid")
    codes = morton_cell_codes(meta)
    order = np.argsort(codes, kind="stable")
    counts_m = counts[order]
    off_m = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts_m, out=off_m[1:])
    start_by_cell = np.empty(len(counts), dtype=np.int64)
    start_by_cell[order] = off_m[:-1]

    cs = int(codes.max()) + 1
    cs_pad = ((cs + wc) // LANE + 1) * LANE
    if cs_pad > _CODE_TABLE_MAX:
        raise ValueError(f"code table would hold {cs_pad} entries (> "
                         f"{_CODE_TABLE_MAX}); use the gather plan for this grid")
    packed = np.zeros((cs_pad,), dtype=np.int64)
    packed[codes] = (start_by_cell << 8) | np.minimum(counts, 255)
    return CodeTable(
        packed=torch.from_numpy(packed.astype(np.int32)).to(grid.offsets.device)
    )


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def plan_tail(start, count, window: int, nb: int, miss=None, demote=None):
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
    rel = start - ws[:, None].expand(-1, LANE).reshape(-1)
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


def isolated_rows(pos_c, vel_c, radius_c, restit_c, start_c, count_c,
                  window: int):
    """``m`` lanes (m % 8 == 0), each alone in a row of LANE: the lane in
    the row's first slot, copies with count 0 in the others.  Returns the
    window kernel's lane and plan arguments for them (pos, vel, radius,
    restitution, rel, count, ws, k_cap) and fit bool[m]: alone, a lane
    fits its row's window when start % 128 + count <= ``window``."""
    m = pos_c.shape[-1]
    first = torch.arange(m * LANE, device=pos_c.device) % LANE == 0
    count = torch.where(first, count_c.repeat_interleave(LANE), 0)
    rel, cnt, ws, k_cap, unfit, _ = plan_tail(
        start_c.repeat_interleave(LANE), count, window, m // SUB)
    lanes = (pos_c.repeat_interleave(LANE, dim=1),
             vel_c.repeat_interleave(LANE, dim=1),
             radius_c.repeat_interleave(LANE), restit_c.repeat_interleave(LANE))
    return (*lanes, rel, cnt, ws, k_cap), ~unfit[::LANE]


# ---------------------------------------------------------------- B2 ----

def cells_window_lookup_plain(key_s, lo, hi, ctab: CodeTable, *, wc: int):
    """Plain PyTorch version of the cells lookup kernel (see
    csrc/cells_kernel.cu for the semantics)."""
    table = ctab.packed
    lo_l = lo.repeat_interleave(LANE)
    hi_l = hi.repeat_interleave(LANE)
    rel_lo = key_s - lo_l
    rel_hi = key_s - hi_l
    ok_lo = (rel_lo >= 0) & (rel_lo < wc)
    ok_hi = (rel_hi >= 0) & (rel_hi < wc) & (hi_l > lo_l)
    ok = (ok_lo | ok_hi) & (key_s >= 0) & (key_s < table.shape[0])
    safe = torch.clamp(key_s, 0, table.shape[0] - 1).long()
    packed = torch.where(ok, table[safe], 0)
    cnt = packed & 255
    start = (packed >> 8) & 0xFFFFFF
    count = torch.where(ok & (cnt < 255), cnt, -1)
    return start, count


def cells_window_lookup(key_s, lo, hi, ctab: CodeTable, *, wc: int):
    """(start, count) per sorted particle from the Morton-code table.

    key_s: i32[N] Morton codes in sorted order (N % 128 == 0); lo, hi:
    i32[N/128] per-row window starts.  count == -1 marks a lookup miss
    (own code outside both windows, or a count >= 255 cell): the caller
    routes those particles to the exact rescue."""
    n = key_s.shape[0]
    if n % LANE:
        raise ValueError(f"particle count {n} is not a multiple of {LANE}")
    if key_s.device.type == "cpu":
        return cells_window_lookup_plain(key_s, lo, hi, ctab, wc=wc)
    dev = key_s.device
    rows = n // LANE
    _check("key_s", key_s, torch.int32, (n,), dev)
    _check("lo", lo, torch.int32, (rows,), dev)
    _check("hi", hi, torch.int32, (rows,), dev)
    _check("ctab.packed", ctab.packed, torch.int32, ctab.packed.shape, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    fn = build.kernel_function("cells_kernel", "psys_cells_window_lookup", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p,
    ])
    start = torch.empty((n,), dtype=torch.int32, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    err = fn(_ptr(key_s), _ptr(lo), _ptr(hi), _ptr(ctab.packed),
             ctab.packed.shape[0], _ptr(start), _ptr(count), n, wc, _stream(dev))
    _raise_on(err, "cells_window_lookup")
    LAUNCHES["cells_window_lookup"] += 1
    return start, count


# ---------------------------------------------------------------- B1 ----

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _candidate(pos, dirn, radius, seg2, v0, v1, v2):
    """Candidate triangles v0, v1, v2 [3, K, A] against lanes (pos, dirn
    [3, 1, A]; radius, seg2 [1, A]): (tri_hit before validity, t2, t,
    flipped normal) per candidate, in the kernel's operation order."""
    nr = _cross3(v1 - v0, v2 - v0)
    nlen = torch.sqrt(torch.clamp(_dot3(nr, nr), min=1e-37))
    nr = nr / nlen[None]
    flip = _dot3(nr, dirn) > 0.0
    nr = torch.where(flip[None], -nr, nr)
    off = nr * radius[None]

    shape, dev = v0.shape[1:], v0.device
    c_t2 = torch.full(shape, _INF, dtype=torch.float32, device=dev)
    c_t = torch.full(shape, _INF, dtype=torch.float32, device=dev)
    c_hit = torch.zeros(shape, dtype=torch.bool, device=dev)

    def consider(hit, t, c_t2, c_t, c_hit):
        t2 = t * t
        take = hit & (t2 < c_t2)
        return torch.where(take, t2, c_t2), torch.where(take, t, c_t), c_hit | hit

    for sgn in (1.0, -1.0):  # offset planes (compute:174-198)
        a0 = v0 + sgn * off
        a1 = v1 + sgn * off
        a2 = v2 + sgn * off
        e1 = a1 - a0
        e2 = a2 - a0
        rov = pos - a0
        nn = _cross3(e1, e2)
        q = _cross3(rov, dirn)
        d = 1.0 / _dot3(dirn, nn)
        u = d * -_dot3(q, e2)
        vv = d * _dot3(q, e1)
        t = d * -_dot3(nn, rov)
        hit = ~((u < 0.0) | (vv < 0.0) | ((u + vv) > 1.0))
        c_t2, c_t, c_hit = consider(hit, t, c_t2, c_t, c_hit)

    for pa, pb in ((v0, v1), (v1, v2), (v2, v0)):  # edge cylinders
        ba = pb - pa
        oc = pos - pa
        baba = _dot3(ba, ba)
        bard = _dot3(ba, dirn)
        baoc = _dot3(ba, oc)
        k2 = baba - bard * bard
        k1 = baba * _dot3(oc, dirn) - baoc * bard
        k0 = baba * _dot3(oc, oc) - baoc * baoc - radius * radius * baba
        h = k1 * k1 - k2 * k0
        hs = torch.sqrt(torch.clamp(h, min=0.0))
        t_body = (-k1 - hs) / k2
        y = baoc + t_body * bard
        body_hit = (h >= 0.0) & (y > 0.0) & (y < baba)
        yc = torch.where(y < 0.0, 0.0, baba)
        t_cap = (yc - baoc) / bard
        qq = oc + dirn * t_cap[None] - ba * (yc / baba)[None]
        cap_hit = (h >= 0.0) & (_dot3(qq, qq) < radius * radius)
        c_t2, c_t, c_hit = consider(
            body_hit | cap_hit, torch.where(body_hit, t_body, t_cap),
            c_t2, c_t, c_hit,
        )

    for pv in (v0, v1, v2):  # vertex spheres (compute:144-161)
        oc = pv - pos
        proj = _dot3(oc, dirn)
        disc = radius * radius - (_dot3(oc, oc) - proj * proj)
        c_t2, c_t, c_hit = consider(
            disc >= 0.0, proj - torch.sqrt(torch.clamp(disc, min=0.0)),
            c_t2, c_t, c_hit,
        )

    return c_hit & (c_t2 <= seg2), c_t2, c_t, nr


def window_collide_sorted_plain(
    pos_s, vel_s, radius_s, restit_s, rel, count, ws, k_cap,
    tables: WindowTables, *, w: int, k_static: int, gravity: tuple,
    dt: float, backoff: float,
):
    """Plain PyTorch version of the window kernel (csrc/window_kernel.cu):
    the same candidates and the same operations, over the lanes that have
    candidates, _K_SLAB candidate slots at a time.  Within a slab the
    first minimal t2 wins, across slabs a strictly smaller one: the
    kernel's sequential strict-< fold."""
    n = pos_s.shape[-1]
    dev = pos_s.device
    ws_l = ws.reshape(-1).repeat_interleave(LANE)
    kb = torch.clamp(k_cap, max=k_static).repeat_interleave(BLOCK)
    bound = torch.minimum(torch.minimum(count, kb), w - rel)

    speed2 = _dot3(vel_s, vel_s)
    inv_speed = 1.0 / torch.sqrt(torch.clamp(speed2, min=1e-37))
    dirn = vel_s * inv_speed[None]
    seg2 = speed2 * (dt * dt)

    best_t2 = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    best_t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    best_n = torch.zeros((3, n), dtype=torch.float32, device=dev)
    any_hit = torch.zeros((n,), dtype=torch.bool, device=dev)

    lanes = torch.nonzero(bound > 0).squeeze(1)
    if lanes.numel():
        a_pos, a_dir = pos_s[:, lanes][:, None], dirn[:, lanes][:, None]
        a_rad, a_seg2 = radius_s[lanes][None], seg2[lanes][None]
        a_bound = bound[lanes]
        a_row = (ws_l + rel)[lanes].long()
        a_t2 = best_t2[lanes]
        a_t = best_t[lanes]
        a_n = best_n[:, lanes]
        a_any = any_hit[lanes]
        k_max = int(a_bound.max())
        for k0 in range(0, k_max, _K_SLAB):
            ks = torch.arange(k0, min(k0 + _K_SLAB, k_max), device=dev)[:, None]
            comp = tables.pairs[:, a_row[None] + ks]  # [9, K, A]
            tri_hit, c_t2, c_t, nr = _candidate(
                a_pos, a_dir, a_rad, a_seg2, comp[0:3], comp[3:6], comp[6:9]
            )
            tri_hit = tri_hit & (ks < a_bound[None])
            c_t2 = torch.where(tri_hit, c_t2, _INF)
            k_best = torch.argmin(c_t2, dim=0)[None]  # first minimum
            s_t2 = torch.gather(c_t2, 0, k_best)[0]
            take = s_t2 < a_t2
            a_t2 = torch.where(take, s_t2, a_t2)
            a_t = torch.where(take, torch.gather(c_t, 0, k_best)[0], a_t)
            s_n = torch.gather(nr, 1, k_best[None].expand(3, 1, -1))[:, 0]
            a_n = torch.where(take[None], s_n, a_n)
            a_any = a_any | tri_hit.any(dim=0)
        best_t2[lanes] = a_t2
        best_t[lanes] = a_t
        best_n[:, lanes] = a_n
        any_hit[lanes] = a_any

    hit = any_hit & (best_t2 < _INF) & (speed2 != 0.0)

    # response (compute:332-352) + integrator (PSReactionUpdate:18-19)
    gdt = torch.tensor(gravity, dtype=torch.float32, device=dev)[:, None] * dt
    col_point = pos_s + dirn * best_t[None]
    dn = _dot3(dirn, best_n)
    refl = dirn - best_n * (2.0 * dn)[None]
    rlen = torch.sqrt(torch.clamp(_dot3(refl, refl), min=1e-37))
    refl = refl / rlen[None]
    ce = (pos_s + vel_s * dt) - col_point
    col_to_end = torch.sqrt(torch.clamp(_dot3(ce, ce), min=0.0))
    speed = torch.sqrt(speed2)
    new_vel = refl * (restit_s * speed)[None] - gdt
    new_pos = (
        col_point
        - dirn * (backoff * radius_s)[None]
        + refl * (col_to_end * restit_s)[None]
    )
    out_vel = torch.where(hit[None], new_vel, vel_s) + gdt
    out_pos = torch.where(hit[None], new_pos, pos_s)
    out_pos = out_pos + out_vel * dt
    return out_pos, out_vel, hit.to(torch.int32)


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once)."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device]


_occupancy: dict = {}


def kernel_occupancy(source: str, symbol: str, outputs: int, device) -> tuple:
    """The ``outputs`` int32 values of the occupancy query ``symbol`` of
    kernel library ``source`` on a CUDA device (read once), resident
    blocks per SM first."""
    key = (source, symbol, device)
    if key not in _occupancy:
        from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

        p = ctypes.POINTER(ctypes.c_int32)
        fn = build.kernel_function(source, symbol, [p] * outputs)
        vals = [ctypes.c_int32() for _ in range(outputs)]
        with torch.cuda.device(device):
            _raise_on(fn(*(ctypes.byref(v) for v in vals)), symbol)
        if vals[0].value < 1:
            raise RuntimeError(f"{symbol}: the kernel fits no block on an SM")
        _occupancy[key] = tuple(v.value for v in vals)
    return _occupancy[key]


def worklist_occupancy(device: torch.device) -> tuple:
    """The worklist collide kernel on a CUDA device: (resident blocks per
    SM, registers a thread, local memory bytes a thread).  Its grid is
    the first times the SM count."""
    return kernel_occupancy("window_kernel", "psys_window_worklist_occupancy", 3,
                            device)


def row_split(n: int, sm_count: int) -> int:
    """Blocks per row of 128 particles for a window-kernel launch over
    ``n`` lanes: 1 when the rows alone give every SM two blocks, else as
    many as bring the launch to two blocks per SM (the rescue chunk: 8192
    lanes = 64 rows)."""
    return max(1, min(_MAX_SPLIT, (2 * sm_count) // max(1, n // LANE)))


def window_collide_sorted(
    pos_s,  # f32[3, N] sorted
    vel_s,
    radius_s,  # f32[N]
    restit_s,
    rel,  # i32[N] own CSR start - own row's window start
    count,  # i32[N]
    ws,  # i32[N/1024, 8] per-row window starts
    k_cap,  # i32[N/1024] per-block candidate bound
    tables: WindowTables,
    *,
    w: int,
    k_static: int,
    gravity: tuple,
    dt: float,
    backoff: float,
    launch_key: str = "window_collide_sorted",
):
    """Narrow phase + response + integration for every sorted particle.
    Returns (pos', vel', hit i32[N]) in the sorted order.  A launch counts
    under ``LAUNCHES[launch_key]``: the rescue's launches count under
    "window_collide_sorted_rescue", apart from the main one."""
    n = pos_s.shape[-1]
    if n % BLOCK:
        raise ValueError(f"particle count {n} is not a multiple of {BLOCK}")
    if not 0 < w <= MAX_WINDOW:
        raise ValueError(f"window {w} is outside (0, {MAX_WINDOW}]")
    kw = dict(w=w, k_static=k_static, gravity=gravity, dt=dt, backoff=backoff)
    if pos_s.device.type == "cpu":
        return window_collide_sorted_plain(
            pos_s, vel_s, radius_s, restit_s, rel, count, ws, k_cap, tables, **kw
        )
    dev = pos_s.device
    nb = n // BLOCK
    p_pad = tables.pairs.shape[1]
    for name, t, dt_, shape in (
        ("pos_s", pos_s, torch.float32, (3, n)),
        ("vel_s", vel_s, torch.float32, (3, n)),
        ("radius_s", radius_s, torch.float32, (n,)),
        ("restit_s", restit_s, torch.float32, (n,)),
        ("rel", rel, torch.int32, (n,)),
        ("count", count, torch.int32, (n,)),
        ("ws", ws, torch.int32, (nb, SUB)),
        ("k_cap", k_cap, torch.int32, (nb,)),
        ("tables.pairs", tables.pairs, torch.float32, (9, p_pad)),
    ):
        _check(name, t, dt_, shape, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    c = ctypes
    fn = build.kernel_function("window_kernel", "psys_window_collide", [
        *([c.c_void_p] * 9), c.c_int64, *([c.c_void_p] * 3), c.c_int64,
        c.c_int32, c.c_int32, *([c.c_float] * 6), c.c_int32, c.c_int32,
        c.c_void_p, c.c_void_p,
    ])
    pos_o = torch.empty_like(pos_s)
    vel_o = torch.empty_like(vel_s)
    hit_o = torch.empty((n,), dtype=torch.int32, device=dev)
    split = row_split(n, _sm_count(dev))
    # scratch of the split launch: one nearest-hit key per lane (the
    # launch fills it with the kernel's NO_HIT key before the row blocks run)
    keys = torch.empty((n,), dtype=torch.int64, device=dev) if split > 1 else None
    f32 = np.float32
    err = fn(
        _ptr(pos_s), _ptr(vel_s), _ptr(radius_s), _ptr(restit_s), _ptr(rel),
        _ptr(count), _ptr(ws), _ptr(k_cap), _ptr(tables.pairs), p_pad,
        _ptr(pos_o), _ptr(vel_o), _ptr(hit_o), n, w, k_static,
        # scalars rounded to float32 exactly as the plain version's
        # tensor-by-Python-scalar products round them
        float(f32(gravity[0])), float(f32(gravity[1])), float(f32(gravity[2])),
        float(f32(dt)), float(f32(dt * dt)), float(f32(backoff)),
        split, _ROW_THREADS, _ptr(keys) if split > 1 else None, _stream(dev),
    )
    _raise_on(err, "window_collide_sorted")
    LAUNCHES[launch_key] += 1
    return pos_o, vel_o, hit_o


def compact_lanes(take):
    """The lanes where ``take`` holds, in lane order, compacted on the
    device (cumsum and scatter, no host read): (lanes i32[N], their
    count i32[]); entries past the count are 0.  The list that the
    worklist entry points (this module's and the p2p kernel's) take."""
    n = take.shape[0]
    t = take.to(torch.int32)
    slot = torch.where(take, torch.cumsum(t, 0) - 1, n).long()
    lanes = torch.zeros((n + 1,), dtype=torch.int32, device=take.device)
    lanes.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=take.device))
    return lanes[:n], t.sum(dtype=torch.int32)


class WorklistSchedule(NamedTuple):
    """The worklist kernels' schedule over the ``m`` listed entries (see
    ``worklist_schedule``); item indices are global, 0 .. total."""

    bound: torch.Tensor  # i64[m] each entry's candidates, min(count, k_static)
    units: torch.Tensor  # i64[m] its items: the bound, at least 1
    off: torch.Tensor  # i64[m] its first item's offset within its chunk
    bsum: torch.Tensor  # i64[scan_blocks] the chunks' sums
    first: torch.Tensor  # i64[m] its first item
    edges: torch.Tensor  # i64[blocks + 1] share b is items [edges[b], edges[b + 1])
    owners: torch.Tensor  # i64[blocks, 2] a share's first and last entry; -1 if empty
    slot: torch.Tensor  # i64[m] edge slot of an entry across shares; -1 if not


def worklist_schedule(count, lanes, n_lanes, *, k_static: int, blocks: int,
                      scan_blocks: int = WORKLIST_SCAN_BLOCKS) -> WorklistSchedule:
    """Plain version of the worklist kernels' schedule (reads ``n_lanes``
    on the host).  Listed entry j (lane ``lanes[j]``) owns units_j =
    max(min(count, k_static), 1) items: candidate k of the lane is item
    first_j + k, and a lane with no candidate owns one item, its response.
    The scan kernel's block c takes chunk c of the list (ceil(m /
    scan_blocks) entries) and writes ``off`` and ``bsum``; collide block
    b takes the items [total b / blocks, total (b + 1) / blocks) and the
    entries that own them (the owner of item x is the last entry with
    first <= x).  An entry whose items fall in two or more shares folds
    its nearest hit into edge slot ``slot``, that of the share of its first
    item; every share's block adds its part to the slot's count, and the
    one that completes it finishes the lane."""
    dev = count.device
    m = int(n_lanes)
    bound = torch.clamp(count[lanes[:m].long()].long(), 0, k_static)
    units = torch.clamp(bound, min=1)
    chunk = max(1, -(-m // scan_blocks))
    c = torch.arange(m, device=dev) // chunk
    bsum = torch.zeros(scan_blocks, dtype=torch.int64, device=dev).index_add_(0, c, units)
    first = torch.cumsum(units, 0) - units
    off = first - (torch.cumsum(bsum, 0) - bsum)[c]
    total = int(bsum.sum())
    edges = total * torch.arange(blocks + 1, device=dev) // blocks
    ends = torch.stack([edges[:-1], edges[1:] - 1], dim=1)  # each share's items
    owners = torch.where(ends[:, :1] <= ends[:, 1:],
                         torch.searchsorted(first, ends, right=True) - 1, -1)
    shares = torch.searchsorted(edges, torch.stack([first, first + units - 1]),
                                right=True) - 1
    across = shares[0] != shares[1]
    slot = torch.where(across, ((first + 1) * blocks - 1) // max(total, 1), -1)
    return WorklistSchedule(bound, units, off, bsum, first, edges, owners, slot)


def window_collide_worklist_plain(
    pos_s, vel_s, radius_s, restit_s, start, count, lanes, n_lanes,
    tables: WindowTables, pos_out, vel_out, hit_out, *, w: int, k_static: int,
    gravity: tuple, dt: float, backoff: float,
):
    """Plain PyTorch version of the worklist entry point: the listed lanes,
    each alone in a row of LANE (``isolated_rows``), through
    ``window_collide_sorted_plain`` -- the one-lane-per-row launch of the
    host-read rescue's phase 2 (``core/step.py::_isolated_plan``).  Reads
    ``n_lanes`` on the host."""
    m = int(n_lanes)
    if m == 0:
        return
    pick = lanes[:m].long()
    rows = -(-m // SUB) * SUB
    pick_p = torch.cat([pick, pick[:1].expand(rows - m)])  # padding: copies
    args, _ = isolated_rows(pos_s[:, pick_p], vel_s[:, pick_p], radius_s[pick_p],
                            restit_s[pick_p], start[pick_p], count[pick_p], w)
    pos_o, vel_o, hit_o = window_collide_sorted_plain(
        *args, tables, w=w, k_static=k_static, gravity=gravity, dt=dt,
        backoff=backoff)
    pos_out[:, pick] = pos_o[:, ::LANE][:, :m]
    vel_out[:, pick] = vel_o[:, ::LANE][:, :m]
    hit_out[pick] = hit_o[::LANE][:m]


def window_collide_worklist(
    pos_s,  # f32[3, N] sorted
    vel_s,
    radius_s,  # f32[N]
    restit_s,
    start,  # i32[N] each lane's first row in the pair table
    count,  # i32[N] its candidate count
    lanes,  # i32[N] listed lanes first
    n_lanes,  # i32[] how many are listed, on the device
    tables: WindowTables,
    pos_out,  # f32[3, N], written at the listed lanes
    vel_out,
    hit_out,  # i32[N]
    *,
    w: int,
    k_static: int,
    gravity: tuple,
    dt: float,
    backoff: float,
):
    """Rescue phase 2: narrow phase, response and integration of the
    first ``n_lanes`` lanes of ``lanes``, each alone, written in place into
    ``pos_out``/``vel_out``/``hit_out`` (other lanes untouched).  Each
    listed lane must fit a row's ``w``-row window alone (start % 128 +
    count <= w; the rescue lists no other): then its result is, bit for
    bit, the window kernel's for it alone in a row of LANE.  Two kernels
    (``worklist_schedule``) whose grids do not depend on the list, so the
    list's length never leaves the device; one count a call."""
    n = pos_s.shape[-1]
    kw = dict(w=w, k_static=k_static, gravity=gravity, dt=dt, backoff=backoff)
    if pos_s.device.type == "cpu":
        return window_collide_worklist_plain(
            pos_s, vel_s, radius_s, restit_s, start, count, lanes, n_lanes,
            tables, pos_out, vel_out, hit_out, **kw)
    dev = pos_s.device
    p_pad = tables.pairs.shape[1]
    for name, t, dt_, shape in (
        ("pos_s", pos_s, torch.float32, (3, n)),
        ("vel_s", vel_s, torch.float32, (3, n)),
        ("radius_s", radius_s, torch.float32, (n,)),
        ("restit_s", restit_s, torch.float32, (n,)),
        ("start", start, torch.int32, (n,)),
        ("count", count, torch.int32, (n,)),
        ("lanes", lanes, torch.int32, (n,)),
        ("n_lanes", n_lanes, torch.int32, ()),
        ("tables.pairs", tables.pairs, torch.float32, (9, p_pad)),
        ("pos_out", pos_out, torch.float32, (3, n)),
        ("vel_out", vel_out, torch.float32, (3, n)),
        ("hit_out", hit_out, torch.int32, (n,)),
    ):
        _check(name, t, dt_, shape, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    c = ctypes
    fn = build.kernel_function("window_kernel", "psys_window_collide_worklist", [
        *([c.c_void_p] * 9), c.c_int64, *([c.c_void_p] * 3), c.c_int64,
        c.c_int32, *([c.c_float] * 6), c.c_int32, c.c_int32, *([c.c_void_p] * 3),
    ])
    blocks = worklist_occupancy(dev)[0] * _sm_count(dev)
    # scratch the kernels overwrite before they read it: each entry's
    # offset in its chunk, the chunks' sums, the edge slots' counts; the
    # edge slots' keys
    scratch = torch.empty((n + WORKLIST_SCAN_BLOCKS + blocks,), dtype=torch.int32,
                          device=dev)
    edge_key = torch.empty((blocks,), dtype=torch.int64, device=dev)
    f32 = np.float32
    err = fn(
        _ptr(pos_s), _ptr(vel_s), _ptr(radius_s), _ptr(restit_s), _ptr(start),
        _ptr(count), _ptr(lanes), _ptr(n_lanes), _ptr(tables.pairs), p_pad,
        _ptr(pos_out), _ptr(vel_out), _ptr(hit_out), n, k_static,
        float(f32(gravity[0])), float(f32(gravity[1])), float(f32(gravity[2])),
        float(f32(dt)), float(f32(dt * dt)), float(f32(backoff)),
        blocks, WORKLIST_SCAN_BLOCKS, _ptr(scratch), _ptr(edge_key), _stream(dev),
    )
    _raise_on(err, "window_collide_worklist")
    LAUNCHES["window_collide_worklist"] += 1


def rescue_front(pos_s, vel_s, overflow, cells2, meta: GridMeta, *, dt: float, w: int,
                 with_fit: bool):
    """The sorted rescue's work over all N lanes, on CUDA, in one pass (two
    kernels whose grids depend on N alone): each overflow lane's (start,
    count) in ``cells2`` by the midpoint lookup (``ops/grid.py``'s
    ``lookup_pos`` and ``cell_index``), the fit test (no candidate, or
    start % 128 + count <= ``w``), the overflow count and the list of the
    lanes that overflow and fit.

    pos_s, vel_s: f32[3, N] sorted; overflow: bool[N]; cells2: i32[2, C]
    (``WindowTables.cells2``, C the cells of ``meta``), all contiguous on
    one CUDA device.  Returns (start, count, fit, lanes, n_lanes, n_over):
    start, count i32[N], written at every listed lane (not necessarily
    elsewhere); fit bool[N] at every lane when ``with_fit`` (the packed
    phase takes ``overflow & ~fit``), else None; lanes i32[N], the listed
    lanes in lane order in its first n_lanes slots, the slots past them
    left unwritten (the worklist kernels read no further); n_lanes,
    n_over i32[] on the device.  Those are, bit for bit, what the plain
    version gives there (``core/step.py::_rescue_front_plain``).  Nothing
    is read on the host, so a step can capture it; one count a call."""
    dev = pos_s.device
    if dev.type != "cuda":
        raise ValueError(f"rescue_front takes CUDA tensors, got {dev}; its plain "
                         "version is core/step.py::_rescue_front_plain")
    n = pos_s.shape[-1]
    if n >= 2**31:
        raise ValueError(f"{n} lanes do not index in 32 bits")
    n_cells = meta.num_cells
    for name, t, dt_, shape in (
        ("pos_s", pos_s, torch.float32, (3, n)),
        ("vel_s", vel_s, torch.float32, (3, n)),
        ("overflow", overflow, torch.bool, (n,)),
        ("cells2", cells2, torch.int32, (2, n_cells)),
    ):
        _check(name, t, dt_, shape, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    c = ctypes
    fn = build.kernel_function("window_kernel", "psys_rescue_front", [
        *([c.c_void_p] * 4), c.c_int64, *([c.c_float] * 5), *([c.c_int32] * 4),
        c.c_int64, *([c.c_void_p] * 6), c.c_int64, c.c_void_p,
    ])
    i32 = dict(dtype=torch.int32, device=dev)
    start = torch.empty((n,), **i32)
    count = torch.empty((n,), **i32)
    fit = torch.empty((n,), dtype=torch.bool, device=dev) if with_fit else None
    lanes = torch.empty((n,), **i32)
    counts = torch.empty((2,), **i32)
    # a bitmap word of 32 lanes, a tile's listed and overflow counts
    scratch = torch.empty((-(-n // 32) + 2 * -(-n // RESCUE_FRONT_TILE),), **i32)
    f32 = np.float32
    # each constant rounded to float32 as the plain version's tensor
    # arithmetic rounds it
    ox, oy, oz = (float(f32(x)) for x in meta.origin)
    dx, dy, dz = meta.dims
    err = fn(
        _ptr(pos_s), _ptr(vel_s), _ptr(overflow), _ptr(cells2), n_cells, ox, oy, oz,
        float(f32(1.0 / meta.cell_size)), float(f32(dt * 0.5)), dx, dy, dz, w, n,
        _ptr(start), _ptr(count), c.c_void_p(None) if fit is None else _ptr(fit),
        _ptr(lanes), _ptr(counts), _ptr(scratch), scratch.shape[0], _stream(dev),
    )
    _raise_on(err, "rescue_front")
    LAUNCHES["rescue_front"] += 1
    return start, count, fit, lanes, counts[0], counts[1]
