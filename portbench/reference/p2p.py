"""The plain reference of the gravity-box cells: spheres in a box that
collide with each other and with its six walls, one step at a time, in
plain PyTorch, from the benchmark's own inputs (the box, the constants,
the particles) and nothing the program made.

One step (a particle-particle pass, then the walls, then the
integrator):
  * each particle's cell is ``floor((pos - box_lo) * (1 / cell_size))``,
    clamped to the grid, linear id ``(cx * dy + cy) * dz + cz``;
  * the particles are sorted by cell, stably: within a call each step
    sorts the order the step before it left, the first step of a call
    the particles' own order;
  * a particle's candidates are nine runs of that order: for each (ox,
    oy) in {-1, 0, 1}^2, in that order, the particles of the three cells
    (cx + ox, cy + oy, cz - 1 .. cz + 1) in linear order, whose linear ids
    are consecutive, so the run is the sorted positions from the first
    particle of cell ``c + off - 1`` to the last of cell ``c + off + 1``
    (``off = (ox * dy + oy) * dz``, the ends clamped to the grid's cells;
    a row (cx + ox, cy + oy) outside the grid gives no run).  A run may
    reach into the next row of cells at the ends of z: those candidates
    are too far away to touch;
  * the contact model (mass ``r * r * r``): touching iff ``0 < |d|^2 <
    (r_i + r_j)^2``, ``d = p_i - p_j``; the normal ``n = d / |d|``; an
    impulse ``-(1 + e) (v_rel . n) m_j / (m_i + m_j)`` along n where the
    pair approaches (``v_rel . n < 0``), ``e = (e_i + e_j) / 2``; a
    de-penetration ``beta (r_i + r_j - |d|) m_j / (m_i + m_j)`` along n;
    both summed over the candidates in run order, then added to the
    particle's velocity and position; the contacts counted;
  * the walls: a particle beyond ``lo + r`` or ``hi - r`` on an axis and
    moving outward is put on that plane with that velocity component
    reversed and scaled by its restitution; a particle that hit a wall
    also takes ``-g dt`` on its velocity (the integrator's
    pre-compensation);
  * ``v += g dt; p += v dt``.
The collision counter takes the particle contacts only.

Every expression is written out in the order that the program documents
for its kernels and their plain versions (``(a0*b0 + a1*b1) + a2*b2``,
no fused multiply-add, IEEE division and square root), so a sound
program's particles agree with these to the bit.  ``dtype`` computes the
whole step in another precision (the control: bfloat16; the witness:
float64).

The candidate loops are blocked by run length: in each step every
(particle, group, k) with k below the group's run length is one entry of
one flat batch, whose pair arithmetic runs at once; the sums then take
the batch's entries group by group and k by k, each k over the
particles whose run is longer than k (a prefix of the particles sorted
by that run's length), so each particle's sum keeps its candidate order.
Every operation is deterministic: sorts, gathers, scatters to distinct
indices, elementwise arithmetic; no atomic add.
"""

from __future__ import annotations

import numpy as np
import torch

# the nine (ox, oy) groups of runs, in order
GROUPS = [(ox, oy) for ox in (-1, 0, 1) for oy in (-1, 0, 1)]
# rows of sorted particles that share one candidate window in the
# program's B3 kernel (its plan, which the work counts follow)
ROW = 128


def box_grid(box_lo, box_hi, cell_size: float) -> dict:
    """The grid over the box: its origin, cell size and cells per axis."""
    lo = np.asarray(box_lo, dtype=np.float64)
    hi = np.asarray(box_hi, dtype=np.float64)
    dims = np.maximum(np.ceil((hi - lo) / cell_size).astype(np.int64), 1)
    return {"origin": tuple(float(x) for x in lo), "cell_size": float(cell_size),
            "dims": tuple(int(d) for d in dims), "cells": int(np.prod(dims))}


class Reference:
    """The reference for one configuration: ``run(state, steps)`` steps a
    state (a dict of ``pos``/``vel`` [3, N], ``collisions`` i32[N],
    ``radius``/``restitution`` [N]) and returns the new one in the same
    particle order, with ``count_work`` also each step's work counts
    (``work``).  The scene is the box (``box_lo``, ``box_hi``)."""

    def __init__(self, scene: dict, cfg: dict, device, dtype=torch.float32,
                 cache_dir: str = ""):
        sim = cfg["sim"]
        self.dtype = dtype
        self.device = torch.device(device)
        self.dt = float(sim["dt"])
        self.beta = float(sim["beta"])
        self.window = int(cfg["runner"]["window"])
        self.grid = box_grid(scene["box_lo"], scene["box_hi"], float(sim["cell_size"]))

        def vec(x):
            return torch.tensor(x, dtype=torch.float32, device=self.device).to(dtype)

        self.lo, self.hi = vec(scene["box_lo"]), vec(scene["box_hi"])
        self.origin = vec(self.grid["origin"])
        self.gravity = vec(sim["gravity"])
        dims = self.grid["dims"]
        i64 = dict(dtype=torch.int64, device=self.device)
        self.g_off = torch.tensor([(ox * dims[1] + oy) * dims[2] for ox, oy in GROUPS],
                                  **i64)[:, None]
        self.g_ox = torch.tensor([ox for ox, _ in GROUPS], **i64)[:, None]
        self.g_oy = torch.tensor([oy for _, oy in GROUPS], **i64)[:, None]
        self.work: list = []

    # ---------------------------------------------------------------- run
    def run(self, state: dict, steps: int, count_work: bool = False) -> dict:
        """``steps`` steps as one call: the order the particles are sorted
        from carries over from step to step, and the result comes back in
        the particles' own order."""
        st = {k: state[k].to(self.device) for k in ("pos", "vel", "collisions",
                                                     "radius", "restitution")}
        for k in ("pos", "vel", "radius", "restitution"):
            st[k] = st[k].to(self.dtype)
        n = st["pos"].shape[-1]
        # the carried order: ids[j] is the particle at position j
        ids = torch.arange(n, device=self.device)
        rows = torch.cat([st["pos"], st["vel"], st["radius"][None],
                          st["restitution"][None]], dim=0)
        col = st["collisions"].to(torch.int32)
        self.work = []
        for _ in range(steps):
            rows, col, ids = self.step(rows, col, ids, count_work)
        out = torch.empty_like(rows)
        out[:, ids] = rows
        out_col = torch.empty_like(col)
        out_col[ids] = col
        return {"pos": out[0:3], "vel": out[3:6], "collisions": out_col,
                "radius": out[6], "restitution": out[7]}

    def cells(self, pos):
        """Linear cell id of each particle."""
        g = self.grid
        c = torch.floor((pos - self.origin[:, None]) * (1.0 / g["cell_size"]))
        dims = g["dims"]
        cx, cy, cz = (torch.clamp(c[a], 0, dims[a] - 1).to(torch.int32) for a in range(3))
        return ((cx * dims[1] + cy) * dims[2] + cz).long()

    def step(self, rows, col, ids, count_work: bool = False):
        """One step of the carried rows ([8, N]: pos, vel, radius,
        restitution), contact counts and ids: returns them in the step's
        sorted order, advanced."""
        cell, perm = torch.sort(self.cells(rows[0:3]), stable=True)
        rows, col, ids = rows[:, perm], col[perm], ids[perm]
        start, count = self.runs(cell)
        dv, dp, ncon = self.contacts(rows, start, count)
        if count_work:
            self.work.append(self._work(cell, start, count))
        pos, vel = rows[0:3] + dp, rows[3:6] + dv
        pos, vel = self.walls(pos, vel, rows[6], rows[7])
        vel = vel + self.gravity[:, None] * self.dt
        pos = pos + vel * self.dt
        return torch.cat([pos, vel, rows[6:8]], dim=0), col + ncon, ids

    def runs(self, cell):
        """(start, count) i64[9, N]: each sorted particle's nine runs."""
        g = self.grid
        cells, dims = g["cells"], g["dims"]
        # offsets[c]: the particles in cells below c (a sorted search)
        offsets = torch.searchsorted(cell, torch.arange(cells + 1, device=cell.device))
        cx, cy = cell // (dims[1] * dims[2]), (cell // dims[2]) % dims[1]
        first = offsets[torch.clamp(cell[None] + self.g_off - 1, 0, cells)]
        end = offsets[torch.clamp(cell[None] + self.g_off + 2, 0, cells)]
        ok = ((cx[None] + self.g_ox >= 0) & (cx[None] + self.g_ox < dims[0])
              & (cy[None] + self.g_oy >= 0) & (cy[None] + self.g_oy < dims[1]))
        return first, torch.where(ok, end - first, 0)

    def contacts(self, rows, start, count):
        """Each sorted particle's summed impulse, correction and contacts
        over its runs, in run order: (dv [3, N], dp [3, N], ncon i32[N])."""
        n = rows.shape[-1]
        dev = rows.device
        dv_dp = torch.zeros((6, n), dtype=rows.dtype, device=dev)
        ncon = torch.zeros((n,), dtype=torch.int32, device=dev)
        # per group, the particles by run length, longest first, and how
        # many have a run longer than k: the batch's segment (g, k)
        length, order = torch.sort(count, dim=1, descending=True, stable=True)
        k_max = int(length[:, 0].max())
        if k_max == 0:
            return dv_dp[:3], dv_dp[3:], ncon
        ks = torch.arange(k_max, device=dev)
        longer = n - torch.searchsorted(length.flip(1).contiguous(),
                                        ks.expand(len(GROUPS), k_max).contiguous(),
                                        right=True)
        seg = longer.flatten()
        host = seg.tolist()
        total = sum(host)
        seg_id = torch.repeat_interleave(torch.arange(seg.numel(), device=dev), seg,
                                         output_size=total)
        first = torch.cumsum(seg, 0) - seg
        g = seg_id // k_max
        k = seg_id % k_max
        lane = order[g, torch.arange(total, device=dev) - first[seg_id]]
        cand = start[g, lane] + k
        out, touching = self.pair(rows[:, lane], rows[:, cand])
        at = 0
        for gi in range(len(GROUPS)):
            o = order[gi]
            acc, cnt = dv_dp[:, o], ncon[o]
            for m in host[gi * k_max:(gi + 1) * k_max]:
                if m == 0:
                    break
                acc[:, :m] += out[:, at:at + m]
                cnt[:m] += touching[at:at + m]
                at += m
            dv_dp[:, o] = acc
            ncon[o] = cnt
        return dv_dp[:3], dv_dp[3:], ncon

    def pair(self, own, cand):
        """The contact model for one candidate an entry (``own``, ``cand``:
        [8, P] rows): ([dv; dp] [6, P], touching i32[P])."""
        pos, vel, radius, restit = own[0:3], own[3:6], own[6], own[7]
        pj, vj, rj, ej = cand[0:3], cand[3:6], cand[6], cand[7]
        mass = radius * radius * radius
        mj = rj * rj * rj
        d = pos - pj
        dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        rsum = radius + rj
        touching = (dist2 < rsum * rsum) & (dist2 > 0.0)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
        nrm = d / dist[None]
        v_rel = vel - vj
        vn = v_rel[0] * nrm[0] + v_rel[1] * nrm[1] + v_rel[2] * nrm[2]
        approaching = touching & (vn < 0.0)
        e = 0.5 * (restit + ej)
        wgt = mj / (mass + mj)
        imp = torch.where(approaching, -(1.0 + e) * vn * wgt, 0.0)
        overlap = torch.where(touching, rsum - dist, 0.0)
        return (torch.cat([nrm * imp[None], nrm * (self.beta * overlap * wgt)[None]]),
                touching.to(torch.int32))

    def walls(self, pos, vel, radius, restit):
        """The six walls' response (before the integrator)."""
        hit_any = torch.zeros(pos.shape[-1], dtype=torch.bool, device=pos.device)
        new_pos, new_vel = [], []
        for a in range(3):
            low = self.lo[a] + radius
            high = self.hi[a] - radius
            p, v = pos[a], vel[a]
            hit_lo = (p < low) & (v < 0.0)
            hit_hi = (p > high) & (v > 0.0)
            new_pos.append(torch.where(hit_lo, low, torch.where(hit_hi, high, p)))
            new_vel.append(torch.where(hit_lo | hit_hi, -v * restit, v))
            hit_any = hit_any | hit_lo | hit_hi
        new_vel = torch.stack(new_vel)
        new_vel = torch.where(hit_any[None], new_vel - self.gravity[:, None] * self.dt,
                              new_vel)
        return torch.stack(new_pos), new_vel

    # --------------------------------------------------------------- work
    def _work(self, cell, start, count) -> dict:
        """The step's work as the program's B3 cells kernel needs it (its
        plan: one window of ``window`` columns a row of 128 sorted
        particles and group, starting at the row's least run start rounded
        down to 128): particles; candidates tested in the windows;
        distinct columns those candidates read; distinct CSR offsets the
        runs read; particles with a run outside its window (listed for
        the worklist)."""
        n = cell.shape[0]
        w = self.window
        rows = -(-n // ROW)
        big = 1 << 62
        s = torch.full((len(GROUPS), rows * ROW), big, dtype=torch.int64, device=cell.device)
        s[:, :n] = torch.where(count > 0, start, big)
        ws = s.reshape(len(GROUPS), rows, ROW).amin(2)
        ws = torch.clamp((torch.where(ws == big, 0, ws) // ROW) * ROW, 0, n)
        ws = ws.repeat_interleave(ROW, dim=1)[:, :n]
        rel = start - ws
        listed = ((count > 0) & ((rel < 0) | (rel + count > w))).any(0)
        rel = torch.clamp(rel, 0, w - 1)
        bound = torch.where(count > 0, torch.minimum(count, w - rel), 0)
        col0 = (ws + rel)[bound > 0]
        diff = torch.zeros(n + w + 1, dtype=torch.int64, device=cell.device)
        diff.index_add_(0, col0, torch.ones_like(col0))
        diff.index_add_(0, col0 + bound[bound > 0], -torch.ones_like(col0))
        g = self.grid
        dims = g["dims"]
        occupied = torch.unique(cell)
        cx, cy = occupied // (dims[1] * dims[2]), (occupied // dims[2]) % dims[1]
        ok = ((cx[None] + self.g_ox >= 0) & (cx[None] + self.g_ox < dims[0])
              & (cy[None] + self.g_oy >= 0) & (cy[None] + self.g_oy < dims[1]))
        c = (occupied[None] + self.g_off)[ok]
        read = torch.unique(torch.cat([torch.clamp(c - 1, 0, g["cells"]),
                                       torch.clamp(c + 2, 0, g["cells"])]))
        return {"lanes": n, "candidates": int(bound.sum()),
                "columns": int((torch.cumsum(diff, 0) > 0).sum()),
                "offsets": int(read.numel()), "listed": int(listed.sum())}
