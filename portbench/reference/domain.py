"""The plain reference of the domain-decomposed box cells: the gravity box
of ``reference/p2p.py`` split into slabs along x, one a rank, with ghost
copies across the slabs' faces and particles that migrate between them,
computed on the whole state, slab by slab, in one process, in plain
PyTorch, from the benchmark's own inputs and nothing the program made.

The decomposition (the configuration's ``domain``: ``n_shards`` slabs of
equal width, ``shard_capacity`` slots a slab, ``halo_capacity`` ghosts a
face and ``migrate_capacity`` migrants a direction a step):
  * slab s spans ``[lo_s, hi_s)`` in x, ``lo_s = box_lo + w * s`` and
    ``hi_s = lo_s + w`` in float32; the first slab also keeps what lies
    below it, the last what lies beyond it.  A call starts with each
    slab's particles in the order of their ids (their place in the
    state), in the slab whose bounds hold them;
  * a step: each slab sends as ghosts, in its slots' order, its particles
    with ``x < lo_s + cell`` to the slab below and those with ``x >=
    hi_s - cell`` to the slab above (at most ``halo_capacity`` each);
  * each slab's buffer is its own slots, then the ghosts from below, then
    those from above; the particles of that buffer are sorted by cell,
    stably, and take one pass of ``reference/p2p.py``'s contact
    arithmetic (its cells, runs and contacts; a buffer's sentinel slots
    hold no particle and take no part); a ghost's result is discarded;
  * each slab's own particles then take the walls of the whole box and
    the integrator (``reference/p2p.py``'s walls and integrator); the
    collision counter takes the particle contacts and the wall hits;
  * particles with ``x < lo_s`` (not in the first slab) migrate down,
    with ``x >= hi_s`` (not in the last) up; a slab's slots become its
    kept particles in order, then the arrivals from below, then those
    from above (``shard_capacity`` at most).  A capacity exceeded drops
    what does not fit, as the program's fixed buffers do, and is counted
    in ``drops``.

``dtype`` computes the whole step in another precision (the control:
bfloat16; the witness: float64).  ``count_work`` records, step by step,
the work of the program's B3 cells kernel on every slab's buffer
(``reference/p2p.py``: ``Reference._work``, over each buffer's
particles), summed over the slabs: the whole step's work, as the
readers of a roofline on several cards take it (``trace.worked``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.p2p import Reference as P2PReference


class Reference:
    """The reference for one configuration: ``run(state, steps)`` steps a
    state (a dict of ``pos``/``vel`` [3, N], ``collisions`` i32[N],
    ``radius``/``restitution`` [N]) and returns the new one in the same
    particle order; ``work`` and ``drops`` (halo, migration and slot
    overflow) of the last call."""

    def __init__(self, scene: dict, cfg: dict, device, dtype=torch.float32,
                 cache_dir: str = ""):
        self.p2p = P2PReference(scene, cfg, device, dtype=dtype)
        self.device, self.dtype = self.p2p.device, dtype
        d = cfg["domain"]
        self.shards = int(d["n_shards"])
        self.capacity = int(d["shard_capacity"])
        self.halo = int(d["halo_capacity"])
        self.migrate = int(d["migrate_capacity"])
        lo, hi = float(scene["box_lo"][0]), float(scene["box_hi"][0])
        f32 = np.float32
        width, cell = f32((hi - lo) / self.shards), f32(cfg["sim"]["cell_size"])
        self.slab_lo = [f32(lo) + width * f32(s) for s in range(self.shards)]
        self.slab_hi = [s_lo + width for s_lo in self.slab_lo]
        if any(a != b for a, b in zip(self.slab_hi, self.slab_lo[1:])):
            raise ValueError("the slabs' float32 bounds leave a gap or an overlap: "
                             "a particle's slab would be ambiguous")
        self.near_lo = [float(s_lo + cell) for s_lo in self.slab_lo]
        self.near_hi = [float(s_hi - cell) for s_hi in self.slab_hi]
        self.work: list = []
        self.drops = [0, 0, 0]

    def run(self, state: dict, steps: int, count_work: bool = False) -> dict:
        st = {k: state[k].to(self.device) for k in ("pos", "vel", "collisions",
                                                     "radius", "restitution")}
        rows = torch.cat([st["pos"], st["vel"], st["radius"][None],
                          st["restitution"][None]], dim=0).to(self.dtype)
        col = st["collisions"].to(torch.int32).clone()
        # the call's slots: each slab's particles in id order
        owner = torch.zeros(rows.shape[1], dtype=torch.int64, device=self.device)
        for s_lo in self.slab_lo[1:]:
            owner += (rows[0] >= float(s_lo)).long()
        slots = [torch.nonzero(owner == s).flatten() for s in range(self.shards)]
        self.work, self.drops = [], [0, 0, 0]
        for _ in range(steps):
            slots = self.step(slots, rows, col, count_work)
        return {"pos": rows[0:3], "vel": rows[3:6], "collisions": col,
                "radius": rows[6], "restitution": rows[7]}

    def _cap(self, idx, capacity: int, kind: int):
        """``idx`` cut to ``capacity``, the cut counted in ``drops``."""
        self.drops[kind] += max(int(idx.numel()) - capacity, 0)
        return idx[:capacity]

    def step(self, slots: list, rows, col, count_work: bool = False) -> list:
        """One step of every slab, in place on the rows ([8, N]: pos, vel,
        radius, restitution) and counters, which are in id order; returns
        the slabs' new slots."""
        S = self.shards
        empty = slots[0][:0]
        down, up = [], []  # the ghosts each slab sends
        for s in range(S):
            x = rows[0, slots[s]]
            down.append(self._cap(slots[s][x < self.near_lo[s]], self.halo, 0))
            up.append(self._cap(slots[s][x >= self.near_hi[s]], self.halo, 0))
        done, work = [], []
        for s in range(S):
            own = slots[s]
            buf = torch.cat([own, up[s - 1] if s > 0 else empty,
                             down[s + 1] if s < S - 1 else empty])
            done.append((own,) + self._advance(rows[:, buf], own.numel(),
                                               work if count_work else None))
        if count_work:
            self.work.append({k: sum(w[k] for w in work) for k in work[0]})
        for own, pos, vel, hits in done:
            rows[0:3, own] = pos
            rows[3:6, own] = vel
            col[own] += hits
        stay, go_down, go_up = [], [], []
        for s in range(S):
            own = slots[s]
            x = rows[0, own]
            lower = (x < float(self.slab_lo[s])) & (s > 0)
            upper = (x >= float(self.slab_hi[s])) & (s < S - 1)
            stay.append(own[~lower & ~upper])
            go_down.append(self._cap(own[lower], self.migrate, 1))
            go_up.append(self._cap(own[upper], self.migrate, 1))
        return [self._cap(torch.cat([stay[s], go_up[s - 1] if s > 0 else empty,
                                     go_down[s + 1] if s < S - 1 else empty]),
                          self.capacity, 2) for s in range(S)]

    def _advance(self, buf, n_own: int, work):
        """One slab's buffer ([8, B] rows, its own ``n_own`` particles
        first): the contacts over the buffer, then the walls and the
        integrator on its own particles, the buffer's work appended to
        ``work`` where it is a list.  Returns their (pos, vel, contacts +
        wall hits)."""
        ref = self.p2p
        if n_own == 0:
            return buf[0:3, :0], buf[3:6, :0], torch.zeros(0, dtype=torch.int32,
                                                           device=buf.device)
        cell, perm = torch.sort(ref.cells(buf[0:3]), stable=True)
        start, count = ref.runs(cell)
        dv, dp, ncon = ref.contacts(buf[:, perm], start, count)
        if work is not None:
            work.append(ref._work(cell, start, count))
        at = torch.empty_like(perm)
        at[perm] = torch.arange(perm.numel(), device=perm.device)
        own = at[:n_own]
        radius, restit = buf[6, :n_own], buf[7, :n_own]
        pos, vel = buf[0:3, :n_own] + dp[:, own], buf[3:6, :n_own] + dv[:, own]
        hits = torch.zeros(n_own, dtype=torch.bool, device=buf.device)
        for a in range(3):
            hits |= (((pos[a] < ref.lo[a] + radius) & (vel[a] < 0.0))
                     | ((pos[a] > ref.hi[a] - radius) & (vel[a] > 0.0)))
        pos, vel = ref.walls(pos, vel, radius, restit)
        vel = vel + ref.gravity[:, None] * ref.dt
        pos = pos + vel * ref.dt
        return pos, vel, ncon[own] + hits.to(torch.int32)
