"""The plain reference of the DragonScene cells: the spatial and the hybrid
method, one step at a time, in plain PyTorch, from the benchmark's own
inputs (scene arrays, camera, spawn) and nothing the program made.

One spatial step, for every particle (ParticleSys.cs:445-527):
  * its candidates are the triangles that the grid (``grid.py``) lists
    for the cell of its travel-segment midpoint ``pos + vel * dt / 2``;
  * the exact swept-sphere test against each (two offset-plane ray tests,
    three edge cylinders, three vertex spheres; SpatialStructure
    CollisionDetection.compute:163-233), the hit kept when its squared
    distance is within the step's travel;
  * the nearest hit, the first candidate on a tie;
  * the response (reflect, scaled by bounciness * |v|, minus g * dt; the
    position snapped to the hit, backed off and rebounded by the rest of
    the travel; compute:332-352), then ``v += g * dt; p += v * dt``.
The hybrid step first runs the screen-space test against the camera's
pre-pass (ScreenSpaceDepthCollisionDetection.compute:31-143): a visible
particle within a radius of the depth surface and moving into it takes
the screen-space response; off-screen and occluded particles are
undecided, and only they take the exact test.

Every expression is written out in the order that the program documents
for its kernels and their plain versions (``(a0*b0 + a1*b1) + a2*b2``,
no fused multiply-add, IEEE division and square root), so a sound
program's particles agree with these to the bit.  ``dtype`` computes the
whole step in another precision (the control: bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import grid as ref_grid
from portbench.reference import raster
from portbench.scene import forward, projection_matrix, view_matrix

_INF = float("inf")
# candidate pairs evaluated at once: each temporary is 16 MiB in float32
_PAIRS = 1 << 22


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def candidate(pos, dirn, radius, seg2, v0, v1, v2):
    """Swept sphere (pos, unit dirn [3, P]; radius, seg2 [P]) against
    triangles v0, v1, v2 [3, P]: (hit within the travel, t2, t, normal
    flipped against the motion)."""
    nr = cross3(v1 - v0, v2 - v0)
    nlen = torch.sqrt(torch.clamp(dot3(nr, nr), min=1e-37))
    nr = nr / nlen[None]
    flip = dot3(nr, dirn) > 0.0
    nr = torch.where(flip[None], -nr, nr)
    off = nr * radius[None]

    c_t2 = torch.full(v0.shape[1:], _INF, dtype=v0.dtype, device=v0.device)
    c_t = torch.full(v0.shape[1:], _INF, dtype=v0.dtype, device=v0.device)
    c_hit = torch.zeros(v0.shape[1:], dtype=torch.bool, device=v0.device)

    def consider(hit, t, c_t2, c_t, c_hit):
        t2 = t * t
        take = hit & (t2 < c_t2)
        return torch.where(take, t2, c_t2), torch.where(take, t, c_t), c_hit | hit

    for sgn in (1.0, -1.0):  # the triangle's plane offset by +-r*n
        a0 = v0 + sgn * off
        a1 = v1 + sgn * off
        a2 = v2 + sgn * off
        e1 = a1 - a0
        e2 = a2 - a0
        rov = pos - a0
        nn = cross3(e1, e2)
        q = cross3(rov, dirn)
        d = 1.0 / dot3(dirn, nn)
        u = d * -dot3(q, e2)
        vv = d * dot3(q, e1)
        t = d * -dot3(nn, rov)
        hit = ~((u < 0.0) | (vv < 0.0) | ((u + vv) > 1.0))
        c_t2, c_t, c_hit = consider(hit, t, c_t2, c_t, c_hit)

    for pa, pb in ((v0, v1), (v1, v2), (v2, v0)):  # edge cylinders
        ba = pb - pa
        oc = pos - pa
        baba = dot3(ba, ba)
        bard = dot3(ba, dirn)
        baoc = dot3(ba, oc)
        k2 = baba - bard * bard
        k1 = baba * dot3(oc, dirn) - baoc * bard
        k0 = baba * dot3(oc, oc) - baoc * baoc - radius * radius * baba
        h = k1 * k1 - k2 * k0
        hs = torch.sqrt(torch.clamp(h, min=0.0))
        t_body = (-k1 - hs) / k2
        y = baoc + t_body * bard
        body_hit = (h >= 0.0) & (y > 0.0) & (y < baba)
        yc = torch.where(y < 0.0, 0.0, baba)
        t_cap = (yc - baoc) / bard
        qq = oc + dirn * t_cap[None] - ba * (yc / baba)[None]
        cap_hit = (h >= 0.0) & (dot3(qq, qq) < radius * radius)
        c_t2, c_t, c_hit = consider(body_hit | cap_hit,
                                    torch.where(body_hit, t_body, t_cap),
                                    c_t2, c_t, c_hit)

    for pv in (v0, v1, v2):  # vertex spheres
        oc = pv - pos
        proj = dot3(oc, dirn)
        disc = radius * radius - (dot3(oc, oc) - proj * proj)
        c_t2, c_t, c_hit = consider(disc >= 0.0,
                                    proj - torch.sqrt(torch.clamp(disc, min=0.0)),
                                    c_t2, c_t, c_hit)

    return c_hit & (c_t2 <= seg2), c_t2, c_t, nr


class Reference:
    """The reference for one configuration: ``run(state, steps)`` steps a
    state (a dict of ``pos``/``vel`` [3, N], ``collisions`` i32[N],
    ``radius``/``restitution`` [N]) and returns the new one, with
    ``count_work`` also each step's work counts (``work``)."""

    def __init__(self, scene: dict, cfg: dict, device, dtype=torch.float32,
                 cache_dir: str = ""):
        sim = cfg["sim"]
        self.dtype = dtype
        self.device = torch.device(device)
        self.dt = float(sim["dt"])
        self.backoff = float(sim["backoff"])
        self.grid = ref_grid.build(scene["triangles"], sim["cell_size"],
                                   sim["expand"], self.device)
        g = self.grid
        self.verts = tuple(g[k].to(dtype) for k in ("v0", "v1", "v2"))
        self.origin = torch.tensor(g["origin"], dtype=torch.float32,
                                   device=self.device).to(dtype)
        self.gravity = torch.tensor(sim["gravity"], dtype=torch.float32,
                                    device=self.device).to(dtype)
        self.tex = None
        cam_name = cfg["scene"].get("camera")
        if cfg["method"] == "hybrid":
            cam = scene["cameras"][cam_name]
            depth, normal = raster.bake(scene["triangles"], cam,
                                        scene["corner_normals"], cache_dir)
            planar = np.concatenate([depth.reshape(1, -1), normal.reshape(-1, 3).T],
                                    axis=0).astype(np.float32)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
                    self.device).to(dtype)

            self.tex = {"view": t(view_matrix(cam)), "proj": t(projection_matrix(cam)),
                        "cam_pos": t(np.asarray(cam["position"], dtype=np.float64)),
                        "cam_fwd": t(forward(cam)), "planar": t(planar),
                        "h": int(depth.shape[0]), "w": int(depth.shape[1])}
        self.work: list = []

    # ---------------------------------------------------------------- run
    def run(self, state: dict, steps: int, count_work: bool = False) -> dict:
        st = {k: v.to(self.device) for k, v in state.items()}
        for k in ("pos", "vel", "radius", "restitution"):
            st[k] = st[k].to(self.dtype)
        self.work = []
        for _ in range(steps):
            st = self.step(st, count_work)
        return st

    def step(self, st: dict, count_work: bool = False) -> dict:
        active = None
        if self.tex is not None:
            st, active = self.screen_space(st)
        return self.exact(st, active, count_work)

    # --------------------------------------------------- screen-space test
    def screen_space(self, st: dict):
        """The screen-space test and response; returns (state, undecided)."""
        tex = self.tex
        pos, velo = st["pos"], st["vel"]
        speed2 = dot3(velo, velo)
        moving = speed2 != 0.0

        def transform(m, xyz, w):
            return torch.stack([m[r, 0] * xyz[0] + m[r, 1] * xyz[1] + m[r, 2] * xyz[2]
                                + m[r, 3] * w for r in range(4)])

        view_pos = transform(tex["view"], pos, 1.0)
        clip = transform(tex["proj"], view_pos[:3], view_pos[3])
        ndc = clip[:3] / clip[3]
        sx = ndc[0] * 0.5 + 0.5
        sy = ndc[1] * 0.5 + 0.5
        inside = (sx >= 0.0) & (sx <= 1.0) & (sy >= 0.0) & (sy <= 1.0)
        to_particle = pos - tex["cam_pos"][:, None]
        in_front = dot3(tex["cam_fwd"][:, None], to_particle) > 0.0
        visible = inside & in_front

        h_px, w_px = tex["h"], tex["w"]
        px = torch.clamp((sx * w_px).to(torch.int32), 0, w_px - 1)
        py = torch.clamp((sy * h_px).to(torch.int32), 0, h_px - 1)
        g = tex["planar"][:, (py * w_px + px).long()]
        depth, normal = g[0], g[1:4]

        eye_dist = torch.sqrt(dot3(to_particle, to_particle))
        diff = torch.abs(eye_dist - depth)
        into = dot3(normal, velo) < 0.0
        near_surface = diff <= st["radius"]
        collide = moving & visible & near_surface & into

        dirn = velo / torch.sqrt(speed2)
        refl = dirn - 2.0 * dot3(dirn, normal) * normal
        refl = refl / torch.sqrt(dot3(refl, refl))
        speed = torch.sqrt(speed2)
        new_vel = refl * (st["restitution"] * speed)[None] - self.gravity[:, None] * self.dt
        new_pos = pos + new_vel * self.dt - velo * self.dt
        out = dict(st)
        out["pos"] = torch.where(collide[None], new_pos, pos)
        out["vel"] = torch.where(collide[None], new_vel, velo)
        out["collisions"] = st["collisions"] + collide.to(torch.int32)
        occluded = visible & ~near_surface & (eye_dist > depth)
        return out, moving & (~visible | occluded)

    # ------------------------------------------------ exact test, response
    def cells(self, pos, vel):
        """Linear cell id of each particle's travel-segment midpoint."""
        g = self.grid
        lp = pos + vel * (self.dt * 0.5)
        c = torch.floor((lp - self.origin[:, None]) * (1.0 / g["cell_size"]))
        dims = g["dims"]
        cx, cy, cz = (torch.clamp(c[a], 0, dims[a] - 1).to(torch.int32) for a in range(3))
        return ((cx * dims[1] + cy) * dims[2] + cz).long()

    def exact(self, st: dict, active, count_work: bool) -> dict:
        pos, vel = st["pos"], st["vel"]
        radius, restit = st["radius"], st["restitution"]
        n, dev, dt = pos.shape[-1], self.device, self.dt
        offsets, tri_ids = self.grid["offsets"], self.grid["tri_ids"]
        cell = self.cells(pos, vel)
        start = offsets[cell]
        count = offsets[cell + 1] - start
        if active is not None:
            count = torch.where(active, count, 0)

        speed2 = dot3(vel, vel)
        inv_speed = 1.0 / torch.sqrt(torch.clamp(speed2, min=1e-37))
        dirn = vel * inv_speed[None]
        seg2 = speed2 * (dt * dt)

        best_t2 = torch.full((n,), _INF, dtype=pos.dtype, device=dev)
        best_t = torch.full((n,), _INF, dtype=pos.dtype, device=dev)
        best_n = torch.zeros((3, n), dtype=pos.dtype, device=dev)
        any_hit = torch.zeros((n,), dtype=torch.bool, device=dev)

        lanes = torch.nonzero(count > 0).squeeze(1)
        if lanes.numel():
            cnt = count[lanes]
            ends = torch.cumsum(cnt, 0)
            # blocks of lanes, each at most _PAIRS candidates (or one lane)
            cuts = torch.searchsorted(ends, torch.arange(
                _PAIRS, int(ends[-1]) + _PAIRS, _PAIRS, device=dev), right=True)
            bounds = sorted({0, *[int(c) for c in cuts.tolist()], lanes.numel()})
            for a, b in zip(bounds, bounds[1:]):
                if b > a:
                    self._block(lanes[a:b], start, count, pos, dirn, radius, seg2,
                                tri_ids, best_t2, best_t, best_n, any_hit)

        if count_work:
            self.work.append(self._work(cell, count, n))

        hit = any_hit & (best_t2 < _INF) & (speed2 != 0.0)
        gdt = self.gravity[:, None] * dt
        col_point = pos + dirn * best_t[None]
        dn = dot3(dirn, best_n)
        refl = dirn - best_n * (2.0 * dn)[None]
        rlen = torch.sqrt(torch.clamp(dot3(refl, refl), min=1e-37))
        refl = refl / rlen[None]
        ce = (pos + vel * dt) - col_point
        col_to_end = torch.sqrt(torch.clamp(dot3(ce, ce), min=0.0))
        speed = torch.sqrt(speed2)
        new_vel = refl * (restit * speed)[None] - gdt
        new_pos = (col_point - dirn * (self.backoff * radius)[None]
                   + refl * (col_to_end * restit)[None])
        out_vel = torch.where(hit[None], new_vel, vel) + gdt
        out_pos = torch.where(hit[None], new_pos, pos)
        out = dict(st)
        out["pos"] = out_pos + out_vel * dt
        out["vel"] = out_vel
        out["collisions"] = st["collisions"] + hit.to(torch.int32)
        return out

    def _block(self, lanes, start, count, pos, dirn, radius, seg2, tri_ids,
               best_t2, best_t, best_n, any_hit):
        """Nearest hit of ``lanes`` over their candidates, in place."""
        dev = pos.device
        cnt = count[lanes]
        m = lanes.numel()
        local = torch.repeat_interleave(torch.arange(m, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(local.numel(), device=dev) - first[local]
        lane = lanes[local]
        tri = tri_ids[start[lane] + k]
        v0, v1, v2 = (v[:, tri] for v in self.verts)
        tri_hit, c_t2, c_t, nr = candidate(pos[:, lane], dirn[:, lane], radius[lane],
                                           seg2[lane], v0, v1, v2)
        c_t2 = torch.where(tri_hit, c_t2, _INF)
        # the first candidate with the least t2
        low = torch.full((m,), _INF, dtype=c_t2.dtype, device=dev).scatter_reduce(
            0, local, c_t2, "amin")
        idx = torch.arange(local.numel(), device=dev)
        big = local.numel()
        win = torch.full((m,), big, dtype=torch.int64, device=dev).scatter_reduce(
            0, local, torch.where(c_t2 == low[local], idx, big), "amin")
        found = low < _INF
        win = torch.where(found, win, 0)
        best_t2[lanes] = torch.where(found, low, best_t2[lanes])
        best_t[lanes] = torch.where(found, c_t[win], best_t[lanes])
        best_n[:, lanes] = torch.where(found[None], nr[:, win], best_n[:, lanes])
        hit_any = torch.zeros((m,), dtype=torch.uint8, device=dev).scatter_reduce(
            0, local, tri_hit.to(torch.uint8), "amax")
        any_hit[lanes] = (hit_any > 0) | any_hit[lanes]

    def _work(self, cell, count, n: int) -> dict:
        """The step's work as the kernels need it: candidates tested,
        distinct (cell, triangle) rows among them, distinct cells looked
        up, lanes."""
        tested = count > 0
        cells_tested = torch.unique(cell[tested])
        offsets = self.grid["offsets"]
        return {"lanes": n, "candidates": int(count.sum()),
                "rows": int((offsets[cells_tested + 1] - offsets[cells_tested]).sum()),
                "keys": int(torch.unique(cell).numel())}
