"""The inputs of the domain-decomposed box cells: the box, and the spawn of
a seed, which is the settled pile that the seed's drop makes.

The drop (``drop``) is ``bench/configs.py::config_5``'s: n particles
uniform in the upper half of the box, one nominal radius in from its
walls, radii ``particle_radius`` x U(``radius_range``), restitution
U(``restitution_range``), velocities N(0, sigma) a component, drawn from
``np.random.default_rng(seed)`` in the order that the program's
``_box_state(hetero=True)`` draws them: positions, radii, restitution,
velocities.  The spawn (``make_spawn``) is that drop after ``pile_step``
steps of the configuration's plain reference in float32, as one call,
made and kept as ``inputs/box.py`` makes and keeps the equal spheres'
pile (under ``portbench/.cache/pile/`` by configuration, seed and
device).

``make_scene`` imports the configuration's system first, so that a
checkout whose program lacks what the system needs fails before the
pile is made.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import harness

KEYS = ("pos", "vel", "radius", "restitution")


def _box():
    return harness.load_module(os.path.join(harness.ROOT, "inputs", "box.py"),
                               "portbench_inputs_box")


def make_scene(cfg: dict) -> dict:
    harness.load_module(os.path.join(harness.ROOT, "systems", f"{cfg['system']}.py"),
                        f"portbench_system_{cfg['system']}")
    return _box().make_scene(cfg)


def drop(cfg: dict, seed: int) -> dict:
    """The seed's drop as host arrays (``pos``/``vel`` f32[3, n],
    ``radius``/``restitution`` f32[n])."""
    sim, p = cfg["sim"], cfg["particles"]
    n, r = p["n"], sim["particle_radius"]
    lo, hi = np.asarray(cfg["scene"]["box_lo"]), np.asarray(cfg["scene"]["box_hi"])
    rng = np.random.default_rng(seed % (1 << 63))
    pos = np.stack([
        rng.uniform(lo[0] + r, hi[0] - r, n),
        rng.uniform((lo[1] + hi[1]) / 2, hi[1] - r, n),
        rng.uniform(lo[2] + r, hi[2] - r, n),
    ]).astype(np.float32)
    (a, b), (e0, e1) = p["radius_range"], p["restitution_range"]
    radius = rng.uniform(a * r, b * r, n).astype(np.float32)
    restitution = rng.uniform(e0, e1, n).astype(np.float32)
    vel = (rng.normal(size=(3, n)) * p["speed_sigma"]).astype(np.float32)
    return {"pos": pos, "vel": vel, "radius": radius, "restitution": restitution}


def make_spawn(cfg: dict, seed: int) -> dict:
    """The step-``pile_step`` pile of the seed's drop (host arrays, with
    ``n_real``), from the cache or made now."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    # the slabs shape the pile's bits: the cache's key holds them
    path = _box()._cache_path(
        dict(cfg, particles=dict(cfg["particles"], domain=cfg["domain"])), seed, dev)
    n = cfg["particles"]["n"]
    if os.path.exists(path):
        with np.load(path) as f:
            return {**{k: f[k] for k in KEYS}, "n_real": n}
    t0 = time.perf_counter()
    ref = harness.load_reference(cfg, make_scene(cfg), dev)
    d = {k: torch.from_numpy(v) for k, v in drop(cfg, seed).items()}
    d["collisions"] = torch.zeros(n, dtype=torch.int32)
    got = ref.run(d, cfg["particles"]["pile_step"])
    pile = {k: got[k].cpu().numpy() for k in KEYS}
    drops = ref.drops
    del ref, got
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **pile)
    os.replace(tmp, path)
    harness.log(f"[portbench] pile of seed {seed}: {cfg['particles']['pile_step']} "
                f"reference steps on {dev.type} in {time.perf_counter() - t0:.3f} s; "
                f"capacity drops (halo, migration, slots) {drops}")
    return {**pile, "n_real": n}
