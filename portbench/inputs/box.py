"""The gravity-box cells' inputs: the box, and the spawn of a seed, which
is the settled pile that the seed's drop makes.

The drop (``drop``) is config 4's: n particles uniform in the upper half
of the box, one radius in from its walls, velocities N(0, sigma) a
component, drawn from ``np.random.default_rng(seed)`` in the order that
``bench/configs.py::_box_state`` of the program draws them.  The spawn
(``make_spawn``) is that drop after ``pile_step`` steps of the plain
reference (``reference/p2p.py``) in float32, as one call: on the card
where there is one (on the CPU in the tests).  Every operation of the
reference is deterministic, so every checkout makes the same bits on the
same device; the pile is kept under ``portbench/.cache/pile/`` by
configuration, seed and device, and a later run of the seed reads it
back.  The card's memory that the making used is given back and its peak
counter set back to zero afterwards, so that a run's peak is the
program's.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from portbench import harness

KEYS = ("pos", "vel", "radius", "restitution")


def make_scene(cfg: dict) -> dict:
    s = cfg["scene"]
    return {"box_lo": tuple(float(x) for x in s["box_lo"]),
            "box_hi": tuple(float(x) for x in s["box_hi"])}


def drop(cfg: dict, seed: int) -> dict:
    """The seed's drop as host arrays (``pos``/``vel`` f32[3, n],
    ``radius``/``restitution`` f32[n])."""
    sim, n = cfg["sim"], cfg["particles"]["n"]
    r = sim["particle_radius"]
    lo, hi = np.asarray(cfg["scene"]["box_lo"]), np.asarray(cfg["scene"]["box_hi"])
    rng = np.random.default_rng(seed % (1 << 63))
    pos = np.stack([
        rng.uniform(lo[0] + r, hi[0] - r, n),
        rng.uniform((lo[1] + hi[1]) / 2, hi[1] - r, n),
        rng.uniform(lo[2] + r, hi[2] - r, n),
    ]).astype(np.float32)
    vel = (rng.normal(size=(3, n)) * cfg["particles"]["speed_sigma"]).astype(np.float32)
    return {"pos": pos, "vel": vel, "radius": np.full(n, r, dtype=np.float32),
            "restitution": np.full(n, sim["bounciness"], dtype=np.float32)}


def _cache_path(cfg: dict, seed: int, device: torch.device) -> str:
    what = {k: cfg[k] for k in ("scene", "sim", "particles")}
    what.update(seed=seed, device=device.type, reference=cfg["reference"])
    key = hashlib.sha256(json.dumps(what, sort_keys=True).encode()).hexdigest()[:24]
    return os.path.join(harness.CACHE, "pile", f"{cfg['name']}-{seed}-{key}.npz")


def make_spawn(cfg: dict, seed: int) -> dict:
    """The step-``pile_step`` pile of the seed's drop (host arrays, with
    ``n_real``), from the cache or made now."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    path = _cache_path(cfg, seed, dev)
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
    del ref, got
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **pile)
    os.replace(tmp, path)
    harness.log(f"[portbench] pile of seed {seed}: {cfg['particles']['pile_step']} "
                f"reference steps on {dev.type} in {time.perf_counter() - t0:.3f} s")
    return {**pile, "n_real": n}
