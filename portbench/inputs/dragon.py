"""The DragonScene cells' inputs: the frozen scene at the configuration's
sizes (``portbench/scene.py``) and the spawn of a seed
(``portbench/spawn.py``)."""

from portbench import scene, spawn


def make_scene(cfg: dict) -> dict:
    s = cfg["scene"]
    return scene.dragon_scene(s["width"], s["height"], tri_budget=s["tri_budget"])


def make_spawn(cfg: dict, seed: int) -> dict:
    p = cfg["particles"]
    return spawn.spawn(cfg["sim"], p["layers_y"], p["cap"], p["pad_multiple"],
                       p["jitter"], seed)
