"""Headline benchmark (port of the JAX package's root ``bench.py``):
particle-steps per second of the spatial (grid) method at 1,048,576
particles, and the settled-phase ms/step beside it.

    python -m particlesystemhybridcollisiondetection_tpu_torch.bench.headline
    python -m particlesystemhybridcollisiondetection_tpu_torch.bench.headline \\
        --device cpu --scene sample --layers-y 1 --steps 48 \\
        --settled-pre 40 --settled-steps 7

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
and its context on stderr (particles, steps, ms/step, steps/s, device,
wall time, the settled-phase ms/step and, on CUDA, the card's name and
power limit from ``nvidia-smi``).

The default scene is DragonScene (the procedural stand-in for
``dragon.fbx``): ``bench.py`` runs the bunny, whose FBX is not shipped;
``--scene bunny`` reads it and raises ``FileNotFoundError`` without it.
``vs_baseline`` is the value over the real-time rate, 1,000,000
particles at 60 steps a second.  Eager PyTorch compiles nothing per
process, so there is no compile cache to enable.

The settled-phase probe is part of the measurement: if it fails, the
command fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from particlesystemhybridcollisiondetection_tpu_torch.bench.harness import (
    EpisodeResult,
    run_episode,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    resolve_device,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_sorted_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

#: real time: 1,000,000 particles at 60 steps a second
BASELINE_PARTICLE_STEPS_PER_SEC = 1_000_000 * 60.0
#: 128^2 x 64 layers, the count the metric names "1M"
HEADLINE_PARTICLES = 1_048_576
#: the episode's timing: chunks of 50 steps after one untimed step
CHUNK = 50
WARMUP_STEPS = 1
#: the scene's cameras are built at bench.py's size (the spatial method
#: bakes none)
WIDTH, HEIGHT = 480, 270
#: the settled probe's runner: window 2048 absorbs the pile's drift, a
#: re-sort every 12 steps
SETTLED_WINDOW = 2048
SETTLED_RESORT_EVERY = 12
SCENE_NAMES = ("dragon", "bunny", "sample", "sphere")


def headline(scene, *, layers_y: int = 64, num_steps: int = 151,
             device="cuda") -> EpisodeResult:
    """The headline episode: the spatial method from spawn on the sorted
    runner (on every device, so the CPU runs the card's path), plan
    "kernel", overflow-triggered re-sort, ``num_steps - WARMUP_STEPS``
    timed steps in chunks of ``CHUNK``."""
    return run_episode(
        scene, "spatial", layers_y=layers_y, num_steps=num_steps, chunk=CHUNK,
        warmup_steps=WARMUP_STEPS, persistent=True, plan="kernel",
        resort_every="auto", device=device)


def settled_state(scene, *, layers_y: int = 64, pre_steps: int = 620,
                  device="cuda"):
    """The settled probe's runner and its state ``pre_steps`` steps from
    spawn (through impact into the pile); both synchronized."""
    runner = make_sorted_episode_runner(
        scene.triangles, scene.config, resort_every=SETTLED_RESORT_EVERY,
        window=SETTLED_WINDOW, device=device)
    state = runner(spawn_grid(scene.config, layers_y=layers_y, device=device),
                   pre_steps)
    fence(state.pos)
    return runner, state


def settled_probe(scene, *, layers_y: int = 64, pre_steps: int = 620,
                  timed_steps: int = 100, device="cuda") -> float:
    """ms/step of ``timed_steps`` steps of the settled pile, after
    ``pre_steps`` from spawn: the host clock around one fenced call."""
    runner, state = settled_state(scene, layers_y=layers_y, pre_steps=pre_steps,
                                  device=device)
    t0 = time.perf_counter()
    state = runner(state, timed_steps)
    fence(state.pos)
    return (time.perf_counter() - t0) * 1000.0 / timed_steps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def result_line(scene_name: str, particle_steps_per_sec: float,
                num_particles: int) -> dict:
    """The JSON line's four keys."""
    size = "1M" if num_particles == HEADLINE_PARTICLES else str(num_particles)
    value = round(particle_steps_per_sec, 1)
    return {
        "metric": f"particle_steps_per_sec_spatial_{scene_name}_{size}",
        "value": value,
        "unit": "particle-steps/s",
        "vs_baseline": round(value / BASELINE_PARTICLE_STEPS_PER_SEC, 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m particlesystemhybridcollisiondetection_tpu_torch.bench.headline",
        description="Headline benchmark: particle-steps/s of the spatial method.")
    ap.add_argument("--scene", default="dragon", choices=SCENE_NAMES,
                    help="bunny needs its FBX (PSYS_REFERENCE_MESH_DIR)")
    ap.add_argument("--layers-y", type=int, default=64,
                    help="spawn layers: 128^2 x 64 = 1,048,576 particles")
    ap.add_argument("--steps", type=int, default=151,
                    help="episode steps, the first one untimed")
    ap.add_argument("--settled-pre", type=int, default=620,
                    help="settled probe: steps from spawn before timing")
    ap.add_argument("--settled-steps", type=int, default=100,
                    help="settled probe: timed steps")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without CUDA) "
                    "or cpu (the plain PyTorch paths)")
    args = ap.parse_args(argv)

    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import SCENES

    dev = resolve_device(args.device)
    scene = SCENES[args.scene](width=WIDTH, height=HEIGHT)
    if dev.type == "cuda":
        print(f"[bench] card: {card_line()}", file=sys.stderr)
    t0 = time.time()
    res = headline(scene, layers_y=args.layers_y, num_steps=args.steps,
                   device=dev)
    elapsed = time.time() - t0
    print(
        f"[bench] {res.num_particles} particles, {res.num_steps} steps, "
        f"{res.mean_ms:.3f} ms/step, {res.steps_per_sec:.1f} steps/s, "
        f"device={dev.type}, wall={elapsed:.1f}s",
        file=sys.stderr,
    )
    # the settled regime (particles piled on the mesh) is the slowest
    # phase: reported beside the headline, which times steps from spawn
    settled_ms = settled_probe(scene, layers_y=args.layers_y,
                               pre_steps=args.settled_pre,
                               timed_steps=args.settled_steps, device=dev)
    print(f"[bench] settled-phase: {settled_ms:.3f} ms/step", file=sys.stderr)
    print(json.dumps(result_line(args.scene, res.particle_steps_per_sec,
                                 res.num_particles)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
