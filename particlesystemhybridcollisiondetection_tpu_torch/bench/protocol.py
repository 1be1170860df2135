"""The reference's full benchmark protocol (port of the JAX package's
``benchmarks/run_reference_protocol.py`` and ``benchmarks/merge_protocol.py``).

Reproduces the Unity harness (BenchmarkManager.cs + scene constants): for
each particle count 128^2 * 2^k (capped at 65535 * 32 = 2,097,120,
``config.REFERENCE_PARTICLE_CAP``), run ``runs x methods x cameras``
episodes of ``lifetime_steps`` steps through ``bench/harness.py::run_benchmark``,
which writes the reference's CSVs and the JSON summary and aggregates; the
per-episode rows of the whole sweep go to ``protocol_<scene>.json`` beside
them.

The full protocol (2001 steps x 4 cameras x 3 methods x 6 runs x 8
particle counts) is hours of wall-clock; ``--quick`` is a sanity-scale
pass (1 run, 300 steps, k in {0, 2}).  Run as

    python -m particlesystemhybridcollisiondetection_tpu_torch.bench.protocol --scene dragon --out results
    python -m particlesystemhybridcollisiondetection_tpu_torch.bench.protocol --quick --scene sample --device cpu

The flags are the JAX script's, plus ``--device`` (default ``cuda``, which
raises when CUDA is absent; ``cpu`` runs the plain PyTorch paths).  The
JAX script first enables a persistent XLA compile cache; eager PyTorch
compiles nothing per process, so this one does not.

``merge_rows`` merges freshly measured rows into a committed row list:
identity is ``(k, method, camera, run)``, fresh rows replace stale ones,
rows without ``run`` are numbered in file order, output sorted.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Optional, Sequence

from particlesystemhybridcollisiondetection_tpu_torch.bench.harness import (
    run_benchmark,
)

METHODS = ("screen_space", "spatial", "hybrid")


def run_protocol(
    scene,
    ks: Sequence[int],
    methods: Sequence[str] = METHODS,
    num_runs: int = 6,
    num_steps: Optional[int] = None,
    out_dir: str = "BenchmarkResults",
    accuracy: bool = True,
    plan: str = "adaptive",
    spatial_all_cameras: bool = False,
    run_offset: int = 0,
    camera_indices: Optional[Sequence[int]] = None,
    device="cuda",
) -> list[dict]:
    """The particle ladder: one ``run_benchmark`` sweep per k with
    ``layers_y = 2^k``.  Returns the per-episode rows (``k, method,
    camera, run, particles, mean_ms, particle_steps_per_sec,
    collisions``, in sweep order) and writes them to
    ``<out_dir>/protocol_<scene.name>.json``; each is also printed as a
    JSON line.  ``camera_indices`` (default: every camera of the scene)
    and the other arguments are ``run_benchmark``'s."""
    rows = []
    for k in ks:
        layers = 1 << k
        n = scene.config.num_particles_xz ** 2 * layers
        print(f"=== {scene.name}: 2^{k} layers = {n} particles ===", flush=True)
        results = run_benchmark(
            scene,
            methods=tuple(methods),
            camera_indices=camera_indices,
            layers_y=layers,
            num_steps=num_steps,
            num_runs=num_runs,
            out_dir=out_dir,
            accuracy=accuracy,
            spatial_all_cameras=spatial_all_cameras,
            plan=plan,
            run_offset=run_offset,
            device=device,
        )
        for r in results:
            line = {
                "k": k,
                "method": r.method,
                "camera": r.camera,
                "run": r.run,
                "particles": r.num_particles,
                "mean_ms": round(r.mean_ms, 3),
                "particle_steps_per_sec": round(r.particle_steps_per_sec, 1),
                "collisions": int(r.collisions.sum()),
            }
            rows.append(line)
            print(json.dumps(line), flush=True)
    # raw per-episode rows; the run-variance moments and the transport-noise
    # flags are in the harness's aggregate_<scene>.json / summary_<scene>.json
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"protocol_{scene.name}.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def merge_rows(base: list[dict], fresh: list[dict]) -> list[dict]:
    """Merge ``fresh`` protocol rows into ``base``: a row is identified by
    ``(k, method, camera, run)``, a fresh row replaces a base row of the
    same identity, every other row is kept, and the result is sorted by
    identity.  Rows without ``run`` (written before the field existed)
    are numbered in file order within each list, so duplicates do not
    collapse onto one key.  The inputs are not modified."""
    def numbered(rows):
        seen = collections.Counter()
        out = []
        for r in rows:
            r = dict(r)
            if "run" not in r:
                key = (r["k"], r["method"], r["camera"])
                r["run"] = seen[key]
                seen[key] += 1
            out.append(r)
        return out

    def key(r):
        return (r["k"], r["method"], r["camera"], r["run"])

    merged = {key(r): r for r in numbered(base)}
    for r in numbered(fresh):
        merged[key(r)] = r
    return [merged[k] for k in sorted(merged)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m particlesystemhybridcollisiondetection_tpu_torch.bench.protocol",
        description="The reference's full benchmark protocol (particle ladder).")
    ap.add_argument("--scene", default="bunny",
                    choices=["sample", "bunny", "dragon", "dragons", "sphere"])
    ap.add_argument("--out", default="BenchmarkResults")
    ap.add_argument("--runs", type=int, default=6, help="reference: 6 (DragonScene.unity:1894)")
    ap.add_argument("--run-offset", type=int, default=0,
                    help="first run index; extend a committed 2-run ladder "
                    "to 6 with --run-offset 2 --runs 4, then merge_rows")
    ap.add_argument("--steps", type=int, default=None, help="reference: lifetime_steps (2001)")
    ap.add_argument("--k-min", type=int, default=0,
                    help="particle sweep 128^2 * 2^k (BenchmarkManager.cs:280-283)")
    ap.add_argument("--k-max", type=int, default=7)
    ap.add_argument(
        "--accuracy", action=argparse.BooleanOptionalAction, default=True,
        help="write per-particle results_acc CSVs (totals go into the JSON "
        "summary regardless; --no-accuracy for large k: the CSV holds one "
        "row per particle, method and camera)")
    ap.add_argument("--quick", action="store_true", help="1 run, 300 steps, k in {0, 2}")
    ap.add_argument("--methods", default=",".join(METHODS),
                    help="comma-separated subset (e.g. re-measure one method; "
                    "merge rows into the main artifact afterwards)")
    ap.add_argument("--plan", default="adaptive",
                    help="cells-lookup execution plan: adaptive (default) | gather "
                    "| kernel | auto (pinned plans are deterministic run to run)")
    ap.add_argument("--spatial-all-cameras", action="store_true",
                    help="run the camera-independent spatial method on all "
                    "cameras (literal reference parity) instead of the first only")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without CUDA) "
                    "or cpu (the plain PyTorch paths)")
    args = ap.parse_args(argv)

    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import SCENES

    if args.quick:
        args.runs, args.steps = 1, 300
        ks = [0, 2]
    else:
        ks = list(range(args.k_min, args.k_max + 1))

    scene = SCENES[args.scene]()
    t0 = time.time()
    run_protocol(
        scene, ks, methods=args.methods.split(","), num_runs=args.runs,
        num_steps=args.steps, out_dir=args.out, accuracy=args.accuracy,
        plan=args.plan, spatial_all_cameras=args.spatial_all_cameras,
        run_offset=args.run_offset, device=args.device)
    print(f"total wall: {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
