"""Command-line interface: the headless analog of the reference's UI (port
of the JAX package's ``cli.py``, same subcommands and flags, plus
``--device``).

The reference is driven by Unity UI (BenchmarkManager.cs:146-191: run
button -> StartBenchmark, scrollbar -> particle count 128^2 * 2^k, quit
button) plus keyboard modes.  Subcommands:

  bench     the BenchmarkManager sweep (methods x cameras x runs -> CSVs)
  simulate  run one episode; optional npz checkpoints + PNG frames
  accviz    accuracy visualization snapshots (ACCURACY_VISUALIZATION mode)
  gridviz   broad-phase occupancy report (BVH-visualization analog)
  p2pbox    gravity-box particle-particle demo (benchmark configs 1/2)
  config    a benchmark configuration of ``bench/configs.py`` by number

Run as ``python -m particlesystemhybridcollisiondetection_tpu_torch <cmd>
...``.  Every subcommand runs on ``--device`` (default ``cuda``, which
raises when CUDA is absent; ``cpu`` runs the plain PyTorch paths).

The JAX package's CLI first enables a persistent XLA compile cache
(``utils/compile_cache.py``).  The port has no counterpart: eager
PyTorch compiles nothing per process, and the CUDA kernels are built
once into ``build/torch_kernels/`` and reused from there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without CUDA) "
                        "or cpu (the plain PyTorch paths)")


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="bunny",
                   choices=["sample", "bunny", "dragon", "dragons", "sphere"])
    p.add_argument("--layers", type=int, default=1,
                   help="Y layers: particles = num_xz^2 * layers "
                        "(the scrollbar's 2^k, BenchmarkManager.cs:280-283)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    _add_device_arg(p)


def _get_scene(args):
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import SCENES

    return SCENES[args.scene](width=args.width, height=args.height)


def cmd_bench(args) -> int:
    from particlesystemhybridcollisiondetection_tpu_torch.bench.harness import (
        run_benchmark,
    )

    scene = _get_scene(args)
    results = run_benchmark(
        scene,
        methods=args.methods.split(","),
        camera_indices=[int(c) for c in args.cameras.split(",")] if args.cameras else None,
        layers_y=args.layers,
        num_steps=args.steps,
        num_runs=args.runs,
        out_dir=args.out,
        per_step_timing=args.per_step,
        accuracy=args.accuracy,
        device=args.device,
    )
    for r in results:
        print(
            f"{r.method:14s} {r.camera:18s} N={r.num_particles:8d} "
            f"{r.mean_ms:8.3f} ms/step  {r.particle_steps_per_sec:.3e} pstep/s "
            f"collisions={int(r.collisions.sum())}"
        )
    return 0


def cmd_simulate(args) -> int:
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
        active_mask, spawn_grid,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
        make_episode_runner, make_method_step,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.io import (
        save_state, write_png,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    scene = _get_scene(args)
    step = make_method_step(scene, args.method, args.camera, device=args.device)
    state = spawn_grid(scene.config, layers_y=args.layers, device=args.device)
    mask = active_mask(state).cpu().numpy()
    steps = args.steps or scene.config.lifetime_steps
    chunk = max(1, steps // max(args.frames, 1)) if args.frames else steps
    runner = make_episode_runner(step, chunk)
    if args.frames or args.checkpoint:
        os.makedirs(args.out, exist_ok=True)
    done = 0
    frame = 0
    while done < steps:
        state = runner(state)
        fence(state.pos)
        done += chunk
        if args.frames:
            from particlesystemhybridcollisiondetection_tpu_torch.viz.render import (
                collision_colormap, render_state,
            )

            cam = scene.cameras[args.camera]
            img = render_state(
                scene.triangles,
                state.pos.cpu().numpy()[:, mask].T,
                state.radius.cpu().numpy()[mask],
                cam,
                collision_colormap(state.collisions.cpu().numpy()[mask]),
            )
            write_png(f"{args.out}/frame_{frame:04d}.png", img)
            frame += 1
        if args.checkpoint:
            save_state(f"{args.out}/state_{done:06d}.npz", state)
    ys = state.pos[1].cpu().numpy()[mask]
    print(
        f"{args.method} on {scene.name}: {done} steps, "
        f"y in [{ys.min():.2f}, {ys.max():.2f}], "
        f"collisions {int(state.collisions.cpu().numpy()[mask].sum())}"
    )
    return 0


def cmd_accviz(args) -> int:
    from particlesystemhybridcollisiondetection_tpu_torch.viz.accuracy import (
        run_accuracy_visualization,
    )

    scene = _get_scene(args)
    paths = run_accuracy_visualization(
        scene,
        methods=args.methods.split(","),
        steps_to_visualize=[int(s) for s in args.snap.split(",")],
        layers_y=args.layers,
        out_dir=args.out,
        device=args.device,
    )
    print("\n".join(paths))
    return 0


def cmd_gridviz(args) -> int:
    from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import (
        build_triangle_grid,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.viz.grid_viz import (
        write_grid_report,
    )

    scene = _get_scene(args)
    grid, meta = build_triangle_grid(scene.triangles, scene.config.grid,
                                     device=args.device)
    paths = write_grid_report(grid, meta, args.out, name=scene.name)
    print("\n".join(paths))
    return 0


def cmd_p2pbox(args) -> int:
    import torch

    from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
        ParticleState, resolve_device,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.core.step import make_p2p_step
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    n = args.particles
    side = float(np.ceil((n * 8.0) ** (1 / 3)))  # roomy box
    box_lo, box_hi = (0.0, 0.0, 0.0), (side, side * 1.5, side)
    r = args.radius
    # the arrays are drawn in NumPy in the JAX package's order, then moved
    pos = np.stack(
        [
            rng.uniform(r, side - r, n),
            rng.uniform(side * 0.5, side * 1.5 - r, n),
            rng.uniform(r, side - r, n),
        ]
    ).astype(np.float32)
    vel = (rng.normal(size=(3, n)) * 0.5).astype(np.float32)
    radius = (rng.uniform(r * 0.7, r * 1.3, n).astype(np.float32)
              if args.hetero else np.full(n, r, dtype=np.float32))
    state = ParticleState(
        pos=torch.from_numpy(pos).to(dev),
        vel=torch.from_numpy(vel).to(dev),
        collisions=torch.zeros((n,), dtype=torch.int32, device=dev),
        radius=torch.from_numpy(radius).to(dev),
        restitution=torch.full((n,), args.restitution, dtype=torch.float32,
                               device=dev),
    )
    cfg = SimConfig(particle_radius=r, dt=args.dt, bounciness=args.restitution)
    # --hetero spawns radii up to 1.3*r; the stencil needs
    # cell_size >= 2 * max radius
    step = make_p2p_step(box_lo, box_hi, cfg, capacity=args.capacity,
                         max_radius=float(radius.max()), device=dev)
    state = step(state)
    fence(state.pos)
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        for _ in range(50):
            state = step(state)
        fence(state.pos)
        done += 50
    dt_s = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "particles": n,
                "steps": done,
                "ms_per_step": dt_s / done * 1000,
                "particle_steps_per_sec": n * done / dt_s,
                "contacts": int(state.collisions.sum()),
            }
        )
    )
    return 0


def cmd_config(args) -> int:
    from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import CONFIGS

    kwargs = {"device": args.device}
    if args.steps is not None:
        kwargs["steps"] = args.steps
    if args.particles is not None and args.id in (1, 2, 4, 5):
        kwargs["n"] = args.particles
    print(json.dumps(CONFIGS[args.id](**kwargs)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="particlesystemhybridcollisiondetection_tpu_torch"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench", help="BenchmarkManager sweep")
    _add_scene_args(b)
    b.add_argument("--methods", default="screen_space,spatial,hybrid")
    b.add_argument("--cameras", default=None, help="comma camera indices")
    b.add_argument("--steps", type=int, default=None)
    b.add_argument("--runs", type=int, default=1)
    b.add_argument("--out", default=None)
    b.add_argument("--per-step", action="store_true")
    b.add_argument("--accuracy", action="store_true")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("simulate", help="run one episode")
    _add_scene_args(s)
    s.add_argument("--method", default="hybrid",
                   choices=["screen_space", "spatial", "hybrid"])
    s.add_argument("--camera", type=int, default=0)
    s.add_argument("--steps", type=int, default=None)
    s.add_argument("--frames", type=int, default=0, help="PNG frames to render")
    s.add_argument("--checkpoint", action="store_true")
    s.add_argument("--out", default="out")
    s.set_defaults(fn=cmd_simulate)

    a = sub.add_parser("accviz", help="accuracy visualization snapshots")
    _add_scene_args(a)
    a.add_argument("--methods", default="screen_space,spatial,hybrid")
    a.add_argument("--snap", default="1600")
    a.add_argument("--out", default="BenchmarkResults")
    a.set_defaults(fn=cmd_accviz)

    g = sub.add_parser("gridviz", help="broad-phase occupancy report")
    _add_scene_args(g)
    g.add_argument("--out", default="BenchmarkResults")
    g.set_defaults(fn=cmd_gridviz)

    c = sub.add_parser("config", help="run a benchmark config (1-5)")
    c.add_argument("--id", type=int, required=True, choices=[1, 2, 3, 4, 5])
    c.add_argument("--steps", type=int, default=None)
    c.add_argument("--particles", type=int, default=None)
    _add_device_arg(c)
    c.set_defaults(fn=cmd_config)

    p = sub.add_parser("p2pbox", help="gravity-box particle-particle demo")
    p.add_argument("--particles", type=int, default=2048)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--radius", type=float, default=0.4)
    p.add_argument("--restitution", type=float, default=0.3)
    p.add_argument("--dt", type=float, default=0.005)
    p.add_argument("--capacity", type=int, default=12)
    p.add_argument("--hetero", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_p2pbox)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
