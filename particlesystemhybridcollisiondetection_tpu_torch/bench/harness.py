"""Benchmark harness (port of the JAX package's ``bench/harness.py``).

Replicates the reference's BenchmarkManager sweep (BenchmarkManager.cs:76-186):
for each run x collision method x camera, roll one episode, recording
per-step timings and per-particle collision counts, and write CSVs in the
reference's format (``results_perf_<scene>_<N>.csv`` with ``step;ms``
rows, ``results_acc_...`` with per-particle counts, :193-271), plus the
JAX package's JSON summary and per-(method, camera, N) aggregates.

``run_episode`` runs spatial and hybrid on the persistent sorted runner
when the device is CUDA, otherwise (or with ``per_step_timing``) one
``make_method_step`` step at a time.  Timing is wall-clock around chunks
of steps (or single steps) closed by a device synchronize
(``utils.profiling.fence``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.config import Method
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    active_mask,
    resolve_device,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_method_step,
    make_sorted_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

METHOD_NAMES = dict(zip([m.value for m in Method], Method.display_names()))


@dataclasses.dataclass
class EpisodeResult:
    method: str
    camera: str
    num_particles: int
    num_steps: int
    step_ms: list  # per-step (per-chunk-averaged) milliseconds
    collisions: np.ndarray  # per-particle totals
    steps_per_sec: float
    run: int = 0  # repeat-run index within a run_benchmark sweep

    @property
    def particle_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.num_particles

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.step_ms)) if self.step_ms else 0.0


class PlanChooser:
    """Chunk-level autotuner over interchangeable execution plans.

    First times every candidate once, then keeps the current winner and
    re-probes the least recently sampled loser every 8 chunks while the
    plans are within 1.3x, every 32 when one is far ahead.  ``pick()``
    then ``record(name, ms)`` per chunk.
    """

    CLOSE_RATIO = 1.3
    PROBE_CLOSE = 8
    PROBE_FAR = 32

    def __init__(self, names: list):
        self.names = list(names)
        self.best = self.names[0]
        self.last_ms: dict = {}
        self.last_sample_i: dict = {}
        self.chunk_i = 0
        self.next_probe = 0

    def pick(self) -> str:
        unsampled = [x for x in self.names if x not in self.last_ms]
        if unsampled:
            return unsampled[0]
        if len(self.names) > 1 and self.chunk_i >= self.next_probe:
            ratio = max(self.last_ms.values()) / max(
                min(self.last_ms.values()), 1e-9
            )
            self.next_probe = self.chunk_i + (
                self.PROBE_CLOSE if ratio < self.CLOSE_RATIO else self.PROBE_FAR
            )
            losers = [x for x in self.names if x != self.best]
            return min(losers, key=lambda x: self.last_sample_i.get(x, -1))
        return self.best

    def record(self, name: str, ms: float) -> None:
        self.last_ms[name] = ms
        self.last_sample_i[name] = self.chunk_i
        if len(self.last_ms) == len(self.names):
            self.best = min(self.last_ms, key=self.last_ms.get)
        self.chunk_i += 1


def run_episode(
    scene,
    method: str,
    camera_index: int = 0,
    layers_y: int = 1,
    num_steps: Optional[int] = None,
    chunk: int = 50,
    per_step_timing: bool = False,
    warmup_steps: int = 1,
    persistent: Optional[bool] = None,
    resort_every: "int | str" = 8,
    plan: str = "adaptive",
    device="cuda",
) -> EpisodeResult:
    """Roll + time one episode of ``method``.

    ``persistent``: run spatial and hybrid on the persistent sorted runner
    (hybrid with ``scene.cameras[camera_index]`` and the scene's corner
    normals).  Default (None): on for spatial and hybrid when the device
    is CUDA, off elsewhere.  Off, and always with ``per_step_timing``,
    the episode steps ``make_method_step`` once per step.

    ``per_step_timing``: one device synchronize and one time per step
    (exact CSV parity with the reference's per-frame times); otherwise
    chunks of ``chunk`` steps share their mean.

    ``plan``: the (start, count) lookup plan.  On the runner "adaptive"
    builds the cells-kernel plan and the gather plan and keeps the faster
    per chunk (PlanChooser); per step it is the step-level "auto".
    "kernel" / "gather" / "auto" pin one plan (pinned runs are
    run-to-run deterministic).  The screen-space method has no plan.
    """
    method = Method(method)
    dev = resolve_device(device)
    if persistent is None:
        persistent = (method in (Method.SPATIAL, Method.HYBRID)
                      and dev.type == "cuda")
    if (persistent and method in (Method.SPATIAL, Method.HYBRID)
            and not per_step_timing):
        return _run_episode_persistent(
            scene, method, camera_index, layers_y, num_steps, chunk,
            warmup_steps, resort_every, plan, dev)
    cfg = scene.config
    steps = num_steps if num_steps is not None else cfg.lifetime_steps
    step = make_method_step(
        scene, method, camera_index,
        cells_lookup="auto" if plan == "adaptive" else plan, device=dev)
    state = spawn_grid(cfg, layers_y=layers_y, device=dev)
    mask = active_mask(state).cpu().numpy()

    # warm-up outside the timed region (first kernel builds and launches;
    # the reference skips step 0's time for the same reason,
    # ParticleSys.cs:457)
    for _ in range(warmup_steps):
        state = step(state)
    fence(state.pos)

    step_ms: list[float] = []
    timed_steps = steps - warmup_steps
    if per_step_timing:
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            state = step(state)
            fence(state.pos)
            step_ms.append((time.perf_counter() - t0) * 1000.0)
        total_s = sum(step_ms) / 1000.0
    else:
        done = 0
        t_start = time.perf_counter()
        while done < timed_steps:
            n = min(chunk, timed_steps - done)
            t0 = time.perf_counter()
            state = _repeat(step, state, n)
            fence(state.pos)
            ms = (time.perf_counter() - t0) * 1000.0 / n
            step_ms.extend([ms] * n)
            done += n
        total_s = time.perf_counter() - t_start
    return _result(scene, method, camera_index, state, mask, timed_steps,
                   step_ms, total_s)


def _result(scene, method, camera_index, state, mask, timed_steps, step_ms,
            total_s) -> EpisodeResult:
    return EpisodeResult(
        method=method.value,
        camera=scene.cameras[camera_index].name if scene.cameras else "none",
        num_particles=int(mask.sum()),
        num_steps=timed_steps,
        step_ms=step_ms,
        collisions=state.collisions.cpu().numpy()[mask],
        steps_per_sec=timed_steps / max(total_s, 1e-12),
    )


def _run_episode_persistent(scene, method, camera_index, layers_y, num_steps,
                            chunk, warmup_steps, resort_every, plan,
                            dev) -> EpisodeResult:
    """Spatial and hybrid on the persistent sorted runner, timed per
    chunk; "adaptive" probes the kernel and gather plans per chunk."""
    cfg = scene.config
    steps = num_steps if num_steps is not None else cfg.lifetime_steps
    hybrid = method == Method.HYBRID
    mk = dict(
        resort_every=resort_every, device=dev,
        camera=scene.cameras[camera_index] if hybrid else None,
        normals=getattr(scene, "corner_normals", None) if hybrid else None,
    )
    if plan != "adaptive":
        runners = {plan: make_sorted_episode_runner(
            scene.triangles, cfg, cells_lookup=plan, **mk)}
    else:
        runners = {"gather": make_sorted_episode_runner(
            scene.triangles, cfg, cells_lookup="gather", **mk)}
        try:
            runners["kernel"] = make_sorted_episode_runner(
                scene.triangles, cfg, cells_lookup="kernel", **mk)
        except ValueError:  # grid too large for the code table
            pass
    state = spawn_grid(cfg, layers_y=layers_y, device=dev)
    mask = active_mask(state).cpu().numpy()

    # warm every runner outside the timed region (first kernel builds
    # and launches), then advance the episode's warmup steps
    for r in runners.values():
        fence(r(state, 2).pos)
    state = runners[next(iter(runners))](state, max(warmup_steps, 1))
    fence(state.pos)

    step_ms: list[float] = []
    timed_steps = steps - warmup_steps
    done = 0
    chooser = PlanChooser(list(runners))
    t_start = time.perf_counter()
    while done < timed_steps:
        n = min(chunk, timed_steps - done)
        pick = chooser.pick()
        t0 = time.perf_counter()
        state = runners[pick](state, n)
        fence(state.pos)
        ms = (time.perf_counter() - t0) * 1000.0 / n
        chooser.record(pick, ms)
        step_ms.extend([ms] * n)
        done += n
    total_s = time.perf_counter() - t_start
    return _result(scene, method, camera_index, state, mask, timed_steps,
                   step_ms, total_s)


def run_benchmark(
    scene,
    methods: Sequence[str] = ("screen_space", "spatial", "hybrid"),
    camera_indices: Optional[Sequence[int]] = None,
    layers_y: int = 1,
    num_steps: Optional[int] = None,
    num_runs: int = 1,
    out_dir: Optional[str] = None,
    per_step_timing: bool = False,
    accuracy: bool = False,
    spatial_all_cameras: bool = False,
    plan: str = "adaptive",
    run_offset: int = 0,
    device="cuda",
) -> list[EpisodeResult]:
    """The full sweep: runs x methods x cameras (BenchmarkManager.cs:76-127).

    With ``out_dir``, writes the reference's CSV formats plus the JSON
    summary and aggregates.  ``run_offset``: first run index (extending
    a sweep keeps run identities).  The spatial method never reads the
    camera, so by default it runs on the first camera only
    (``cameras_deduped`` in the summary); ``spatial_all_cameras=True``
    times it on every camera, as the reference does.
    """
    dev = resolve_device(device)
    cameras = (
        list(camera_indices)
        if camera_indices is not None
        else list(range(len(scene.cameras)))
    )
    results = []
    for run in range(run_offset, run_offset + num_runs):
        per_method: dict[str, list[EpisodeResult]] = {}
        for method in methods:
            dedup = Method(method) == Method.SPATIAL and not spatial_all_cameras
            for cam in cameras[:1] if dedup else cameras:
                r = run_episode(
                    scene, method, camera_index=cam, layers_y=layers_y,
                    num_steps=num_steps, per_step_timing=per_step_timing,
                    plan=plan, device=dev,
                )
                r.run = run
                results.append(r)
                per_method.setdefault(method, []).append(r)
        if out_dir:
            _write_csvs(scene, per_method, layers_y, out_dir,
                        append=run != run_offset, accuracy=accuracy)
    if out_dir:
        _write_summary(scene, results, layers_y, out_dir,
                       spatial_all_cameras=spatial_all_cameras)
    return results


def _write_csvs(scene, per_method, layers_y, out_dir, append, accuracy):
    """The reference's CSVs: a ``<method display name>;ms`` header per
    method, then ``step;ms`` rows (``;collisions`` and one row per
    particle for the accuracy file)."""
    os.makedirs(out_dir, exist_ok=True)
    n = next(iter(per_method.values()))[0].num_particles
    mode = "a" if append else "w"
    perf_path = os.path.join(out_dir, f"results_perf_{scene.name}_{n}.csv")
    with open(perf_path, mode) as f:
        for method, runs in per_method.items():
            f.write(f"{METHOD_NAMES[method]};ms\n")
            for r in runs:
                f.write("".join(f"{i};{ms}\n" for i, ms in enumerate(r.step_ms)))
    if accuracy:
        acc_path = os.path.join(out_dir, f"results_acc_{scene.name}_{n}.csv")
        with open(acc_path, mode) as f:
            for method, runs in per_method.items():
                f.write(f"{METHOD_NAMES[method]};collisions\n")
                for r in runs:
                    f.write("".join(
                        f"{i};{c}\n" for i, c in enumerate(r.collisions)))


def _write_summary(scene, results, layers_y, out_dir,
                   spatial_all_cameras: bool = False):
    """``summary_<scene>.json``: one row per episode, merged with an
    existing file (fresh rows replace rows of the same method, camera, N
    and run), then flagged and aggregated."""
    os.makedirs(out_dir, exist_ok=True)
    summary = [
        {
            "scene": scene.name,
            "method": r.method,
            "camera": r.camera,
            "run": r.run,
            "num_particles": r.num_particles,
            "num_steps": r.num_steps,
            "mean_ms_per_step": r.mean_ms,
            "steps_per_sec": r.steps_per_sec,
            "particle_steps_per_sec": r.particle_steps_per_sec,
            "total_collisions": int(r.collisions.sum()),
            "cameras_deduped": (
                Method(r.method) == Method.SPATIAL and not spatial_all_cameras
            ),
        }
        for r in results
    ]
    path = os.path.join(out_dir, f"summary_{scene.name}.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
        except (json.JSONDecodeError, OSError):
            old = []

        def _key(s):
            return (s["method"], s["camera"], s["num_particles"],
                    s.get("run", 0))

        fresh = {_key(s) for s in summary}
        summary += [s for s in old if _key(s) not in fresh]
    _flag_transport_noise(summary)
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    _write_aggregates(scene, summary, out_dir)


def _flag_transport_noise(summary) -> None:
    """Mark episodes whose mean step time is a gross outlier among their
    duplicates (same method, camera and N across runs): above 3x the
    minimum of a pair (the median of two contains the outlier), or 3x
    the median of three or more.  The raw number is kept; downstream
    means can exclude it."""
    groups: dict = {}
    for s in summary:
        groups.setdefault(
            (s["method"], s["camera"], s["num_particles"]), []
        ).append(s)
    for rows in groups.values():
        ms = [r["mean_ms_per_step"] for r in rows]
        ref = float(np.min(ms)) if len(ms) == 2 else float(np.median(ms))
        for r in rows:
            r["suspect_transport_noise"] = bool(
                len(rows) >= 2 and ref > 0 and r["mean_ms_per_step"] > 3.0 * ref
            )


def _write_aggregates(scene, summary, out_dir) -> None:
    """``aggregate_<scene>.json``: per (method, camera, N) across repeat
    runs, the run count and mean/std/min/max of the per-episode mean step
    time; flagged rows are excluded from the moments but counted.  Rows
    carry ``k``/``particles`` and ``scene``/``num_particles``, as the JAX
    package writes them."""
    base = scene.config.num_particles_xz ** 2
    groups: dict = {}
    for s in summary:
        groups.setdefault(
            (s["method"], s["camera"], s["num_particles"]), []
        ).append(s)
    agg = []
    for (method, camera, n), rows in sorted(groups.items()):
        clean = [r["mean_ms_per_step"] for r in rows
                 if not r.get("suspect_transport_noise")]
        ms = clean or [r["mean_ms_per_step"] for r in rows]
        agg.append({
            "scene": scene.name,
            # n = base * 2^k except at the 2,097,120 reference cap
            # (ParticleSys.cs:236), where rounding recovers k
            "k": int(round(math.log2(max(n, 1) / base))),
            "method": method,
            "camera": camera,
            "particles": n,
            "num_particles": n,
            "runs": len(rows),
            "runs_quarantined": len(rows) - len(clean),
            "mean_ms_mean": round(float(np.mean(ms)), 3),
            "mean_ms_std": (round(float(np.std(ms, ddof=1)), 3)
                            if len(ms) > 1 else 0.0),
            "mean_ms_min": round(float(np.min(ms)), 3),
            "mean_ms_max": round(float(np.max(ms)), 3),
            "cameras_deduped": bool(rows[0].get("cameras_deduped")),
        })
    with open(os.path.join(out_dir, f"aggregate_{scene.name}.json"), "w") as f:
        json.dump(agg, f, indent=2)


def _repeat(step, state, n: int):
    for _ in range(n):
        state = step(state)
    return state
