"""Episode harness: roll and time one episode of any of the three
collision methods.

Port of ``run_episode`` / ``_run_episode_persistent`` of the JAX
package's ``bench/harness.py``: spatial and hybrid on the persistent
sorted runner, screen-space one ``make_method_step`` step at a time.  Timing is wall-clock around chunks of
steps closed by a device synchronize (``utils.profiling.fence``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from particlesystemhybridcollisiondetection_tpu_torch.config import Method
from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    active_mask,
    spawn_grid,
)
from particlesystemhybridcollisiondetection_tpu_torch.core.step import (
    make_method_step,
    make_sorted_episode_runner,
)
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence


@dataclasses.dataclass
class EpisodeResult:
    method: str
    camera: str
    num_particles: int
    num_steps: int
    step_ms: list  # per-step (per-chunk-averaged) milliseconds
    collisions: np.ndarray  # per-particle totals
    steps_per_sec: float

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
    warmup_steps: int = 1,
    resort_every: "int | str" = 8,
    plan: str = "adaptive",
    device="cuda",
) -> EpisodeResult:
    """Roll + time one episode of ``method``.

    "spatial" and "hybrid" run on the persistent sorted runner (hybrid
    with ``scene.cameras[camera_index]`` and the scene's corner normals);
    "screen_space" steps ``make_method_step`` once per step.

    ``plan``: the (start, count) lookup plan of the persistent runner.
    "adaptive" builds the cells-kernel plan and the gather plan and keeps
    the faster per chunk (PlanChooser); "kernel" / "gather" / "auto" pin
    one plan (pinned runs are run-to-run deterministic).  The
    screen-space method has no such plan.
    """
    method = Method(method)
    cfg = scene.config
    steps = num_steps if num_steps is not None else cfg.lifetime_steps
    camera = scene.cameras[camera_index] if scene.cameras else None
    state = spawn_grid(cfg, layers_y=layers_y, device=device)
    mask = active_mask(state).cpu().numpy()
    if method == Method.SCREEN_SPACE:
        step = make_method_step(scene, method, camera_index, device=device)
        runners = {"step": lambda s, n: _repeat(step, s, n)}
    else:
        hybrid = method == Method.HYBRID
        mk = dict(
            resort_every=resort_every, device=device,
            camera=camera if hybrid else None,
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

    return EpisodeResult(
        method=method.value,
        camera=camera.name if camera is not None else "none",
        num_particles=int(mask.sum()),
        num_steps=timed_steps,
        step_ms=step_ms,
        collisions=state.collisions.cpu().numpy()[mask],
        steps_per_sec=timed_steps / max(total_s, 1e-12),
    )


def _repeat(step, state, n: int):
    for _ in range(n):
        state = step(state)
    return state
