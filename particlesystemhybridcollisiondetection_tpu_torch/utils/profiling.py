"""Timing and tracing instrumentation (port of the JAX package's
``utils/profiling.py``).

  * ``fence``: wait for the device (``torch.cuda.synchronize``).
  * ``Stopwatch``: host timer with named laps (build phases; a runner's
    set-up laps).
  * ``DeviceTimer``: first-call and steady-state ms/call of a callable,
    by CUDA events on the card and the host clock on the CPU.
  * ``trace``: ``torch.profiler`` around a block, written as a Chrome trace.
  * ``StepTimeseries``: per-step ms with the reference's skip-first rule.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def fence(tree) -> None:
    """Wait until the device has finished every queued kernel: a tensor,
    or a (named) tuple, list or dict of them.  CUDA tensors synchronize
    their device; on the CPU PyTorch runs synchronously."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Stopwatch:
    """Named-lap host timer (the BVH-build Stopwatch analog)."""

    def __init__(self) -> None:
        self.laps: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t0 = now
        return dt

    def restart(self) -> None:
        """Start the next lap now (the time since the last lap is dropped)."""
        self._t0 = time.perf_counter()

    def report(self) -> str:
        total = sum(self.laps.values())
        lines = [f"{k}: {v * 1000:.1f} ms" for k, v in self.laps.items()]
        lines.append(f"total: {total * 1000:.1f} ms")
        return "\n".join(lines)


def _on_cuda(tree) -> bool:
    return any(t.device.type == "cuda" for t in _tensors(tree))


class DeviceTimer:
    """Time a callable: ``compile_s`` is the first call (kernel builds
    and first launches included), ``mean_ms`` the steady state over
    ``reps`` calls, by CUDA events when the arguments are on the card."""

    def __init__(self, fn: Callable, *args, reps: int = 20, warmup: int = 2):
        t0 = time.perf_counter()
        out = fn(*args)
        fence(out)
        self.compile_s = time.perf_counter() - t0
        for _ in range(warmup - 1):
            out = fn(*args)
        fence(out)
        if _on_cuda(args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = fn(*args)
            end.record()
            end.synchronize()
            self.mean_ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            fence(out)
            self.mean_ms = (time.perf_counter() - t0) / reps * 1000.0
        self.last_output = out


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` around the block (CPU, and CUDA when present);
    writes ``trace.json`` (Chrome trace format) into ``log_dir``, by
    default ``psys_trace`` under the temporary directory.  Yields the
    directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "psys_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimeseries:
    """Per-step ms series with the reference's skip-first semantics
    (ParticleSys.cs:457: step 0 is never recorded)."""

    def __init__(self) -> None:
        self.ms: list[float] = []
        self._skip_done = False

    def record(self, dt_s: float) -> None:
        if not self._skip_done:
            self._skip_done = True
            return
        self.ms.append(dt_s * 1000.0)

    def summary(self) -> dict:
        a = np.asarray(self.ms) if self.ms else np.zeros(1)
        return {
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "steps": len(self.ms),
        }
