"""Fault-tolerant episode execution (port of the JAX package's
``bench/resilient.py``).

The reference has no failure handling (a lost GPU kills the run).  This
runner snapshots the state to host memory every chunk and, on a device
failure, waits for the device to answer again, rebuilds the step,
restores the last snapshot onto the state's own device and continues.
Progress loss is bounded by the chunk size.

What counts as a device failure: ``torch.AcceleratorError`` (CUDA
errors such as a lost device or an illegal address), ``OSError`` and
``TimeoutError``.  Anything else, a bare ``RuntimeError`` from a shape
bug included, propagates.  Limit: an illegal address poisons the CUDA
context of the process, so a retry in the same process fails again and
ends in ``DeviceLost``; real recovery from that needs a fresh process.
Nothing is ever restored onto the CPU.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    restore,
    snapshot,
)
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

DEVICE_ERRORS = (torch.AcceleratorError, OSError, TimeoutError)


class DeviceLost(RuntimeError):
    pass


def _device_alive(device="cuda", timeout_s: float = 20.0) -> bool:
    """Liveness probe of ``device`` in a fresh interpreter with a hard
    timeout (a wedged device tends to hang rather than raise)."""
    code = ("import torch; "
            f"print(float(torch.ones((8, 8), device={str(device)!r}).sum()))")
    try:
        r = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            timeout=timeout_s,
        )
        return r.returncode == 0
    except (subprocess.SubprocessError, OSError):
        return False


class ResilientRunner:
    """Run ``total_steps`` of ``step_factory()`` with snapshot/retry.

    ``step_factory`` must build the step from scratch, so a recovered
    device gets fresh tables and kernels.
    """

    def __init__(
        self,
        step_factory: Callable[[], Callable],
        chunk: int = 100,
        max_retries: int = 3,
        retry_wait_s: float = 30.0,
        checkpoint_path: Optional[str] = None,
    ) -> None:
        self.step_factory = step_factory
        self.chunk = chunk
        self.max_retries = max_retries
        self.retry_wait_s = retry_wait_s
        self.checkpoint_path = checkpoint_path
        self.recoveries = 0

    def run(self, state: ParticleState, total_steps: int) -> ParticleState:
        device = state.pos.device
        step = self.step_factory()
        snap = snapshot(state)
        done_at_snap = 0
        done = 0
        retries = 0
        while done < total_steps:
            n = min(self.chunk, total_steps - done)
            try:
                for _ in range(n):
                    state = step(state)
                fence(state.pos)
                done += n
                snap = snapshot(state)
                done_at_snap = done
                retries = 0
                if self.checkpoint_path:
                    np.savez(self.checkpoint_path, _step=done, **snap)
            except DEVICE_ERRORS as e:
                retries += 1
                self.recoveries += 1
                if retries > self.max_retries:
                    raise DeviceLost(
                        f"device failed {retries} times at step {done}") from e
                deadline = time.time() + self.retry_wait_s * retries
                while time.time() < deadline and not _device_alive(device):
                    time.sleep(5.0)
                step = self.step_factory()
                state = restore(snap, device=device)
                done = done_at_snap
        return state
