"""PyTorch port, the profiling utilities and the resilient runner on the
CPU: ``Stopwatch``, ``StepTimeseries`` (summaries equal to the JAX
package's on the same series), ``DeviceTimer``, ``phase_times``, ``trace``
and ``fence``; ``ResilientRunner`` with injected device failures (the
recovered run equal to an uninterrupted one bit for bit), giving up, and
propagating real bugs."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.utils import profiling as jprof
from particlesystemhybridcollisiondetection_tpu_torch.bench import resilient as tres
from particlesystemhybridcollisiondetection_tpu_torch.bench.resilient import (
    DeviceLost,
    ResilientRunner,
)
from particlesystemhybridcollisiondetection_tpu_torch.config import PRESETS
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import spawn_grid
from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import sample_scene
from particlesystemhybridcollisiondetection_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def test_stopwatch_and_timeseries():
    sw = tprof.Stopwatch()
    sum(range(10000))
    sw.lap("sum")
    assert "sum" in sw.laps and sw.laps["sum"] >= 0
    assert "total" in sw.report()

    series = np.random.default_rng(0).uniform(0.001, 0.02, 40)
    ts, js = tprof.StepTimeseries(), jprof.StepTimeseries()
    for x in series:
        ts.record(float(x))
        js.record(float(x))
    assert ts.summary() == js.summary()
    assert ts.summary()["steps"] == 39  # first step skipped (ParticleSys.cs:457)
    empty = tprof.StepTimeseries()
    empty.record(0.01)
    assert empty.summary() == {"mean_ms": 0.0, "p50_ms": 0.0, "p99_ms": 0.0,
                               "steps": 0}


def test_device_timer_and_phases():
    scene = sample_scene()
    step = tstep.make_spatial_step_grid(scene.triangles, scene.config, device="cpu")
    state = spawn_grid(scene.config, layers_y=1, pad_multiple=128, device="cpu")
    t = tprof.DeviceTimer(step, state, reps=3, warmup=1)
    assert t.compile_s > 0 and t.mean_ms > 0
    assert t.last_output.pos.shape == state.pos.shape

    phases = tprof.phase_times(
        [
            ("collide+integrate", step),
            ("integrate-only", lambda s: s._replace(pos=s.pos + s.vel * 0.001)),
        ],
        state,
        reps=2,
    )
    assert set(phases) == {"collide+integrate", "integrate-only"}
    assert phases["collide+integrate"] > phases["integrate-only"]


def test_trace_writes_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        x = torch.ones(64, 64)
        (x @ x).sum()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_fence_and_rtt_on_cpu():
    """fence takes a tensor or a (named) tuple of them; on the CPU it has
    nothing to wait for.  rtt_ms measures a tiny op and a read back."""
    s = spawn_grid(PRESETS["sample"], layers_y=1, device="cpu")
    tprof.fence(s)
    tprof.fence(s.pos)
    tprof.fence({"a": [s.pos, (s.vel,)]})
    assert tprof.rtt_ms(reps=3, device="cpu") > 0


def _fast_step():
    scene = sample_scene(width=96, height=64)
    cfg = dataclasses.replace(scene.config, dt=scene.config.dt * 20)
    return cfg, tstep.make_spatial_step_grid(scene.triangles, cfg, device="cpu")


@pytest.mark.parametrize("error", ["AcceleratorError", "OSError"])
def test_resilient_runner_recovers_from_injected_failures(tmp_path, error):
    """A step factory whose first product fails at its 70th call: the
    runner restores its snapshot onto the state's device, rebuilds the
    step, and ends equal to an uninterrupted run bit for bit, with one
    recovery and a checkpoint of the last chunk."""
    exc = {"AcceleratorError": torch.AcceleratorError, "OSError": OSError}[error]
    cfg, real_step = _fast_step()
    state = spawn_grid(cfg, layers_y=1, pad_multiple=128, device="cpu")
    calls = {"n": 0, "made": 0}

    def factory():
        calls["made"] += 1
        first = calls["made"] == 1

        def step(s):
            calls["n"] += 1
            if first and calls["n"] == 70:
                raise exc("injected device loss")
            return real_step(s)

        return step

    ckpt = str(tmp_path / "ckpt.npz")
    runner = ResilientRunner(factory, chunk=25, max_retries=2, retry_wait_s=0.0,
                             checkpoint_path=ckpt)
    out = runner.run(state, total_steps=100)
    assert runner.recoveries == 1 and calls["made"] == 2
    ref = state
    for _ in range(100):
        ref = real_step(ref)
    assert int(ref.collisions.sum()) > 0
    for a, b in zip(out, ref):
        assert a.device.type == "cpu" and torch.equal(a, b)
    with np.load(ckpt) as z:
        assert int(z["_step"]) == 100
        np.testing.assert_array_equal(z["pos"], ref.pos.numpy())


def test_resilient_runner_gives_up():
    def factory():
        def step(s):
            raise torch.AcceleratorError("always broken")

        return step

    state = spawn_grid(PRESETS["sample"], layers_y=1, device="cpu")
    runner = ResilientRunner(factory, chunk=10, max_retries=1, retry_wait_s=0.0)
    with pytest.raises(DeviceLost):
        runner.run(state, total_steps=20)
    assert runner.recoveries == 2


@pytest.mark.parametrize("error", [ValueError, RuntimeError, IndexError])
def test_resilient_runner_propagates_real_bugs(error):
    """Exceptions other than device loss (shape bugs, a bare
    RuntimeError, typos) propagate and are not retried."""
    def factory():
        def step(s):
            raise error("a real bug, not device loss")

        return step

    state = spawn_grid(PRESETS["sample"], layers_y=1, device="cpu")
    runner = ResilientRunner(factory, chunk=10, max_retries=3, retry_wait_s=0.0)
    with pytest.raises(error):
        runner.run(state, total_steps=20)
    assert runner.recoveries == 0


def test_device_probe_runs_in_a_fresh_interpreter():
    """The liveness probe answers for the CPU, and fails for a device this
    machine does not have."""
    assert tres._device_alive("cpu")
    if not torch.cuda.is_available():
        assert not tres._device_alive("cuda")
