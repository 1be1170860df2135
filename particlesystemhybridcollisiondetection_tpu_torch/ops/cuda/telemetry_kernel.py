"""The episode runners' in-graph telemetry kernels (the sorted runner's and
the p2p runner's), for CUDA (``csrc/telemetry_kernel.cu``):

  * ``stamp``: the device clock (``%globaltimer``, ns) into one slot of
    the ring row that the device step counter selects; the step's last
    stamp also copies its counters into the row and advances the counter;
  * ``count_undecided``: adds the undecided real lanes of the hybrid's
    screen-space stage to a device accumulator.

Each has its plain version beside it, which runs for tensors on the CPU:
there ``stamp`` writes the host's ``time.perf_counter_ns``, so the CPU
runs the same layout and counters.  Each launch adds one to this
module's ``LAUNCHES[<wrapper name>]``, apart from
``window_kernel.LAUNCHES``: they run only on a runner's ``with_stats``
calls, beside the step's own launches (a runner's replay of a stamped
graph adds its ``telemetry_launches``).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import FLOAT_SENTINEL
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.build import LaunchCounter
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import (
    _check,
    _ptr,
    _raise_on,
    _stream,
)

# a lane is real below this |x| (core/state.py::active_mask), in float32
REAL_BOUND = float(np.float32(FLOAT_SENTINEL * 0.5))

#: kernel launches by wrapper, since the last ``reset_launches``
LAUNCHES = LaunchCounter("stamp", "count_undecided")
reset_launches = LAUNCHES.reset


def _opt_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else _ptr(t)


def stamp_plain(ring, step, slot: int, *, counters_at: int = -1, n_over=None,
                undecided=None, n_lanes=None) -> None:
    """Plain version of ``stamp``: the host clock."""
    row = ring[int(step[0]) % ring.shape[0]]
    row[slot] = time.perf_counter_ns()
    if counters_at >= 0:
        for j, c in enumerate((n_over, undecided, n_lanes)):
            row[counters_at + j] = -1 if c is None else int(c)
        if undecided is not None:
            undecided.zero_()
        step += 1


def stamp(ring, step, slot: int, *, counters_at: int = -1, n_over=None,
          undecided=None, n_lanes=None) -> None:
    """Stamp slot ``slot`` of row ``step % cap`` of ``ring`` (i64[cap,
    width]) with the clock.  With ``counters_at`` >= 0 (the step's last
    stamp) also write the i32 device scalars ``n_over``, ``undecided`` and
    ``n_lanes`` into slots ``counters_at`` .. + 2 (-1 for a None), set
    ``undecided`` back to 0 and add one to ``step`` (i32[1])."""
    if ring.device.type == "cpu":
        return stamp_plain(ring, step, slot, counters_at=counters_at, n_over=n_over,
                           undecided=undecided, n_lanes=n_lanes)
    dev = ring.device
    cap, width = ring.shape
    _check("ring", ring, torch.int64, (cap, width), dev)
    _check("step", step, torch.int32, (1,), dev)
    if not 0 <= slot < width or counters_at + 3 > width:
        raise ValueError(f"slot {slot} or counters at {counters_at} outside a "
                         f"row of {width}")
    for name, c in (("n_over", n_over), ("undecided", undecided), ("n_lanes", n_lanes)):
        if c is not None:
            _check(name, c, torch.int32, (), dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    fn = build.kernel_function("telemetry_kernel", "psys_stamp", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ])
    err = fn(_ptr(ring), _ptr(step), cap, width, slot, counters_at, _opt_ptr(n_over),
             _opt_ptr(undecided), _opt_ptr(n_lanes), _stream(dev))
    _raise_on(err, "stamp")
    LAUNCHES["stamp"] += 1


def count_undecided_plain(undecided, x, acc) -> None:
    """Plain version of ``count_undecided``."""
    acc += (undecided & (torch.abs(x) < REAL_BOUND)).sum(dtype=torch.int32)


def count_undecided(undecided, x, acc) -> None:
    """Add to ``acc`` (i32[]) the lanes where ``undecided`` (bool[N]) holds
    and the lane is real, ``|x| < REAL_BOUND`` (x: f32[N], a position
    row)."""
    if x.device.type == "cpu":
        return count_undecided_plain(undecided, x, acc)
    dev = x.device
    n = x.shape[0]
    _check("undecided", undecided, torch.bool, (n,), dev)
    _check("x", x, torch.float32, (n,), dev)
    _check("acc", acc, torch.int32, (), dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    fn = build.kernel_function("telemetry_kernel", "psys_undecided_count", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ])
    err = fn(_ptr(undecided), _ptr(x), n, REAL_BOUND, _ptr(acc), _stream(dev))
    _raise_on(err, "count_undecided")
    LAUNCHES["count_undecided"] += 1
