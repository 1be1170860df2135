"""The yardstick's arithmetic: the card's peaks, the bytes and operations
that the B1 and B2 kernels' work needs, and the shares built from them.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
Counts: a frozen copy of the per-launch arithmetic of the repository's
``chip_smoke.py`` (``window_case``, ``b2_case``), applied to the work a
step needs, whatever launches do it: each input byte read once, each
output byte written once.  B1 (the swept-sphere narrow phase, response
and integration) reads each lane's position, velocity, radius and
restitution and each distinct (cell, triangle) row it tests (nine
floats), writes position, velocity and the hit flag, and does 550 float
operations a candidate and 100 a lane.  B2 (the cells lookup) reads each
lane's key and each distinct key's table entry, writes (start, count),
and reads two code-window bounds a row of 128.  The plan arrays (B1's
``rel``, ``count``, ``ws``, ``k_cap``) are left out, so a share may read
low, never high.
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12  # HBM3
F32_OPS_PER_S = 67e12  # FP32 outside the tensor cores
WINDOW_OPS_PER_CANDIDATE = 550
WINDOW_OPS_PER_LANE = 100
LANE = 128


def b1_bound_s(work: dict) -> float:
    """Least seconds of one step's B1 work (``work``: the reference's
    lanes, candidates and distinct rows)."""
    n = work["lanes"]
    n_bytes = n * (12 + 12 + 4 + 4) + 36 * work["rows"] + n * (12 + 12 + 4)
    n_ops = WINDOW_OPS_PER_CANDIDATE * work["candidates"] + WINDOW_OPS_PER_LANE * n
    return max(n_bytes / BYTES_PER_S, n_ops / F32_OPS_PER_S)


def b2_bound_s(work: dict) -> float:
    """Least seconds of one step's B2 work (lanes and distinct keys)."""
    n = work["lanes"]
    return (4 * n + 8 * n + 8 * (n // LANE) + 4 * work["keys"]) / BYTES_PER_S


def share_pct(bound_s: float, device_s: float):
    """A bound's share of the device time, in %; None when nothing ran."""
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s


def idle_pct(busy_s: float, window_s: float):
    """The device's idle share of a traced window, in %."""
    if window_s <= 0.0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def rate(particles: int, steps: int, seconds: float) -> float:
    """Particle-steps per second."""
    return particles * steps / seconds
