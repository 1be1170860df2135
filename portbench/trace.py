"""Reading ``torch.profiler`` sessions: each traced chunk's device and
host records, the device's busy time (the union of its records), kernel
times by name, and the idle gaps labelled by what the host was doing.
The sessions stay in memory; no trace file is written.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Session(NamedTuple):
    """One traced chunk: records as (name, start us, end us)."""

    steps: int
    device: list  # kernels, copies and sets on the card
    host: list  # host-side records (operators, runtime calls)
    work: list  # the reference's per-step work counts (filled later)


def record(prof, steps: int) -> Session:
    """The records of a finished profiler session."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == DeviceType.CUDA else host).append(rec)
    return Session(steps, device, host, [])


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_window_us(s: Session) -> tuple:
    """(device busy us, traced window us) of a session: the union of its
    device records, and the span from its first record to its last."""
    if not s.device:
        return 0.0, 0.0
    busy = sum(b - a for a, b in union((a, b) for _, a, b in s.device))
    every = s.device + s.host
    return busy, max(b for _, _, b in every) - min(a for _, a, _ in every)


def traced(rank_sessions) -> list:
    """Every rank's sessions that recorded device time, in one list
    (``ctx.rank_sessions``: each rank's by chunk): a reader of device time
    over them reads each card's mean a step."""
    return [s for r in rank_sessions for s in r if s.device]


def worked(rank_sessions) -> list:
    """[(a traced chunk's work, its session on every rank)] for the chunks
    whose every step the reference counted: the work, counted on the
    whole state, is on rank 0's session, and the chunk's index in each
    rank's list is the same.  A share of a roofline is the work's least
    time on one card over the kernels' time summed over every card."""
    return [(s.work, [r[j] for r in rank_sessions])
            for j, s in enumerate(rank_sessions[0]) if s.device and len(s.work) == s.steps]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def kernel_us(sessions, names) -> float:
    """Summed device time of the kernels whose name holds one of
    ``names``."""
    return sum(b - a for s in sessions for n, a, b in s.device
               if any(k in n for k in names))


def kernel_count(sessions, name: str) -> int:
    return sum(1 for s in sessions for n, _, _ in s.device if name in n)


def short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][-60:]


def _top(tot: dict, k: int, devices: int) -> list:
    """The ``k`` largest of ``tot``, each over ``devices``."""
    return [[n, v / devices] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def top_device_ops(sessions, k: int = 10, devices: int = 1) -> list:
    """[[name, seconds], ...]: the device records that took most time,
    summed by name (over ``devices``: the sessions of that many ranks)."""
    tot: dict = {}
    for s in sessions:
        for n, a, b in s.device:
            tot[short(n)] = tot.get(short(n), 0.0) + (b - a) / 1e6
    return _top(tot, k, devices)


def idle_gaps(sessions, k: int = 10, devices: int = 1) -> list:
    """[[host activity, seconds], ...]: the device's idle gaps inside each
    session, summed by the innermost host record running at each gap's
    middle ("no host record" where none was); over ``devices`` as
    ``top_device_ops``."""
    tot: dict = {}
    for s in sessions:
        merged = union((a, b) for _, a, b in s.device)
        if len(merged) < 2 or not s.host:
            continue
        e0 = np.array([b for _, b in merged[:-1]])
        s1 = np.array([a for a, _ in merged[1:]])
        mid = (e0 + s1) / 2.0
        names = [n for n, _, _ in s.host]
        h0 = np.array([a for _, a, _ in s.host])
        h1 = np.array([b for _, _, b in s.host])
        for c in range(0, len(mid), 1024):
            m = mid[c:c + 1024, None]
            dur = np.where((h0[None] <= m) & (m <= h1[None]), (h1 - h0)[None], np.inf)
            pick = dur.argmin(axis=1)
            found = np.isfinite(dur[np.arange(len(pick)), pick])
            for i, (p, f) in enumerate(zip(pick, found)):
                label = names[p] if f else "no host record"
                tot[label] = tot.get(label, 0.0) + (s1[c + i] - e0[c + i]) / 1e6
    return _top(tot, k, devices)
