"""The episode runners' telemetry (``core/step.py``: the sorted runner
``SortedEpisodeRunner`` and the gravity box's ``P2PEpisodeRunner``, their
``with_stats`` calls): stage stamps and counters written on the device
inside each step, one ring row a step, read once a call; the host span
around each step's replay; the set-up laps.

  * ``StepRing``: a runner's ring, step counter and undecided
    accumulator for one particle count (the addresses its stamped graphs
    hold), and the stamps a step takes (``ops/cuda/telemetry_kernel.py``).
  * ``Telemetry`` (``runner.telemetry``): the set-up laps, the call
    count, and a ``CallStamps`` for each of the newest ``KEEP_CALLS``
    ``with_stats`` calls.
  * ``step_span``: the profiler span ``STEP_SPAN`` a stats step runs in.

The stamps are the same for every runner; a runner leaves out those that
its step has not (the p2p runner: ``halo``, ``screenspace``,
``integrate``), and its stages are named by the stamp that ends them.
Sorted runner: ``order`` (Morton key, sort, permutes), ``main`` (plan,
B2, B1's main launch), ``rescue``, ``end``.  P2p runner: ``order`` (cell
key, stable sort, CSR offsets, row gather and pad), ``main`` (B3's cells
launch), ``rescue`` (the fallback's compaction and B3's worklist
launch), ``end`` (walls, integration, write-back).  Domain runner
(``parallel/domain.py``): ``halo`` (the ghosts' pack and exchange),
``order``, ``main`` and ``rescue`` as the p2p runner's over the rank's
slots and the ghosts, ``integrate`` (the un-sort of the rank's own
slots, walls, integration), ``end`` (the migrants' pack and exchange,
the merge); its counters beside ``n_over`` and ``n_lanes``: the ghost
lanes received, the migrants sent and the rank's drops (halo, migration
and cell overflow).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import telemetry_kernel as tk
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import Stopwatch

#: a step's stamps in order, then its counters: the columns of a ring row
STAMPS = ("start", "halo", "screenspace", "order", "main", "rescue", "integrate", "end")
COUNTERS = ("n_over", "undecided", "n_lanes", "ghosts", "migrants", "drops")
#: the ``with_stats`` calls whose records a runner keeps, the newest
KEEP_CALLS = 1024
#: the ``torch.profiler`` span around each step (the sorted runner's flag
#: read, the replay) of a runner's ``with_stats`` call
STEP_SPAN = "psys.runner.step"


def step_span():
    """The profiler span ``STEP_SPAN``, a host record only
    (``_RecordFunctionFast`` is private to PyTorch; PyTorch 2.11 and 2.13
    have it).  A ``record_function`` span is a user annotation, over which
    the profiler also lays a device record covering the kernels launched
    inside it: trace readers would count that record as device time."""
    return torch._C._profiler._RecordFunctionFast(STEP_SPAN)


class StepRing:
    """A runner's telemetry buffers for one particle count, whose
    addresses a captured step holds: the ring (i64[cap, 9], one row a
    step: the ``STAMPS`` in ns, then the ``COUNTERS``; -1 where a step
    writes nothing), the device step counter that selects the row, the
    hybrid's undecided accumulator, and ``lanes``, the lane count of the
    step's worklist launch as it is issued (set by the sorted steps'
    ``_device_rescue`` and the p2p step's ``_p2p_device_fallback``).
    ``count`` writes a step's counters after the end stamp's three
    (``COUNTERS[3:]``) into its row."""

    def __init__(self, device, hybrid: bool, cap: int = 4096):
        self.ring = torch.full((cap, len(STAMPS) + len(COUNTERS)), -1,
                               dtype=torch.int64, device=device)
        self.step = torch.zeros((1,), dtype=torch.int32, device=device)
        self.undecided = (torch.zeros((), dtype=torch.int32, device=device)
                          if hybrid else None)
        self.lanes = None
        self._extra = torch.arange(len(STAMPS) + 3, len(STAMPS) + len(COUNTERS),
                                   dtype=torch.int64, device=device)

    @property
    def cap(self) -> int:
        return self.ring.shape[0]

    def stamp(self, name: str) -> None:
        tk.stamp(self.ring, self.step, STAMPS.index(name))

    def count_undecided(self, undecided, x) -> None:
        """Add the step's undecided real lanes (``x``: a position row)."""
        tk.count_undecided(undecided, x, self.undecided)

    def count(self, *values) -> None:
        """Write the step's ``COUNTERS[3:]`` (device integer scalars, in
        that order) into its row; before ``end``, which moves to the next
        row."""
        row = (self.step.long() % self.cap).expand(len(values))
        self.ring.index_put_((row, self._extra[:len(values)]),
                             torch.stack([v.to(torch.int64) for v in values]))

    def end(self, n_over) -> None:
        """The step's last stamp: with its counters, then the next row."""
        tk.stamp(self.ring, self.step, STAMPS.index("end"), counters_at=len(STAMPS),
                 n_over=n_over, undecided=self.undecided, n_lanes=self.lanes)
        self.lanes = None

    def drain(self, steps: int) -> np.ndarray:
        """The rows of the ``steps`` steps stamped since the last drain (one
        read), the step counter set back to row 0."""
        rows = self.ring[:steps].to("cpu", copy=True).numpy()
        self.step.zero_()
        return rows


class CallStamps(NamedTuple):
    """One ``with_stats`` call's telemetry, step by step."""

    call: int  # the runner's call index (calls without stats count too)
    stages_ms: dict  # stamp name -> f64[steps]: the time up to it from the one before
    period_ms: np.ndarray  # f64[steps - 1]: a step's start stamp to the next's
    gap_ms: np.ndarray  # f64[steps - 1]: a step's end stamp to the next's start
    counters: dict  # counter name -> i64[steps]


class Telemetry:
    """What a runner records (``runner.telemetry``): its set-up laps
    (``setup_laps``: the sorted runner's ``tables``, ``bake`` for the
    hybrid, and every runner's ``capture``), the count of its calls, and
    ``records``, a ``CallStamps`` for each of the newest ``KEEP_CALLS``
    ``with_stats`` calls."""

    def __init__(self, setup: Stopwatch):
        self.setup = setup
        self.calls = 0
        self.records: collections.deque = collections.deque(maxlen=KEEP_CALLS)

    @property
    def setup_laps(self) -> dict:
        return self.setup.laps

    def keep(self, call: int, rows: np.ndarray) -> CallStamps:
        """Decode a call's ring rows (``StepRing.drain``) and keep them.
        A stage runs from the stamp before it to its own; a stamp that no
        step wrote (the screen-space one of the spatial method and of the
        p2p runner) is left out."""
        t = rows[:, :len(STAMPS)]
        present = [k for k in range(len(STAMPS)) if (t[:, k] >= 0).all()]
        stages = {STAMPS[k]: (t[:, k] - t[:, j]) / 1e6
                  for j, k in zip(present, present[1:])}
        start, end = t[:, 0], t[:, STAMPS.index("end")]
        rec = CallStamps(
            call=call, stages_ms=stages, period_ms=np.diff(start) / 1e6,
            gap_ms=(start[1:] - end[:-1]) / 1e6,
            counters={c: rows[:, len(STAMPS) + i] for i, c in enumerate(COUNTERS)})
        self.records.append(rec)
        return rec

    def steps(self, call: int, ring: "StepRing | None", num_steps: int, step) -> list:
        """Run ``step(i)`` for each of a call's ``num_steps`` steps.  With a
        ``ring`` (a ``with_stats`` call) each step runs inside the span
        ``STEP_SPAN``, the ring is drained every ``ring.cap`` steps and
        after the last, and the call's record is kept; returns its
        per-step "n_over" counts (host ints; none without a ring)."""
        if ring is None:
            for i in range(num_steps):
                step(i)
            return []
        rows = []
        for i in range(num_steps):
            if i and i % ring.cap == 0:
                rows.append(ring.drain(ring.cap))
            with step_span():
                step(i)
        if not num_steps:
            return []
        rows.append(ring.drain(num_steps - len(rows) * ring.cap))
        return self.keep(call, np.concatenate(rows)).counters["n_over"].tolist()
