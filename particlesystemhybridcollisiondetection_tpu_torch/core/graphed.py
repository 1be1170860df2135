"""Captured CUDA graphs of the episode runners' steps.

  * ``GraphedRunner``: the core of the sorted runner, the p2p runner
    (``core/step.py``: ``SortedEpisodeRunner``, ``P2PEpisodeRunner``) and
    the domain runner (``parallel/domain.py::DomainEpisodeRunner``):
    carried buffers per particle count, the first step eager, the
    capture, the replays, the telemetry ring and the order restored once
    a call.
  * ``_capture``/``_replay``: a graph with its kernel launches counted
    (``make_p2p_step``'s graph cache uses them too).
  * ``uncaptured``: steps eagerly where they would replay.
  * ``HostSyncs``: the count of the host's reads of device values.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.telemetry import (
    StepRing,
    Telemetry,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import telemetry_kernel as tk
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.build import COUNTERS
from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import Stopwatch


class HostSyncs:
    """Counts the device scalars read back to the host to decide a branch
    (each read waits for the device): the host's form of the JAX
    package's on-device branches.  Those that remain are the runner's
    "auto" re-sort flag (with a mesh, the flag of the summed overflow),
    the packed rescue phase where a scene needs it, the per-step sorted
    step's ``with_stats`` overflow and the p2p "sorted" variant's loop
    bounds (``core/step.py``).  A runner's ``with_stats`` list, read once
    after a call's last step, is the caller's read and not counted."""

    def __init__(self):
        self.count = 0

    def read(self, t: torch.Tensor) -> int:
        self.count += 1
        return int(t.item())


# step capture on CUDA; off only inside ``uncaptured()``
_CAPTURE = True


@contextlib.contextmanager
def uncaptured():
    """Test and smoke helper: inside it, the sorted and p2p runners and
    the p2p "kernel" step step eagerly on CUDA (no graph is captured or
    replayed), running the code a captured step holds, so the two can be
    held against each other."""
    global _CAPTURE
    was, _CAPTURE = _CAPTURE, False
    try:
        yield
    finally:
        _CAPTURE = was


def _capture(body, *, pool=None, error_mode: str = "global"):
    """Capture ``body()`` in a new CUDA graph (memory from ``pool`` when
    given).  Returns (graph, what ``body`` returned, {wrapper: launches}):
    a capture launches nothing, so the launches that the wrappers counted
    (every ``LaunchCounter``, ``ops/cuda/build.py``) go back out of their
    counters, and ``_replay`` adds them per replay.  Python's cycle
    collector is off during the capture: a graph that it freed then (one
    held by dead objects) would invalidate the capture."""
    before = {k: c[k] for k, c in COUNTERS.items()}
    g = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(g, pool=pool, capture_error_mode=error_mode):
            out = body()
    finally:
        gc.enable()
    made = {k: c[k] - before.get(k, 0) for k, c in COUNTERS.items()
            if c[k] != before.get(k, 0)}
    _tally({k: -v for k, v in made.items()})
    return g, out, made


def _replay(graph, launches: dict) -> None:
    """Replay a captured step and count its kernel launches."""
    graph.replay()
    _tally(launches)


def _tally(launches: dict) -> None:
    """Add each wrapper's launches to the counter that holds its name."""
    for k, v in launches.items():
        COUNTERS[k][k] += v


class GraphedRunner:
    """An episode runner that carries a state in place, one set of
    buffers per particle count: ``runner(state, num_steps)`` loads the
    state, steps, and returns it in the original particle order (the
    carry's ids row, restored once a call); ``syncs.count`` and ``steps``
    count host reads and steps over all calls.

    On CUDA (``graphed``) every step replays a captured CUDA graph of its
    branch: the first step for a (particle count, with stats) key runs
    eagerly (its kernels load before any capture), the next captures a
    graph of each of ``BRANCHES`` (in the count's one memory pool), and
    every step from then on replays one.  The first step and the capture
    are timed as the set-up lap "capture".  ``launches`` holds a replay's
    kernel launches by wrapper, which every replay adds to the wrappers'
    ``LAUNCHES``; ``telemetry_launches`` the stamped graphs' telemetry
    kernel launches, which every replay of them adds to
    ``telemetry_kernel.LAUNCHES``.  ``uncaptured()`` steps eagerly.  A
    failed capture raises.

    ``telemetry`` (``core/telemetry.py::Telemetry``) holds the set-up laps
    and, for every ``with_stats`` call, its steps' stage times and
    counters.  Such a call steps with the count's ``StepRing``, read once
    after the call's last step, each step inside the profiler span
    "psys.runner.step"; its steps are graphs of their own (captured on the
    first ``with_stats`` call), so a call without stats replays graphs
    without a stamp.

    A runner gives ``_new_carry(n)`` (buffers with ``rows8``, f32[8, n]:
    pos3 vel3 radius restitution, and ``aux``, i32[2, n]: collisions and
    original ids; the domain runner, which has a ``__call__`` of its own,
    carries its slots otherwise), ``_load(state)`` (the state into the
    carry of its count, ids aside), ``_step(b, branch, ring)`` (one step
    in place on the carry) and, with more than one branch, ``BRANCHES``
    and ``_branch``."""

    #: the branches a step can take, each a graph of its own
    BRANCHES = (None,)

    def __init__(self, device: torch.device, graphed: bool, *, hybrid: bool = False,
                 telemetry: Telemetry | None = None, error_mode: str = "global"):
        self.device = device
        #: steps are captured and replayed
        self.graphed = graphed
        self.syncs = HostSyncs()
        self.steps = 0
        #: kernel launches per replay, by wrapper, once captured (the
        #: telemetry's stamps are not counted)
        self.launches: dict = {}
        #: telemetry kernel launches per replay of the stamped graphs
        self.telemetry_launches: dict = {}
        self.telemetry = telemetry or Telemetry(Stopwatch())
        self._hybrid = hybrid  # the rings keep an undecided count
        self._error_mode = error_mode
        self._carry: dict = {}  # N -> carry
        self._rings: dict = {}  # N -> StepRing
        self._graphs: dict = {}  # (N, with stats) -> {branch: CUDAGraph}
        self._pools: dict = {}  # N -> the memory pool its graphs share
        self._warm: set = set()  # (N, with stats) whose first step ran eagerly

    def _carry_for(self, n: int):
        b = self._carry.get(n)
        if b is None:
            b = self._carry[n] = self._new_carry(n)
        return b

    def _branch(self, b, i: int):
        """The branch of the call's step ``i``."""
        return None

    def _capture_branches(self, n: int, b, ring):
        """Capture the step on each branch (with ``ring``, the stamped
        step) in the memory pool of N's graphs.  Their kernel launches,
        which must be the same as every other graph's, go to
        ``launches``, the stamped graphs' telemetry launches to
        ``telemetry_launches``."""
        graphs, made, stamped = {}, [self.launches] if self.launches else [], []
        for branch in self.BRANCHES:
            g, _, launches = _capture(lambda: self._step(b, branch, ring),
                                      pool=self._pools.get(n), error_mode=self._error_mode)
            self._pools[n] = g.pool()
            graphs[branch] = g
            stamped.append({k: launches.pop(k) for k in tk.LAUNCHES if k in launches})
            made.append(launches)
        if any(m != made[0] for m in made) or any(s != stamped[0] for s in stamped):
            raise RuntimeError(f"the captured steps launch different kernels: "
                               f"{made}, telemetry {stamped}")
        self.launches = made[0]
        if ring is not None:
            self.telemetry_launches = stamped[0]
        self._graphs[n, ring is not None] = graphs
        return graphs

    def _advance(self, n: int, b, branch, graphed: bool, ring) -> None:
        """One step on ``branch``: replay its graph, or step eagerly."""
        key = (n, ring is not None)
        graphs = self._graphs.get(key) if graphed else None
        if graphs is None and key in self._warm and not graphed:
            self._step(b, branch, ring)
        elif graphs is None:
            setup = self.telemetry.setup
            setup.restart()
            if key in self._warm:
                graphs = self._capture_branches(n, b, ring)
            else:
                self._step(b, branch, ring)
                self._warm.add(key)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            setup.lap("capture")
        if graphs is not None:
            _replay(graphs[branch], self.launches)
            if ring is not None:
                _tally(self.telemetry_launches)

    def __call__(self, state, num_steps: int, with_stats: bool = False):
        """``with_stats=True``: also return the per-step window-overflow
        counts (host ints, the ring's "n_over" column, read once after the
        last step)."""
        dev = state.pos.device
        if dev != self.device:
            raise ValueError(f"state is on {dev}, the runner on {self.device}")
        b = self._load(state)
        n = b.rows8.shape[1]
        b.aux[1].copy_(torch.arange(n, dtype=torch.int32, device=dev))
        graphed = self.graphed and _CAPTURE
        call = self.telemetry.calls
        self.telemetry.calls += 1
        ring = None
        if with_stats:
            ring = self._rings.get(n)
            if ring is None:
                ring = self._rings[n] = StepRing(dev, hybrid=self._hybrid)
        overflows = self.telemetry.steps(
            call, ring, num_steps,
            lambda i: self._advance(n, b, self._branch(b, i), graphed, ring))
        self.steps += num_steps
        # restore the original order once
        ids = b.aux[1].long()
        out8 = torch.empty_like(b.rows8)
        out_aux = torch.empty_like(b.aux)
        out8[:, ids] = b.rows8
        out_aux[:, ids] = b.aux
        m = state.pos.shape[-1]
        out = state._replace(pos=out8[0:3, :m], vel=out8[3:6, :m],
                             collisions=out_aux[0, :m])
        return (out, overflows) if with_stats else out
