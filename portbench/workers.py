"""The worker processes of a run on k > 1 cards, and rank 0's watchdog
over them.  This module imports no torch: the command starts the workers
before its own heavy imports (``portbench/run.py``), so that theirs and
its own overlap.

Rank r (1 <= r < k) is a process of the spawn start method, the leader
of a process group of its own, which ``end`` kills whole (the worker and
whatever it started); a worker also dies with rank 0
(``PR_SET_PDEATHSIG``).  Once rank 0 joins the group (``ranks.join``),
a thread of rank 0 watches the workers: a worker that ends before it is
told to stop, or with another code than 0, and a wait of rank 0 on the
others that outlasts its limit (``expect``), end the run with no result
(``FAULT_EXIT``).
"""

from __future__ import annotations

import ctypes
import multiprocessing
import multiprocessing.connection
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback

#: rank 0's exit code when the watchdog ends the run
FAULT_EXIT = 4


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Workers:
    """Ranks 1 to ``world - 1`` of one run, started at once; the
    rendezvous file lies in a new temporary directory (``init``)."""

    def __init__(self, world: int, bench: dict, workload: str, root: str, seed: int,
                 trace_on: bool, device_type: str, threads: "int | None" = None):
        self.world = world
        self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
        self.init = "file://" + os.path.join(self.tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=worker, name=f"rank {r}",
                                  args=(r, world, self.init, bench, workload, root, seed,
                                        trace_on, device_type, threads, os.getpid()))
                      for r in range(1, world)]
        self.stopping = False
        self._wait = None  # (since, limit): one attribute, set at once
        self._ended = threading.Event()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, name="portbench-watch",
                                        daemon=True)
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.end()
            raise

    # ------------------------------------------------------- the watch
    def watch(self) -> None:
        """From now, a worker that ends ends the run, unless told to stop."""
        self._thread.start()

    def expect(self, limit) -> None:
        """From now, a wait of at most ``limit`` seconds (None: none)."""
        self._wait = None if limit is None else (time.monotonic(), limit)

    def _watch(self) -> None:
        alive = {p.sentinel: p for p in self.procs}
        while not self._done.is_set():
            for s in multiprocessing.connection.wait(list(alive), timeout=0.5):
                p = alive.pop(s)
                p.join()
                if p.exitcode != 0 or not self.stopping:
                    self.fault(f"{p.name} ended with exit code {p.exitcode}")
            if not alive:
                self._ended.set()
            wait = self._wait
            if wait is not None and time.monotonic() - wait[0] > wait[1]:
                self.fault(f"rank 0 waited over {wait[1]} s on the other ranks")

    def fault(self, why: str) -> None:
        log(f"[portbench] {why}: the run ends with no result")
        self.end()
        os._exit(FAULT_EXIT)

    def finish(self, timeout: float = 60.0) -> None:
        """Wait for every worker to end after the order to stop (the watch
        reaps them and ends the run if one ends with another code than 0)."""
        if not self._ended.wait(timeout):
            raise RuntimeError(f"[portbench] a worker was still running {timeout} s "
                               "after the order to stop")

    # ---------------------------------------------------------- the end
    def end(self) -> None:
        """Kill every worker's process group, and remove the rendezvous."""
        for p in self.procs:
            if p.pid is None:
                continue
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:  # ended, or not yet its group's leader
                pass
            if p.exitcode is None:
                p.kill()
        for p in self.procs:
            if p.pid is not None and p.exitcode is None:
                p.join(5.0)
        shutil.rmtree(self.tmp, ignore_errors=True)

    def close(self) -> None:
        """After rank 0's run, normal or not: nothing it started is left."""
        self._done.set()
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join()
        self.end()


def _die_with(parent: int) -> None:
    """End this process when rank 0's does (Linux)."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def worker(rank: int, world: int, init: str, bench: dict, workload: str, root: str,
           seed: int, trace_on: bool, device_type: str, threads: "int | None",
           parent: int) -> None:
    """A worker rank's process: its share of the run, then the check that
    it loaded nothing forbidden.  It prints nothing to standard output."""
    os.setpgrp()
    _die_with(parent)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        import torch

        from portbench import guard, harness, ranks

        if threads:
            torch.set_num_threads(threads)
        group = ranks.Group(rank, world, init, ranks.device_of(device_type, rank))
        harness.follow(harness.cell(bench, workload, root=root), seed, trace_on,
                       group.device, group)
        bad = guard.loaded_forbidden()
        if bad:
            log(f"[portbench] rank {rank}: loaded in this process: {bad}")
            os._exit(3)
    except BaseException:  # noqa: BLE001 (reported and ended here: rank 0 sees the code)
        log(f"[portbench] rank {rank} failed:\n{traceback.format_exc()}")
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)
