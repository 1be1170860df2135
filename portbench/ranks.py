"""The ranks of one run: one process a card, one ``torch.distributed``
group, and rank 0 ordering every step of the others.

A one-chip cell runs in one process with ``Solo``, which starts nothing
and leaves the harness's loop as it is.  A cell on k > 1 chips: rank 0
(the command's own process, which keeps the clock, the window, the
keeper, the judge and the result line) has started k - 1 workers
(``workers.Workers``); rank r binds ``cuda:r`` (or the CPU, for the
tests).  The ranks join one group (``join``: NCCL on cards, gloo on the
CPU) through a file in a new temporary directory, removed at the end.
Every worker builds its share of the system as rank 0 does
(``harness.follow``) and then does what rank 0 orders, one small
broadcast before each step: run a call (traced or not), gather the state
to rank 0, reset to the spawn, report its readings, stop.

A fault ends the run with no result line (``workers.py``): a worker that
raises or exits before it is told to stop, or a wait of rank 0 on the
others longer than its limit (``SETUP_WAIT_S`` in set-up, ``WAIT_S`` in
the window).  Collectives time out after ``GROUP_TIMEOUT_S``, so a rank
0 that hangs ends its workers, and through them the run.
"""

from __future__ import annotations

import contextlib
import datetime

import torch
import torch.distributed as dist

#: orders rank 0 broadcasts: (order, argument)
RUN, WHOLE, RESET, REPORT, STOP = range(5)
#: how long a collective may wait before the group gives up (set-up
#: included: every rank builds the same kernels and tables at once, so
#: their set-ups end within seconds of each other)
GROUP_TIMEOUT_S = 120
#: how long rank 0 may wait on the others inside the window (a call and
#: its join, a gather, the report) before the watchdog ends the run
WAIT_S = 90
#: how long rank 0 may wait for the others to finish their set-up
SETUP_WAIT_S = GROUP_TIMEOUT_S


class Solo:
    """One rank: no process, no group, no collective; what each step of
    the window does is what it did before there were ranks."""

    rank, world = 0, 1

    def run(self, traced_idx: int) -> None:
        pass

    def join(self) -> None:
        pass

    def all(self, flag: bool) -> bool:
        return flag

    def whole(self, system, state):
        return state

    def reset(self, system, spawn_state, out):
        return system.state(pos=spawn_state.pos, vel=spawn_state.vel,
                            collisions=out.collisions, radius=spawn_state.radius,
                            restitution=spawn_state.restitution)

    def report(self, peak: int, counters, sessions: dict):
        return [peak], [counters], [sessions]

    def stop(self) -> None:
        pass


class Group:
    """One rank of a run on several: this process's place in the group,
    and (on rank 0) the workers it started, which watch its waits."""

    def __init__(self, rank: int, world: int, init_method: str, device, workers=None):
        self.rank, self.world, self.device = rank, world, torch.device(device)
        self.workers = workers
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo", init_method=init_method,
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        self._order = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._flag = torch.zeros(1, dtype=torch.int32, device=self.device)
        # the first collective makes the communicator: here, and not inside
        # the capture of a step that runs one
        self._collect(dist.ReduceOp.MIN)

    # ---------------------------------------------------- rank 0's side
    @contextlib.contextmanager
    def _waiting(self, limit: "float | None" = None):
        """Rank 0 waits on the others here for at most ``limit`` s
        (``WAIT_S`` by default)."""
        if self.workers is not None:
            self.workers.expect(limit or WAIT_S)
        yield
        if self.workers is not None:
            self.workers.expect(None)

    def _send(self, order: int, arg: int = 0) -> None:
        self._order.copy_(torch.tensor((order, arg)))
        dist.broadcast(self._order, src=0)

    def _collect(self, op, value: int = 1) -> int:
        self._flag.fill_(value)
        dist.all_reduce(self._flag, op=op)
        return int(self._flag.item())

    def run(self, traced_idx: int) -> None:
        """Order a call on every rank (traced as window chunk
        ``traced_idx``, or not when it is -1); the wait for it is watched
        until ``join`` has returned."""
        self.workers.expect(WAIT_S)
        self._send(RUN, traced_idx)

    def join(self, limit: "float | None" = None) -> None:
        """Every rank has synchronised its card: one collective."""
        with self._waiting(limit):
            self._collect(dist.ReduceOp.MIN)

    def all(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        with self._waiting():
            return bool(self._collect(dist.ReduceOp.MIN, int(bool(flag))))

    def whole(self, system, state):
        """The whole state, gathered from every rank's shard to rank 0
        (``system.whole``: None on the other ranks)."""
        with self._waiting():
            if self.rank == 0:
                self._send(WHOLE)
            return system.whole(state)

    def reset(self, system, spawn_state, out):
        """Every rank back to its own shard of the spawn, the collision
        counters carried (``system.reset``)."""
        if self.rank == 0:
            self._send(RESET)
        return system.reset(spawn_state, out)

    def report(self, peak: int, counters, sessions: dict):
        """Each rank's (device memory peak, ``system.counters()`` or None,
        traced sessions by chunk), gathered to rank 0: three lists by
        rank there (rank 0's own, not a copy: the harness adds the
        reference's work to its sessions), None on the others."""
        mine = (int(peak), counters, sessions)
        with self._waiting():
            if self.rank != 0:
                dist.gather_object(mine, None, dst=0)
                return None
            self._send(REPORT)
            got = [None] * self.world
            dist.gather_object(mine, got, dst=0)
        got[0] = mine
        return tuple(list(x) for x in zip(*got))

    def stop(self) -> None:
        """Order the others to stop, wait for each to end cleanly (raises
        if one does not), and leave the group."""
        self.workers.stopping = True
        self._send(STOP)
        self.workers.finish()
        with self._waiting():
            dist.destroy_process_group()

    # ------------------------------------------------- a worker's side
    def orders(self):
        """The orders from rank 0, as (order, argument), up to STOP."""
        while True:
            self._order.fill_(-1)
            dist.broadcast(self._order, src=0)
            order, arg = self._order.tolist()
            if order == STOP:
                return
            yield order, arg


def join(workers, device_type: str) -> Group:
    """Rank 0 of a run on ``workers.world`` ranks (``workers.Workers``,
    started before): watch the workers, and join the group with them."""
    workers.watch()
    workers.expect(SETUP_WAIT_S)
    try:
        group = Group(0, workers.world, workers.init, device_of(device_type, 0), workers)
    except BaseException:
        workers.close()
        raise
    workers.expect(None)
    return group


def device_of(device_type: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
