"""One run of a cell of a small benchmark on CPU ranks (gloo), through
``workers.Workers``, ``ranks.join`` and ``harness.run_cell``, as
``portbench.run`` makes it on cards; the tests of the multi-rank path run
it in a process of its own, since a fault ends that process.

    python ranks_run.py <root> <workload> <seed> <seconds> <trace 0|1> [<wait s>]

``<root>`` holds the small benchmark (``BENCHMARK.json``, ``configs/``,
``traffic/``, ``metrics/``) and its caches.  ``<wait s>`` lowers how long
rank 0 waits on the others in the window (``ranks.WAIT_S``).  Prints the
line last on standard output.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import harness, ranks, workers as workers_  # noqa: E402


def main(root: str, workload: str, seed: str, seconds: str, trace_on: str,
         wait_s: str = "") -> int:
    torch.set_num_threads(1)
    harness.CACHE = os.path.join(root, "cache")
    if wait_s:
        ranks.WAIT_S = float(wait_s)
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    spec = harness.cell(bench, workload, root=root)
    workers = workers_.Workers(spec[0]["chips"], bench, workload, root, int(seed),
                               trace_on == "1", "cpu", threads=1)
    try:
        group = ranks.join(workers, "cpu")
        line = harness.run_cell(spec, int(seed), float(seconds), trace_on == "1", t0=T0,
                                device="cpu", ranks=group)
    finally:
        workers.close()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
