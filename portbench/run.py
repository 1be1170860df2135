"""The benchmark's command: one run of one cell on the card.

    python3 -m portbench.run --workload dragon_spatial_2M.episodes \\
        --seed 2147483659 --seconds 20 --trace 0

Prints the run's context and, last, each number compared beside its
limit on standard error, and one JSON line as the last line of standard
output: ``correct``, ``attempted`` (calls of the system in the window),
``failed`` (compared chunks with a number beyond its limit), ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``.  Without a card, or with fewer cards than the cell asks for,
it exits 2 and prints no result.  A cell on more than one card runs one
process a card: this one is rank 0 and prints the line, and starts the
others (``workers.py``) before it imports torch, so that their imports
and its own overlap.  The program's bake cache is
``portbench/.cache/bake`` (``PSYS_BAKE_CACHE``), the reference's
``portbench/.cache/reference_bake``; the kernels build into ``build/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# no torch yet: a cell on several cards starts its workers first
from portbench import workers as workers_  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_limit() -> str:
    """The card's name, power limit and draw, SM clock and its maximum, and
    temperature, as ``nvidia-smi`` reads them after the window."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
                            "clocks.sm,clocks.max.sm,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["PSYS_BAKE_CACHE"] = os.path.join(REPO, "portbench", ".cache", "bake")
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    need = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    # ranks 1 to need - 1 import alongside this process; every return
    # below ends them
    workers = workers_.Workers(need, bench, args.workload, os.path.join(REPO, "portbench"),
                               args.seed, bool(args.trace), "cuda") if need > 1 else None
    try:
        import importlib.util

        import torch

        from portbench import harness, ranks

        found = importlib.util.find_spec(harness.guard.PROGRAM)
        if found is None or not os.path.abspath(found.origin).startswith(
                harness.REPO + os.sep):
            harness.log(f"[portbench] the program {harness.guard.PROGRAM} is not in this "
                        f"checkout ({harness.REPO}): found {found and found.origin}")
            return 2
        spec = harness.cell(bench, args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            harness.log(f"[portbench] {args.workload} needs {need} CUDA device(s); this "
                        f"machine has "
                        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        bad = harness.guard.reference_imports_bad()
        if bad:
            harness.log(f"[portbench] the reference imports what it must not: {bad}")
            return 2
        group = ranks.join(workers, "cuda") if workers else None
        line = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), t0=T0,
                                ranks=group)
    finally:
        if workers:
            workers.close()
    bad = harness.guard.loaded_forbidden()
    if bad:
        harness.log(f"[portbench] loaded in this process: {bad}")
        return 3
    harness.log(f"[portbench] card: {card_limit()}")
    for name, c in line["checks"].items():
        harness.log(f"[portbench] check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
