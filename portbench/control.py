"""The readings that the limit of ``correct`` is set from, on the card at
a cell's own size: for each seed, one episode of the program from that
seed's spawn, in the mix's calls, and on each chunk that a run compares
(``harness.chunk_plan``):

  * the program's reading against the plain reference (float32): the
    numbers of ``harness.judge`` (the widest gap of the lanes in no
    contact, the lanes in contact beyond the tolerance) and the lanes
    that differ in any bit;
  * the control's reading: the reference itself, computed in bfloat16
    (the nearest precision below the configuration's float32), in the
    program's place, judged the same way;
  * the witness's reading: the reference computed in float64 in the
    program's place, which differs from the float32 reference by
    rounding alone, as a change of a kernel's rounding (a fused
    multiply-add, another order of a sum) would.

    python3 -m portbench.control --workload dragon_spatial_2M.episodes \\
        --seeds 1 2 3

One JSON line per seed on standard output.  The benchmark's own runs do
not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ["PSYS_BAKE_CACHE"] = os.path.join(harness.CACHE, "bake")
    w, cfg, mix, _, _ = harness.cell(harness.load_bench(), args.workload)
    dev = torch.device(args.device)
    chunk = mix["chunk_steps"]
    sc = harness.build_scene(cfg)
    system = harness.load_system(cfg, sc, dev)
    ref = harness.load_reference(cfg, sc, dev)
    low = harness.load_reference(cfg, sc, dev, dtype=torch.bfloat16)
    wit = harness.load_reference(cfg, sc, dev, dtype=torch.float64)
    tol, dt = cfg["limits"]["gap_tolerance"], float(cfg["sim"]["dt"])
    harness.log(f"[control] {w['name']}: set up in {time.perf_counter() - T0:.1f} s")
    for seed in args.seeds:
        t = time.perf_counter()
        per, compare, _ = harness.chunk_plan(mix, seed, False)
        sp, spawn_t = harness.build_spawn(cfg, seed, dev)
        n = sp["n_real"]
        state = system.state(**spawn_t)
        ins, outs = {}, {}
        for i in range(max(compare) + 1):
            if i in compare:
                ins[i] = {k: getattr(state, k).clone() for k in harness.STATE_KEYS}
            state, _ = system.run(state, chunk)
            if i in compare:
                outs[i] = {k: getattr(state, k).clone() for k in harness.STATE_KEYS}
        rec = {"seed": seed, "tolerance": tol}
        for i in compare:
            src = dict(ins[i], radius=spawn_t["radius"], restitution=spawn_t["restitution"])
            good = ref.run(src, chunk)
            row = {}
            for name, got in (("program", outs[i]), ("control", low.run(src, chunk)),
                              ("witness", wit.run(src, chunk))):
                got = {k: got[k] for k in harness.STATE_KEYS}
                free_gap, far, contact = harness.judge(got, good, ins[i]["collisions"],
                                                         n, dt, tol)
                off, gap = harness.lanes_off(got, good, n)
                row[name] = {"free_gap": free_gap, "contact_far": far, "contact": contact,
                             "lanes_off": off, "widest_pos_gap": gap}
            rec[f"chunk{i}"] = row
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
