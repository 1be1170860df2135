#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

On a host with several cards phase 9 adds a run over NCCL across them.

Phases (each raises on failure; nothing is caught and passed over):
  1. print the card (nvidia-smi name and power limit), the torch and CUDA
     versions, and build the five CUDA sources of ops/cuda/csrc (ptxas
     usage by kernel; B1's worklist collide kernel's and B3's worklist
     kernel's occupancy and instructions per candidate from the SASS,
     ``sass_counts``, for B3 also those of a candidate that fails the
     contact test); bake
     DragonScene's four cameras (1920 x 1080, corner normals) on the host
     into the disk cache, one spawned worker process per camera not yet
     there (``prebake``), for phases 5, 8 and 10;
  2. drive the spatial main path: the persistent sorted episode runner of
     the spatial method on DragonScene at 1,048,576 particles (128^2 x 64
     layers), cells lookup "kernel", resort_every "auto", 700 steps from
     spawn, its step captured as CUDA graphs and replayed; print host
     reads per step (steps 1-151, 151-700); check no NaN on active lanes,
     sentinels intact, collisions > 0, overflow in steps 600-700, and each
     kernel launched as a runner step launches it (launch counters, which
     count replays, reset just before; every call is made with stats, so
     the runner replays its stamped graphs, and the telemetry kernels'
     launches, counted apart, must be five stamps a step); then run the same 700 steps with
     capture off (``uncaptured``) and hold the final state and the
     overflow sequence bit for bit against the captured run;
  3. on the states at step 650 and at step 700 (denser), hold each of
     its kernels against its plain PyTorch version at the main path's
     shapes (cells lookup; window kernel at the main window and at the
     rescue window over the host-looped rescue's whole phase-1 order, the
     full Morton-compacted order, which no step launches any more; the
     worklist entry point on the lanes the rescue lists, every overflow
     lane, every lane checked, and at step 650 with no lane listed), and
     the window kernel on a chunk of 8,192 lanes of the phase-1 order,
     which splits each row over several blocks (``row_split``, as every
     launch with fewer rows than two per SM: the k = 0 rung, the
     host-read rescue's chunks); print how the candidates are spread
     over lanes and rows;
  4. time each (CUDA events around one call, median of 20, and device
     time from torch.profiler) and its plain version, with the bound of
     each case; run steps 600-700 once more with the
     dense-cell demotion off and print ms/step and overflow beside the
     default's (a reading; the default is unchanged);
  5. drive the hybrid path (``drive_hybrid``) on the same scene and
     spawn: load "Main Camera"'s bake,
     run the hybrid persistent runner 700 steps (cells lookup "kernel",
     resort_every "auto"; launch counters reset just before), print the
     undecided share, host reads and overflow, and check it as phase 2
     does, with the undecided share at step 700 strictly between 0 and
     1, the screen-space kernel launched once a step, and host reads per
     step beside the spatial runner's (steps
     600-700 with stats: six stamps and one undecided count a step, and
     the ring's undecided counter of step 600 equal to the stage's
     undecided real lanes recounted on its input); run the
     screen-space method 700 steps at the same width; print the three
     methods' collisions; hold B1 (masked main plan, the phase-1 order), the
     worklist entry point and B2 against their plain versions on the
     hybrid state at step 650 and time them; hold 20 runner steps from
     step 600 against 20 steps of make_hybrid_step_sorted;
  6. drive the particle-particle main path (``drive_p2p``): 1,000,000
     particles in the 160 x 80 x 160 gravity box of bench/configs.py
     config 4, 200 steps of make_p2p_step (variant "auto", which must
     resolve to "kernel"; a captured CUDA graph from the second step) and
     50 steps of make_p2p_episode_runner (captured, after two warm
     steps), both on the window kernel's entry point that plans in the
     kernel and its worklist entry point (the fallback sized on the
     device); launch counters reset just before each; check every lane
     finite and inside the box, contacts > 0, each entry point launched
     once per step, no host read; the overflows of the steps read once;
     the same steps uncaptured (``uncaptured``) equal bit for bit, states
     and overflow sequences, ms/step of both; the runner once more at
     window 128, where lanes overflow, captured equal to uncaptured; the
     settled box: the runner (window 512) from spawn to step 1,500, the
     box settled into a pile, steps 1,400-1,500 timed, its overflow lanes
     a step read once, contacts, no host read; on the state at step 100
     hold the three entry points of the kernel (plan in the kernel;
     explicit plan arrays from ops/p2p_plan.py; the worklist over the
     overflow lanes, also against the host-looped fallback) against their
     plain versions on every lane (window 512, and 128 where lanes
     overflow), the overflow mask included, the worklist also over every
     97th lane of the window-128 list and over its first lane alone, and
     on the settled box's state at step 1,500 at windows 512 and 128; and
     p2p_collide_window against p2p_collide_sorted; time all three, the
     worklist in each of its cases, and print its launches on the
     settled run times its device time less its bound;
  8. (after 6, in the same process) drive the port's command line
     (``drive_cli``), every sub-step through ``cli.main`` with the default
     device (CUDA), checked and timed: ``bench`` of the three methods on
     DragonScene at 1,048,576 particles, camera 0, 200 steps (full width,
     depth cut from 2001), with the accuracy CSV (three perf-CSV blocks of
     199 rows, three accuracy blocks of 1,048,576 rows, summary totals
     equal to the printed results and to the accuracy blocks, B1 and B2
     launched); ``bench --per-step`` of the spatial method, 50 steps (the
     non-persistent ``make_method_step`` path, each step launching each
     kernel as a runner step does), then that step over 20 steps from spawn and
     from step 650 with its rescue and with the host-looped one in its
     place (ms/step and host reads, states equal bit for bit; a
     reading); ``simulate`` of the
     spatial method, 100 steps, with a checkpoint that must equal a fresh
     run's ``snapshot`` bit for bit; ``p2pbox`` at 1,000,000 particles, 50
     steps (B3 and its worklist entry point once per step).  Then, on the spatial state at step 650,
     the oracle steps: "stream" against "packed" on every lane (hits equal
     but for near ties, counted), "dense" against "stream" on the 65,536
     active lanes whose cells hold the most candidates, brute force
     against "stream" on 4,096 lanes (the hit lanes first); and the
     ``ResilientRunner`` over 200 sorted steps with one injected device
     loss, equal bit for bit to an uninterrupted run.  The launches of
     each command go into the kernel line as ``launches_cli``;
  9. (after 8, in ranks spawned by ``parallel/dryrun.py::run_ranks``, so
     no rank builds a kernel; ``drive_mesh``) the multi-device paths from
     the main path's state at step 600: world 1 over NCCL, then 2 ranks
     sharing the one card over gloo (the exchange staged through host
     memory; not a multi-GPU number), then, where there are at least two
     cards, min(4, cards) ranks over NCCL.  In each: the spatial runner
     with ``mesh=`` over steps 600-650 (a warm pass, then the timed pass,
     which must repeat it bit for bit), gathered and held bit for bit
     against the single-device runner on all 1,048,576 lanes, both
     overflow sums printed, with each rank's host reads per step (the
     re-sort flag of the overflow summed on the device), its host integer
     sums (none) and whether its step was captured (over NCCL; not over
     gloo); in every rank B1 (main window) and B2 against
     their plain versions on the rank's state at step 650; config 5, 5
     timed steps (500,000 particles per rank), every particle kept and no
     halo or migration overflow.  Each rank's launches on the mesh
     runner go into the kernel line as ``launches_mesh``.  Then one
     spawn of 3 ranks on the card (``_first_ranks_rank``), meshes over
     the first n of them as the JAX package's ``make_mesh(n)`` takes the
     first n devices: over rank 0 alone (its group on NCCL, the runner
     captured with the all-reduce inside the graph, though the world is
     gloo), then over ranks 0-1 (gloo, sharing the card); each runs the
     spatial runner with ``mesh=`` over steps 600-650 (warm pass, then
     the timed pass, which must repeat it bit for bit), gathered and held
     bit for bit against the single-device runner on every lane, B1 and
     B2 against their plain versions on each member's state at step 650,
     each kernel launched; then config 5 on the first 2 of the 3 ranks,
     every particle kept; rank 2 sits out every mesh and exits 0.  Last,
     the ``parallel/dryrun.py`` entry point on the card with 2 ranks, and
     on the first 2 of 3 ranks;
 10. (after 9; ``drive_protocol``) the reference protocol's particle ladder
     through ``bench/protocol.py::run_protocol`` on DragonScene, plan
     "kernel", no accuracy CSV, launch counters reset just before each
     sweep: (a) k = 7, 2,097,120 particles (the reference cap; 32 sentinel
     lanes), the three methods on "Main Camera", 2001 steps: rows,
     collisions, ms/step by window; through a tap on the harness's runner
     of the spatial episode (``_EpisodeTap``), that episode's last state
     (no NaN, sentinels inert and never a live lane of the plan), its
     overflow per step, its host reads and launches per step over steps
     1400-2001, and on its state at step 1500 B1 (main, rescue phase 1,
     the 8,192-lane chunk), the worklist entry point and B2 against their
     plain versions, the screen-space kernel on "Main Camera" against
     its plain version (``screenspace_case``: both entry points, every
     lane bit for bit, timed beside its byte bound), and one step of the
     runner (replayed) against one of
     the per-step step with the rescue looped on the host
     (``_chunked_rescue``, a test and smoke helper) in place of its own,
     every lane; then ``rescue_route``: the spatial episode in the
     benchmark's 87-step calls by the runner, every overflow lane listed
     on every step, and the rescue at a free-fall step, step 1500 and the
     step with the most overflow lanes, eager and replayed, equal there
     to the host-looped rescue and timed (CUDA events), and at each of
     them the rescue's front against its plain version
     (``rescue_front_case``: the list, the counts, (start, count) at the
     listed lanes and the fit mask, bit for bit; timed beside its byte
     bound); (b) k = 0, the three
     methods on all four cameras, 50 steps: a row for each, and each
     camera's undecided mask on the k = 7 state (active lanes, and the
     falling sentinels, which must stay out of the hybrid's plan).  The
     launches go into the kernel line as the ":protocol" entries.  The
     tapped episode runs with stats (five stamps a step, counted); on
     "Main Camera"'s undecided mask of the k = 7 state at step 2001
     (2,097,152 lanes, sentinels among them) the telemetry kernels are
     held against their plain versions (``telemetry_case``: the count of
     undecided real lanes, and a step's last stamp with the overflow and
     the worklist's lane count of step 1500) and timed;
 11. (after 10; ``drive_headline``) the headline benchmark: ``python -m
     ….bench.headline`` in its own process at its defaults (DragonScene at
     1,048,576 particles, 151 steps, the settled probe over 620 + 100
     steps), its one stdout line checked and printed with the settled
     ms/step; ``headline()`` again in this process under torch.profiler,
     launch counters reset just before (each kernel as a runner step
     launches it, equal to the profiler's count when its trace is not
     empty; they go into the kernel line as ``launches_headline``), the
     runner's host reads per step, and from the trace the device's busy
     and elapsed ms per timed step; the settled probe's state at step 620
     (window 2048, a re-sort every 12 steps, no host read) held bit for
     bit against the main path's runner from its state at step 600, and
     B1 at window 2048 and B2 against their plain versions on it
     (``settled_probe`` in their entries);
  7. print the kernel table as one JSON line (``ms`` is the events
     reading, ``device_ms`` the profiler's, null where its device trace
     came back empty; the hybrid path's entries carry "path": "hybrid";
     every ``launches`` is a counter's reading: B1's main entry counts its
     main launches, its phase-1 entry the launches at the rescue window
     (``window_collide_sorted_rescue``, 0 on every path), and nests the
     8,192-lane chunk's numbers;
     the explicit-plan entry point of the p2p kernel, which no main path
     launches, and its worklist entry point are listed under that
     kernel's entry; the screen-space kernel, "path": "hybrid", with its
     launches on the hybrid path (one a step), the main path (none) and
     the k = 7 protocol; the rescue's front, with its launches on the
     main, hybrid, protocol, CLI, mesh and headline paths (one a sorted
     step), its k = 7 free-fall case nested; the telemetry kernels,
     "path": "telemetry", last, with their launches on the main, hybrid
     and k = 7 paths).
The last line is {"ok": true, "device": {...}}.  Exits non-zero (and
prints no result) without CUDA or without the port's package beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import types

N_STEPS = 700
SNAP_STEP = 650
# lanes of the window-kernel case on a chunk of the phase-1 order (64
# rows: split over several blocks a row)
RESCUE_CHUNK = 8192
# phase 2's runner calls: step 0, steps 1-151, 151-600, 600-650, 650-700
PHASE2_CALLS = (1, 150, 449, 50, 50)
# a sorted step's launches by wrapper (cells lookup "kernel"): B2, B1's
# main launch, the rescue's front (the list), the worklist entry point
# (every overflow lane); B1 at the rescue window never
STEP_LAUNCHES = {"cells_window_lookup": 1, "window_collide_sorted": 1,
                 "window_collide_sorted_rescue": 0, "window_collide_worklist": 1,
                 "rescue_front": 1}
REPS = 20
PROFILER_TRIES = 3
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM
# float operations of the window kernel (csrc/window_kernel.cu), each
# add, multiply, divide, square root, comparison and select counted as
# one: per candidate triangle, and per lane outside the candidate loop
WINDOW_OPS_PER_CANDIDATE = 550
WINDOW_OPS_PER_LANE = 100
# rtol/atol for kernel vs plain: exact agreement is expected (same
# operations, --fmad=false, IEEE division and sqrt), so any lane outside
# this is a fault
RTOL, ATOL = 1e-6, 1e-5
JAX_KERNELS = "particlesystemhybridcollisiondetection_tpu/ops/pallas/window_kernel.py"
JAX_P2P_KERNEL = "particlesystemhybridcollisiondetection_tpu/ops/pallas/p2p_window_kernel.py"
JAX_P2P_FALLBACK = "particlesystemhybridcollisiondetection_tpu/ops/p2p_sorted.py"
PORT_CSRC = "particlesystemhybridcollisiondetection_tpu_torch/ops/cuda/csrc/"

# the particle-particle path: bench/configs.py config 4
P2P_N = 1_000_000
P2P_BOX = ((0.0, 0.0, 0.0), (160.0, 80.0, 160.0))
P2P_STEPS, P2P_SNAP_STEP, P2P_RUNNER_STEPS = 200, 100, 50
P2P_SMALL_WINDOW = 128  # small enough that lanes overflow their window
# the settled box: the box has settled into a pile by step 1,500 (the
# spawn fills y in [40, 80]; the highest particle reaches the pile near
# step 800); steps 1,400-1,500 timed
P2P_SETTLED_STEP, P2P_SETTLED_TIMED = 1500, 100
P2P_SPARSE_STRIDE = 97  # the sparse list: every 97th lane of the window-128 list
# phase 8, the command line at full width (DragonScene, 128^2 x 64 =
# 1,048,576 particles; depth cut to 200 steps for bench, 50 for --per-step,
# 100 for simulate) and the oracle steps on the state at step 650
CLI_LAYERS = 64
# steps of the per-step step's reading with each rescue (phase 8)
PER_STEP_READING_STEPS = 20
CLI_STEPS, CLI_PER_STEP_STEPS, CLI_SIM_STEPS, CLI_P2P_STEPS = 200, 50, 100, 50
CLI_DENSE_LANES = 65_536  # [N, K] f32 at K = 483 is 2 GB per temporary at 1M
CLI_BF_LANES = 4_096  # each against all 397,688 triangles
CLI_RESILIENT_STEPS, CLI_RESILIENT_FAIL_AT = 200, 120
# float operations of the p2p window kernel (csrc/p2p_window_kernel.cu),
# counted as above: per candidate, and per lane outside the loop (the
# mass and the six final adds)
P2P_OPS_PER_CANDIDATE = 53
P2P_OPS_PER_LANE = 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _demangle(mangled: str) -> str:
    """The kernel's name in a mangled symbol of the csrc sources (an
    anonymous namespace, then the name; a bool template argument as <0>
    or <1>)."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    tail = rest[m.end() + int(m.group(1)):]
    t = re.match(r"ILb(\d)E", tail)
    return name + (f"<{t.group(1)}>" if t else "")


def ptxas_usage(log: str) -> list:
    """(kernel, "registers, spills, shared memory") of each entry function
    in an nvcc build's ``-Xptxas -v`` report."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = _demangle(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            out.append((kernel, f"{line.split(':', 1)[1].strip()}; {spills}"))
            kernel = None
    return out


# SASS opcodes that run on the FP32 and special-function pipes
SASS_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET", "MUFU"}


def sass_counts(build, source: str, kernel: str, test_path: bool = False) -> dict:
    """Instructions per candidate of a kernel's walk, from the built
    library's SASS (``cuobjdump -sass``): the body of the innermost loop
    that holds special-function (MUFU) instructions -- the walk over the
    candidates, one an iteration -- counted statically: FP32 and MUFU
    instructions, MUFU alone, and all; with ``test_path``, also ``test``,
    the instructions a candidate that fails the contact test runs (the
    loop's head to its first forward conditional branch, the test's exit,
    then that branch's target to the loop's end).  The IEEE division and square root slow paths are
    subroutines outside the loop (their call sites count among "all").
    {} when cuobjdump is missing."""
    import re

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("cuobjdump not found: SASS not counted", file=sys.stderr)
        return {}
    sass = subprocess.run([tool, "-sass", build._paths(source)[1]],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    for body in sass.split("Function : ")[1:]:
        if _demangle(body.split()[0]) != kernel:
            continue
        ins = []  # (address, opcode, predicated, text)
        for line in body.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                raw = m.group(2).strip()
                text = re.sub(r"^@!?U?P\w+\s+", "", raw)
                ins.append((int(m.group(1), 16), text.split()[0].split(".")[0],
                            text != raw, text))
        loops = []
        for addr, op, _, text in ins:
            target = text.split()[-1]
            if op == "BRA" and target.startswith("0x") and int(target, 16) < addr:
                loop = [x for x in ins if int(target, 16) <= x[0] <= addr]
                if any(x[1] == "MUFU" for x in loop):
                    loops.append(loop)
        loop = min(loops, key=len)
        ops = [x[1] for x in loop]
        counts = {"fp32": sum(op in SASS_FP32 for op in ops), "mufu": ops.count("MUFU"),
                  "all": len(ops)}
        text = ""
        if test_path:
            exit_at = next(i for i, x in enumerate(loop) if x[1] == "BRA" and x[2]
                           and x[3].split()[-1].startswith("0x")
                           and int(x[3].split()[-1], 16) > x[0])
            rejoin = int(loop[exit_at][3].split()[-1], 16)
            counts["test"] = exit_at + 1 + sum(x[0] >= rejoin for x in loop)
            text = f"; a candidate that fails the test: {counts['test']}"
        print(f"  SASS {kernel}, per candidate (its walk loop, static): "
              f"{counts['fp32']} FP32 instructions ({counts['mufu']} MUFU) of "
              f"{counts['all']}{text}")
        return counts
    raise RuntimeError(f"{kernel} is not in the SASS of {source}")


def median_ms(torch, fn) -> float:
    fn()  # warm
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return (times[REPS // 2 - 1] + times[REPS // 2]) / 2.0


def device_ms(torch, fn):
    """Device time of one call of ``fn``: the summed device time of every
    CUDA kernel it launches (torch.profiler over REPS calls; each
    wrapper launches each of its kernels once a call, so a kernel's time
    per call is its mean over the launches the trace holds, which stays
    right if the trace misses some), without the host's gaps between
    them.  Returns (ms, {kernel name: ms}, {kernel name: launches in the
    trace}).  CUDA events around one call of a wrapper (``median_ms``)
    also count the host's time between its launches, which is most of
    the reading once a kernel takes under ~0.1 ms.

    The profiler's device tracing can come back empty (it depends on CUPTI,
    which a machine may withhold from one session and grant the next).  Then the session is tried again, and after PROFILER_TRIES empty
    sessions the reading is (None, {}): not measured.  The events reading
    ``ms`` does not depend on it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if seen:
            rows = {e.key: e.self_device_time_total / 1000.0 / e.count for e in seen}
            return sum(rows.values()), rows, {e.key: e.count for e in seen}
    print("  torch.profiler reported no device time in "
          f"{PROFILER_TRIES} sessions: device time not measured", file=sys.stderr)
    return None, {}, {}


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def timed(torch, fn, plain_fn) -> dict:
    """The timing keys of a kernel-table entry: ``ms`` is CUDA events
    around one wrapper call (``median_ms``), ``device_ms`` the device time
    of that call, ``plain_ms`` the events around the plain version."""
    ms = median_ms(torch, fn)
    plain_ms = median_ms(torch, plain_fn)
    dev_ms, rows, counts = device_ms(torch, fn)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "by_kernel": (rows, counts)}


def short_kernel(key: str) -> str:
    """A kernel's name in the profiler's table without its signature."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0][-32:]


def by_kernel(rows_counts) -> str:
    """'name ms (launches in the trace of REPS calls)' of the kernels of
    one call, longest first."""
    rows, counts = rows_counts
    if not rows:
        return "no kernel times"
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:4]
    return ", ".join(f"{short_kernel(k)} {v:.4f} ({counts[k]}/{REPS})" for k, v in top)


def check_runner_launches(tag: str, launches: dict, steps: int) -> None:
    """A sorted step's launches over ``steps`` steps (``STEP_LAUNCHES``)."""
    want = {k: v * steps for k, v in STEP_LAUNCHES.items()}
    if launches != want:
        raise RuntimeError(f"{tag}: launches {launches}, want {want}")


def launch_fault(launches: dict) -> bool:
    """Whether a sorted path's launch counts (over some steps) miss a
    kernel of its step, or hold a launch that its step never makes
    (``STEP_LAUNCHES``)."""
    return any((n > 0) != (STEP_LAUNCHES[k] > 0) for k, n in launches.items())


def check_telemetry_launches(tag: str, launches: dict, stats_steps: int,
                             hybrid: bool) -> None:
    """The telemetry kernels' launches (``telemetry_kernel.LAUNCHES``,
    counted apart from the step's own, which ``check_runner_launches``
    holds) over ``stats_steps`` steps of ``with_stats`` calls: a stamp at
    each stage boundary, five a step and six with the hybrid's
    screen-space stage, and the hybrid's undecided count once a step."""
    want = {"stamp": (5 + hybrid) * stats_steps, "count_undecided": hybrid * stats_steps}
    if launches != want:
        raise RuntimeError(f"{tag}: telemetry launches {launches}, want {want}")


def telemetry_case(torch, card: str, tag: str, und, x, n_over, n_lanes) -> dict:
    """The telemetry kernels against their plain versions on a real
    undecided mask (``und``, bool[N]; ``x``, the position row that tells
    real lanes from sentinels): the count of undecided real lanes, exact;
    a step's last stamp, whose counter copies (the window overflow
    ``n_over``, that count, rescue phase 2's ``n_lanes``), zeroed
    accumulator and advanced row must equal the plain version's; each
    timed.  Returns the kernel-table numbers of each kernel."""
    from particlesystemhybridcollisiondetection_tpu_torch.core.telemetry import (
        COUNTERS, STAMPS,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        telemetry_kernel as tk,
    )

    acc = torch.zeros((), dtype=torch.int32, device=x.device)
    tk.count_undecided(und, x, acc)
    acc_p = torch.zeros((), dtype=torch.int32)
    tk.count_undecided_plain(und.cpu(), x.cpu(), acc_p)
    real = x.abs() < tk.REAL_BOUND
    # a ring of 4 rows with the step counter at 5: the stamps go to row 1
    at, end = len(STAMPS), STAMPS.index("end")
    rings = [torch.full((4, at + len(COUNTERS)), -1, dtype=torch.int64, device=d)
             for d in (x.device, "cpu")]
    steps = [torch.full((1,), 5, dtype=torch.int32, device=d) for d in (x.device, "cpu")]
    accs = [acc.clone(), acc_p.clone()]
    scalars = [(n_over, n_lanes), (n_over.cpu(), n_lanes.cpu())]
    for stamp, ring, step, a, (o, n) in zip((tk.stamp, tk.stamp_plain), rings, steps,
                                             accs, scalars):
        stamp(ring, step, 0)
        stamp(ring, step, end, counters_at=at, n_over=o, undecided=a, n_lanes=n)
    got, want = rings[0].cpu(), rings[1]
    stamps_ok = bool(torch.equal(got[:, :at] >= 0, want[:, :at] >= 0)
                     and 0 < got[1, 0] <= got[1, end])
    print(f"[{card}] telemetry kernels ({tag}, {x.shape[0]} lanes): undecided real "
          f"lanes {int(acc)} (plain {int(acc_p)}; {int(und.sum())} undecided, "
          f"{int(real.sum())} real); the last stamp's counters "
          f"{got[1, at:].tolist()} (plain {want[1, at:].tolist()}), step counter "
          f"{int(steps[0])} (plain {int(steps[1])}), accumulator {int(accs[0])} "
          f"(plain {int(accs[1])}), stamps in the right slots and rising: {stamps_ok}")
    if int(acc) != int(acc_p) or int(acc) != int((und & real).sum()):
        raise RuntimeError(f"{tag}: the undecided count kernel disagrees with its "
                           "plain version")
    if not (torch.equal(got[:, at:], want[:, at:]) and int(steps[0]) == int(steps[1]) == 6
            and int(accs[0]) == int(accs[1]) == 0 and stamps_ok):
        raise RuntimeError(f"{tag}: the stamp kernel's counters disagree with its "
                           "plain version's")
    count = timed(torch, lambda: tk.count_undecided(und, x, acc),
                  lambda: tk.count_undecided_plain(und, x, acc))
    stamp = timed(torch, lambda: tk.stamp(rings[0], steps[0], 0),
                  lambda: tk.stamp_plain(rings[1], steps[1], 0))
    for name, t in (("undecided count", count), ("stamp", stamp)):
        print(f"[{card}] {name} kernel ({tag}): {t['ms']:.4f} ms by events around "
              f"the call, {ms_text(t['device_ms'])} on the device; plain "
              f"{t['plain_ms']:.4f} ms")
    return {"count": {"max_abs_err": 0, **count}, "stamp": {"max_abs_err": 0, **stamp}}


def screenspace_case(torch, card: str, tag: str, state, tex, gravity, dt: float) -> dict:
    """The screen-space kernel against its plain version (run on the
    card) on ``state``: both entry points, the hybrid and the
    screen-space-only pass out of place and the runner's pass in place
    on a copy of its [8, N] rows, every lane bit for bit (pos, vel,
    count, mask; raises on any difference), the in-place pass leaving
    every lane that does not collide unwritten; then the in-place pass
    timed (the runner's) and the out-of-place one, with the plain
    version's time and the byte bound.  Returns its kernel-table
    numbers."""
    from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as ss

    def bits(t):
        return t.view(torch.int32)

    n = state.pos.shape[-1]
    differ = {}
    for hybrid in (True, False):
        want, want_und = ss.screen_space_collide_plain(state, tex, gravity, dt,
                                                       hybrid=hybrid)
        got, und = ss.screen_space_collide(state, tex, gravity, dt, hybrid=hybrid)
        differ["hybrid" if hybrid else "screen-space only"] = int(
            ((bits(got.pos) != bits(want.pos)).any(0) | (bits(got.vel) != bits(want.vel)).any(0)
             | (got.collisions != want.collisions) | (und != want_und)).sum())
        if hybrid:
            ref, ref_und = want, want_und
    rows8 = torch.cat([state.pos, state.vel, state.radius[None], state.restitution[None]])
    rows0, coll = rows8.clone(), state.collisions.clone()
    und = torch.ones((n,), dtype=torch.bool, device=rows8.device)
    ss.screen_space_collide_rows(rows8, coll, und, tex, gravity, dt)
    hit = coll != state.collisions
    differ["in place"] = int(
        ((bits(rows8[0:3]) != bits(ref.pos)).any(0) | (bits(rows8[3:6]) != bits(ref.vel)).any(0)
         | (coll != ref.collisions) | (und != ref_und)).sum())
    untouched = bool(torch.equal(bits(rows8[:, ~hit]), bits(rows0[:, ~hit]))
                     and torch.equal(bits(rows8[6:8]), bits(rows0[6:8])))
    hits = int(hit.sum())
    # the lanes that gather a texel: visible (on screen, in front) and moving
    pos = state.pos
    view_pos = ss._transform(tex.view, pos, 1.0)
    clip = ss._transform(tex.proj, view_pos[:3], view_pos[3])
    sx, sy = clip[0] / clip[3] * 0.5 + 0.5, clip[1] / clip[3] * 0.5 + 0.5
    in_front = (tex.cam_fwd[:, None] * (pos - tex.cam_pos[:, None])).sum(0) > 0
    gather = int(((sx >= 0) & (sx <= 1) & (sy >= 0) & (sy <= 1) & in_front
                  & ((state.vel != 0).any(0))).sum())
    print(f"[{card}] screen-space kernel ({tag}, {n} lanes): lanes that differ in any "
          f"bit from the plain version: {differ}; the in-place pass leaves the "
          f"{n - hits} lanes that do not collide unwritten: {untouched}; "
          f"{hits} lanes collide "
          f"({int((ref.collisions != state.collisions).sum())} by the plain version), "
          f"{gather} gather a texel, {int(ref_und.sum())} undecided")
    if any(differ.values()) or not untouched:
        raise RuntimeError(f"screen-space kernel ({tag}) disagrees with its plain version")
    scratch = rows0.clone()
    coll_s = state.collisions.clone()
    t = timed(torch, lambda: ss.screen_space_collide_rows(scratch, coll_s, und, tex,
                                                          gravity, dt),
              lambda: ss.screen_space_collide_plain(state, tex, gravity, dt, hybrid=True))

    def oop():
        ss.screen_space_collide(state, tex, gravity, dt, hybrid=True)

    out_of_place = {"ms": median_ms(torch, oop), "device_ms": device_ms(torch, oop)[0]}
    # bound: the rows and the count read, the mask written on every lane;
    # pos, vel and the count written where a lane collides; a 16 B texel
    # where one is gathered (in place); every output written (out of place)
    n_bytes = n * (32 + 4 + 1) + hits * (24 + 4) + gather * 16
    n_bytes_out = n * (32 + 4 + 24 + 4 + 1) + gather * 16
    bound = n_bytes / H100_BYTES_PER_S * 1e3
    bound_out = n_bytes_out / H100_BYTES_PER_S * 1e3
    print(f"[{card}] screen-space kernel ({tag}), in place: {t['ms']:.4f} ms by events "
          f"around the call, {ms_text(t['device_ms'])} on the device "
          f"({by_kernel(t.pop('by_kernel'))}); plain {t['plain_ms']:.4f} ms; bound "
          f"{bound:.4f} ms (bytes: {n_bytes} B); out of place "
          f"{out_of_place['ms']:.4f} ms by events, {ms_text(out_of_place['device_ms'])} "
          f"on the device, bound {bound_out:.4f} ms (bytes: {n_bytes_out} B)")
    return {"max_abs_err": 0, **t, "bound_ms": bound, "bound_by": "bytes",
            "out_of_place": {**out_of_place, "bound_ms": bound_out}}


def lane_diff(torch, a, b) -> int:
    """Lanes (last axis) on which two tensors differ anywhere."""
    ne = a != b
    return int((ne.any(0) if ne.dim() > 1 else ne).sum())


def span_columns(torch, col0, bound, n_cols: int) -> int:
    """Distinct columns in the union of the intervals [col0, col0 + bound)."""
    live = bound > 0
    diff = torch.zeros(n_cols + 1, dtype=torch.int32, device=col0.device)
    one = torch.ones(int(live.sum()), dtype=torch.int32, device=col0.device)
    diff.index_add_(0, col0[live], one)
    diff.index_add_(0, (col0 + bound)[live], -one)
    return int((torch.cumsum(diff, 0) > 0).sum())


def sorted_plan(torch, sp, state, undecided=None):
    """Sort and plan a state as the runner's step does: the cells
    kernel's arguments, the window kernel's at the main window and at the
    rescue window over ``_chunked_rescue``'s phase-1 order (``_rescue_chunk``
    over ``_phase1_order``: the full Morton-compacted order, and its
    first 8,192 lanes, a launch of 64 rows, which ``row_split`` spreads
    over several blocks a row), the main plan's overflow mask (sorted
    order), and the worklist entry point's arguments on the lanes the
    rescue lists (every overflow lane that fits alone; the main launch's
    output, which the arguments end with).  ``undecided`` (hybrid): the
    screen-space stage's mask, which zeroes the other lanes' counts."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import (
        lookup_pos, morton_key,
    )

    cfg = sp.cfg
    nb = state.pos.shape[-1] // wk.BLOCK
    key = morton_key(lookup_pos(state.pos, state.vel, cfg.dt), sp.meta)
    key_s, perm = torch.sort(key, stable=True)
    rows = torch.cat([state.pos, state.vel, state.radius[None],
                      state.restitution[None]], dim=0)[:, perm]
    sorted_state = (rows[0:3].contiguous(), rows[3:6].contiguous(),
                    rows[6].contiguous(), rows[7].contiguous())
    kr = key_s.reshape(nb * wk.SUB, wk.LANE)
    lo = (kr.min(dim=1).values // 128) * 128
    hi = torch.clamp(((kr.max(dim=1).values - S._CODE_WC + 128) // 128) * 128, min=0)
    active_s = None if undecided is None else undecided[perm]
    rel, count, ws, k_cap, overflow, _ = S._window_plan_coded(
        key_s, sp.ctab, sp.window, nb, active_s=active_s, demote=sp.demote)
    pick = S._phase1_order(overflow, key_s)
    _, p1_state, (rel_1, cnt_1, ws_1, kcap_1, _) = S._rescue_chunk(
        sorted_state, overflow, pick, sp.tables, sp.meta, cfg, sp.rescue_window)
    _, chunk_state, (rel_c, cnt_c, ws_c, kcap_c, _) = S._rescue_chunk(
        sorted_state, overflow, pick[:RESCUE_CHUNK], sp.tables, sp.meta, cfg,
        sp.rescue_window)
    main = (*sorted_state, rel, count, ws, k_cap, sp.tables)
    out = wk.window_collide_sorted(*main, w=sp.window, k_static=sp.meta.max_tris_per_cell,
                                   gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff)
    start, count_2, fit = S._phase2_plan(sorted_state, sp)
    lanes, n_lanes = wk.compact_lanes(overflow & fit)
    return ((key_s, lo, hi, sp.ctab),
            {"main": (main, sp.window),
             "rescue phase 1": ((*p1_state, rel_1, cnt_1, ws_1, kcap_1, sp.tables),
                                sp.rescue_window),
             "rescue chunk": ((*chunk_state, rel_c, cnt_c, ws_c, kcap_c, sp.tables),
                              sp.rescue_window)},
            overflow,
            (*sorted_state, start, count_2, lanes, n_lanes, sp.tables, *out))


def b1_vs_plain(torch, args, w, kw) -> dict:
    """The window kernel against its plain version on one case: active
    lanes whose hit differs, lanes outside rtol/atol, active lanes that
    differ in any bit, the largest difference, and the kernel's hits."""
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    pk, vk, hk = wk.window_collide_sorted(*args, w=w, **kw)
    pp, vp, hp = wk.window_collide_sorted_plain(*args, w=w, **kw)
    torch.cuda.synchronize()
    act = torch.abs(args[0][0]) < 5e37
    close = (torch.isclose(pk, pp, rtol=RTOL, atol=ATOL).all(0)
             & torch.isclose(vk, vp, rtol=RTOL, atol=ATOL).all(0))
    return {"hit_bad": int(((hk != hp) & act).sum()), "far": int((~close).sum()),
            "bits": lane_diff(torch, pk[:, act], pp[:, act])
            + lane_diff(torch, vk[:, act], vp[:, act]),
            "err": max(float(torch.abs(pk - pp)[:, act].max()),
                       float(torch.abs(vk - vp)[:, act].max())),
            "hits": int(hk.sum())}


def b2_vs_plain(torch, b2_args) -> dict:
    """The cells kernel against its plain version: lanes that differ (the
    start only where the plain version hit) and the misses."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    start_k, count_k = wk.cells_window_lookup(*b2_args, wc=S._CODE_WC)
    start_p, count_p = wk.cells_window_lookup_plain(*b2_args, wc=S._CODE_WC)
    torch.cuda.synchronize()
    hit_cnt = count_p >= 0
    return {"bad": int((count_k != count_p).sum()
                       + ((start_k != start_p) & hit_cnt).sum()),
            "misses": int((~hit_cnt).sum())}


def window_case(torch, card: str, sp, tag: str, args, w: int) -> dict:
    """One window-kernel case on the plan of ``sp`` (``sorted_plan``'s
    tables and constants): candidate spread, agreement with the plain
    version (raises on any difference), times and bound.  Returns its
    kernel-table numbers."""
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    cfg = sp.cfg
    kw = dict(k_static=sp.meta.max_tris_per_cell, gravity=cfg.gravity,
              dt=cfg.dt, backoff=cfg.backoff)
    rel, count, ws, k_cap = args[4:8]
    m = args[0].shape[1]
    ws_l = ws.reshape(-1).repeat_interleave(wk.LANE)
    kb = torch.clamp(k_cap, max=sp.meta.max_tris_per_cell).repeat_interleave(wk.BLOCK)
    bound = torch.clamp(torch.minimum(torch.minimum(count, kb), w - rel), min=0)
    n_cand = int(bound.sum())
    row_sum = bound.reshape(-1, wk.LANE).sum(dim=1)
    split = wk.row_split(m, torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"[{card}] B1 {tag} (w={w}, N={m}, {m // wk.LANE} rows x {split} "
          f"blocks): candidates per lane max {int(bound.max())}, 99.9th "
          f"percentile {float(torch.quantile(bound.float(), 0.999)):.1f}, mean "
          f"{float(bound.float().mean()):.4f}; per row max {int(row_sum.max())}, "
          f"mean {float(row_sum.float().mean()):.2f}, rows with candidates "
          f"{int((row_sum > 0).sum())}; total {n_cand}")

    c = b1_vs_plain(torch, args, w, kw)
    err = c["err"]
    print(f"[{card}] B1 {tag} vs plain: hit differs on {c['hit_bad']} active "
          f"lanes, pos/vel differ in any bit on {c['bits']} active lanes, "
          f"outside rtol={RTOL} atol={ATOL} on {c['far']} lanes, max |diff| "
          f"{err:.3e}, hits {c['hits']}")
    if c["hit_bad"] or c["far"] or c["bits"]:
        raise RuntimeError(f"window kernel ({tag}) disagrees with its plain version")

    t = timed(torch, lambda: wk.window_collide_sorted(*args, w=w, **kw),
              lambda: wk.window_collide_sorted_plain(*args, w=w, **kw))
    # bound: lane inputs and outputs, every distinct candidate row once
    # (36 B), and the float operations of the candidates evaluated
    n_rows = span_columns(torch, (ws_l + rel).long(), bound,
                          sp.tables.pairs.shape[1])
    n_bytes = m * (12 + 12 + 4 + 4 + 4 + 4) + 4 * (m // wk.LANE) \
        + 4 * (m // wk.BLOCK) + 36 * n_rows + m * (12 + 12 + 4)
    n_ops = WINDOW_OPS_PER_CANDIDATE * n_cand + WINDOW_OPS_PER_LANE * m
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_F32_OPS_PER_S * 1e3
    print(f"[{card}] B1 {tag}: {t['ms']:.4f} ms by events around the call, "
          f"{ms_text(t['device_ms'])} on the device "
          f"({by_kernel(t.pop('by_kernel'))}); plain {t['plain_ms']:.4f} ms; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_cand} candidates, {n_rows} "
          f"distinct rows, {n_bytes} B = {bytes_ms:.4f} ms, {n_ops:.3e} ops = "
          f"{ops_ms:.4f} ms)")
    return {"max_abs_err": err, **t,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def worklist_vs_plain(torch, sp, wl_args) -> dict:
    """The worklist entry point against its plain version (each writing
    into its own copy of the main launch's output): lanes that differ in
    any bit (every lane: the unlisted ones must stay as they were), the
    largest difference, and the listed lanes' hits."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    args, outs = wl_args[:9], wl_args[9:]
    kw = S._rescue_kw(sp)
    res = []
    for fn in (wk.window_collide_worklist, wk.window_collide_worklist_plain):
        o = [x.clone() for x in outs]
        fn(*args, *o, **kw)
        res.append(o)
    torch.cuda.synchronize()
    (pk, vk, hk), (pp, vp, hp) = res
    lanes, n_lanes = args[6], args[7]
    pick = lanes[:int(n_lanes)].long()
    return {"bits": lane_diff(torch, pk, pp) + lane_diff(torch, vk, vp)
            + lane_diff(torch, hk, hp),
            "err": max(float(torch.abs(pk - pp).max()), float(torch.abs(vk - vp).max())),
            "hits": int(hk[pick].sum())}


def worklist_case(torch, card: str, sp, tag: str, wl_args) -> dict:
    """The worklist entry point (the rescue) on the lanes the rescue lists
    in ``wl_args`` (``sorted_plan``'s): candidate spread and the
    kernels' schedule (``worklist_schedule``), agreement with its plain
    version on every lane (raises on any difference), times (each
    kernel's device time apart) and bound.  Returns its kernel-table
    numbers."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    args, outs = wl_args[:9], wl_args[9:]
    start, count, lanes, n_lanes, tables = args[4:9]
    m = int(n_lanes)
    pick = lanes[:m].long()
    bound = torch.clamp(count[pick], 0, sp.meta.max_tris_per_cell)
    n_cand = int(bound.sum())
    blocks = wk.worklist_occupancy(start.device)[0] \
        * torch.cuda.get_device_properties(0).multi_processor_count
    sched = wk.worklist_schedule(count, lanes, n_lanes,
                                 k_static=sp.meta.max_tris_per_cell, blocks=blocks)
    share = sched.edges.diff()
    print(f"[{card}] worklist {tag}: {m} listed lanes of {lanes.numel()}; "
          f"candidates per lane max {int(bound.max()) if m else 0}, mean "
          f"{float(bound.float().mean()) if m else 0.0:.2f}; total {n_cand}; "
          f"schedule: {blocks} collide blocks, {int(sched.edges[-1])} items, "
          f"{int(share.max())} a share, {int((sched.slot >= 0).sum())} lanes across "
          "shares")
    c = worklist_vs_plain(torch, sp, wl_args)
    print(f"[{card}] worklist {tag} vs plain: {c['bits']} lanes differ in any bit, "
          f"max |diff| {c['err']:.3e}, hits {c['hits']}")
    if c["bits"]:
        raise RuntimeError(f"the worklist entry point ({tag}) disagrees with its "
                           "plain version")
    kw = S._rescue_kw(sp)
    scratch = [x.clone() for x in outs]
    t = timed(torch, lambda: wk.window_collide_worklist(*args, *scratch, **kw),
              lambda: wk.window_collide_worklist_plain(*args, *scratch, **kw))
    # bound: each listed lane's state, (start, count) and index in, its
    # outputs out, every distinct candidate row once (36 B), and the
    # float operations of its candidates
    n_rows = span_columns(torch, start[pick].long(), bound, tables.pairs.shape[1])
    n_bytes = m * (12 + 12 + 4 + 4 + 4 + 4 + 4) + 4 + 36 * n_rows + m * (12 + 12 + 4)
    n_ops = WINDOW_OPS_PER_CANDIDATE * n_cand + WINDOW_OPS_PER_LANE * m
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_F32_OPS_PER_S * 1e3
    rows, _ = t["by_kernel"]
    print(f"[{card}] worklist {tag}: {t['ms']:.4f} ms by events around the call, "
          f"{ms_text(t['device_ms'])} on the device "
          f"({by_kernel(t.pop('by_kernel'))}); plain {t['plain_ms']:.4f} ms; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_cand} candidates, {n_rows} distinct "
          f"rows, {n_bytes} B = {bytes_ms:.4f} ms, {n_ops:.3e} ops = {ops_ms:.4f} ms)")
    return {"max_abs_err": c["err"], **t, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "device_ms_by_kernel": {short_kernel(k): v for k, v in rows.items()},
            "listed_lanes": m, "candidates": n_cand}


def empty_list(wl_args):
    """``sorted_plan``'s worklist arguments with no lane listed."""
    return (*wl_args[:7], wl_args[7] * 0, *wl_args[8:])


def b2_case(torch, card: str, tag: str, b2_args) -> dict:
    """The cells kernel against its plain version (raises on any
    difference), timed, with its bound.  Returns its kernel-table
    numbers."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    key_s = b2_args[0]
    n = key_s.numel()
    c = b2_vs_plain(torch, b2_args)
    b2_bad = c["bad"]
    print(f"[{card}] B2 cells lookup ({tag}) vs plain at N={n}: {b2_bad} lanes "
          f"differ (misses {c['misses']})")
    if b2_bad:
        raise RuntimeError(f"cells kernel disagrees with its plain version "
                           f"on {b2_bad} lanes")
    b2 = timed(
        torch, lambda: wk.cells_window_lookup(*b2_args, wc=S._CODE_WC),
        lambda: wk.cells_window_lookup_plain(*b2_args, wc=S._CODE_WC))
    del b2["by_kernel"]
    # B2 bound: key in, (start, count) out, lo/hi, one table entry
    # per distinct key
    n_keys = int(torch.unique(key_s).numel())
    b2_bytes = 4 * n + 8 * n + 8 * (n // wk.LANE) + 4 * n_keys
    b2_bound = b2_bytes / H100_BYTES_PER_S * 1e3
    print(f"[{card}] B2 cells lookup ({tag}): {b2['ms']:.4f} ms by events "
          f"around the call, {ms_text(b2['device_ms'])} on the device; plain "
          f"{b2['plain_ms']:.4f} ms; bound {b2_bound:.4f} ms ({b2_bytes} B, "
          f"{n_keys} distinct keys)")
    return {"max_abs_err": 0.0, **b2, "bound_ms": b2_bound, "bound_by": "bytes"}


def drive_hybrid(torch, card: str, scene, state0, spatial_coll: int, sp,
                 spatial_reads: float) -> dict:
    """Phase 5: the hybrid path at full width on the spatial path's scene
    and spawn, and the screen-space method beside it.  Returns the hybrid
    path's kernel launches and the kernel-table numbers of B1, B2 and the
    worklist entry point on its state at step 650 (``sp``: the main
    path's tables and constants, which the hybrid runner's equal;
    ``spatial_reads``: the spatial runner's host reads a step, printed
    beside the hybrid's)."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as ss
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        screenspace_kernel as ssk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        telemetry_kernel as tk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    cfg = scene.config
    cam, normals = scene.cameras[0], scene.corner_normals
    cached = os.path.exists(ss.bake_path(scene.triangles, cam, normals))
    t0 = time.perf_counter()
    tex = ss.bake_camera(scene.triangles, cam, normals)
    fence(tex.planar)
    print(f"[{card}] bake of {cam.name!r} ({cam.width}x{cam.height}, corner "
          f"normals, {scene.num_triangles} triangles) on the host: "
          f"{time.perf_counter() - t0:.2f} s; disk cache "
          f"{'served it' if cached else 'empty, rasterized'}")
    t0 = time.perf_counter()
    runner = S.make_sorted_episode_runner(
        scene.triangles, cfg, cells_lookup="kernel", resort_every="auto",
        camera=cam, normals=normals)
    print(f"[{card}] hybrid runner host setup {time.perf_counter() - t0:.1f} s")
    gravity = runner.sp.gravity

    def undecided_share(state) -> float:
        # the plain version: the kernel's launches count the runner's alone
        _, und = ss.screen_space_collide_plain(state, tex, gravity, cfg.dt, hybrid=True)
        return float(und[active_mask(state)].float().mean())

    def check(tag, s, want_hits):
        mask = active_mask(s)
        bad = int((~torch.isfinite(s.pos[:, mask]).all(0)).sum()
                  + (~torch.isfinite(s.vel[:, mask]).all(0)).sum())
        if bad:
            raise RuntimeError(f"{tag}: {bad} active lanes hold NaN/inf")
        if not bool((s.pos[0, ~mask] == 1e38).all() and (s.pos[2, ~mask] == 1e38).all()
                    and (s.collisions[~mask] == 0).all()):
            raise RuntimeError(f"{tag}: padding sentinels moved or collided")
        coll = int(s.collisions[mask].sum())
        if want_hits and coll <= 0:
            raise RuntimeError(f"{tag}: no collisions in {N_STEPS} steps")
        return coll

    # ---- the hybrid runner, 700 steps, timed as the spatial path ----
    wk.reset_launches()
    tk.reset_launches()
    ssk.reset_launches()
    syncs0 = runner.syncs.count
    share, ms = {}, {}
    h = runner(state0, 1)  # step 0
    fence(h.pos)
    share[1] = undecided_share(h)
    for a, b in ((1, 151), (151, 600)):
        t0 = time.perf_counter()
        h = runner(h, b - a)
        fence(h.pos)
        ms[(a, b)] = (time.perf_counter() - t0) * 1000.0 / (b - a)
        share[b] = undecided_share(h)
    h600 = h
    t0 = time.perf_counter()
    h, ovf_a = runner(h, SNAP_STEP - 600, with_stats=True)
    fence(h.pos)
    t_a = time.perf_counter() - t0
    h650 = h
    t0 = time.perf_counter()
    h, ovf_b = runner(h, N_STEPS - SNAP_STEP, with_stats=True)
    fence(h.pos)
    ms[(600, 700)] = (t_a + time.perf_counter() - t0) * 1000.0 / (N_STEPS - 600)
    launches = dict(wk.LAUNCHES)
    tel_launches = dict(tk.LAUNCHES)
    ss_launches = ssk.LAUNCHES["screen_space_collide"]
    # the ring's undecided counter of step 600 (the first step with stats)
    # against the stage's undecided real lanes recounted on its input
    _, und600 = ss.screen_space_collide(h600, tex, gravity, cfg.dt, hybrid=True)
    und_want = int((und600 & active_mask(h600)).sum())
    und_got = int(runner.telemetry.records[-2].counters["undecided"][0])
    syncs_per_step = (runner.syncs.count - syncs0) / N_STEPS
    share[N_STEPS] = undecided_share(h)
    coll = check("hybrid path", h, True)
    ovf = sorted(ovf_a + ovf_b)
    print(f"[{card}] hybrid path ({cam.name!r}), {N_STEPS} steps at "
          f"{h.pos.shape[-1]} particles: "
          + ", ".join(f"steps {a}-{b} {v:.3f} ms/step" for (a, b), v in ms.items())
          + f"; undecided share (active lanes) "
          + ", ".join(f"step {k} {v:.4f}" for k, v in share.items())
          + f"; host reads {syncs_per_step:.4f}/step (spatial runner "
          f"{spatial_reads:.4f}); overflow steps 600-700 min "
          f"{ovf[0]} median {ovf[len(ovf) // 2]} max {ovf[-1]}; collisions {coll}; "
          f"launches {launches}, the screen-space kernel {ss_launches}; steps 600-700 "
          f"with stats (the stamped graphs), "
          f"telemetry launches {tel_launches}; the ring's undecided real lanes at "
          f"step 600 {und_got}, the stage's recounted {und_want}")
    if not 0.0 < share[N_STEPS] < 1.0:
        raise RuntimeError(f"undecided share {share[N_STEPS]} at step {N_STEPS} "
                           "is not strictly between 0 and 1")
    check_runner_launches("hybrid path", launches, N_STEPS)
    if ss_launches != N_STEPS:
        raise RuntimeError(f"hybrid path: the screen-space kernel launched {ss_launches} "
                           f"times in {N_STEPS} steps, want one a step")
    check_telemetry_launches("hybrid path", tel_launches, N_STEPS - 600, True)
    if und_got != und_want:
        raise RuntimeError("the hybrid's undecided counter disagrees with the stage")
    if not max(ovf) > 0:
        raise RuntimeError("no lane overflowed in steps 600-700: the rescue never ran")

    # ---- the screen-space method at the same width ----
    step = S.make_method_step(scene, "screen_space")
    s = state0
    fence(s.pos)
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        s = step(s)
    fence(s.pos)
    ss_ms = (time.perf_counter() - t0) * 1000.0 / N_STEPS
    ss_coll = check("screen-space method", s, False)
    print(f"[{card}] screen-space method ({cam.name!r}), {N_STEPS} steps: "
          f"{ss_ms:.3f} ms/step; collisions {ss_coll}")
    print(f"[{card}] total collisions in {N_STEPS} steps at {s.pos.shape[-1]} "
          f"particles: spatial {spatial_coll}, hybrid {coll}, screen-space {ss_coll}")

    # ---- B1 and B2 against their plain versions on the masked plan ----
    st, und = ss.screen_space_collide(h650, tex, gravity, cfg.dt, hybrid=True)
    b2_args, cases, overflow, wl_args = sorted_plan(torch, sp, st, und)
    print(f"[{card}] hybrid state at step {SNAP_STEP}: undecided "
          f"{int(und.sum())} lanes, {int(overflow.sum())} overflow lanes in the masked main plan; "
          f"the screen-space stage collides "
          f"{int((st.collisions - h650.collisions).sum())} particles in this step")
    numbers = {"b2": b2_case(torch, card, f"hybrid, step {SNAP_STEP}", b2_args), "b1": {},
               "launches": launches, "tel_launches": tel_launches,
               "ss_launches": ss_launches,
               "worklist": worklist_case(torch, card, sp, f"hybrid, step {SNAP_STEP}",
                                         wl_args)}
    for tag, (args, w) in cases.items():
        numbers["b1"][tag] = window_case(torch, card, sp, f"hybrid {tag}, step {SNAP_STEP}",
                                         args, w)

    # ---- the runner against the per-step path, 20 steps from step 600 ----
    per_step = S.make_hybrid_step_sorted(scene.triangles, cfg, cam, normals,
                                         cells_lookup="kernel")
    a = h600
    for _ in range(20):
        a = per_step(a)
    fresh = S.make_sorted_episode_runner(
        scene.triangles, cfg, cells_lookup="kernel", resort_every="auto",
        camera=cam, normals=normals)
    b = fresh(h600, 20)
    mask = active_mask(h600)
    coll_diff = int((a.collisions != b.collisions).sum())
    far = int((~torch.isclose(a.pos[:, mask], b.pos[:, mask], rtol=1e-6,
                              atol=1e-7).all(0)).sum())
    print(f"[{card}] hybrid runner vs make_hybrid_step_sorted, 20 steps from step "
          f"600: collisions differ on {coll_diff} lanes "
          f"({int(a.collisions[mask].sum())} in all), pos outside rtol 1e-6 "
          f"atol 1e-7 on {far} lanes")
    if coll_diff or far:
        bad = (a.collisions != b.collisions) | ~torch.isclose(
            a.pos, b.pos, rtol=1e-6, atol=1e-7).all(0)
        for i in torch.nonzero(bad & mask).flatten()[:5].tolist():
            print(f"[{card}]   lane {i}: collisions {int(a.collisions[i])} (step) "
                  f"{int(b.collisions[i])} (runner), pos {a.pos[:, i].tolist()} "
                  f"(step) {b.pos[:, i].tolist()} (runner)")
        raise RuntimeError("the hybrid runner disagrees with the per-step path")
    return numbers


def drive_p2p(torch, card: str) -> list:
    """Phase 6: the particle-particle path at full width.  Returns the
    kernel-table entry of the p2p window kernel, its explicit-plan and
    worklist entry points nested under it (the worklist kernel's
    occupancy and SASS counts in the latter)."""
    from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import _box_state
    from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
    from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as GR
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan
    from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        p2p_window_kernel as pk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    occ = pk.worklist_occupancy(torch.device("cuda", 0))
    wl_kernel = {"blocks_per_sm": occ[0], "threads": occ[3], "registers": occ[1],
                 "local_bytes": occ[2],
                 "sass_per_candidate": sass_counts(build, "p2p_window_kernel",
                                                   "p2p_worklist_kernel", True)}
    print(f"[{card}] p2p worklist kernel: {occ[0]} blocks of {occ[3]} threads an "
          f"SM, {occ[1]} registers and {occ[2]} local bytes a thread")
    name_a, name_b = "p2p_window_collide_sorted", "p2p_window_collide_cells"
    name_w = "p2p_collide_worklist"
    lo, hi = P2P_BOX
    cfg = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)
    state0 = _box_state(P2P_N, lo, hi, 0.4, 0.3, seed=0)

    def make_step():
        step = S.make_p2p_step(lo, hi, cfg, capacity=8, variant="auto",
                               with_stats=True)
        if step.variant != "kernel":
            raise RuntimeError(f'variant "auto" chose {step.variant!r}, not "kernel"')
        return step

    step = make_step()
    runner = S.make_p2p_episode_runner(lo, hi, cfg, capacity=8)
    meta = runner.meta
    window = runner.window
    n = P2P_N
    n_k = -(-n // pk.BLOCK) * pk.BLOCK
    wl_blocks = occ[0] * torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{card}] p2p box {hi}, particle grid dims {meta.dims} "
          f"({meta.num_cells} cells), {n} particles in {n_k} lanes, window {window}")

    def check(tag, s):
        bad = int((~torch.isfinite(s.pos).all(0)).sum() + (~torch.isfinite(s.vel).all(0)).sum())
        if bad:
            raise RuntimeError(f"p2p {tag}: {bad} lanes hold NaN/inf")
        lo_t = torch.tensor(lo, device=s.pos.device)[:, None] - s.radius[None]
        hi_t = torch.tensor(hi, device=s.pos.device)[:, None] + s.radius[None]
        out = int(((s.pos < lo_t) | (s.pos > hi_t)).any(0).sum())
        if out:
            raise RuntimeError(f"p2p {tag}: {out} particles left the box")
        contacts = int(s.collisions.sum())
        if contacts <= 0:
            raise RuntimeError(f"p2p {tag}: no contacts")
        return contacts

    def stats(v):
        return f"min {min(v)} median {sorted(v)[len(v) // 2]} max {max(v)}"

    def differ(a, b) -> int:
        """Lanes on which two states differ in any bit."""
        return (lane_diff(torch, a.pos, b.pos) + lane_diff(torch, a.vel, b.vel)
                + lane_diff(torch, a.collisions, b.collisions))

    launched = {name_a: 0, name_b: 0, name_w: 0}  # over the main path's drives

    def expect_launches(tag, steps, count=True):
        """Read the counters after a drive of ``steps`` steps (reset just
        before): each step launches the entry point that plans in the
        kernel once and the worklist entry point once."""
        got = dict(pk.LAUNCHES)
        want = {name_a: 0, name_b: steps, name_w: steps}
        if got != want:
            raise RuntimeError(f"p2p {tag}: launches {got}, expected {want}")
        if count:
            for k in launched:
                launched[k] += got[k]
        return got

    def drive_step(step_fn):
        """P2P_STEPS steps from spawn: (state, state at P2P_SNAP_STEP, the
        overflow of each step read once at the end, ms per segment)."""
        s, ovf, seg_ms, snap = state0, [], [], None
        for upto in (20, P2P_SNAP_STEP, P2P_STEPS):
            fence(s.pos)
            t0 = time.perf_counter()
            for _ in range(upto - len(ovf)):
                s, st = step_fn(s)
                ovf.append(st["cell_overflow"])
            fence(s.pos)
            seg_ms.append((time.perf_counter() - t0) * 1000.0)
            if upto == P2P_SNAP_STEP:
                snap = s
        seg = [seg_ms[0] / 20, (seg_ms[1] + seg_ms[2]) / (P2P_STEPS - 20)]
        return s, snap, torch.stack(ovf).tolist(), seg

    # ---- the step path: 200 steps (captured from the second), snapshot at
    # step 100; then the same steps uncaptured, equal bit for bit ----
    pk.reset_launches()
    s, snap, ovf, seg = drive_step(step)
    expect_launches("step path", P2P_STEPS)
    contacts = check("step path", s)
    eager_step = make_step()
    pk.reset_launches()
    with GR.uncaptured():
        e, _, e_ovf, e_seg = drive_step(eager_step)
    expect_launches("step path, uncaptured", P2P_STEPS, count=False)
    step_differ = differ(s, e)
    print(f"[{card}] p2p step path (variant {step.variant}, captured: a graph "
          f"replayed from step 2, launches per replay {step.launches}), "
          f"{P2P_STEPS} steps at {n} particles: steps 1-20 {seg[0]:.3f} ms/step, "
          f"steps 21-{P2P_STEPS} {seg[1]:.3f} ms/step; uncaptured {e_seg[0]:.3f} / "
          f"{e_seg[1]:.3f} ms/step; host reads per step "
          f"{step.syncs.count / P2P_STEPS:.4f} (uncaptured "
          f"{eager_step.syncs.count / P2P_STEPS:.4f}); cell_overflow (lanes "
          f"redone by the fallback, read once) {stats(ovf)}; contacts {contacts}; "
          f"captured vs uncaptured: {step_differ} lanes differ in any bit, overflow "
          f"differs on {sum(a != b for a, b in zip(ovf, e_ovf))} of {P2P_STEPS} steps")
    if step.syncs.count or eager_step.syncs.count:
        raise RuntimeError("the p2p step read the host")
    if step_differ or ovf != e_ovf:
        raise RuntimeError("the captured p2p step and the eager one disagree")
    del e, eager_step

    # ---- the persistent runner: 50 steps from the same state, captured and
    # uncaptured, at window 512 and at 128, where lanes overflow ----
    def drive_runner(run, tag):
        """Warm ``run`` (its eager first step and the capture), then drive
        it P2P_RUNNER_STEPS steps captured and the same steps uncaptured.
        Returns the captured run's overflows and launches."""
        run(state0, 2)
        out = {}
        for captured in (True, False):
            pk.reset_launches()
            fence(state0.pos)
            t0 = time.perf_counter()
            with contextlib.nullcontext() if captured else GR.uncaptured():
                r, r_ovf = run(state0, P2P_RUNNER_STEPS, with_stats=True)
            fence(r.pos)
            ms = (time.perf_counter() - t0) * 1000.0 / P2P_RUNNER_STEPS
            got = expect_launches(f"{tag}, {'captured' if captured else 'uncaptured'}",
                                  P2P_RUNNER_STEPS, count=captured and tag == "runner")
            out[captured] = (r, r_ovf, ms, got)
        (r, r_ovf, ms, got), (b, b_ovf, b_ms, _) = out[True], out[False]
        r_contacts = check(tag, r)
        bad = differ(r, b)
        print(f"[{card}] p2p {tag} (window {run.window}), {P2P_RUNNER_STEPS} "
              f"steps: captured {ms:.3f} ms/step, uncaptured {b_ms:.3f} ms/step; "
              f"host reads {run.syncs.count} over {run.steps} steps; launches per "
              f"replay {run.launches}; cell_overflow {stats(r_ovf)}; contacts "
              f"{r_contacts}; captured vs uncaptured: {bad} lanes differ in any "
              f"bit, overflow differs on {sum(x != y for x, y in zip(r_ovf, b_ovf))} "
              f"of {P2P_RUNNER_STEPS} steps")
        if run.syncs.count:
            raise RuntimeError(f"the p2p {tag} read the host")
        if bad or r_ovf != b_ovf:
            raise RuntimeError(f"the captured p2p {tag} and the eager one disagree")
        return r_ovf, got

    drive_runner(runner, "runner")
    runner_s = S.make_p2p_episode_runner(lo, hi, cfg, capacity=8,
                                         window=P2P_SMALL_WINDOW)
    ovf_s, launches_s = drive_runner(runner_s, "runner with overflow")
    if not max(ovf_s) > 0:
        raise RuntimeError(f"no lane overflowed a window of {P2P_SMALL_WINDOW}")
    del runner_s

    # ---- the settled box: the main runner (captured, window 512) from
    # spawn to step P2P_SETTLED_STEP, where the box has settled into a
    # pile; steps 1400-1500 timed, the overflows read once at the end ----
    pk.reset_launches()
    fence(state0.pos)
    pile, ovf_fall = runner(state0, P2P_SETTLED_STEP - P2P_SETTLED_TIMED,
                            with_stats=True)
    fence(pile.pos)
    t0 = time.perf_counter()
    pile, ovf_pile = runner(pile, P2P_SETTLED_TIMED, with_stats=True)
    fence(pile.pos)
    settled_ms = (time.perf_counter() - t0) * 1000.0 / P2P_SETTLED_TIMED
    launches_settled = expect_launches("settled box", P2P_SETTLED_STEP, count=False)
    settled_contacts = check("settled box", pile)
    heights = pile.pos[1][active_mask(pile)]
    print(f"[{card}] p2p settled box (runner, window {window}, captured): steps "
          f"{P2P_SETTLED_STEP - P2P_SETTLED_TIMED}-{P2P_SETTLED_STEP} "
          f"{settled_ms:.3f} ms/step; overflow lanes a step (read once) over those "
          f"steps {stats(ovf_pile)}, over steps 1-{P2P_SETTLED_STEP - P2P_SETTLED_TIMED} "
          f"{stats(ovf_fall)}; contacts {settled_contacts}; height mean "
          f"{float(heights.mean()):.3f} max {float(heights.max()):.3f}; host reads "
          f"{runner.syncs.count}; launches {launches_settled}")
    if runner.syncs.count:
        raise RuntimeError("the p2p runner read the host in the settled box")
    pk.reset_launches()

    def offsets_read(cid) -> int:
        """Distinct CSR offsets that the runs of particles in cells ``cid``
        read: the two run ends of every in-grid group of every occupied
        cell, each entry once (neighbouring cells share them)."""
        dx, dy, dz = meta.dims
        cells = torch.unique(cid[cid < meta.num_cells]).long()
        cx, cy = cells // (dy * dz), (cells // dz) % dy
        read = torch.zeros(meta.num_cells + 2, dtype=torch.bool, device=cid.device)
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                c = cells[(cx + ox >= 0) & (cx + ox < dx) & (cy + oy >= 0)
                          & (cy + oy < dy)] + (ox * dy + oy) * dz
                read[torch.clamp(c - 1, 0, meta.num_cells)] = True
                read[torch.clamp(c + 2, 0, meta.num_cells)] = True
        return int(read.sum())

    def sorted_inputs(st):
        """What a step on ``st`` hands the kernel: (cell ids and rows padded
        to n_k lanes and sorted, the sort order, the CSR offsets, the full
        run bounds)."""
        dev = st.pos.device
        cid_key = torch.cat([
            p2ps._cell_key(st.pos, meta, active_mask(st)),
            torch.full((n_k - n,), meta.num_cells, dtype=torch.int32, device=dev)])
        rows = torch.cat([p2ps._state_rows(st), p2ps._pad_columns(n_k - n, dev)], dim=1)
        cid_s, perm = torch.sort(cid_key, stable=True)
        offsets = p2p_plan.csr_offsets(cid_key, meta.num_cells)
        starts, cnt = p2p_plan.run_bounds(cid_s, p2p_plan.run_table(offsets, meta), meta)
        return rows[:, perm], cid_s, perm, offsets, starts, cnt

    def worklist_check(tag, inputs, out_b, keep):
        """The worklist entry point (the fallback sized on the device) over
        the lanes where ``keep`` holds, against its plain version and
        against the host-looped fallback (one chunk: lanes are
        independent), on every lane; the case's arguments and counts for
        its timing."""
        rows_s, cid_s, perm, offsets, starts, cnt = inputs
        lanes, n_lanes = wk.compact_lanes(keep)
        res = {}
        for route in ("kernel", "plain", "host-looped"):
            mine = tuple(x.clone() for x in out_b[:3])
            if route == "host-looped":
                parts = p2ps.WindowParts(*mine, rows_s, keep, perm, cid_s, offsets, meta)
                p2ps._p2p_chunked_fallback(parts, 0.5, n_k)
            else:
                fn = pk.p2p_collide_worklist if route == "kernel" else \
                    pk.p2p_collide_worklist_plain
                fn(rows_s, cid_s, offsets, meta, lanes, n_lanes, *mine, beta=0.5)
            res[route] = mine
        torch.cuda.synchronize()
        listed = keep.nonzero()[:, 0]
        n_l = int(n_lanes)
        n_cand = int(cnt[:, listed].sum()) - n_l  # the self pair adds nothing
        # the distinct columns the listed lanes' runs cover, their own
        # columns among them, and the distinct CSR offsets they read
        n_cols_w = span_columns(torch, torch.cat([starts[:, listed].reshape(-1).long(),
                                                  listed]),
                                torch.cat([cnt[:, listed].reshape(-1),
                                           torch.ones_like(listed, dtype=torch.int32)]),
                                n_k)
        n_offsets_w = offsets_read(cid_s[listed])
        # the walk's steps: the kernel's warps take `width` neighbouring
        # entries at a time (worklist_schedule) and a warp steps through a
        # group as long as its longest run there
        sched = pk.worklist_schedule(n_lanes, blocks=wl_blocks)
        batch = (torch.arange(n_l, device=listed.device) // sched.width).expand(
            pk.N_GROUPS, n_l)
        longest = torch.zeros((pk.N_GROUPS, -(-n_l // sched.width)), dtype=torch.int32,
                              device=listed.device)
        longest.scatter_reduce_(1, batch, cnt[:, listed], "amax")
        n_slots = int(longest.sum())
        for ref in ("plain", "host-looped"):
            bad = [lane_diff(torch, a, b) for a, b in zip(res["kernel"], res[ref])]
            print(f"[{card}] B3 {name_w} ({tag}, {n_l} listed lanes, {n_cand} "
                  f"candidates) vs the {ref} fallback on every lane: pos differs on "
                  f"{bad[0]} lanes, vel on {bad[1]}, ncon on {bad[2]}")
            if any(bad):
                raise RuntimeError(f"{name_w} ({tag}) disagrees with the {ref} fallback")
        if n_l:
            err[name_w] = max(err[name_w], max(
                float(torch.abs(a[..., listed] - b[..., listed]).max())
                for a, b in zip(res["kernel"][:2], res["plain"][:2])))
        return ((rows_s, cid_s, offsets, meta, lanes, n_lanes), res["kernel"], n_l,
                n_cand, n_cols_w, n_offsets_w, n_slots)

    # ---- every entry point against its plain version, state at step 100 ----
    dev = snap.pos.device
    inputs = sorted_inputs(snap)
    rows_s, cid_s, perm, offsets, starts, cnt = inputs
    pad = perm >= n
    real = torch.abs(rows_s[0]) < 5e37
    plans, wl_cases, err = {}, {}, {name_a: 0.0, name_b: 0.0, name_w: 0.0}
    for w in (window, P2P_SMALL_WINDOW):
        rel, ws, k_cap, overflow = p2p_plan.window_geometry(starts, cnt, w)
        rows_pad = torch.cat([rows_s, p2ps._pad_columns(w, dev)], dim=1)
        args_a = (rows_s[0:3], rows_s[3:6], rows_s[6], rows_s[7], rows_pad, rel,
                  cnt, ws, k_cap)
        args_b = (rows_pad, cid_s, offsets, meta)
        plans[w] = (args_a, args_b)
        pp, vp, npl = pk.p2p_window_collide_sorted_plain(*args_a, w=w, beta=0.5)
        plain_b = pk.p2p_window_collide_cells_plain(*args_b, w=w, beta=0.5)
        if not (torch.equal(plain_b[0], pp) and torch.equal(plain_b[1], vp)
                and torch.equal(plain_b[2], npl) and torch.equal(plain_b[3], overflow)):
            raise RuntimeError("the two plain versions disagree")
        out_a = pk.p2p_window_collide_sorted(*args_a, w=w, beta=0.5)
        out_b = pk.p2p_window_collide_cells(*args_b, w=w, beta=0.5)
        torch.cuda.synchronize()
        for name, (pk_, vk, nk, *ovf_k) in ((name_a, out_a), (name_b, out_b)):
            bad_n, bad_p, bad_v = (lane_diff(torch, nk, npl), lane_diff(torch, pk_, pp),
                                   lane_diff(torch, vk, vp))
            bad_o = lane_diff(torch, ovf_k[0], overflow) if ovf_k else 0
            w_err = max(float(torch.abs(pk_ - pp)[:, real].max()),
                        float(torch.abs(vk - vp).max()))
            err[name] = max(err[name], w_err)
            pads_inert = bool((nk[pad] == 0).all() and (vk[:, pad] == 0).all()
                              and (pk_[:, pad] == 1e38).all())
            print(f"[{card}] B3 {name} (w={w}, N={n_k}) vs plain on every lane: "
                  f"ncon differs on {bad_n} lanes, pos on {bad_p}, vel on {bad_v}, "
                  f"overflow mask on {bad_o if ovf_k else 'n/a'}, max |diff| "
                  f"{w_err:.3e}; contacts {int(nk.sum())}; overflow lanes "
                  f"{int(overflow.sum())}; {int(pad.sum())} pad columns inert: "
                  f"{pads_inert}")
            if bad_n or bad_p or bad_v or bad_o:
                raise RuntimeError(f"{name} (w={w}) disagrees with its plain version")
            if not pads_inert or int(pad.sum()) != n_k - n:
                raise RuntimeError("p2p pad columns moved or collided")
        if w == P2P_SMALL_WINDOW and not bool(overflow.any()):
            raise RuntimeError(f"no lane overflows a window of {w}")
        if bool((pad | ~real)[overflow].any()):
            raise RuntimeError("a sentinel or pad lane overflowed its window")
        wl_cases[f"w{w}"] = worklist_check(f"step {P2P_SNAP_STEP}, w={w}", inputs, out_b,
                                          overflow)
        if w == P2P_SMALL_WINDOW:
            # a sparse list (a batch's lanes far apart) and a list of one
            listed = overflow.nonzero()[:, 0]
            for key, pick, what in (
                    ("sparse", listed[::P2P_SPARSE_STRIDE],
                     f"every {P2P_SPARSE_STRIDE}th lane of the w={w} list"),
                    ("one_lane", listed[:1], f"the first lane of the w={w} list")):
                keep = torch.zeros_like(overflow)
                keep[pick] = True
                wl_cases[key] = worklist_check(f"step {P2P_SNAP_STEP}, {what}", inputs,
                                               out_b, keep)

    # ---- the worklist entry point on the settled box (step 1,500) at both
    # windows: what the main path lists there (w = 512), and w = 128 ----
    inputs_p = sorted_inputs(pile)
    for w in (window, P2P_SMALL_WINDOW):
        rows_pad = torch.cat([inputs_p[0], p2ps._pad_columns(w, dev)], dim=1)
        out_p = pk.p2p_window_collide_cells(rows_pad, inputs_p[1], inputs_p[3], meta,
                                            w=w, beta=0.5)
        wl_cases[f"settled_w{w}"] = worklist_check(
            f"settled box, step {P2P_SETTLED_STEP}, w={w}", inputs_p, out_p, out_p[3])
        del rows_pad, out_p

    # ---- p2p_collide_window (kernel + fallback) against p2p_collide_sorted ----
    act = active_mask(snap)
    ref, _ = p2ps.p2p_collide_sorted(snap, meta, active=act)
    for w in (window, P2P_SMALL_WINDOW):
        t0 = time.perf_counter()
        out, n_over = p2ps.p2p_collide_window(snap, meta, active=act, window=w)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1000.0
        bad_c = lane_diff(torch, out.collisions, ref.collisions)
        far = int((~(torch.isclose(out.pos, ref.pos, rtol=1e-5, atol=1e-5).all(0)
                     & torch.isclose(out.vel, ref.vel, rtol=1e-4, atol=1e-5).all(0))).sum())
        print(f"[{card}] p2p_collide_window (w={w}) vs p2p_collide_sorted: "
              f"{int(n_over)} lanes redone by the fallback, counts differ on {bad_c} "
              f"lanes, pos (rtol=1e-5 atol=1e-5) / vel (rtol=1e-4 atol=1e-5) "
              f"outside on {far} lanes; {dt_ms:.1f} ms")
        if bad_c or far:
            raise RuntimeError(f"p2p_collide_window (w={w}) disagrees with p2p_collide_sorted")
    pk.reset_launches()

    # ---- time and bound at the main path's shapes (w = 512) ----
    args_a, args_b = plans[window]
    t_b = timed(
        torch, lambda: pk.p2p_window_collide_cells(*args_b, w=window, beta=0.5),
        lambda: pk.p2p_window_collide_cells_plain(*args_b, w=window, beta=0.5))
    t_a = timed(
        torch, lambda: pk.p2p_window_collide_sorted(*args_a, w=window, beta=0.5),
        lambda: pk.p2p_window_collide_sorted_plain(*args_a, w=window, beta=0.5))
    rows_pad, rel, cnt_, ws, k_cap = args_a[4:]
    nb = n_k // pk.BLOCK
    ws_l = ws.permute(1, 0, 2).reshape(pk.N_GROUPS, nb * pk.SUB).repeat_interleave(
        pk.LANE, dim=1)
    bound = torch.minimum(torch.minimum(
        cnt_, k_cap.t().repeat_interleave(pk.BLOCK, dim=1)), window - rel)
    n_cand = int(bound.sum())
    n_cols = span_columns(torch, (ws_l + rel).long(), bound, rows_pad.shape[1])
    n_offsets = offsets_read(cid_s)
    # explicit plan: each lane's pos/vel/radius/restitution (32 B), rel and
    # cnt (72 B), ws and k_cap, every distinct candidate column once (32 B),
    # out 28 B.  Plan in the kernel: each lane's column (32 B) and cell id
    # (4 B), the distinct CSR offsets (4 B), the candidate columns, out
    # 28 B and the overflow flag (1 B)
    bytes_a = n_k * (32 + 72) + 4 * ws.numel() + 4 * k_cap.numel() \
        + 32 * n_cols + 28 * n_k
    bytes_b = n_k * (32 + 4) + 4 * n_offsets + 32 * n_cols + 29 * n_k
    n_ops = P2P_OPS_PER_CANDIDATE * n_cand + P2P_OPS_PER_LANE * n_k
    ops_ms = n_ops / H100_F32_OPS_PER_S * 1e3
    entries = []
    for name, t, n_bytes in ((name_b, t_b, bytes_b), (name_a, t_a, bytes_a)):
        del t["by_kernel"]
        bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
        print(f"[{card}] B3 {name}: {t['ms']:.4f} ms by events around the call, "
              f"{ms_text(t['device_ms'])} on the device; plain "
              f"{t['plain_ms']:.4f} ms; bound {max(bytes_ms, ops_ms):.4f} ms "
              f"({n_cand} candidates, {n_cols} distinct columns, {n_offsets} "
              f"distinct CSR offsets, {n_bytes} B = "
              f"{bytes_ms:.4f} ms, {n_ops:.3e} ops = {ops_ms:.4f} ms); launches on "
              f"the main path {launched[name]}")
        entries.append({
            "name": name, "route": "cuda", "source": PORT_CSRC + "p2p_window_kernel.cu",
            "replaces": f"{JAX_P2P_KERNEL}:77", "launches": launched[name],
            "max_abs_err": err[name], **t, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None})

    # the worklist entry point in each case.  Bytes, each input read
    # once: per listed lane its own column (32 B), cell id (4 B), list
    # entry (4 B) and output (28 B); each other distinct column its runs
    # cover, the position and radius the distance test reads (16 B); each
    # distinct CSR offset (4 B).  (32 B a candidate, as if neighbouring
    # lanes shared no column, is no lower bound: the kernel beats it.)
    # Operations: 53 a candidate, 8 a lane
    wl = {}
    for key, (wl_args, scratch, n_l, n_cand_w, n_cols_w, n_off_w,
              n_slots) in wl_cases.items():
        t = timed(torch, lambda: pk.p2p_collide_worklist(*wl_args, *scratch, beta=0.5),
                  lambda: pk.p2p_collide_worklist_plain(*wl_args, *scratch, beta=0.5))
        del t["by_kernel"]
        n_bytes = 68 * n_l + 16 * (n_cols_w - n_l) + 4 * n_off_w
        bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
        ops_ms = (P2P_OPS_PER_CANDIDATE * n_cand_w + P2P_OPS_PER_LANE * n_l) \
            / H100_F32_OPS_PER_S * 1e3
        wl[key] = {**t, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                   "listed_lanes": n_l, "candidates": n_cand_w, "warp_steps": n_slots,
                   "library_ms": None}
        print(f"[{card}] B3 {name_w} ({key}, {n_l} listed lanes, {n_cand_w} "
              f"candidates, {n_slots} warp steps over runs, {n_cols_w} distinct "
              f"columns, {n_off_w} distinct CSR offsets): {t['ms']:.4f} ms by events "
              f"around the call, "
              f"{ms_text(t['device_ms'])} on the device; plain {t['plain_ms']:.4f} "
              f"ms; bound {wl[key]['bound_ms']:.4f} ms ({wl[key]['bound_by']}: "
              f"{n_bytes} B = {bytes_ms:.4f} ms, {ops_ms:.4f} ms of operations)")
    settled = wl[f"settled_w{window}"]
    if settled["device_ms"] is not None:
        print(f"[{card}] B3 {name_w} on the main path in the settled box: "
              f"{launches_settled[name_w]} launches x (device "
              f"{settled['device_ms']:.4f} - bound {settled['bound_ms']:.4f}) ms = "
              f"{launches_settled[name_w] * (settled['device_ms'] - settled['bound_ms']):.3f}"
              f" ms over {P2P_SETTLED_STEP} steps")
    entry_w = {
        "name": name_w, "route": "cuda", "source": PORT_CSRC + "p2p_window_kernel.cu",
        # the JAX package runs this redo in XLA (a while_loop over chunks)
        "replaces": f"{JAX_P2P_KERNEL}:77", "stands_for": f"{JAX_P2P_FALLBACK}:474",
        "launches": launched[name_w],
        "launches_runner_w128": launches_s[name_w],
        "launches_settled": launches_settled[name_w],
        "max_abs_err": err[name_w], **wl[f"w{window}"],
        "window_128": wl[f"w{P2P_SMALL_WINDOW}"], "sparse": wl["sparse"],
        "one_lane": wl["one_lane"], "settled_window_512": settled,
        "settled_window_128": wl[f"settled_w{P2P_SMALL_WINDOW}"],
        "settled_ms_per_step": settled_ms, "kernel": wl_kernel}
    # the main path launches the kernel through its entry point that plans
    # in the kernel, and redoes the overflow lanes through the worklist
    # entry point; the explicit-plan entry point (the counterpart of the
    # TPU kernel's signature) is held against its plain version and timed
    # above; both are listed under the kernel's entry
    entries[0]["other_entry_points"] = [entries[1], entry_w]
    return entries[:1]


def per_step_launches_ok(launches: dict) -> bool:
    """The per-step sorted step (make_method_step) launches each kernel as
    a runner step does (``STEP_LAUNCHES``), over some steps."""
    steps = launches["cells_window_lookup"]
    return steps > 0 and launches == {k: v * steps for k, v in STEP_LAUNCHES.items()}


def run_cli(card: str, tag: str, argv: list) -> tuple:
    """One command through the port's ``cli.main`` (default device,
    CUDA), its output echoed; raises on a non-zero return.  Returns
    (stdout text, wall seconds)."""
    import io

    from particlesystemhybridcollisiondetection_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines()[-8:]:
        print(f"  {line}")
    print(f"[{card}] cli {tag}: `{' '.join(argv)}` returned {rc} in {wall:.2f} s")
    if rc != 0:
        raise RuntimeError(f"cli {tag} returned {rc}")
    return text, wall


def drive_cli(torch, card: str, snap) -> dict:
    """Phase 8: the command line on the card (every sub-step through
    ``cli.main`` with the default device, each checked and timed), then
    the oracle steps on ``snap`` (the spatial state at step 650) and the
    resilient runner.  Returns the launches of each sub-step."""
    import re
    import shutil
    import tempfile

    from particlesystemhybridcollisiondetection_tpu_torch.bench.harness import METHOD_NAMES
    from particlesystemhybridcollisiondetection_tpu_torch.bench import resilient as R
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
        ParticleState, active_mask, snapshot, spawn_grid,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as G
    from particlesystemhybridcollisiondetection_tpu_torch.ops import narrow_phase as NP
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        p2p_window_kernel as pk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.io import load_state
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    t_phase = time.perf_counter()
    scene = dragon_scene()
    tmp = tempfile.mkdtemp(prefix="psys_cli_")
    launches = {}
    n_full = scene.config.spawn_count(CLI_LAYERS)
    scene_args = ["--scene", "dragon", "--layers", str(CLI_LAYERS)]
    try:
        # ---- 8.1: bench, three methods, accuracy CSV, full width ----
        out1 = os.path.join(tmp, "bench")
        wk.reset_launches()
        text, _ = run_cli(card, "bench", [
            "bench", *scene_args, "--methods", "screen_space,spatial,hybrid",
            "--cameras", "0", "--steps", str(CLI_STEPS), "--runs", "1",
            "--accuracy", "--out", out1])
        launches["bench"] = dict(wk.LAUNCHES)
        printed = {m: (float(ms), int(c)) for m, ms, c in re.findall(
            r"^(\w+)\s.*?\s([\d.]+) ms/step .* collisions=(\d+)$", text, re.M)}
        if set(printed) != {"screen_space", "spatial", "hybrid"}:
            raise RuntimeError(f"bench printed {sorted(printed)}")
        names = [METHOD_NAMES[m] for m in ("screen_space", "spatial", "hybrid")]
        with open(os.path.join(out1, f"results_perf_{scene.name}_{n_full}.csv")) as f:
            perf = f.read().splitlines()
        want = []
        for name in names:
            want += [f"{name};ms"] + [str(i) for i in range(CLI_STEPS - 1)]
        if [x.split(";")[0] if ";ms" not in x else x for x in perf] != want:
            raise RuntimeError("perf CSV: not three method blocks of "
                               f"{CLI_STEPS - 1} rows")
        with open(os.path.join(out1, f"results_acc_{scene.name}_{n_full}.csv")) as f:
            acc = f.read().splitlines()
        block = n_full + 1
        if len(acc) != 3 * block or [acc[i * block] for i in range(3)] != [
                f"{n};collisions" for n in names]:
            raise RuntimeError(f"accuracy CSV: {len(acc)} lines, not 3 blocks of "
                               f"1 + {n_full}")
        acc_sum = [sum(int(x.rsplit(";", 1)[1]) for x in acc[i * block + 1:(i + 1) * block])
                   for i in range(3)]
        with open(os.path.join(out1, f"summary_{scene.name}.json")) as f:
            summary = json.load(f)
        with open(os.path.join(out1, f"aggregate_{scene.name}.json")) as f:
            aggregate = json.load(f)
        got = {r["method"]: r["total_collisions"] for r in summary}
        want_c = {m: c for m, (_, c) in printed.items()}
        if len(summary) != 3 or got != want_c or acc_sum != [
                want_c[m] for m in ("screen_space", "spatial", "hybrid")]:
            raise RuntimeError(f"summary {got} / accuracy CSV {acc_sum} / printed "
                               f"{want_c} disagree")
        if len(aggregate) != 3 or {r["num_particles"] for r in aggregate} != {n_full}:
            raise RuntimeError(f"aggregate rows {aggregate}")
        if launch_fault(launches["bench"]):
            raise RuntimeError(f"bench launches {launches['bench']}: a kernel of "
                               "the path never launched, or B1 at the rescue window did")
        print(f"[{card}] bench via the CLI, {n_full} particles, steps 2-{CLI_STEPS}: "
              + ", ".join(f"{m} {ms:.3f} ms/step ({c} collisions)"
                          for m, (ms, c) in printed.items())
              + f"; launches {launches['bench']}; perf CSV {len(perf)} lines, accuracy "
              f"CSV {len(acc)} lines")

        # ---- 8.2: --per-step, the non-persistent make_method_step path ----
        wk.reset_launches()
        text, _ = run_cli(card, "bench --per-step", [
            "bench", *scene_args, "--methods", "spatial", "--cameras", "0",
            "--steps", str(CLI_PER_STEP_STEPS), "--per-step",
            "--out", os.path.join(tmp, "per_step")])
        launches["per_step"] = dict(wk.LAUNCHES)
        per_ms = float(re.search(r"([\d.]+) ms/step", text).group(1))
        if not per_step_launches_ok(launches["per_step"]):
            raise RuntimeError(f"--per-step launches {launches['per_step']}")
        print(f"[{card}] spatial ms/step: --per-step (make_method_step, a sync per "
              f"step, steps 2-{CLI_PER_STEP_STEPS}) {per_ms:.3f}, persistent runner "
              f"(steps 2-{CLI_STEPS}) {printed['spatial'][0]:.3f}")

        # ---- a reading: the per-step step with its rescue (sized on the
        # device) and with the host-looped one in its place, which reads
        # the overflow and skips the rescue when none overflows; 20 steps
        # in free fall (from spawn) and at impact (from step 650) ----
        device_rescue = S._device_rescue
        rescues = {"device-sized": device_rescue,
                   "host-looped": S._chunked_rescue}
        spawn = spawn_grid(scene.config, CLI_LAYERS)
        step = S.make_method_step(scene, "spatial")
        for where, st0 in (("free fall, from spawn", spawn), ("impact, from step 650", snap)):
            got = {}
            for tag, rescue in rescues.items():
                S._device_rescue = rescue
                try:
                    x = step(st0)  # the first call: allocations, kernel lookup
                    fence(x.pos)
                    reads0 = step.syncs.count
                    t0 = time.perf_counter()
                    for _ in range(PER_STEP_READING_STEPS):
                        x = step(x)
                    fence(x.pos)
                    ms = (time.perf_counter() - t0) * 1000.0 / PER_STEP_READING_STEPS
                finally:
                    S._device_rescue = device_rescue
                got[tag] = (x, ms, (step.syncs.count - reads0) / PER_STEP_READING_STEPS)
            (a, ms_a, reads_a), (b, ms_b, reads_b) = got.values()
            differ = int(((a.pos != b.pos).any(0) | (a.vel != b.vel).any(0)
                          | (a.collisions != b.collisions)).sum())
            print(f"[{card}] per-step step, {where}, {PER_STEP_READING_STEPS} steps: "
                  f"rescue sized on the device {ms_a:.3f} ms/step ({reads_a:.2f} host "
                  f"reads/step), host-looped {ms_b:.3f} ms/step ({reads_b:.2f} host "
                  f"reads/step); {differ} lanes differ in any bit")
            if differ:
                raise RuntimeError(f"the per-step step's two rescues disagree ({where})")
        del spawn, step, a, b, x, got

        # ---- 8.3: simulate with a checkpoint (make_episode_runner) ----
        out3 = os.path.join(tmp, "simulate")
        wk.reset_launches()
        run_cli(card, "simulate", [
            "simulate", *scene_args, "--method", "spatial",
            "--steps", str(CLI_SIM_STEPS), "--checkpoint", "--out", out3])
        launches["simulate"] = dict(wk.LAUNCHES)
        if not per_step_launches_ok(launches["simulate"]):
            raise RuntimeError(f"simulate launches {launches['simulate']}")
        again = S.make_episode_runner(S.make_method_step(scene, "spatial"),
                                      CLI_SIM_STEPS)(spawn_grid(scene.config, CLI_LAYERS))
        fresh = snapshot(again)
        ckpt = snapshot(load_state(os.path.join(out3, f"state_{CLI_SIM_STEPS:06d}.npz")))
        bad = [k for k in fresh if fresh[k].dtype != ckpt[k].dtype
               or not (fresh[k] == ckpt[k]).all()]
        print(f"[{card}] simulate checkpoint at step {CLI_SIM_STEPS} against a fresh "
              f"run's snapshot: fields differing {bad or 'none'}")
        if bad:
            raise RuntimeError(f"checkpoint differs from the fresh run in {bad}")

        # ---- 8.4: p2pbox at 1,000,000 particles ----
        pk.reset_launches()
        text, _ = run_cli(card, "p2pbox", [
            "p2pbox", "--particles", str(P2P_N), "--steps", str(CLI_P2P_STEPS)])
        launches["p2pbox"] = dict(pk.LAUNCHES)
        box = json.loads(text.strip().splitlines()[-1])
        want_b3 = {"p2p_window_collide_sorted": 0,
                   "p2p_window_collide_cells": CLI_P2P_STEPS + 1,
                   "p2p_collide_worklist": CLI_P2P_STEPS + 1}
        if launches["p2pbox"] != want_b3 or box["contacts"] <= 0:
            raise RuntimeError(f"p2pbox launches {launches['p2pbox']} (want "
                               f"{want_b3}), contacts {box['contacts']}")
        print(f"[{card}] p2pbox {P2P_N}: {box['ms_per_step']:.3f} ms/step, contacts "
              f"{box['contacts']}, B3 launches {launches['p2pbox']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 8.5: the oracle steps on the spatial state at step 650 ----
    cfg = scene.config
    n = snap.pos.shape[-1]
    mask = active_mask(snap)
    grid, meta = G.build_triangle_grid(scene.triangles, cfg.grid, device=snap.pos.device)

    def one_step(tag, step, state):
        fence(state.pos)
        t0 = time.perf_counter()
        out = step(state)
        fence(out.pos)
        ms = (time.perf_counter() - t0) * 1000.0
        print(f"[{card}] {tag}: one step on {state.pos.shape[-1]} lanes {ms:.1f} ms, "
              f"hits {int((out.collisions - state.collisions).sum())}")
        return out, ms

    def lanes(state, idx):
        return ParticleState(*(x[..., idx] for x in state))

    def top_t2(state, idx):
        """Best and second-best t^2 over each lane's grid candidates."""
        st = lanes(state, idx)
        speed2 = (st.vel * st.vel).sum(0)
        dirn = st.vel / torch.sqrt(speed2)[None]
        v0, v1, v2, cm = G.gather_candidates(grid, meta, G.lookup_pos(st.pos, st.vel, cfg.dt))
        h = NP.particle_vs_triangles(st.pos, dirn, speed2 * cfg.dt * cfg.dt, v0, v1, v2,
                                     st.radius)
        t2 = torch.where(h.hit & cm, h.t2, float("inf"))
        two = torch.topk(t2, 2, dim=1, largest=False).values
        return two[:, 0], two[:, 1]

    stream_step = S.make_spatial_step_grid(scene.triangles, cfg, "stream")
    packed_step = S.make_spatial_step_grid(scene.triangles, cfg, "packed")
    o_stream, ms_stream = one_step("stream", stream_step, snap)
    o_packed, ms_packed = one_step("packed", packed_step, snap)
    hit_s = o_stream.collisions - snap.collisions
    hit_p = o_packed.collisions - snap.collisions
    hit_lanes = torch.nonzero((hit_s + hit_p) > 0).flatten()
    b0, b1 = top_t2(snap, hit_lanes)
    near = (b1 - b0) <= 1e-5 * b0
    differ = torch.nonzero(hit_s != hit_p).flatten()
    differ_near = int(torch.isin(differ, hit_lanes[near]).sum())
    close = torch.isclose(o_stream.pos, o_packed.pos, rtol=1e-5, atol=1e-6).all(0)
    bits = lane_diff(torch, o_stream.pos[:, mask], o_packed.pos[:, mask])
    print(f"[{card}] stream vs packed on {n} lanes: hits differ on {differ.numel()} "
          f"lanes ({differ_near} of them near ties), pos outside rtol 1e-5 atol 1e-6 "
          f"on {int((~close & mask).sum())} active lanes, differ in any bit on {bits}; "
          f"near ties (best and second t^2 within rtol 1e-5) among the "
          f"{hit_lanes.numel()} hit lanes: {int(near.sum())}")
    if differ.numel() != differ_near or int((~close & mask).sum()):
        raise RuntimeError("the stream step disagrees with the packed step")

    count = (grid.offsets[1:] - grid.offsets[:-1])[
        G.cell_index(G.lookup_pos(snap.pos, snap.vel, cfg.dt), meta).long()]
    busy = torch.argsort(torch.where(mask, count, -1), descending=True, stable=True)
    dense_idx = torch.sort(busy[:CLI_DENSE_LANES]).values
    dense_step = S.make_spatial_step_grid(scene.triangles, cfg, "dense")
    o_dense, ms_dense = one_step("dense (slice)", dense_step, lanes(snap, dense_idx))
    o_sd = lanes(o_stream, dense_idx)  # lanes are independent of each other
    dense_bits = sum(lane_diff(torch, a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]))
                     for a, b in zip(o_dense, o_sd))
    print(f"[{card}] dense vs stream on the {CLI_DENSE_LANES} active lanes whose cells "
          f"hold the most candidates ({int(count[dense_idx].min())}-"
          f"{int(count[dense_idx].max())}): lanes differing in any bit {dense_bits}")
    if dense_bits:
        raise RuntimeError("the dense step disagrees with the stream step")

    # the lanes that hit in either step, then the active lanes whose cells
    # hold the most candidates
    order = torch.cat([hit_lanes, busy[~torch.isin(busy, hit_lanes)]])
    bf_idx = torch.sort(order[:CLI_BF_LANES]).values
    bf_step = S.make_spatial_step_bruteforce(scene.triangles, cfg)
    o_bf, ms_bf = one_step("brute force (4,096 lanes)", bf_step, lanes(snap, bf_idx))
    o_sb = lanes(o_stream, bf_idx)
    hit_bf = o_bf.collisions - snap.collisions[bf_idx]
    hit_sb = o_sb.collisions - snap.collisions[bf_idx]
    bf_far = int((~torch.isclose(o_bf.pos, o_sb.pos, rtol=1e-5, atol=1e-6).all(0)).sum())
    print(f"[{card}] brute force vs stream on {bf_idx.numel()} lanes "
          f"({int((hit_sb > 0).sum())} hit in the stream step): hit sets differ on "
          f"{int((hit_bf != hit_sb).sum())} lanes, pos outside rtol 1e-5 atol 1e-6 "
          f"on {bf_far}")
    if int((hit_bf != hit_sb).sum()):
        raise RuntimeError("the grid misses a hit that brute force finds")

    # ---- 8.6: ResilientRunner, one injected device loss ----
    state0 = spawn_grid(cfg, CLI_LAYERS)
    calls = {"n": 0, "made": 0}
    err = R.DEVICE_ERRORS[0]

    def factory():
        calls["made"] += 1
        first = calls["made"] == 1
        step = S.make_spatial_step_sorted(scene.triangles, cfg, cells_lookup="kernel")

        def wrapped(s):
            calls["n"] += 1
            if first and calls["n"] == CLI_RESILIENT_FAIL_AT:
                raise err("injected CUDA device loss")
            return step(s)

        return wrapped

    t0 = time.perf_counter()
    runner = R.ResilientRunner(factory, chunk=50, max_retries=2, retry_wait_s=30.0)
    out = runner.run(state0, CLI_RESILIENT_STEPS)
    fence(out.pos)
    res_s = time.perf_counter() - t0
    ref = S.make_episode_runner(S.make_spatial_step_sorted(
        scene.triangles, cfg, cells_lookup="kernel"), CLI_RESILIENT_STEPS)(state0)
    diff = sum(lane_diff(torch, a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]))
               for a, b in zip(out, ref))
    print(f"[{card}] ResilientRunner, {CLI_RESILIENT_STEPS} sorted steps with one "
          f"injected {err.__name__} at call {CLI_RESILIENT_FAIL_AT}: recoveries "
          f"{runner.recoveries}, {res_s:.2f} s; lanes differing in any bit from an "
          f"uninterrupted run {diff}")
    if runner.recoveries != 1 or diff:
        raise RuntimeError("the resilient runner's result is not the uninterrupted one")
    print(f"[{card}] phase 8 (command line, oracles, resilient runner): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "ms": {"stream": ms_stream, "packed": ms_packed,
                                         "dense": ms_dense, "bruteforce": ms_bf}}


MESH_STEPS = 50  # phase 9: steps 600-650 of the main path, on a mesh
CONFIG5_STEPS = 5  # few, to keep the whole script near half its time limit


def check_rank_kernels(card: str, tag: str, who: str, rec: dict) -> None:
    """Print and gate one rank's B1 and B2 against their plain versions
    (``rec["b1"]``, ``rec["b2"]``) and its launches on the mesh runner."""
    b1, b2 = rec["b1"], rec["b2"]
    print(f"[{card}]   {who} ({rec['device']}): B1 main vs plain: "
          f"hit differs on {b1['hit_bad']} lanes, any bit on {b1['bits']}, "
          f"outside tolerance {b1['far']}, max |diff| {b1['err']:.3e}, hits "
          f"{b1['hits']}; B2 vs plain: {b2['bad']} lanes differ (misses "
          f"{b2['misses']}); launches on the mesh runner {rec['launches']}")
    if b1["hit_bad"] or b1["bits"] or b1["far"] or b2["bad"]:
        raise RuntimeError(f"{tag}, {who}: a kernel disagrees with its plain "
                           "version")
    if launch_fault(rec["launches"]):
        raise RuntimeError(f"{tag}, {who}: a kernel of the path never launched, or "
                           "B1 at the rescue window did")


def _mesh_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 9 in one rank of ``world`` (the backend is the one
    ``data_parallel.choose_backend`` picked for it): the spatial runner
    with mesh= from the main path's state at step 600 over MESH_STEPS
    steps, gathered to rank 0; B1 and B2 against their plain versions on
    this rank's state at step 650; then config 5, CONFIG5_STEPS timed
    steps.  Rank 0 saves the gathered state and every rank's record."""
    import torch
    import torch.distributed as dist

    from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import config_5
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.parallel import (
        data_parallel as dp,
    )

    mesh = dp.make_mesh(device_type="cuda")
    t0 = time.perf_counter()
    scene = dragon_scene()
    cfg = scene.config
    runner = S.make_sorted_episode_runner(
        scene.triangles, cfg, cells_lookup="kernel", resort_every="auto",
        mesh=mesh)
    setup_s = time.perf_counter() - t0
    glob = ParticleState(*torch.load(os.path.join(workdir, "snap600.pt")))
    local = dp.shard_state(glob, mesh)
    # the same tables without the mesh: this rank's slice alone, so the
    # mesh's cost is read in turns inside one process
    alone = S.SortedEpisodeRunner(runner.sp, "auto", 8192)
    # a first pass of each warms this fresh process (allocator, lazily
    # loaded modules) as the main path's 600 steps warmed the
    # single-device runner; the timed passes must repeat it bit for bit
    warm = runner(local, MESH_STEPS)
    alone(local, MESH_STEPS)
    # the host integer sums the mesh runner makes (the data-parallel
    # module's host collectives), counted over its first timed pass
    host_sums = [0]
    summers = {f: getattr(dp, f) for f in ("sum_ints", "sum_int_list")}

    def counted(fn):
        def call(*args, **kw):
            host_sums[0] += 1
            return fn(*args, **kw)
        return call

    ms = {"mesh": [], "alone": []}
    for turn in ("mesh", "alone", "mesh", "alone"):
        torch.cuda.synchronize()
        first_mesh = turn == "mesh" and not ms["mesh"]
        if first_mesh:
            wk.reset_launches()
            reads0 = runner.syncs.count
            for f, fn in summers.items():
                setattr(dp, f, counted(fn))
        t0 = time.perf_counter()
        if turn == "mesh":
            res, ovf_t = runner(local, MESH_STEPS, with_stats=True)
        else:
            res = alone(local, MESH_STEPS)
        torch.cuda.synchronize()
        ms[turn].append((time.perf_counter() - t0) * 1000.0 / MESH_STEPS)
        if first_mesh:
            for f, fn in summers.items():
                setattr(dp, f, fn)
            launches = dict(wk.LAUNCHES)
            reads = (runner.syncs.count - reads0) / MESH_STEPS
            out, ovf = res, ovf_t
        elif turn == "alone":
            alone_out = res
    repeat_diff = sum(lane_diff(torch, a, b) for a, b in zip(out, warm))
    alone_diff = sum(lane_diff(torch, a, b) for a, b in zip(out, alone_out))
    gathered = dp.gather_state(out, mesh)

    # B1 (main window) and B2 on this rank's state at step 650
    kw = dict(k_static=runner.sp.meta.max_tris_per_cell, gravity=cfg.gravity,
              dt=cfg.dt, backoff=cfg.backoff)
    b2_args, cases, _, _ = sorted_plan(torch, runner.sp, out)
    args, w = cases["main"]
    rec = {"rank": rank, "device": str(dp.rank_device(mesh)),
           "backend": dist.get_backend(), "n_local": out.pos.shape[-1],
           "setup_s": setup_s, "ms_mesh": ms["mesh"], "ms_alone": ms["alone"],
           "overflow": ovf, "reads_per_step": reads, "host_sums": host_sums[0],
           "captured": bool(runner._graphs),
           "repeat_diff": repeat_diff + alone_diff, "launches": launches,
           "b1": b1_vs_plain(torch, args, w, kw), "b2": b2_vs_plain(torch, b2_args)}
    del runner, alone, glob, local, out, warm, res, alone_out, b2_args, cases, args
    torch.cuda.empty_cache()
    rec["config5"] = config_5(steps=CONFIG5_STEPS)
    recs = [None] * world
    dist.all_gather_object(recs, rec)
    if rank == 0:
        torch.save({"state": tuple(x.cpu() for x in gathered), "ranks": recs},
                   os.path.join(workdir, f"mesh_{world}.pt"))


FIRST_WORLD = 3  # phase 9's partial meshes: ranks spawned
FIRST_MESHES = (1, 2)  # the meshes over the first n of them, in turn
FIRST_CONFIG5 = 2  # config 5's shards in that world


def _first_ranks_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 9's meshes over the first n of ``world`` ranks, in one rank:
    for each n of FIRST_MESHES every rank calls ``make_mesh(n)``; the
    members run the spatial runner with mesh= from the main path's state
    at step 600 over MESH_STEPS steps (a warm pass, then the timed pass),
    gather it to rank 0 and hold B1 and B2 against their plain versions
    on their own state at step 650; then config 5 on the first
    FIRST_CONFIG5 ranks.  The other ranks only take part in building
    each group.  Rank 0 saves the gathered states and every rank's
    record."""
    import torch
    import torch.distributed as dist

    from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import config_5
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import ParticleState
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.parallel import (
        data_parallel as dp,
    )

    scene = None
    rec = {"rank": rank, "meshes": {}}
    states = {}
    for n in FIRST_MESHES:
        mesh = dp.make_mesh(n, device_type="cuda")
        if mesh is None:
            rec["meshes"][n] = None
            continue
        scene = scene or dragon_scene()
        cfg = scene.config
        group = mesh.get_group()
        runner = S.make_sorted_episode_runner(
            scene.triangles, cfg, cells_lookup="kernel", resort_every="auto",
            mesh=mesh)
        glob = ParticleState(*torch.load(os.path.join(workdir, "snap600.pt")))
        local = dp.shard_state(glob, mesh)
        warm = runner(local, MESH_STEPS)
        torch.cuda.synchronize()
        wk.reset_launches()
        reads0 = runner.syncs.count
        t0 = time.perf_counter()
        out, ovf = runner(local, MESH_STEPS, with_stats=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0 / MESH_STEPS
        launches = dict(wk.LAUNCHES)
        reads = (runner.syncs.count - reads0) / MESH_STEPS
        repeat_diff = sum(lane_diff(torch, a, b) for a, b in zip(out, warm))
        gathered = dp.gather_state(out, mesh)
        kw = dict(k_static=runner.sp.meta.max_tris_per_cell, gravity=cfg.gravity,
                  dt=cfg.dt, backoff=cfg.backoff)
        b2_args, cases, _, _ = sorted_plan(torch, runner.sp, out)
        args, w = cases["main"]
        rec["meshes"][n] = {
            "mesh_ranks": dist.get_process_group_ranks(group),
            "mesh_rank": mesh.get_local_rank(), "backend": dist.get_backend(group),
            "device": str(dp.rank_device(mesh)), "n_local": out.pos.shape[-1],
            "ms": ms, "overflow": ovf, "reads_per_step": reads,
            "captured": bool(runner._graphs), "repeat_diff": repeat_diff,
            "launches": launches, "b1": b1_vs_plain(torch, args, w, kw),
            "b2": b2_vs_plain(torch, b2_args)}
        if rank == 0:
            states[n] = tuple(x.cpu() for x in gathered)
        del runner, glob, local, warm, out, gathered, b2_args, cases, args
        torch.cuda.empty_cache()
    rec["config5"] = config_5(steps=CONFIG5_STEPS, n_shards=FIRST_CONFIG5)
    recs = [None] * world
    dist.all_gather_object(recs, rec)
    if rank == 0:
        torch.save({"states": states, "ranks": recs},
                   os.path.join(workdir, f"first_of_{world}.pt"))


def drive_first_ranks(torch, card: str, workdir: str, snap650, ovf_single) -> dict:
    """Phase 9's meshes over the first n of FIRST_WORLD ranks on the card
    (``_first_ranks_rank``): each gathered state at step 650 must equal
    the single-device runner's on every lane, each member's B1 and B2
    their plain versions, each kernel must launch, the mesh over one rank
    must be NCCL and captured where ``choose_backend`` gives it NCCL,
    config 5 must keep every particle on the first FIRST_CONFIG5 ranks,
    and every other rank must sit out.  Returns each mesh's per-member
    launches."""
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun import (
        run_ranks,
    )

    world = FIRST_WORLD
    t0 = time.perf_counter()
    run_ranks(_first_ranks_rank, world, workdir, device_type="cuda")
    wall = time.perf_counter() - t0
    res = torch.load(os.path.join(workdir, f"first_of_{world}.pt"))
    recs = res["ranks"]
    n_all = snap650.pos.shape[-1]
    mask = active_mask(snap650)
    world_backend = dp.choose_backend("cuda", world)
    print(f"[{card}] phase 9, the first n of {world} ranks ({wall:.1f} s with "
          f"spawn; the world over {world_backend}): meshes over the first "
          + ", ".join(str(n) for n in FIRST_MESHES) + " ranks")
    launches = {}
    for n in FIRST_MESHES:
        backend = dp.choose_backend("cuda", n)
        tag = f"first {n} of {world} ranks over {backend}"
        members = [r["meshes"][n] for r in recs[:n]]
        if any(m is None for m in members) or any(
                r["meshes"][n] is not None for r in recs[n:]):
            raise RuntimeError(f"{tag}: the mesh is not the first {n} ranks")
        got = [x.to(snap650.pos.device) for x in res["states"][n]]
        diff = sum(lane_diff(torch, g, w) for g, w in zip(got, snap650))
        ovf = members[0]["overflow"]
        print(f"[{card}] phase 9, {tag}: spatial runner with mesh=, steps "
              f"600-650, {n_all // n} particles per member: lanes differing from "
              f"the single-device runner {diff} of {n_all} (collisions "
              f"{int(got[2][mask].sum())} vs {int(snap650.collisions[mask].sum())}); "
              f"overflow summed over members and steps {sum(ovf)} (single device "
              f"{sum(ovf_single)}); ms/step by member (timed pass) "
              + ", ".join(f"{m['ms']:.3f}" for m in members)
              + "; host reads per step " + ", ".join(
                  f"{m['reads_per_step']:.4f}" for m in members)
              + "; step captured " + ", ".join(str(m["captured"]) for m in members)
              + ("; members share one card: not a multi-GPU number"
                 if n > torch.cuda.device_count() else ""))
        if diff:
            raise RuntimeError(f"{tag}: mesh runner differs from the single-device "
                               f"runner on {diff} lanes")
        if any(m["mesh_ranks"] != list(range(n)) or m["backend"] != backend
               or m["overflow"] != ovf or m["repeat_diff"] for m in members):
            raise RuntimeError(f"{tag}: members disagree on the group, backend "
                               "or overflow, or a pass did not repeat")
        if any(m["reads_per_step"] > 1 or m["captured"] != (backend == "nccl")
               for m in members):
            raise RuntimeError(f"{tag}: the mesh runner read more than the flag, "
                               "or was not captured as its backend implies")
        for m in members:
            check_rank_kernels(card, tag, f"member {m['mesh_rank']}", m)
        launches[f"first{n}_of{world}_{backend}"] = [m["launches"] for m in members]
    c5 = [r["config5"] for r in recs]
    members, rest = c5[:FIRST_CONFIG5], c5[FIRST_CONFIG5:]
    backend = dp.choose_backend("cuda", FIRST_CONFIG5)
    print(f"[{card}] phase 9, first {FIRST_CONFIG5} of {world} ranks over {backend}: "
          f"config 5, {members[0]['particles']} particles, {CONFIG5_STEPS} timed "
          f"steps: alive after {members[0]['active_particles']}; overflow halo "
          f"{members[0]['halo_overflow']}, migrate "
          f"{members[0]['migrate_overflow']}, cell "
          f"{members[0]['cell_overflow']}; ms/step "
          + ", ".join(f"{1000.0 / c['steps_per_sec']:.3f}" for c in members)
          + "; the other ranks: " + ", ".join(json.dumps(c) for c in rest))
    if any(c.get("sat_out") or c["active_particles"] != c["particles"]
           or c["halo_overflow"] or c["migrate_overflow"]
           or c["shards"] != FIRST_CONFIG5 or c["backend"] != backend
           for c in members):
        raise RuntimeError("config 5 on the first ranks lost particles, overflowed "
                           "or ran on the wrong group")
    if any(c != {"config": 5, "shards": FIRST_CONFIG5, "rank": r, "sat_out": True}
           for r, c in enumerate(rest, FIRST_CONFIG5)):
        raise RuntimeError("a rank outside config 5's mesh did not sit out")
    return launches


def drive_mesh(torch, card: str, snap600, snap650, ovf_single, single_ms) -> dict:
    """Phase 9: the multi-device paths, in ranks spawned after the kernel
    build (so no rank builds) from the main path's state at step 600.
    World 1 over NCCL, then 2 ranks on the one card over gloo (the
    exchange staged through host memory), then, with at least two cards,
    min(4, cards) ranks over NCCL.  Each run's gathered state at step
    650 must equal the single-device runner's (``snap650``) bit for bit
    on every lane, B1 and B2 must equal their plain versions in every
    rank, and config 5 must keep every particle.  Returns each world's
    per-rank B1 and B2 launches on the mesh runner."""
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
        run_ranks,
    )

    t_phase = time.perf_counter()
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "phase9")
    os.makedirs(workdir, exist_ok=True)
    torch.save(tuple(x.cpu() for x in snap600), os.path.join(workdir, "snap600.pt"))
    n = snap650.pos.shape[-1]
    mask = active_mask(snap650)
    worlds = [1, 2]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        worlds.append(min(4, n_cards))
    else:
        print(f"[{card}] phase 9: {n_cards} card: the NCCL run over several "
              "cards is skipped")
    print(f"[{card}] phase 9: single-device runner, steps 600-650: "
          f"{single_ms:.3f} ms/step, overflow summed over the steps "
          f"{sum(ovf_single)}")
    launches = {}
    for world in worlds:
        backend = dp.choose_backend("cuda", world)
        shared = world > n_cards
        tag = (f"{world} rank{'s' if world > 1 else ''} over {backend}"
               + (" on one card" if shared else ""))
        t0 = time.perf_counter()
        run_ranks(_mesh_rank, world, workdir, device_type="cuda")
        wall = time.perf_counter() - t0
        res = torch.load(os.path.join(workdir, f"mesh_{world}.pt"))
        recs = res["ranks"]
        got = [x.to(snap650.pos.device) for x in res["state"]]
        diff = sum(lane_diff(torch, g, w) for g, w in zip(got, snap650))
        note = ("; 2 ranks share one card: not a multi-GPU number"
                if shared else "")
        ovf = recs[0]["overflow"]
        print(f"[{card}] phase 9, {tag} ({wall:.1f} s with spawn): spatial "
              f"runner with mesh=, steps 600-650, {n // world} particles per "
              f"rank: lanes differing from the single-device runner {diff} of "
              f"{n} (collisions {int(got[2][mask].sum())} vs "
              f"{int(snap650.collisions[mask].sum())}); overflow summed over "
              f"ranks and steps {sum(ovf)} (single device {sum(ovf_single)}); "
              f"ms/step by rank, "
              f"two passes each in turns, with mesh= / the same slice without: "
              + "; ".join(" / ".join(", ".join(f"{t:.3f}" for t in r[k])
                                     for k in ("ms_mesh", "ms_alone"))
                          for r in recs)
              + " (host setup " + ", ".join(f"{r['setup_s']:.1f}" for r in recs)
              + f" s){note}")
        if diff:
            raise RuntimeError(f"{tag}: mesh runner differs from the single-device "
                               f"runner on {diff} lanes")
        # "auto" re-sorts from the summed overflow: ranks that report the
        # same sequence re-sorted at the same steps
        if any(r["backend"] != backend or r["overflow"] != ovf for r in recs):
            raise RuntimeError(f"{tag}: ranks disagree on backend or overflow")
        if any(r["repeat_diff"] for r in recs):
            raise RuntimeError(f"{tag}: a timed pass differs from the warm pass "
                               "or from the slice run without the mesh")
        # "auto" sums the overflow on the device; the host reads the flag
        # derived from the sum, one a step after the first.  The step is
        # captured where the collectives run on the device (NCCL)
        print(f"[{card}] phase 9, {tag}: host reads per step "
              + ", ".join(f"{r['reads_per_step']:.4f}" for r in recs)
              + "; host integer sums " + ", ".join(str(r["host_sums"]) for r in recs)
              + "; step captured " + ", ".join(str(r["captured"]) for r in recs))
        if any(r["reads_per_step"] > 1 or r["host_sums"]
               or r["captured"] != (backend == "nccl") for r in recs):
            raise RuntimeError(f"{tag}: the mesh runner read or summed on the host, "
                               "or was not captured as its backend implies")
        for r in recs:
            check_rank_kernels(card, tag, f"rank {r['rank']}", r)
        launches[f"world{world}_{backend}"] = [r["launches"] for r in recs]
        c5 = [r["config5"] for r in recs]
        print(f"[{card}] phase 9, {tag}: config 5, {c5[0]['particles']} particles, "
              f"{CONFIG5_STEPS} timed steps: alive after {c5[0]['active_particles']}; "
              f"overflow halo {c5[0]['halo_overflow']}, migrate "
              f"{c5[0]['migrate_overflow']}, cell "
              f"{c5[0]['cell_overflow']}; ms/step "
              + ", ".join(f"{1000.0 / c['steps_per_sec']:.3f}" for c in c5)
              + f"{note}")
        if any(c["active_particles"] != c["particles"]
               or c["halo_overflow"] or c["migrate_overflow"]
               or c["backend"] != backend for c in c5):
            raise RuntimeError(f"{tag}: config 5 lost particles or overflowed")
    t0 = time.perf_counter()
    launches.update(drive_first_ranks(torch, card, workdir, snap650, ovf_single))
    added = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun_multichip(2)
    print(f"[{card}] phase 9: the dry-run entry point, 2 ranks over "
          f"{dp.choose_backend('cuda', 2)}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_multichip(2, world=FIRST_WORLD)
    dt = time.perf_counter() - t0
    added += dt
    print(f"[{card}] phase 9: the dry-run entry point, the first 2 of "
          f"{FIRST_WORLD} ranks over {dp.choose_backend('cuda', 2)}: {dt:.1f} s")
    print(f"[{card}] phase 9: the meshes over the first ranks of "
          f"{FIRST_WORLD} and their dry run added {added:.1f} s")
    print(f"[{card}] phase 9 (multi-device paths): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 10: the reference protocol's particle ladder (bench/protocol.py)
PROTOCOL_K = 7  # 128^2 x 2^7 = 2,097,152 spawns, cut to the reference cap
PROTOCOL_STEPS = 2001  # the reference's lifetime_steps: nothing cut
PROTOCOL_SNAP_STEP = 1500
PROTOCOL_WINDOWS = ((1, 151), (151, 600), (600, 1400), (1400, 2001))
CAMERA_STEPS = 50  # sweep (b): k = 0 on the four cameras


def _prebake(cam_index: int) -> float:
    """Bake one DragonScene camera into the disk cache (``PSYS_BAKE_CACHE``)
    on the host, in a worker process of ``prebake``.  Returns its seconds."""
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as ss

    scene = dragon_scene()
    t0 = time.perf_counter()
    ss.bake_camera(scene.triangles, scene.cameras[cam_index], scene.corner_normals,
                   device="cpu")
    return time.perf_counter() - t0


def prebake(card: str) -> None:
    """Bake DragonScene's four cameras (1920 x 1080, corner normals) into
    the disk cache before any phase needs them: one spawned worker process
    per camera not yet cached, all at once (each bake is a minute of
    single-threaded host NumPy), joined before the function returns."""
    import concurrent.futures
    import multiprocessing

    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as ss

    scene = dragon_scene()
    pending = [i for i, cam in enumerate(scene.cameras) if not os.path.exists(
        ss.bake_path(scene.triangles, cam, scene.corner_normals))]
    if not pending:
        print(f"[{card}] bakes: all {len(scene.cameras)} cameras in the disk cache")
        return
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(pending),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        bake_s = list(pool.map(_prebake, pending))
    print(f"[{card}] bakes of "
          + ", ".join(f"{scene.cameras[i].name!r} {t:.1f} s"
                      for i, t in zip(pending, bake_s))
          + f" ({scene.cameras[0].width}x{scene.cameras[0].height}, corner normals, "
          f"host, one worker process each): {time.perf_counter() - t0:.1f} s in all")


class _EpisodeTap:
    """Stands in for the sorted runner that ``bench/harness.py`` builds for
    the spatial episode, so phase 10 sees the episode the protocol runs:
    every call runs with ``with_stats`` (the overflow of each step), a call
    that would pass ``snap_step`` is split there to keep that state, and
    the last state is kept.  The states are the runner's.  A call from the
    state of the first call restarts the count: the harness warms the
    runner from the spawn state, then runs the episode from it.  The
    host reads and kernel launches so far are kept at the first call's
    end at or past ``mark_step`` (``mark``) and at the last call's
    (``end``): (step, reads, launches).  ``stats_steps`` counts every step
    it ran, all with stats."""

    def __init__(self, runner, snap_step: int, mark_step: int):
        self.runner, self.snap_step, self.mark_step = runner, snap_step, mark_step
        self.sp = runner.sp
        self.spawn = None
        self.stats_steps = 0

    def counters(self):
        from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
            window_kernel as wk,
        )
        return self.done, self.runner.syncs.count, dict(wk.LAUNCHES)

    def __call__(self, state, num_steps: int):
        if self.spawn is None or state is self.spawn:
            self.spawn = state
            self.done, self.overflow, self.snap, self.mark = 0, [], None, None
            self.syncs0 = self.runner.syncs.count
        parts = [num_steps]
        if self.done < self.snap_step < self.done + num_steps:
            parts = [self.snap_step - self.done, self.done + num_steps - self.snap_step]
        for n in parts:
            state, ovf = self.runner(state, n, with_stats=True)
            self.overflow += ovf
            self.done += n
            self.stats_steps += n
            if self.done == self.snap_step:
                self.snap = state
        if self.mark is None and self.done >= self.mark_step:
            self.mark = self.counters()
        self.end = self.counters()
        self.last = state
        return state


# the rescue's turns (phase 10): the spatial k = 7 episode in the
# benchmark's calls of 87 steps (2001 = 23 x 87), and its free-fall step
RESCUE_CALL_STEPS = 87
RESCUE_FREE_FALL_STEP = 100


def rescue_inputs(runner, spawn, step: int) -> tuple:
    """The arguments that ``_device_rescue`` gets in step ``step`` (1 is the
    first) of the episode ``runner`` steps from ``spawn`` in calls of
    RESCUE_CALL_STEPS: the calls before the one that holds the step
    replayed, that one up to the step stepped eagerly (``uncaptured``:
    the same bits), each rescue's arguments copied on the way in.
    Returns (kernel_out, sorted_state, overflow, key_s, ovf_count)."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as GR
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S

    before = (step - 1) // RESCUE_CALL_STEPS * RESCUE_CALL_STEPS
    state = spawn
    for _ in range(before // RESCUE_CALL_STEPS):
        state = runner(state, RESCUE_CALL_STEPS)
    kept = []
    device_rescue = S._device_rescue

    def keep(kernel_out, sorted_state, overflow, sp, *, key_s, ovf_count, syncs,
             tap=None):
        kept[:] = [(tuple(x.clone() for x in kernel_out),
                    tuple(x.clone() for x in sorted_state), overflow.clone(),
                    key_s.clone(), ovf_count.clone())]
        return device_rescue(kernel_out, sorted_state, overflow, sp, key_s=key_s,
                             ovf_count=ovf_count, syncs=syncs, tap=tap)

    S._device_rescue = keep
    try:
        with GR.uncaptured():
            runner(state, step - before)
    finally:
        S._device_rescue = device_rescue
    return kept[0]


def rescue_front_case(torch, card: str, tag: str, sp, sorted_state, overflow) -> dict:
    """The rescue's front (``window_kernel.rescue_front``) against its plain
    version run on the card (``_rescue_front_plain``, the CPU route of
    ``_device_rescue``) on one step's rescue inputs, without and with the
    fit mask: the list, both counts, (start, count) at every listed lane
    and the mask at every lane, bit for bit (raises on any difference);
    then the kernel alone timed (without the mask, as the dragon's steps
    run it) beside its byte bound: what these inputs need (every lane's
    flag, an overflow lane's rows and table entry, a listed lane's
    (start, count) and slot, the bitmap written and read), and beside it
    the bound of the same front at every lane (41 B a lane: rows, flag,
    table entry, (start, count) written; and the list).  Returns its
    kernel-table numbers."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    def front(with_fit):
        return wk.rescue_front(*sorted_state[:2], overflow, sp.tables.cells2, sp.meta,
                               dt=sp.cfg.dt, w=sp.rescue_window, with_fit=with_fit)

    def plain():
        return S._rescue_front_plain(sorted_state, overflow, sp)

    p_start, p_count, p_fit, p_lanes, p_n, p_over = plain()
    n, m, n_over = overflow.shape[0], int(p_n), int(p_over)
    pick = p_lanes[:m].long()
    differ = {}
    for with_fit in (False, True):
        start, count, fit, lanes, n_lanes, k_over = front(with_fit)
        torch.cuda.synchronize()
        differ["with the mask" if with_fit else "without"] = (
            int(int(n_lanes) != m) + int(int(k_over) != n_over)
            + int((lanes[:m] != p_lanes[:m]).sum())
            + int((start[pick] != p_start[pick]).sum())
            + int((count[pick] != p_count[pick]).sum())
            + (int((fit != p_fit).sum()) if with_fit else 0))
    print(f"[{card}] the rescue's front ({tag}; {n} lanes, {n_over} overflow, {m} "
          f"listed): entries differing from the plain front's {differ}")
    if any(differ.values()):
        raise RuntimeError(f"the rescue's front ({tag}) disagrees with its plain version")
    t = timed(torch, lambda: front(False), plain)
    words = -(-n // 32) * 4
    n_bytes = n + n_over * (24 + 8) + m * (8 + 4) + 2 * words
    n_bytes_full = n * (24 + 1 + 8 + 8) + m * 4
    bound = n_bytes / H100_BYTES_PER_S * 1e3
    bound_full = n_bytes_full / H100_BYTES_PER_S * 1e3
    print(f"[{card}] the rescue's front ({tag}): {t['ms']:.4f} ms by events around the "
          f"call, {ms_text(t['device_ms'])} on the device ({by_kernel(t.pop('by_kernel'))}); "
          f"plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms (bytes: {n_bytes} B), "
          f"at every lane {bound_full:.4f} ms (bytes: {n_bytes_full} B)")
    return {"max_abs_err": 0, **t, "bound_ms": bound, "bound_by": "bytes",
            "bound_every_lane_ms": bound_full, "lanes": n, "overflow": n_over,
            "listed": m}


def rescue_route(torch, card: str, runner, spawn) -> dict:
    """The rescue (``_device_rescue``: every overflow lane straight to the
    worklist) on DragonScene at k = 7.

    (a) The episode: PROTOCOL_STEPS steps from ``spawn`` in calls of
    RESCUE_CALL_STEPS with stats, by ``runner`` (captured): the rescue
    lists every overflow lane on every step (the ring's ``n_lanes``
    equals its ``n_over``); ms a step.

    (b) Three steps of that episode: free fall (RESCUE_FREE_FALL_STEP),
    PROTOCOL_SNAP_STEP, and the step with the most overflow lanes.  On the
    rescue's arguments there (``rescue_inputs``) the rescue, made eagerly
    and replayed from a CUDA graph of the call, gives the host-looped
    ``_chunked_rescue``'s bits and lists every overflow lane; then it is
    timed (CUDA events around one call made eagerly and around one
    replay, the median of REPS each, the main launch's output copied
    back in before each call, outside the events).  Returns the numbers."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as GR
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S

    sp = runner.sp
    if S._phase3_possible(sp) or PROTOCOL_STEPS % RESCUE_CALL_STEPS:
        raise RuntimeError("the rescue's checks want a scene without phase 3 and "
                           "whole calls")
    t_phase = time.perf_counter()
    n = PROTOCOL_STEPS
    state, ovf, lanes = spawn, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n // RESCUE_CALL_STEPS):
        state, o = runner(state, RESCUE_CALL_STEPS, with_stats=True)
        ovf += o
        lanes += runner.telemetry.records[-1].counters["n_lanes"].tolist()
    torch.cuda.synchronize()
    ms_episode = (time.perf_counter() - t0) * 1e3 / n
    del state
    print(f"[{card}] the rescue over the k={PROTOCOL_K} spatial episode ({n} steps, "
          f"calls of {RESCUE_CALL_STEPS}, with stats): {ms_episode:.4f} ms/step; "
          f"overflow mean {sum(ovf) / n:.1f}, max {max(ovf)}; listed lanes mean "
          f"{sum(lanes) / n:.1f}, equal to the overflow on "
          f"{sum(x == y for x, y in zip(lanes, ovf))} of {n} steps")
    if lanes != ovf:
        raise RuntimeError("the rescue left an overflow lane unlisted")
    numbers = {"episode_ms_per_step": ms_episode, "mean_overflow": sum(ovf) / n}

    peak = max(range(n), key=lambda i: ovf[i]) + 1
    for where, step in (("free fall", RESCUE_FREE_FALL_STEP),
                        (f"k={PROTOCOL_K} step {PROTOCOL_SNAP_STEP}", PROTOCOL_SNAP_STEP),
                        ("the most overflow", peak)):
        kernel_out, sorted_state, overflow, key_s, ovf_count = rescue_inputs(
            runner, spawn, step)
        n_over = int(overflow.sum())
        if n_over != ovf[step - 1]:
            raise RuntimeError(f"step {step}: the rescue's inputs are not the episode's")
        bufs = tuple(x.clone() for x in kernel_out)
        # a rescue's ``tap``: it keeps the count of the lanes listed
        tap = types.SimpleNamespace(lanes=None)

        def call():
            return S._device_rescue(bufs, sorted_state, overflow, sp, key_s=key_s,
                                    ovf_count=ovf_count, syncs=S.HostSyncs(), tap=tap)

        def reset():
            for x, x0 in zip(bufs, kernel_out):
                x.copy_(x0)

        host = S._chunked_rescue(tuple(x.clone() for x in kernel_out), sorted_state,
                                 overflow, sp, key_s=key_s, ovf_count=ovf_count,
                                 syncs=S.HostSyncs())
        call()  # warm: allocations
        out = tuple(x.clone() for x in bufs)
        graph, _, _ = GR._capture(call)
        reset()
        graph.replay()
        torch.cuda.synchronize()
        if any(not torch.equal(x, y) for x, y in zip(bufs, out)):
            raise RuntimeError(f"step {step}: the rescue's graph and its eager call "
                               "disagree")
        differ = sum(lane_diff(torch, x, y) for x, y in zip(out, host[:3]))
        listed = int(tap.lanes)
        ms = {}
        for mode in ("eager", "replay"):
            times = []
            for _ in range(REPS):
                reset()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                if mode == "eager":
                    call()
                else:
                    graph.replay()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            times.sort()
            ms[mode] = (times[REPS // 2 - 1] + times[REPS // 2]) / 2.0
        print(f"[{card}] the rescue at {where} (step {step}; {n_over} overflow lanes, "
              f"{listed} listed): lanes differing from the host-looped rescue's in "
              f"any bit {differ}; ms eager / replayed {ms['eager']:.4f} / "
              f"{ms['replay']:.4f}")
        if differ or listed != n_over:
            raise RuntimeError(f"step {step}: the rescue and the host-looped rescue "
                               "disagree, or it left an overflow lane unlisted")
        del graph, bufs, out, host
        numbers[where] = {"step": step, "overflow": n_over, "listed": listed, "ms": ms,
                          "front": rescue_front_case(torch, card, f"{where}, step {step}",
                                                     sp, sorted_state, overflow)}
    print(f"[{card}] the rescue's checks: {time.perf_counter() - t_phase:.1f} s")
    return numbers


def drive_protocol(torch, card: str) -> dict:
    """Phase 10: the reference protocol's particle ladder on DragonScene
    through ``bench/protocol.py::run_protocol`` (plan "kernel", no accuracy
    CSV, output under build/protocol/; the cameras' bakes come from
    the disk cache that ``prebake`` filled).

    (a) k = 7 (2,097,120 particles, 32 sentinel lanes), the three methods
    on "Main Camera", one run of 2001 steps: every row at 2,097,120 with
    collisions; ms/step by window from the perf CSV; B1 and B2 launched.
    The harness's runner of the spatial episode is tapped (``_EpisodeTap``):
    on that episode's last state no NaN on active lanes, the sentinels at
    1e38 with no horizontal velocity and no hit, never a live lane of the
    plan; its overflow per step; its host reads and launches per step
    over the steps from 1400; on its state at step 1500, B1 (main window,
    rescue phase 1, the 8,192-lane chunk), the worklist entry point and B2
    against their plain versions, and one step of the runner (replayed)
    against one of the per-step step with the rescue looped on the host
    (``_chunked_rescue``) in place of its own, on every lane; then the
    rescue over the episode and at three of its steps (``rescue_route``).

    (b) k = 0, the three methods on all four cameras, one run of 50
    steps: a row for each; each camera's undecided mask on the k = 7 state
    at step 2001 holds active lanes and the falling sentinels, which carry
    no candidates in the hybrid's plan.

    Returns the launches of each sweep and the kernel-table numbers of
    the step-1500 cases."""
    from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as H
    from particlesystemhybridcollisiondetection_tpu_torch.bench import protocol as P
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as ss
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        screenspace_kernel as ssk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        telemetry_kernel as tk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )

    t_phase = time.perf_counter()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "protocol")
    scene = dragon_scene()
    cfg = scene.config
    methods = P.METHODS
    n_real = cfg.spawn_count(1 << PROTOCOL_K)

    # ---- 10(a): k = 7, the three methods on "Main Camera", 2001 steps ----
    taps = []

    def tapped_runner(triangles, cfg_, **kw):
        runner = make_runner(triangles, cfg_, **kw)
        if kw.get("camera") is None:  # the spatial episode's
            taps.append(_EpisodeTap(runner, PROTOCOL_SNAP_STEP, PROTOCOL_WINDOWS[-1][0]))
            return taps[-1]
        return runner

    make_runner = H.make_sorted_episode_runner
    H.make_sorted_episode_runner = tapped_runner
    wk.reset_launches()
    tk.reset_launches()
    ssk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rows = P.run_protocol(scene, [PROTOCOL_K], methods, num_runs=1,
                              num_steps=PROTOCOL_STEPS, out_dir=os.path.join(out, "k7"),
                              accuracy=False, plan="kernel", camera_indices=[0])
    finally:
        H.make_sorted_episode_runner = make_runner
    wall_a = time.perf_counter() - t0
    launches_a = dict(wk.LAUNCHES)
    tel_launches_a = dict(tk.LAUNCHES)
    ss_launches_a = ssk.LAUNCHES["screen_space_collide"]
    cam0 = scene.cameras[0].name
    if [(r["method"], r["camera"]) for r in rows] != [(m, cam0) for m in methods]:
        raise RuntimeError(f"protocol k={PROTOCOL_K}: rows {rows}")
    for r in rows:
        if r["particles"] != n_real or r["collisions"] <= 0 or not r["mean_ms"] > 0:
            raise RuntimeError(f"protocol k={PROTOCOL_K}: row {r}")
    with open(os.path.join(out, "k7", f"results_perf_{scene.name}_{n_real}.csv")) as f:
        lines = f.read().splitlines()
    names = {H.METHOD_NAMES[m]: m for m in methods}
    per_step: dict = {}
    for line in lines:
        a, b = line.split(";")
        if b == "ms":
            cur = per_step.setdefault(names[a], [])
        else:
            cur.append(float(b))
    # row j of the perf CSV is step j + 1 (step 0 is the harness's warm step)
    if any(len(v) != PROTOCOL_STEPS - 1 for v in per_step.values()):
        raise RuntimeError(f"perf CSV rows {[len(v) for v in per_step.values()]}")
    for r in rows:
        v = per_step[r["method"]]
        print(f"[{card}] protocol k={PROTOCOL_K}, {r['method']} ({cam0!r}), "
              f"{r['particles']} particles, {PROTOCOL_STEPS} steps: mean "
              f"{r['mean_ms']:.3f} ms/step; "
              + ", ".join(f"steps {a}-{b} {sum(v[a - 1:b - 1]) / (b - a):.3f}"
                          for a, b in PROTOCOL_WINDOWS)
              + f" ms/step (harness chunks of 50 steps); collisions {r['collisions']}")
    # two exact methods, each a runner step a step (warm-up included):
    # each kernel as a runner step launches it (``STEP_LAUNCHES``)
    n_b2 = launches_a["cells_window_lookup"]
    if n_b2 < 2 * PROTOCOL_STEPS or launches_a != {
            k: v * n_b2 for k, v in STEP_LAUNCHES.items()}:
        raise RuntimeError(f"protocol k={PROTOCOL_K} launches {launches_a}: a kernel "
                           "of the path never launched, or not once a step")
    print(f"[{card}] protocol k={PROTOCOL_K}: {wall_a:.1f} s; launches {launches_a}, "
          f"the screen-space kernel {ss_launches_a} (the screen-space and the hybrid "
          f"episodes, one a step); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- the spatial episode's own states, through the tap ----
    if len(taps) != 1 or taps[0].done != PROTOCOL_STEPS or taps[0].snap is None:
        raise RuntimeError("the spatial episode's runner was not tapped as expected")
    tap = taps[0]
    sp, s, snap, ovf = tap.sp, tap.last, tap.snap, tap.overflow
    mask = active_mask(s)
    n_pad = s.pos.shape[-1] - n_real
    pad = slice(n_real, None)
    nan_lanes = int((~torch.isfinite(s.pos[:, mask]).all(0)).sum()
                    + (~torch.isfinite(s.vel[:, mask]).all(0)).sum())
    coll = int(s.collisions[mask].sum())
    vmax = float(torch.sqrt((s.vel[:, mask] ** 2).sum(0).max()))
    sv = s.vel[:, pad]
    sentinels_ok = bool(
        n_pad == -n_real % wk.BLOCK and int(mask.sum()) == n_real and not mask[pad].any()
        and (s.pos[:, pad] == 1e38).all() and (sv[0] == 0).all() and (sv[2] == 0).all()
        and torch.isfinite(sv[1]).all() and (sv[1] == sv[1, 0]).all()
        and (s.collisions[pad] == 0).all())
    check_telemetry_launches(f"protocol k={PROTOCOL_K}, the spatial episode",
                             tel_launches_a, tap.stats_steps, False)
    (m_step, m_reads, m_launch), (e_step, e_reads, e_launch) = tap.mark, tap.end
    late = e_step - m_step
    print(f"[{card}] protocol k={PROTOCOL_K}, the spatial episode, steps {m_step}-"
          f"{e_step}: host reads {(e_reads - m_reads) / late:.4f}/step; launches per step "
          + ", ".join(f"{k} {(e_launch[k] - m_launch[k]) / late:.4f}" for k in e_launch))
    print(f"[{card}] protocol k={PROTOCOL_K}, the spatial episode at step "
          f"{PROTOCOL_STEPS}: overflow per step max {max(ovf)}, median "
          f"{sorted(ovf)[len(ovf) // 2]}; host reads "
          f"{(tap.runner.syncs.count - tap.syncs0) / PROTOCOL_STEPS:.2f}/step; "
          f"{tap.stats_steps} steps with stats, telemetry launches {tel_launches_a}; "
          f"collisions {coll} (row {rows[methods.index('spatial')]['collisions']}); "
          f"NaN/inf on {nan_lanes} active lanes; max speed {vmax:.2f} u/s (bound "
          f"g*dt*steps {abs(cfg.gravity[1]) * cfg.dt * PROTOCOL_STEPS:.1f}, lookup cover "
          f"2*(expand - r)/dt {2 * (cfg.grid.expand - cfg.particle_radius) / cfg.dt:.1f}); "
          f"{n_pad} sentinel lanes: pos 1e38, vel (0, {float(sv[1, 0]):.4f}, 0) "
          f"(integrated as every lane is), hits {int(s.collisions[pad].sum())}: "
          f"{'inert' if sentinels_ok else 'NOT inert'}")
    if nan_lanes:
        raise RuntimeError(f"protocol k={PROTOCOL_K}: {nan_lanes} active lanes hold NaN/inf")
    if not sentinels_ok:
        raise RuntimeError(f"protocol k={PROTOCOL_K}: sentinel lanes moved, collided "
                           "or counted")
    if coll != rows[methods.index("spatial")]["collisions"] or len(ovf) != PROTOCOL_STEPS:
        raise RuntimeError("the tapped states are not the spatial row's episode")

    # ---- B1 and B2 against their plain versions on the state at step 1500 ----
    def sentinels_in_plan(tag, state, undecided=None):
        """The sentinel lanes in ``state``'s plan: where they sort, B2's
        count for them, and whether any is a live lane (a candidate count
        or a place in the overflow mask), which raises.  Returns the plan."""
        b2_args, cases, overflow, wl_args = sorted_plan(torch, sp, state, undecided)
        pos_s, count_main = cases["main"][0][0], cases["main"][0][5]
        sent_s = pos_s[0] > 5e37
        _, cnt_b2 = wk.cells_window_lookup(*b2_args, wc=S._CODE_WC)
        where = torch.nonzero(sent_s).flatten()
        print(f"[{card}] {tag}: {int(overflow.sum())} overflow lanes in the main "
              f"plan; the {int(sent_s.sum())} sentinel lanes sort to positions "
              f"{int(where.min())}-{int(where.max())}, B2 count there "
              f"{sorted(set(cnt_b2[sent_s].tolist()))}, in the overflow mask "
              f"{int(overflow[sent_s].sum())}, main-plan count "
              f"{int(count_main[sent_s].abs().sum())}")
        if int(sent_s.sum()) != n_pad or overflow[sent_s].any() or count_main[sent_s].any():
            raise RuntimeError(f"{tag}: a sentinel lane is a live lane of the plan")
        return b2_args, cases, wl_args

    b2_args, cases, wl_args = sentinels_in_plan(
        f"protocol k={PROTOCOL_K}, state at step {PROTOCOL_SNAP_STEP}", snap)
    at = f"protocol k={PROTOCOL_K}, step {PROTOCOL_SNAP_STEP}"
    numbers = {"b2": b2_case(torch, card, at, b2_args), "b1": {},
               "worklist": worklist_case(torch, card, sp, at, wl_args)}
    # the stamp's counters in phase 10's telemetry case: this step's
    # window overflow and rescue phase 2's listed lanes
    tel_scalars = (torch.tensor(ovf[PROTOCOL_SNAP_STEP], dtype=torch.int32,
                                device=snap.pos.device), wl_args[7])
    for tag, (args, w) in cases.items():
        numbers["b1"][tag] = window_case(
            torch, card, sp, f"protocol k={PROTOCOL_K} {tag}, step {PROTOCOL_SNAP_STEP}",
            args, w)
    del b2_args, cases, wl_args
    numbers["screenspace"] = screenspace_case(
        torch, card, f"{cam0!r}, {at}", snap,
        ss.bake_camera(scene.triangles, scene.cameras[0], scene.corner_normals),
        sp.gravity, cfg.dt)

    # ---- one step from the state at step 1500: the runner's captured step
    # (its rescue sized on the device) against the per-step step with the
    # rescue looped on the host in its place, every lane ----
    reads0 = tap.runner.syncs.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = tap.runner(snap, 1)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    host_step = S._sorted_step(sp, None, False)
    device_rescue = S._device_rescue
    S._device_rescue = S._chunked_rescue
    try:
        t0 = time.perf_counter()
        b = host_step(snap)
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
    finally:
        S._device_rescue = device_rescue
    differ = int(((a.pos != b.pos).any(0) | (a.vel != b.vel).any(0)
                  | (a.collisions != b.collisions)).sum())
    print(f"[{card}] protocol k={PROTOCOL_K}, one step from step {PROTOCOL_SNAP_STEP}: "
          f"the runner's step (replayed, {tap.runner.syncs.count - reads0} host reads, "
          f"{t_dev * 1e3:.3f} ms) against the host-looped rescue's "
          f"({host_step.syncs.count} host reads, {t_host * 1e3:.3f} ms): {differ} of "
          f"{a.pos.shape[-1]} lanes differ in any bit; hits {int((a.collisions - snap.collisions).sum())}")
    if differ:
        raise RuntimeError("the device-sized rescue and the host-read rescue disagree "
                           f"on {differ} lanes at k={PROTOCOL_K}")
    del a, b

    # ---- the rescue: an episode, three steps ----
    numbers["rescue_route"] = rescue_route(
        torch, card, S.SortedEpisodeRunner(sp, "auto", 8192), tap.spawn)

    # ---- 10(b): k = 0, the three methods on the four cameras ----
    wk.reset_launches()
    t0 = time.perf_counter()
    rows0 = P.run_protocol(scene, [0], methods, num_runs=1, num_steps=CAMERA_STEPS,
                           out_dir=os.path.join(out, "k0_cameras"), accuracy=False,
                           plan="kernel", spatial_all_cameras=True)
    wall_b = time.perf_counter() - t0
    launches_b = dict(wk.LAUNCHES)
    want = [(m, cam.name) for m in methods for cam in scene.cameras]
    got = [(r["method"], r["camera"]) for r in rows0]
    if sorted(got) != sorted(want) or len(got) != len(want) or any(
            r["particles"] != cfg.spawn_count(1) or not r["mean_ms"] > 0 for r in rows0):
        raise RuntimeError(f"protocol k=0 on the four cameras: rows {rows0}")
    if launch_fault(launches_b):
        raise RuntimeError(f"protocol k=0 launches {launches_b}")
    print(f"[{card}] protocol k=0, {CAMERA_STEPS} steps on the four cameras: "
          f"{len(rows0)} rows ("
          + ", ".join(f"{r['method']}/{r['camera']} {r['mean_ms']:.3f} ms/step"
                      for r in rows0)
          + f"); {wall_b:.1f} s; launches {launches_b}")
    # the undecided mask on each camera: active lanes, plus the sentinel
    # lanes once they fall (off screen, so undecided, as in the JAX package;
    # tests/test_torch_screenspace.py::test_padding_lanes_inert), which
    # must stay out of the hybrid's plan
    for cam in scene.cameras:
        tex = ss.bake_camera(scene.triangles, cam, scene.corner_normals)
        st, und = ss.screen_space_collide(s, tex, sp.gravity, cfg.dt, hybrid=True)
        outside = und & ~mask
        print(f"[{card}] {cam.name!r} on the k={PROTOCOL_K} state at step "
              f"{PROTOCOL_STEPS}: undecided share of the active lanes "
              f"{float(und[mask].float().mean()):.4f}; undecided lanes outside "
              f"them {int(outside.sum())}, all sentinel lanes: "
              f"{bool(not outside[:n_real].any())}")
        if outside[:n_real].any():
            raise RuntimeError(f"{cam.name}: the undecided mask holds lanes that are "
                               "neither active nor sentinels")
        sentinels_in_plan(f"hybrid plan on {cam.name!r}, k={PROTOCOL_K} state at step "
                          f"{PROTOCOL_STEPS}", st, und)
        if cam is scene.cameras[0]:  # the telemetry kernels on its mask
            numbers["telemetry"] = telemetry_case(
                torch, card, f"{cam.name!r}, k={PROTOCOL_K} state at step "
                f"{PROTOCOL_STEPS}", und, s.pos[0], *tel_scalars)
    print(f"[{card}] phase 10 (protocol ladder): {time.perf_counter() - t_phase:.1f} s")
    return {"launches_k7": launches_a, "launches_k0": launches_b,
            "tel_launches_k7": tel_launches_a, "ss_launches_k7": ss_launches_a, **numbers}


# phase 11: the headline benchmark (bench/headline.py), at its defaults
HEADLINE_MODULE = "particlesystemhybridcollisiondetection_tpu_torch.bench.headline"
HEADLINE_TIMEOUT = 600
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
# the profiler's names of the kernels that each launch count's launches
# run, once each a launch (B1's main and rescue counts launch the same
# kernel; the worklist entry point launches its scan, then its collide
# kernel, the last of a sorted step's kernels of B1; the rescue's front
# its two kernels before them)
TRACED_KERNELS = {"window_collide_sorted": ("window_collide_kernel",),
                  "window_collide_sorted_rescue": ("window_collide_kernel",),
                  "cells_window_lookup": ("cells_window_lookup_kernel",),
                  "window_collide_worklist": ("worklist_scan_kernel",
                                              "worklist_collide_kernel"),
                  "rescue_front": ("rescue_front_kernel", "rescue_list_kernel")}


def by_symbol(launches: dict) -> dict:
    """Launch counts summed by the kernel they run (``TRACED_KERNELS``)."""
    out: dict = {}
    for name, n in launches.items():
        for symbol in TRACED_KERNELS[name]:
            out[symbol] = out.get(symbol, 0) + n
    return out


def traced_launches(prof) -> dict:
    """Launches of B1, B2, the worklist entry point's and the rescue
    front's kernels in a profiler session, counted by kernel name
    (replayed graphs' kernels included); {} when the device trace came
    back empty."""
    from torch.autograd import DeviceType

    counts = {symbol: 0 for symbols in TRACED_KERNELS.values() for symbol in symbols}
    seen = False
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        seen = True
        for symbol in counts:
            if symbol in e.key:
                counts[symbol] += e.count
    return counts if seen else {}


def busy_per_step(prof, steps: int):
    """The device's busy and elapsed ms per step over an episode's last
    ``steps`` steps, from the trace: every CUDA event (kernels, copies,
    sets) that starts after the end of the worklist entry point's last
    kernel (its collide kernel, rescue phase 2) of the step before them
    and up to the end of the last one, summed, that span, and the device
    events a step.  Steps are told apart by that kernel, so it needs one
    launch a step (the caller checks it); None when the trace holds too
    few of them (an empty device trace)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    last = TRACED_KERNELS["window_collide_worklist"][-1]
    ends = sorted((e.time_range.end for e in events if last in e.name))
    if len(ends) <= steps:
        return None
    t0, t1 = ends[-steps - 1], ends[-1]
    inside = [e for e in events if t0 < e.time_range.start < t1]
    busy = sum(e.time_range.end - e.time_range.start for e in inside)
    return busy / 1000.0 / steps, (t1 - t0) / 1000.0 / steps, len(inside) / steps


def profiled_headline(torch, HL, H, wk, scene):
    """``headline()`` on ``scene`` under torch.profiler with the launch
    counters reset just before: its result, the counters, the profiler's
    count by kernel (``traced_launches``), its runner and the profile."""
    from torch.profiler import ProfilerActivity, profile

    made = []
    make_runner = H.make_sorted_episode_runner  # run_episode's

    def kept_runner(*a, **k):
        made.append(make_runner(*a, **k))
        return made[-1]

    torch.cuda.synchronize()
    wk.reset_launches()
    H.make_sorted_episode_runner = kept_runner
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = HL.headline(scene)
            torch.cuda.synchronize()
    finally:
        H.make_sorted_episode_runner = make_runner
    return res, dict(wk.LAUNCHES), traced_launches(prof), made[0], prof


def lost_steps(launches: dict, traced: dict) -> int:
    """How many whole steps a trace lacks: d > 0 when every kernel's traced
    count is its counted launches less d steps' worth of it (the mark of
    records CUPTI dropped, not of a counter at fault); 0 otherwise,
    agreement included."""
    want = by_symbol(launches)
    per_step = by_symbol(STEP_LAUNCHES)
    if not traced or set(traced) != set(want):
        return 0
    short = {(want[k] - traced[k]) / per_step[k] for k in want}
    d = short.pop() if len(short) == 1 else 0
    return int(d) if d >= 1 and d == int(d) else 0


def trace_gaps(prof) -> str:
    """Where a trace's steps are missing: the steps after which the gap
    between B2's kernels is over 1.7 times the median (B2 runs once a
    step), and the host's graph launches and kernel launches in the trace."""
    from torch.autograd import DeviceType

    events = prof.events()
    b2 = TRACED_KERNELS["cells_window_lookup"][0]
    starts = sorted(e.time_range.start for e in events
                    if e.device_type == DeviceType.CUDA and b2 in e.name)
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    med = sorted(gaps)[len(gaps) // 2] if gaps else 0.0
    wide = [i for i, g in enumerate(gaps) if g > 1.7 * med]
    host = [e.name for e in events if e.device_type != DeviceType.CUDA]
    return (f"B2 traced {len(starts)} times, wide gaps after steps {wide}; "
            f"host records cudaGraphLaunch {host.count('cudaGraphLaunch')}, "
            f"cudaLaunchKernel {host.count('cudaLaunchKernel')}")


def drive_headline(torch, card: str, runner, snap600) -> dict:
    """Phase 11: the headline benchmark.

    (a) ``python -m ….bench.headline`` in its own process at its defaults
    (DragonScene, 1,048,576 particles, 151 steps, the settled probe over
    620 + 100 steps): exit 0, exactly one stdout line holding exactly the
    four keys, the metric naming dragon and 1M, a finite value above 0,
    stderr naming 1048576 particles on cuda and a finite settled ms/step.

    (b) In this process, ``headline()`` on the same scene with the launch
    counters reset just before, under torch.profiler: B1 and B2 launched
    (the counters; the profiler's counts by kernel name are printed beside
    them, "not measured" when its trace is empty, and must equal them; a
    trace that lacks whole steps, every kernel alike, is reported and a
    fresh episode traced once, which must then agree); from the accepted
    trace the device's busy and elapsed ms per timed step, beside the
    host's.

    (c) The settled probe's state at step 620 (``settled_state``: window
    2048, a re-sort every 12 steps) held bit for bit on every lane against
    the main path's runner (window 1024, resort_every "auto") from its
    state at step 600; B1 at window 2048 and B2 against their plain
    versions on that state.

    Returns the launches and the kernel-table numbers of (c)."""
    import math
    import re

    from particlesystemhybridcollisiondetection_tpu_torch.bench import harness as H
    from particlesystemhybridcollisiondetection_tpu_torch.bench import headline as HL
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    t_phase = time.perf_counter()
    # ---- 11(a): the command as a user runs it ----
    torch.cuda.empty_cache()  # the cached blocks of phases 2-10 stay free for it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", HEADLINE_MODULE],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=HEADLINE_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-20:]:
        print(f"  headline stderr: {line}")
    if proc.returncode:
        raise RuntimeError(f"the headline exited {proc.returncode}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise RuntimeError(f"the headline printed {len(lines)} stdout lines: {lines}")
    result = json.loads(lines[-1])
    if set(result) != HEADLINE_KEYS:
        raise RuntimeError(f"the headline's keys {sorted(result)}")
    if "_dragon_" not in result["metric"] or not result["metric"].endswith("_1M"):
        raise RuntimeError(f"the headline's metric {result['metric']!r}")
    if not (math.isfinite(result["value"]) and result["value"] > 0):
        raise RuntimeError(f"the headline's value {result['value']}")
    ctx = re.search(r"\] (\d+) particles, .* device=(\w+),", proc.stderr)
    if not ctx or ctx.groups() != ("1048576", "cuda"):
        raise RuntimeError("the headline's stderr does not say 1048576 "
                           f"particles on cuda: {ctx and ctx.groups()}")
    settled = re.search(r"settled-phase: (\S+) ms/step", proc.stderr)
    settled_ms = float(settled.group(1)) if settled else math.nan
    if not math.isfinite(settled_ms):
        raise RuntimeError("the headline's settled ms/step is missing or not finite")
    print(f"[{card}] headline: {lines[0]}; settled phase {settled_ms} ms/step "
          f"({wall:.1f} s in its own process)")

    # ---- 11(b): its launches, in this process ----
    scene = dragon_scene(width=HL.WIDTH, height=HL.HEIGHT)
    res, launches, traced, hrun, prof = profiled_headline(torch, HL, H, wk, scene)
    print(f"[{card}] headline in this process, under the profiler: "
          f"{res.num_particles} particles, {res.num_steps} timed steps, "
          f"{res.mean_ms:.3f} ms/step (a reading, not the headline's "
          f"number); runner captured {hrun.graphed}, host reads "
          f"{hrun.syncs.count / hrun.steps:.4f}/step over its {hrun.steps} steps; "
          f"launches {launches} (counters: replays counted), by the profiler "
          f"{traced or 'not measured'}")
    check_runner_launches("the headline episode", launches, hrun.steps)
    lost = lost_steps(launches, traced)
    if lost:
        # CUPTI handed back a trace short of whole steps: say where, and
        # trace a fresh episode, which must then agree exactly
        note = (f"the profiler's trace of the headline lacks {lost} whole "
                f"step(s) the counters saw ({trace_gaps(prof)}); tracing a "
                f"fresh episode, which must agree exactly")
        print(f"[{card}] {note}")
        print(f"chip_smoke: {note}", file=sys.stderr)
        res, launches, traced, hrun, prof = profiled_headline(torch, HL, H, wk, scene)
        print(f"[{card}] headline traced again: launches {launches}, by the "
              f"profiler {traced or 'not measured'}")
        check_runner_launches("the headline episode traced again", launches,
                              hrun.steps)
    if traced and traced != by_symbol(launches):
        raise RuntimeError(f"the launch counters {launches} disagree with the "
                           f"profiler's count {traced}")
    # how much of a timed step the device works: the worklist's collide
    # kernel, once a step, marks where each step ends in the trace
    busy = busy_per_step(prof, res.num_steps)
    if busy is None:
        print(f"[{card}] headline device time per step: not measured")
    else:
        print(f"[{card}] headline, timed steps by the trace: device busy "
              f"{busy[0]:.4f} ms/step of {busy[1]:.4f} ms/step elapsed on the "
              f"device (busy share {busy[0] / busy[1]:.4f}; {busy[2]:.1f} device "
              f"events a step); host "
              f"{res.mean_ms:.4f} ms/step under the profiler, "
              f"{HL.HEADLINE_PARTICLES * 1000.0 / result['value']:.4f} ms/step "
              f"in 11(a) without it")

    # ---- 11(c): the settled probe's state at step 620 against the main path's ----
    pre = HL.settled_probe.__kwdefaults__["pre_steps"]
    srun, s_probe = HL.settled_state(scene)
    if srun.sp.ctab is None:
        raise RuntimeError("the settled probe's runner built no cells table: "
                           "B2 is not on its path")
    probe_reads = srun.syncs.count / srun.steps
    print(f"[{card}] settled probe's runner (re-sort every {srun.resort_every}): host "
          f"reads {probe_reads:.4f}/step over its {srun.steps} steps")
    if probe_reads:
        raise RuntimeError("the settled probe's runner read the host with a fixed "
                           "resort_every")
    s_main = runner(snap600, pre - 600)
    fence(s_main.pos)
    differ = ((s_probe.pos != s_main.pos).any(0) | (s_probe.vel != s_main.vel).any(0)
              | (s_probe.collisions != s_main.collisions))
    n_differ = int(differ.sum())
    print(f"[{card}] settled probe's state at step {pre} (window "
          f"{srun.sp.window}, re-sort every {srun.resort_every}) against the main "
          f"path's runner (window {runner.sp.window}, resort_every "
          f"{runner.resort_every!r}): {n_differ} of {differ.numel()} lanes differ "
          f"in any bit; collisions {int(s_probe.collisions.sum())} vs "
          f"{int(s_main.collisions.sum())}")
    if n_differ:
        raise RuntimeError(f"the settled probe's state at step {pre} differs from "
                           f"the main path's on {n_differ} lanes")
    b2_args, cases, overflow, _ = sorted_plan(torch, srun.sp, s_probe)
    print(f"[{card}] settled probe's state at step {pre}: {int(overflow.sum())} "
          f"overflow lanes in the main plan (window {srun.sp.window})")
    numbers = {"cells_window_lookup": b2_case(torch, card, f"settled probe, step {pre}",
                                              b2_args),
               "window_collide_sorted": window_case(
                   torch, card, srun.sp, f"settled probe main, step {pre}", *cases["main"])}
    print(f"[{card}] phase 11 (the headline): {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "traced": traced, "line": result,
            "settled_ms": settled_ms, "reads_per_step": hrun.syncs.count / hrun.steps,
            "busy": busy, **numbers}


def device_line(torch) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import particlesystemhybridcollisiondetection_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 2

    from particlesystemhybridcollisiondetection_tpu_torch.core import graphed as GR
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
        active_mask, spawn_grid,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        screenspace_kernel as ssk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        telemetry_kernel as tk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        window_kernel as wk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    # bakes go to the checkout's build directory unless the caller says
    os.environ.setdefault("PSYS_BAKE_CACHE", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "psys_bake"))

    # ---- phase 1: card, versions, kernel build ----
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}; conditional graph nodes from "
          "PyTorch (CUDAGraph.begin_capture_to_if_node): "
          + ("available" if hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
             else "absent, so the runner holds a graph for each branch"))
    build_s = build.build_all()
    print(f"[{card}] kernel build (nvcc, {len(build.SOURCES)} sources in "
          f"parallel): {build_s:.2f} s")
    for name, log in build.build_log.items():
        for kernel, usage in ptxas_usage(log):
            print(f"  ptxas {name} {kernel}: {usage}")
    sass = sass_counts(build, "window_kernel", "worklist_collide_kernel")
    print(f"  (WINDOW_OPS_PER_CANDIDATE = {WINDOW_OPS_PER_CANDIDATE}, "
          f"P2P_OPS_PER_CANDIDATE = {P2P_OPS_PER_CANDIDATE})")
    wl_blocks, wl_regs, wl_local = wk.worklist_occupancy(torch.device("cuda", 0))
    print(f"[{card}] worklist collide kernel: {wl_blocks} blocks of "
          f"{wk.WORKLIST_BATCH} threads an SM, {wl_regs} registers and {wl_local} "
          "local bytes a thread")

    # the four cameras' bakes, in parallel, for phases 5, 8 and 10
    prebake(card)

    # ---- phase 2: the main path ----
    t0 = time.perf_counter()
    scene = dragon_scene()
    cfg = scene.config
    runner = S.make_sorted_episode_runner(
        scene.triangles, cfg, cells_lookup="kernel", resort_every="auto",
    )
    state0 = spawn_grid(cfg, layers_y=64)
    fence(state0.pos)
    sp = runner.sp
    n = state0.pos.shape[-1]
    print(f"[{card}] DragonScene: {scene.num_triangles} triangles, grid dims "
          f"{sp.meta.dims}, {sp.meta.num_pairs} pair rows, max "
          f"{sp.meta.max_tris_per_cell} per cell, window {sp.window}, rescue "
          f"window {sp.rescue_window}, demote {sp.demote}; {n} particles; "
          f"host setup {time.perf_counter() - t0:.1f} s")

    wk.reset_launches()
    tk.reset_launches()
    ssk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ovf_all, reads = [], []
    s = state0
    walls = []
    # the calls (PHASE2_CALLS): step 0 runs eagerly (the first launches),
    # the runner captures its step at the next one and replays it from then
    for k in PHASE2_CALLS:
        r0 = runner.syncs.count
        t0 = time.perf_counter()
        s, ovf_k = runner(s, k, with_stats=True)
        fence(s.pos)
        walls.append(time.perf_counter() - t0)
        reads.append(runner.syncs.count - r0)
        ovf_all += ovf_k
        if len(walls) == 3:
            snap600 = s
        if len(walls) == 4:
            snap = s
    spawn_ms = walls[1] * 1000.0 / PHASE2_CALLS[1]
    mid_ms = walls[2] * 1000.0 / PHASE2_CALLS[2]
    t_a = walls[3]
    impact_ms = (walls[3] + walls[4]) * 1000.0 / (N_STEPS - 600)
    launches = dict(wk.LAUNCHES)
    tel_launches = dict(tk.LAUNCHES)
    syncs_per_step = sum(reads) / N_STEPS
    ovf_a, ovf_b = ovf_all[600:SNAP_STEP], ovf_all[SNAP_STEP:]
    print(f"[{card}] main path: runner captured {runner.graphed}; host reads per "
          f"step, steps 1-151 {sum(reads[:2]) / 151:.4f}, steps 151-700 "
          f"{sum(reads[2:]) / 549:.4f} (the \"auto\" re-sort flag, one a step after "
          f"each call's first); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    mask = active_mask(s)
    nan_lanes = int((~torch.isfinite(s.pos[:, mask]).all(0)).sum()
                    + (~torch.isfinite(s.vel[:, mask]).all(0)).sum())
    sentinels_ok = bool((s.pos[0, ~mask] == 1e38).all()
                        and (s.pos[2, ~mask] == 1e38).all()
                        and (s.collisions[~mask] == 0).all())
    total_coll = int(s.collisions[mask].sum())
    ovf = ovf_a + ovf_b
    print(f"[{card}] main path, {N_STEPS} steps at {n} particles: "
          f"steps 1-151 {spawn_ms:.3f} ms/step, steps 151-600 "
          f"{mid_ms:.3f} ms/step, steps 600-700 {impact_ms:.3f} ms/step; "
          f"host syncs {syncs_per_step:.2f}/step; overflow steps 600-700 "
          f"min {min(ovf)} median {sorted(ovf)[len(ovf) // 2]} max {max(ovf)}; "
          f"collisions {total_coll}; launches {launches}; every call with stats "
          f"(the stamped graphs), telemetry launches {tel_launches}")
    if nan_lanes:
        raise RuntimeError(f"{nan_lanes} active lanes hold NaN/inf")
    if not sentinels_ok:
        raise RuntimeError("padding sentinels moved or collided")
    if total_coll <= 0:
        raise RuntimeError("no collisions in 700 steps")
    check_runner_launches("main path", launches, N_STEPS)
    if ssk.LAUNCHES["screen_space_collide"]:
        raise RuntimeError("main path: the spatial runner launched the screen-space kernel")
    check_telemetry_launches("main path", tel_launches, N_STEPS, False)
    if not max(ovf) > 0:
        raise RuntimeError("no lane overflowed in steps 600-700: the rescue never ran")

    # ---- the same 700 steps with capture off: the eager run of the code
    # each captured step holds, equal bit for bit ----
    eager = S.SortedEpisodeRunner(sp, "auto", runner.resort_threshold)
    e, ovf_e = state0, []
    t0 = time.perf_counter()
    with GR.uncaptured():
        for k in PHASE2_CALLS:
            e, ovf_k = eager(e, k, with_stats=True)
            ovf_e += ovf_k
    fence(e.pos)
    eager_s = time.perf_counter() - t0
    e_differ = int(((e.pos != s.pos).any(0) | (e.vel != s.vel).any(0)
                    | (e.collisions != s.collisions)).sum())
    ovf_differ = sum(a != b for a, b in zip(ovf_e, ovf_all))
    print(f"[{card}] main path against the same {N_STEPS} steps uncaptured (eager, "
          f"{eager_s:.1f} s, host reads {eager.syncs.count / N_STEPS:.4f}/step): "
          f"{e_differ} lanes differ in any bit, overflow differs on {ovf_differ} "
          f"of {len(ovf_all)} steps")
    if e_differ or ovf_differ or len(ovf_e) != len(ovf_all):
        raise RuntimeError("the captured runner and the eager runner disagree")
    del eager, e

    # ---- phases 3 and 4: each kernel against its plain version and timed,
    # on the states at step 650 and at step 700 ----
    b1, wl = {}, {}
    for at, state in ((SNAP_STEP, snap), (N_STEPS, s)):
        b2_args, cases, overflow, wl_args = sorted_plan(torch, sp, state)
        print(f"[{card}] state at step {at}: {int(overflow.sum())} overflow lanes in "
              "the main plan")
        if at == SNAP_STEP:
            b2 = b2_case(torch, card, f"spatial, step {at}", b2_args)
        for tag, (args, w) in cases.items():
            b1[(tag, at)] = window_case(torch, card, sp, f"{tag}, step {at}", args, w)
        wl[at] = worklist_case(torch, card, sp, f"step {at}", wl_args)
        if at == SNAP_STEP:
            # what a step that lists no lane pays (free fall: the headline)
            wl["empty"] = worklist_case(torch, card, sp, f"step {at}, empty list",
                                        empty_list(wl_args))
        del b2_args, cases, wl_args

    # ---- a reading, no default changed: steps 600-700 once more with the
    # dense-cell demotion off ----
    nodemote = S.SortedEpisodeRunner(sp._replace(demote=None), "auto", 8192)
    fence(snap600.pos)
    t0 = time.perf_counter()
    s_nd, ovf_nd = nodemote(snap600, N_STEPS - 600, with_stats=True)
    fence(s_nd.pos)
    nd_ms = (time.perf_counter() - t0) * 1000.0 / (N_STEPS - 600)
    nd_coll = int(s_nd.collisions[active_mask(s_nd)].sum())
    print(f"[{card}] steps 600-700 with dense_demote=None: {nd_ms:.3f} ms/step "
          f"(default, demote {sp.demote}: {impact_ms:.3f}); overflow min "
          f"{min(ovf_nd)} median {sorted(ovf_nd)[len(ovf_nd) // 2]} max "
          f"{max(ovf_nd)} (default: min {min(ovf)} median "
          f"{sorted(ovf)[len(ovf) // 2]} max {max(ovf)}); host syncs "
          f"{nodemote.syncs.count / (N_STEPS - 600):.2f}/step; collisions "
          f"{nd_coll} (default {total_coll})")

    # ---- phase 5: the hybrid path on the same scene and spawn ----
    hyb = drive_hybrid(torch, card, scene, state0, total_coll, sp, syncs_per_step)

    # ---- phase 6: the particle-particle path ----
    b3 = drive_p2p(torch, card)

    # ---- phase 8: the command line, the oracle steps, the resilient runner ----
    cli = drive_cli(torch, card, snap)

    # ---- phase 9: the multi-device paths, from the main path's state at
    # step 600 ----
    mesh_launches = drive_mesh(torch, card, snap600, snap, ovf_a,
                               t_a * 1000.0 / (SNAP_STEP - 600))

    # ---- phase 10: the reference protocol's particle ladder, k = 7 and
    # k = 0 on the four cameras ----
    prot = drive_protocol(torch, card)

    # ---- phase 11: the headline benchmark, its own process and this one ----
    head = drive_headline(torch, card, runner, snap600)

    def mesh_launch(key):
        return {w: [r[key] for r in ranks] for w, ranks in mesh_launches.items()}

    def cli_launches(key):
        return {sub: counts[key] for sub, counts in cli["launches"].items()
                if key in counts}

    def b1_entry(suffix, numbers, n_launch):
        return {"name": "window_collide_sorted" + suffix, "route": "cuda",
                "source": PORT_CSRC + "window_kernel.cu",
                "replaces": f"{JAX_KERNELS}:346", "launches": n_launch,
                **numbers, "library_ms": None}

    def b2_entry(suffix, numbers, n_launch):
        return {"name": "cells_window_lookup" + suffix, "route": "cuda",
                "source": PORT_CSRC + "cells_kernel.cu",
                "replaces": f"{JAX_KERNELS}:192", "launches": n_launch,
                **numbers, "library_ms": None}

    def wl_entry(suffix, numbers, n_launch):
        # B1's second entry point: rescue phase 2 (the TPU kernel's rescue
        # use; the JAX package takes those lanes by its packed path); its
        # collide kernel's blocks per SM, registers and local bytes a
        # thread, and its instructions per candidate (sass_counts)
        return {"name": "window_collide_worklist" + suffix, "route": "cuda",
                "source": PORT_CSRC + "window_kernel.cu",
                "replaces": f"{JAX_KERNELS}:346", "launches": n_launch,
                **numbers, "library_ms": None,
                "collide_kernel": {"blocks_per_sm": wl_blocks, "registers": wl_regs,
                                   "local_bytes": wl_local, "sass_per_candidate": sass}}

    def tel_entry(name, key, numbers):
        # the runner's telemetry kernels (no TPU kernel behind them: the
        # JAX package times its steps from outside), launched on the calls
        # with stats, counted apart from the step's own launches; held
        # against their plain versions on "Main Camera"'s undecided mask
        # of the k = 7 state at step 2001
        return {"name": name, "route": "cuda", "source": PORT_CSRC + "telemetry_kernel.cu",
                "replaces": None, "launches": tel_launches[key],
                "launches_hybrid": hyb["tel_launches"][key],
                "launches_protocol_k7": prot["tel_launches_k7"][key],
                **numbers, "library_ms": None, "path": "telemetry"}

    def headline_keys(key):
        # phase 11: the headline episode's launches (the counter, which
        # counts graph replays; the profiler's count of each kernel the
        # counter's launches run, B1's main and rescue launches together,
        # null when its trace was empty) and the case at the settled
        # probe's window on its state at step 620
        keys = {"launches_headline": head["launches"][key],
                "kernel_launches_headline_traced":
                    {symbol: head["traced"].get(symbol)
                     for symbol in TRACED_KERNELS[key]}}
        if key in head:
            keys["settled_probe"] = {**head[key], "library_ms": None}
        return keys

    def with_chunk(entry, numbers):
        # the window kernel on 8,192 lanes of the phase-1 order (split
        # over several blocks a row), nested in the phase-1 entry
        return {**entry, "rescue_chunk": {**numbers, "library_ms": None}}

    # every launch count is a counter's reading: B1's main launches count
    # under "window_collide_sorted", its launches at the rescue window (the
    # host-looped rescue's alone, none on these paths) under
    # "window_collide_sorted_rescue"
    rescue = "window_collide_sorted_rescue"
    h_launch = hyb["launches"]
    k7 = prot["launches_k7"]
    kernels = [
        {**b2_entry("", b2, launches["cells_window_lookup"]),
         "launches_cli": cli_launches("cells_window_lookup"),
         "launches_mesh": mesh_launch("cells_window_lookup"),
         **headline_keys("cells_window_lookup")},
        {**b1_entry("", b1[("main", SNAP_STEP)], launches["window_collide_sorted"]),
         "launches_cli": cli_launches("window_collide_sorted"),
         "launches_mesh": mesh_launch("window_collide_sorted"),
         **headline_keys("window_collide_sorted")},
        with_chunk({**b1_entry(":rescue_phase1", b1[("rescue phase 1", SNAP_STEP)],
                               launches[rescue]),
                    "launches_cli": cli_launches(rescue),
                    "launches_mesh": mesh_launch(rescue), **headline_keys(rescue)},
                   b1[("rescue chunk", SNAP_STEP)]),
        {**wl_entry("", wl[SNAP_STEP], launches["window_collide_worklist"]),
         "launches_cli": cli_launches("window_collide_worklist"),
         "launches_mesh": mesh_launch("window_collide_worklist"),
         **headline_keys("window_collide_worklist")},
        b1_entry(":main_step700", b1[("main", N_STEPS)], launches["window_collide_sorted"]),
        with_chunk(b1_entry(":rescue_phase1_step700", b1[("rescue phase 1", N_STEPS)],
                            launches[rescue]), b1[("rescue chunk", N_STEPS)]),
        wl_entry(":step700", wl[N_STEPS], launches["window_collide_worklist"]),
        # the same launch with no lane listed, on the state at step 650
        wl_entry(":empty_list", wl["empty"], launches["window_collide_worklist"]),
        # the hybrid path's launches, held against their plain versions on
        # the hybrid state at step 650 (counts zeroed on lanes the
        # screen-space stage decided)
        {**b2_entry(":hybrid", hyb["b2"], h_launch["cells_window_lookup"]),
         "path": "hybrid"},
        {**b1_entry(":hybrid", hyb["b1"]["main"], h_launch["window_collide_sorted"]),
         "path": "hybrid"},
        {**with_chunk(b1_entry(":hybrid_rescue_phase1", hyb["b1"]["rescue phase 1"],
                               h_launch[rescue]), hyb["b1"]["rescue chunk"]),
         "path": "hybrid"},
        {**wl_entry(":hybrid", hyb["worklist"], h_launch["window_collide_worklist"]),
         "path": "hybrid"},
        # phase 10: the protocol's launches at k = 7 and at k = 0 on the
        # four cameras, held against their plain versions on the k = 7
        # spatial state at step 1500
        {**b2_entry(":protocol", prot["b2"], k7["cells_window_lookup"]),
         "path": "protocol k=7",
         "launches_k0_cameras": prot["launches_k0"]["cells_window_lookup"]},
        {**b1_entry(":protocol", prot["b1"]["main"], k7["window_collide_sorted"]),
         "path": "protocol k=7",
         "launches_k0_cameras": prot["launches_k0"]["window_collide_sorted"]},
        {**with_chunk(b1_entry(":protocol_rescue_phase1", prot["b1"]["rescue phase 1"],
                               k7[rescue]), prot["b1"]["rescue chunk"]),
         "path": "protocol k=7", "launches_k0_cameras": prot["launches_k0"][rescue]},
        {**wl_entry(":protocol", prot["worklist"], k7["window_collide_worklist"]),
         "path": "protocol k=7",
         "launches_k0_cameras": prot["launches_k0"]["window_collide_worklist"]},
        # the screen-space stage (no TPU kernel behind it: the JAX package
        # runs it in XLA), held against its plain version on "Main
        # Camera" over the k = 7 spatial state at step 1500; its launches
        # on the hybrid path (one a step; none on the main path) and in
        # the protocol's k = 7 screen-space and hybrid episodes
        {"name": "screen_space_collide", "route": "cuda",
         "source": PORT_CSRC + "screenspace_kernel.cu", "replaces": None,
         "launches": hyb["ss_launches"], "launches_main": 0,
         "launches_protocol_k7": prot["ss_launches_k7"], **prot["screenspace"],
         "library_ms": None, "path": "hybrid"},
        # the rescue's front (no TPU kernel behind it: the JAX package
        # leaves it to XLA), held against its plain version on the k = 7
        # spatial episode's rescue inputs at step 1500 and, nested, at its
        # free-fall step; its launches, one a sorted step, on every path
        {"name": "rescue_front", "route": "cuda", "source": PORT_CSRC + "window_kernel.cu",
         "replaces": None, "launches": launches["rescue_front"],
         "launches_hybrid": h_launch["rescue_front"],
         "launches_protocol_k7": k7["rescue_front"],
         "launches_cli": cli_launches("rescue_front"),
         "launches_mesh": mesh_launch("rescue_front"), **headline_keys("rescue_front"),
         **prot["rescue_route"][f"k={PROTOCOL_K} step {PROTOCOL_SNAP_STEP}"]["front"],
         "free_fall": {**prot["rescue_route"]["free fall"]["front"], "library_ms": None},
         "library_ms": None},
        {**b3[0], "launches_cli": cli_launches(b3[0]["name"])},
        *b3[1:],
        tel_entry("psys_stamp_kernel", "stamp", prot["telemetry"]["stamp"]),
        tel_entry("undecided_count_kernel", "count_undecided", prot["telemetry"]["count"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(device_line(torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
