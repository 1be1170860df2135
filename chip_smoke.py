#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

On a host with several cards phase 9 adds a run over NCCL across them.

Phases (each raises on failure; nothing is caught and passed over):
  1. print the card (nvidia-smi name and power limit), the torch and CUDA
     versions, and build the three CUDA sources of ops/cuda/csrc; bake
     DragonScene's four cameras (1920 x 1080, corner normals) on the host
     into the disk cache, one spawned worker process per camera not yet
     there (``prebake``), for phases 5, 8 and 10;
  2. drive the spatial main path: the persistent sorted episode runner of
     the spatial method on DragonScene at 1,048,576 particles (128^2 x 64
     layers), cells lookup "kernel", resort_every "auto", 700 steps from
     spawn; check no NaN on active lanes, sentinels intact, collisions > 0
     and both kernels launched (launch counters reset just before);
  3. on the states at step 650 and at step 700 (denser), hold each of
     its kernels against its plain PyTorch version at the main path's
     shapes (cells lookup; window kernel at the main window, on the
     first phase-1 rescue chunk and on a phase-2 launch of 1024 rows with
     one lane each), and print how the window kernel's
     candidates are spread over lanes and rows;
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
     1; run the screen-space method 700 steps at the same width; print
     the three methods' collisions; hold B1 (masked main plan, first
     rescue chunk, a phase-2 launch) and B2 against their plain versions on the hybrid
     state at step 650 and time them; hold 20 runner steps from step 600
     against 20 steps of make_hybrid_step_sorted;
  6. drive the particle-particle main path (``drive_p2p``): 1,000,000
     particles in the 160 x 80 x 160 gravity box of bench/configs.py
     config 4, 200 steps of make_p2p_step (variant "auto", which must
     resolve to "kernel") and 50 steps of make_p2p_episode_runner, both
     on the window kernel's entry point that plans in the kernel; launch
     counters reset just before each; check every lane finite and inside
     the box, contacts > 0, one kernel launch per step; on the state at
     step 100 hold both entry points of the kernel (plan in the kernel;
     explicit plan arrays from ops/p2p_plan.py) against their plain
     versions on every lane (window 512, and 128 where lanes overflow),
     the overflow mask included, and p2p_collide_window against
     p2p_collide_sorted; time both;
  8. (after 6, in the same process) drive the port's command line
     (``drive_cli``), every sub-step through ``cli.main`` with the default
     device (CUDA), checked and timed: ``bench`` of the three methods on
     DragonScene at 1,048,576 particles, camera 0, 200 steps (full width,
     depth cut from 2001), with the accuracy CSV (three perf-CSV blocks of
     199 rows, three accuracy blocks of 1,048,576 rows, summary totals
     equal to the printed results and to the accuracy blocks, B1 and B2
     launched); ``bench --per-step`` of the spatial method, 50 steps (the
     non-persistent ``make_method_step`` path); ``simulate`` of the
     spatial method, 100 steps, with a checkpoint that must equal a fresh
     run's ``snapshot`` bit for bit; ``p2pbox`` at 1,000,000 particles, 50
     steps (B3 once per step).  Then, on the spatial state at step 650,
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
     overflow sums printed; in every rank B1 (main window) and B2 against
     their plain versions on the rank's state at step 650; config 5, 5
     timed steps (500,000 particles per rank), every particle kept and no
     halo or migration overflow.  Each rank's launches on the mesh
     runner go into the kernel line as ``launches_mesh``.  Last, the
     ``parallel/dryrun.py`` entry point on the card with 2 ranks;
 10. (after 9; ``drive_protocol``) the reference protocol's particle ladder
     through ``bench/protocol.py::run_protocol`` on DragonScene, plan
     "kernel", no accuracy CSV, launch counters reset just before each
     sweep: (a) k = 7, 2,097,120 particles (the reference cap; 32 sentinel
     lanes), the three methods on "Main Camera", 2001 steps: rows,
     collisions, ms/step by window; through a tap on the harness's runner
     of the spatial episode (``_EpisodeTap``), that episode's last state
     (no NaN, sentinels inert and never a live lane of the plan), its
     overflow per step, and on its state at step 1500 B1 (main, rescue
     chunk, one lane per row) and B2 against their plain versions; (b) k = 0, the three
     methods on all four cameras, 50 steps: a row for each, and each
     camera's undecided mask on the k = 7 state (active lanes, and the
     falling sentinels, which must stay out of the hybrid's plan).  The
     launches go into the kernel line as the ":protocol" entries;
  7. print the kernel table as one JSON line (``ms`` is the events
     reading, ``device_ms`` the profiler's, null where its device trace
     came back empty; the hybrid path's entries carry "path": "hybrid";
     the rescue entries count every launch beyond the main one and nest
     the phase-2 case under "one_lane_per_row";
     the explicit-plan entry point of the p2p kernel, which no main path
     launches, is listed under that kernel's entry).
The last line is {"ok": true, "device": {...}}.  Exits non-zero (and
prints no result) without CUDA or without the port's package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_STEPS = 700
SNAP_STEP = 650
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
PORT_CSRC = "particlesystemhybridcollisiondetection_tpu_torch/ops/cuda/csrc/"

# the particle-particle path: bench/configs.py config 4
P2P_N = 1_000_000
P2P_BOX = ((0.0, 0.0, 0.0), (160.0, 80.0, 160.0))
P2P_STEPS, P2P_SNAP_STEP, P2P_RUNNER_STEPS = 200, 100, 50
P2P_SMALL_WINDOW = 128  # small enough that lanes overflow their window
# phase 8, the command line at full width (DragonScene, 128^2 x 64 =
# 1,048,576 particles; depth cut to 200 steps for bench, 50 for --per-step,
# 100 for simulate) and the oracle steps on the state at step 650
CLI_LAYERS = 64
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
    CUDA kernel it launches (torch.profiler, mean of REPS calls), without
    the host's gaps between them.  Returns (ms, {kernel name: ms}).  CUDA
    events around one call of a wrapper (``median_ms``) also count the
    host's time between its launches, which is most of the reading once a
    kernel takes under ~0.1 ms.

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
        rows = {e.key: e.self_device_time_total / 1000.0 / REPS
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        if rows:
            return sum(rows.values()), rows
    print("  torch.profiler reported no device time in "
          f"{PROFILER_TRIES} sessions: device time not measured", file=sys.stderr)
    return None, {}


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def timed(torch, fn, plain_fn) -> dict:
    """The timing keys of a kernel-table entry: ``ms`` is CUDA events
    around one wrapper call (``median_ms``), ``device_ms`` the device time
    of that call, ``plain_ms`` the events around the plain version."""
    ms = median_ms(torch, fn)
    plain_ms = median_ms(torch, plain_fn)
    dev_ms, rows = device_ms(torch, fn)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "by_kernel": rows}


def by_kernel(rows: dict) -> str:
    """'name ms' of the kernels of one call, longest first."""
    def short(key):
        key = key.replace("void ", "").replace("(anonymous namespace)::", "")
        return key.split("(")[0].split("<")[0][-32:]
    if not rows:
        return "no kernel times"
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:4]
    return ", ".join(f"{short(k)} {v:.4f}" for k, v in top)


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
    """Sort and plan a state as the step does: the cells kernel's
    arguments, the window kernel's at the main window, on the first
    phase-1 rescue chunk and on a phase-2 launch, and the main plan's
    overflow mask (sorted order).  ``undecided`` (hybrid): the
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
    pick = S._phase1_order(overflow, key_s)[:8192]
    _, chunk_state, (rel_c, cnt_c, ws_c, kcap_c, _) = S._rescue_chunk(
        sorted_state, overflow, pick, sp.tables, sp.meta, cfg, sp.rescue_window)
    # a phase-2 launch (one lane per row) on the first 1024 of them
    pick2 = pick[:1024]
    args2, _ = S._isolated_plan(sorted_state, overflow[pick2], pick2, sp.tables,
                                sp.meta, cfg, sp.rescue_window)
    return ((key_s, lo, hi, sp.ctab),
            {"main": ((*sorted_state, rel, count, ws, k_cap, sp.tables), sp.window),
             "rescue chunk": ((*chunk_state, rel_c, cnt_c, ws_c, kcap_c, sp.tables),
                              sp.rescue_window),
             "one lane per row": ((*args2, sp.tables), sp.rescue_window)},
            overflow)


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


def drive_hybrid(torch, card: str, scene, state0, spatial_coll: int, sp) -> dict:
    """Phase 5: the hybrid path at full width on the spatial path's scene
    and spawn, and the screen-space method beside it.  Returns the hybrid
    path's kernel launches and the kernel-table numbers of B1 and B2 on
    its state at step 650 (``sp``: the main path's tables and constants,
    which the hybrid runner's equal)."""
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.ops import screenspace as ss
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
        _, und = ss.screen_space_collide(state, tex, gravity, cfg.dt, hybrid=True)
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
    syncs_per_step = (runner.syncs.count - syncs0) / N_STEPS
    share[N_STEPS] = undecided_share(h)
    coll = check("hybrid path", h, True)
    ovf = sorted(ovf_a + ovf_b)
    print(f"[{card}] hybrid path ({cam.name!r}), {N_STEPS} steps at "
          f"{h.pos.shape[-1]} particles: "
          + ", ".join(f"steps {a}-{b} {v:.3f} ms/step" for (a, b), v in ms.items())
          + f"; undecided share (active lanes) "
          + ", ".join(f"step {k} {v:.4f}" for k, v in share.items())
          + f"; host reads {syncs_per_step:.2f}/step; overflow steps 600-700 min "
          f"{ovf[0]} median {ovf[len(ovf) // 2]} max {ovf[-1]}; collisions {coll}; "
          f"launches {launches}")
    if not 0.0 < share[N_STEPS] < 1.0:
        raise RuntimeError(f"undecided share {share[N_STEPS]} at step {N_STEPS} "
                           "is not strictly between 0 and 1")
    if launches["cells_window_lookup"] <= 0:
        raise RuntimeError("the cells kernel never launched on the hybrid path")
    if launches["window_collide_sorted"] <= N_STEPS:
        raise RuntimeError(
            f"window kernel launched {launches['window_collide_sorted']} times in "
            f"{N_STEPS} hybrid steps: the rescue never used it")

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
    b2_args, cases, overflow = sorted_plan(torch, sp, st, und)
    print(f"[{card}] hybrid state at step {SNAP_STEP}: undecided "
          f"{int(und.sum())} lanes, {int(overflow.sum())} overflow lanes in the masked main plan; "
          f"the screen-space stage collides "
          f"{int((st.collisions - h650.collisions).sum())} particles in this step")
    numbers = {"b2": b2_case(torch, card, f"hybrid, step {SNAP_STEP}", b2_args), "b1": {},
               "launches": launches}
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
    """Phase 5: the particle-particle path at full width.  Returns the
    kernel-table entries of the p2p window kernel's two entry points."""
    from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import _box_state
    from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan
    from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        p2p_window_kernel as pk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    name_a, name_b = "p2p_window_collide_sorted", "p2p_window_collide_cells"
    lo, hi = P2P_BOX
    cfg = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)
    state0 = _box_state(P2P_N, lo, hi, 0.4, 0.3, seed=0)
    step = S.make_p2p_step(lo, hi, cfg, capacity=8, variant="auto", with_stats=True)
    if step.variant != "kernel":
        raise RuntimeError(f'variant "auto" chose {step.variant!r}, not "kernel"')
    runner = S.make_p2p_episode_runner(lo, hi, cfg, capacity=8)
    meta = runner.meta
    window = runner.window
    n = P2P_N
    n_k = -(-n // pk.BLOCK) * pk.BLOCK
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

    launched = {name_a: 0, name_b: 0}  # over both drives of the path

    def expect_launches(tag, want_a, want_b):
        """Read the counters after a drive (they were reset just before)."""
        got = pk.LAUNCHES[name_a], pk.LAUNCHES[name_b]
        if got != (want_a, want_b):
            raise RuntimeError(f"p2p {tag}: launches (explicit plan, plan in the "
                               f"kernel) = {got}, expected {(want_a, want_b)}")
        launched[name_a] += got[0]
        launched[name_b] += got[1]

    # ---- the step path: 200 steps, snapshot at step 100 ----
    pk.reset_launches()
    s, ovf, seg_ms = state0, [], []
    snap = None
    for upto in (20, P2P_SNAP_STEP, P2P_STEPS):
        fence(s.pos)
        t0 = time.perf_counter()
        for _ in range(upto - len(ovf)):
            s, st = step(s)
            ovf.append(int(st["cell_overflow"]))
        fence(s.pos)
        seg_ms.append((time.perf_counter() - t0) * 1000.0)
        if upto == P2P_SNAP_STEP:
            snap = s
    expect_launches("step path", 0, P2P_STEPS)
    contacts = check("step path", s)
    print(f"[{card}] p2p step path (variant {step.variant}, plan in the kernel), "
          f"{P2P_STEPS} steps at {n} particles: steps 1-20 {seg_ms[0] / 20:.3f} "
          f"ms/step, steps 21-{P2P_STEPS} "
          f"{(seg_ms[1] + seg_ms[2]) / (P2P_STEPS - 20):.3f} ms/step; "
          f"host reads {step.syncs.count / P2P_STEPS:.2f}/step; cell_overflow "
          f"(lanes redone by the fallback) {stats(ovf)}; contacts {contacts}; "
          f"launches {P2P_STEPS}")

    # ---- the persistent runner: 50 steps from the same state ----
    pk.reset_launches()
    fence(state0.pos)
    t0 = time.perf_counter()
    r, r_ovf = runner(state0, P2P_RUNNER_STEPS, with_stats=True)
    fence(r.pos)
    runner_ms = (time.perf_counter() - t0) * 1000.0 / P2P_RUNNER_STEPS
    expect_launches("runner", 0, P2P_RUNNER_STEPS)
    r_contacts = check("runner", r)
    print(f"[{card}] p2p episode runner, {P2P_RUNNER_STEPS} steps: {runner_ms:.3f} "
          f"ms/step; host reads {runner.syncs.count / P2P_RUNNER_STEPS:.2f}/step; "
          f"cell_overflow {stats(r_ovf)}; contacts {r_contacts}; launches "
          f"{P2P_RUNNER_STEPS}")

    # ---- both entry points against their plain versions, state at step 100 ----
    dev = snap.pos.device
    cid_key = torch.cat([
        p2ps._cell_key(snap.pos, meta, active_mask(snap)),
        torch.full((n_k - n,), meta.num_cells, dtype=torch.int32, device=dev)])
    rows = torch.cat([p2ps._state_rows(snap), p2ps._pad_columns(n_k - n, dev)], dim=1)
    cid_s, perm = torch.sort(cid_key, stable=True)
    offsets = p2p_plan.csr_offsets(cid_key, meta.num_cells)
    starts, cnt = p2p_plan.run_bounds(cid_s, p2p_plan.run_table(offsets, meta), meta)
    rows_s = rows[:, perm]
    pad = perm >= n
    real = torch.abs(rows_s[0]) < 5e37
    plans, err = {}, {name_a: 0.0, name_b: 0.0}
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
              f"{n_over} lanes redone by the fallback, counts differ on {bad_c} "
              f"lanes, pos (rtol=1e-5 atol=1e-5) / vel (rtol=1e-4 atol=1e-5) "
              f"outside on {far} lanes; {dt_ms:.1f} ms")
        if bad_c or far:
            raise RuntimeError(f"p2p_collide_window (w={w}) disagrees with p2p_collide_sorted")

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
    # distinct CSR offsets that the plan in the kernel reads: the two run
    # ends of every in-grid group of every occupied cell, each entry once
    # (neighbouring cells share them)
    dx, dy, dz = meta.dims
    cells = torch.unique(cid_s[cid_s < meta.num_cells]).long()
    cx, cy = cells // (dy * dz), (cells // dz) % dy
    read = torch.zeros(meta.num_cells + 2, dtype=torch.bool, device=dev)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            c = cells[(cx + ox >= 0) & (cx + ox < dx) & (cy + oy >= 0) & (cy + oy < dy)] \
                + (ox * dy + oy) * dz
            read[torch.clamp(c - 1, 0, meta.num_cells)] = True
            read[torch.clamp(c + 2, 0, meta.num_cells)] = True
    n_offsets = int(read.sum())
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
    # the main path launches the kernel through its entry point that plans
    # in the kernel; the explicit-plan entry point (the counterpart of the
    # TPU kernel's signature) is held against its plain version and timed
    # above, and listed under the kernel's entry
    entries[0]["other_entry_points"] = [entries[1]]
    return entries[:1]


def run_cli(card: str, tag: str, argv: list) -> tuple:
    """One command through the port's ``cli.main`` (default device,
    CUDA), its output echoed; raises on a non-zero return.  Returns
    (stdout text, wall seconds)."""
    import contextlib
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
        if min(launches["bench"].values()) <= 0:
            raise RuntimeError(f"bench launches {launches['bench']}: a kernel of "
                               "the path never launched")
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
        if min(launches["per_step"].values()) <= 0:
            raise RuntimeError(f"--per-step launches {launches['per_step']}")
        print(f"[{card}] spatial ms/step: --per-step (make_method_step, a sync per "
              f"step, steps 2-{CLI_PER_STEP_STEPS}) {per_ms:.3f}, persistent runner "
              f"(steps 2-{CLI_STEPS}) {printed['spatial'][0]:.3f}")

        # ---- 8.3: simulate with a checkpoint (make_episode_runner) ----
        out3 = os.path.join(tmp, "simulate")
        wk.reset_launches()
        run_cli(card, "simulate", [
            "simulate", *scene_args, "--method", "spatial",
            "--steps", str(CLI_SIM_STEPS), "--checkpoint", "--out", out3])
        launches["simulate"] = dict(wk.LAUNCHES)
        if min(launches["simulate"].values()) <= 0:
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
                   "p2p_window_collide_cells": CLI_P2P_STEPS + 1}
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
    alone = S.SortedEpisodeRunner(runner.sp, "auto", 8192, 8192, False)
    # a first pass of each warms this fresh process (allocator, lazily
    # loaded modules) as the main path's 600 steps warmed the
    # single-device runner; the timed passes must repeat it bit for bit
    warm = runner(local, MESH_STEPS)
    alone(local, MESH_STEPS)
    ms = {"mesh": [], "alone": []}
    for turn in ("mesh", "alone", "mesh", "alone"):
        torch.cuda.synchronize()
        first_mesh = turn == "mesh" and not ms["mesh"]
        if first_mesh:
            wk.reset_launches()
        t0 = time.perf_counter()
        if turn == "mesh":
            res, ovf_t = runner(local, MESH_STEPS, with_stats=True)
        else:
            res = alone(local, MESH_STEPS)
        torch.cuda.synchronize()
        ms[turn].append((time.perf_counter() - t0) * 1000.0 / MESH_STEPS)
        if first_mesh:
            launches = dict(wk.LAUNCHES)
            out, ovf = res, ovf_t
        elif turn == "alone":
            alone_out = res
    repeat_diff = sum(lane_diff(torch, a, b) for a, b in zip(out, warm))
    alone_diff = sum(lane_diff(torch, a, b) for a, b in zip(out, alone_out))
    gathered = dp.gather_state(out, mesh)

    # B1 (main window) and B2 on this rank's state at step 650
    kw = dict(k_static=runner.sp.meta.max_tris_per_cell, gravity=cfg.gravity,
              dt=cfg.dt, backoff=cfg.backoff)
    b2_args, cases, _ = sorted_plan(torch, runner.sp, out)
    args, w = cases["main"]
    rec = {"rank": rank, "device": str(dp.rank_device(mesh)),
           "backend": dist.get_backend(), "n_local": out.pos.shape[-1],
           "setup_s": setup_s, "ms_mesh": ms["mesh"], "ms_alone": ms["alone"],
           "overflow": ovf,
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
        for r in recs:
            b1, b2 = r["b1"], r["b2"]
            print(f"[{card}]   rank {r['rank']} ({r['device']}): B1 main vs plain: "
                  f"hit differs on {b1['hit_bad']} lanes, any bit on {b1['bits']}, "
                  f"outside tolerance {b1['far']}, max |diff| {b1['err']:.3e}, hits "
                  f"{b1['hits']}; B2 vs plain: {b2['bad']} lanes differ (misses "
                  f"{b2['misses']}); launches on the mesh runner {r['launches']}")
            if b1["hit_bad"] or b1["bits"] or b1["far"] or b2["bad"]:
                raise RuntimeError(f"{tag}, rank {r['rank']}: a kernel disagrees "
                                   "with its plain version")
            if min(r["launches"].values()) <= 0:
                raise RuntimeError(f"{tag}, rank {r['rank']}: a kernel of the "
                                   "path never launched")
        launches[f"world{world}_{backend}"] = [r["launches"] for r in recs]
        c5 = [r["config5"] for r in recs]
        print(f"[{card}] phase 9, {tag}: config 5, {c5[0]['particles']} particles, "
              f"{CONFIG5_STEPS} timed steps: alive after {c5[0]['active_particles']}; "
              f"overflow halo {c5[0]['halo_overflow_last_step']}, migrate "
              f"{c5[0]['migrate_overflow_last_step']}, cell "
              f"{c5[0]['cell_overflow_last_step']}; ms/step "
              + ", ".join(f"{1000.0 / c['steps_per_sec']:.3f}" for c in c5)
              + f"{note}")
        if any(c["active_particles"] != c["particles"]
               or c["halo_overflow_last_step"] or c["migrate_overflow_last_step"]
               or c["backend"] != backend for c in c5):
            raise RuntimeError(f"{tag}: config 5 lost particles or overflowed")
    t0 = time.perf_counter()
    dryrun_multichip(2)
    print(f"[{card}] phase 9: the dry-run entry point, 2 ranks over "
          f"{dp.choose_backend('cuda', 2)}: {time.perf_counter() - t0:.1f} s")
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
    runner from the spawn state, then runs the episode from it."""

    def __init__(self, runner, snap_step: int):
        self.runner, self.snap_step = runner, snap_step
        self.sp = runner.sp
        self.spawn = None

    def __call__(self, state, num_steps: int):
        if self.spawn is None or state is self.spawn:
            self.spawn = state
            self.done, self.overflow, self.snap = 0, [], None
            self.syncs0 = self.runner.syncs.count
        parts = [num_steps]
        if self.done < self.snap_step < self.done + num_steps:
            parts = [self.snap_step - self.done, self.done + num_steps - self.snap_step]
        for n in parts:
            state, ovf = self.runner(state, n, with_stats=True)
            self.overflow += ovf
            self.done += n
            if self.done == self.snap_step:
                self.snap = state
        self.last = state
        return state


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
    plan; its overflow per step; on its state at step 1500, B1 (main
    window, rescue chunk, one lane per row) and B2 against their plain
    versions.

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
            taps.append(_EpisodeTap(runner, PROTOCOL_SNAP_STEP))
            return taps[-1]
        return runner

    make_runner = H.make_sorted_episode_runner
    H.make_sorted_episode_runner = tapped_runner
    wk.reset_launches()
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
    if launches_a["cells_window_lookup"] < 2 * PROTOCOL_STEPS or \
            launches_a["window_collide_sorted"] <= 2 * PROTOCOL_STEPS:
        raise RuntimeError(f"protocol k={PROTOCOL_K} launches {launches_a}: a kernel "
                           "of the path never launched, or the rescue never did")
    print(f"[{card}] protocol k={PROTOCOL_K}: {wall_a:.1f} s; launches {launches_a}; "
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
    print(f"[{card}] protocol k={PROTOCOL_K}, the spatial episode at step "
          f"{PROTOCOL_STEPS}: overflow per step max {max(ovf)}, median "
          f"{sorted(ovf)[len(ovf) // 2]}, above {S._COMPACT_CAP} on "
          f"{sum(o > S._COMPACT_CAP for o in ovf)} steps; host reads "
          f"{(tap.runner.syncs.count - tap.syncs0) / PROTOCOL_STEPS:.2f}/step; "
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
        b2_args, cases, overflow = sorted_plan(torch, sp, state, undecided)
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
        return b2_args, cases

    b2_args, cases = sentinels_in_plan(
        f"protocol k={PROTOCOL_K}, state at step {PROTOCOL_SNAP_STEP}", snap)
    numbers = {"b2": b2_case(torch, card, f"protocol k={PROTOCOL_K}, step "
                             f"{PROTOCOL_SNAP_STEP}", b2_args), "b1": {}}
    for tag, (args, w) in cases.items():
        numbers["b1"][tag] = window_case(
            torch, card, sp, f"protocol k={PROTOCOL_K} {tag}, step {PROTOCOL_SNAP_STEP}",
            args, w)

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
    if min(launches_b.values()) <= 0:
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
    print(f"[{card}] phase 10 (protocol ladder): {time.perf_counter() - t_phase:.1f} s")
    return {"launches_k7": launches_a, "launches_k0": launches_b, **numbers}


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

    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
        active_mask, spawn_grid,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.geometry.scenes import (
        dragon_scene,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build
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
          f"device {torch.cuda.get_device_name(0)}")
    build_s = build.build_all()
    print(f"[{card}] kernel build (nvcc, {len(build.SOURCES)} sources in "
          f"parallel): {build_s:.2f} s")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    syncs0 = runner.syncs.count
    s = runner(state0, 1)  # step 0 (first launches)
    fence(s.pos)
    t0 = time.perf_counter()
    s = runner(s, 150)
    fence(s.pos)
    spawn_ms = (time.perf_counter() - t0) * 1000.0 / 150
    t0 = time.perf_counter()
    s = runner(s, 449)
    fence(s.pos)
    mid_ms = (time.perf_counter() - t0) * 1000.0 / 449
    snap600 = s
    t0 = time.perf_counter()
    s, ovf_a = runner(s, SNAP_STEP - 600, with_stats=True)
    fence(s.pos)
    t_a = time.perf_counter() - t0
    snap = s
    t0 = time.perf_counter()
    s, ovf_b = runner(s, N_STEPS - SNAP_STEP, with_stats=True)
    fence(s.pos)
    impact_ms = (t_a + time.perf_counter() - t0) * 1000.0 / (N_STEPS - 600)
    launches = dict(wk.LAUNCHES)
    syncs_per_step = (runner.syncs.count - syncs0) / N_STEPS

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
          f"collisions {total_coll}; launches {launches}")
    if nan_lanes:
        raise RuntimeError(f"{nan_lanes} active lanes hold NaN/inf")
    if not sentinels_ok:
        raise RuntimeError("padding sentinels moved or collided")
    if total_coll <= 0:
        raise RuntimeError("no collisions in 700 steps")
    if launches["cells_window_lookup"] <= 0:
        raise RuntimeError("the cells kernel never launched on the main path")
    if launches["window_collide_sorted"] <= N_STEPS:
        raise RuntimeError(
            f"window kernel launched {launches['window_collide_sorted']} "
            f"times in {N_STEPS} steps: the rescue never used it")

    # ---- phases 3 and 4: each kernel against its plain version and timed,
    # on the states at step 650 and at step 700 ----
    b1 = {}
    for at, state in ((SNAP_STEP, snap), (N_STEPS, s)):
        b2_args, cases, overflow = sorted_plan(torch, sp, state)
        print(f"[{card}] state at step {at}: {int(overflow.sum())} overflow lanes in "
              "the main plan")
        if at == SNAP_STEP:
            b2 = b2_case(torch, card, f"spatial, step {at}", b2_args)
        for tag, (args, w) in cases.items():
            b1[(tag, at)] = window_case(torch, card, sp, f"{tag}, step {at}", args, w)

    # ---- a reading, no default changed: steps 600-700 once more with the
    # dense-cell demotion off ----
    nodemote = S.SortedEpisodeRunner(sp._replace(demote=None), "auto", 8192, 8192, False)
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
    hyb = drive_hybrid(torch, card, scene, state0, total_coll, sp)

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

    def mesh_launch(key):
        return {w: [r[key] for r in ranks] for w, ranks in mesh_launches.items()}

    def cli_launches(key):
        return {sub: counts[key] for sub, counts in cli["launches"].items()
                if key in counts}

    b1_total = launches["window_collide_sorted"]

    def b1_entry(suffix, numbers, n_launch, phase2=None):
        entry = {"name": "window_collide_sorted" + suffix, "route": "cuda",
                 "source": PORT_CSRC + "window_kernel.cu",
                 "replaces": f"{JAX_KERNELS}:346", "launches": n_launch,
                 **numbers, "library_ms": None}
        if phase2 is not None:
            entry["one_lane_per_row"] = {**phase2, "library_ms": None}
        return entry

    # every step launches the window kernel once at the main window; the
    # launches beyond that are the rescue's: phase-1 chunks and phase-2
    # launches of one lane per row (whose case is nested in the entry)
    def b2_entry(suffix, numbers, n_launch):
        return {"name": "cells_window_lookup" + suffix, "route": "cuda",
                "source": PORT_CSRC + "cells_kernel.cu",
                "replaces": f"{JAX_KERNELS}:192", "launches": n_launch,
                **numbers, "library_ms": None}

    h_launch = hyb["launches"]
    kernels = [
        {**b2_entry("", b2, launches["cells_window_lookup"]),
         "launches_cli": cli_launches("cells_window_lookup"),
         "launches_mesh": mesh_launch("cells_window_lookup")},
        {**b1_entry("", b1[("main", SNAP_STEP)], b1_total),
         "launches_cli": cli_launches("window_collide_sorted"),
         "launches_mesh": mesh_launch("window_collide_sorted")},
        b1_entry(":rescue_chunk", b1[("rescue chunk", SNAP_STEP)], b1_total - N_STEPS,
                 b1[("one lane per row", SNAP_STEP)]),
        b1_entry(":main_step700", b1[("main", N_STEPS)], N_STEPS),
        b1_entry(":rescue_chunk_step700", b1[("rescue chunk", N_STEPS)],
                 b1_total - N_STEPS, b1[("one lane per row", N_STEPS)]),
        # the hybrid path's launches of B1 and B2, held against their plain
        # versions on the hybrid state at step 650 (counts zeroed on lanes
        # the screen-space stage decided)
        {**b2_entry(":hybrid", hyb["b2"], h_launch["cells_window_lookup"]),
         "path": "hybrid"},
        {**b1_entry(":hybrid", hyb["b1"]["main"], N_STEPS), "path": "hybrid"},
        {**b1_entry(":hybrid_rescue_chunk", hyb["b1"]["rescue chunk"],
                    h_launch["window_collide_sorted"] - N_STEPS,
                    hyb["b1"]["one lane per row"]), "path": "hybrid"},
        # phase 10: the protocol's launches of B1 (main and rescue) and B2
        # at k = 7 and at k = 0 on the four cameras, held against their
        # plain versions on the k = 7 spatial state at step 1500
        {**b2_entry(":protocol", prot["b2"], prot["launches_k7"]["cells_window_lookup"]),
         "path": "protocol k=7",
         "launches_k0_cameras": prot["launches_k0"]["cells_window_lookup"]},
        {**b1_entry(":protocol", prot["b1"]["main"],
                    prot["launches_k7"]["window_collide_sorted"],
                    prot["b1"]["one lane per row"]),
         "rescue_chunk": {**prot["b1"]["rescue chunk"], "library_ms": None},
         "path": "protocol k=7",
         "launches_k0_cameras": prot["launches_k0"]["window_collide_sorted"]},
        {**b3[0], "launches_cli": cli_launches(b3[0]["name"])},
        *b3[1:],
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(device_line(torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
