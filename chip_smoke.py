#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and passed over):
  1. print the card (nvidia-smi name and power limit), the torch and CUDA
     versions, and build the three CUDA kernels from ops/cuda/csrc;
  2. drive the spatial main path: the persistent sorted episode runner of
     the spatial method on DragonScene at 1,048,576 particles (128^2 x 64
     layers), cells lookup "kernel", resort_every "auto", 700 steps from
     spawn; check no NaN on active lanes, sentinels intact, collisions > 0
     and both kernels launched (launch counters reset just before);
  3. on the state at step 650, hold each of its kernels against its plain
     PyTorch version at the main path's shapes (cells lookup; window
     kernel at the main window and on the first phase-1 rescue chunk);
  4. time each and its plain version (CUDA events, median of 20);
  5. drive the particle-particle main path (``drive_p2p``): 1,000,000
     particles in the 160 x 80 x 160 gravity box of bench/configs.py
     config 4, 200 steps of make_p2p_step (variant "auto", which must
     resolve to "kernel") and 50 steps of make_p2p_episode_runner, launch
     counters reset just before each; check every lane finite and inside
     the box, contacts > 0, one kernel launch per step; on the state at
     step 100 hold the p2p window kernel against its plain version on
     every lane (window 512, and 128 where lanes overflow) and
     p2p_collide_window against p2p_collide_sorted; time the kernel;
  6. print the kernel table as one JSON line.
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


def lane_diff(torch, a, b) -> int:
    """Lanes (last axis) on which two tensors differ anywhere."""
    ne = a != b
    return int((ne.any(0) if ne.dim() > 1 else ne).sum())


def drive_p2p(torch, card: str) -> dict:
    """Phase 5: the particle-particle path at full width.  Returns the
    kernel-table entry of the p2p window kernel."""
    from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import _box_state
    from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
    from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
    from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
    from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
        p2p_window_kernel as pk,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

    name = "p2p_window_collide_sorted"
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
    step_launches = pk.LAUNCHES[name]
    contacts = check("step path", s)
    print(f"[{card}] p2p step path (variant {step.variant}), {P2P_STEPS} steps at "
          f"{n} particles: steps 1-20 {seg_ms[0] / 20:.3f} ms/step, steps 21-"
          f"{P2P_STEPS} {(seg_ms[1] + seg_ms[2]) / (P2P_STEPS - 20):.3f} ms/step; "
          f"host reads {step.syncs.count / P2P_STEPS:.2f}/step; cell_overflow "
          f"(lanes redone by the fallback) {stats(ovf)}; contacts {contacts}; "
          f"launches {step_launches}")
    if step_launches != P2P_STEPS:
        raise RuntimeError(f"p2p kernel launched {step_launches} times in "
                           f"{P2P_STEPS} steps")

    # ---- the persistent runner: 50 steps from the same state ----
    pk.reset_launches()
    fence(state0.pos)
    t0 = time.perf_counter()
    r, r_ovf = runner(state0, P2P_RUNNER_STEPS, with_stats=True)
    fence(r.pos)
    runner_ms = (time.perf_counter() - t0) * 1000.0 / P2P_RUNNER_STEPS
    runner_launches = pk.LAUNCHES[name]
    r_contacts = check("runner", r)
    print(f"[{card}] p2p episode runner, {P2P_RUNNER_STEPS} steps: {runner_ms:.3f} "
          f"ms/step; host reads {runner.syncs.count / P2P_RUNNER_STEPS:.2f}/step; "
          f"cell_overflow {stats(r_ovf)}; contacts {r_contacts}; launches "
          f"{runner_launches}")
    if runner_launches != P2P_RUNNER_STEPS:
        raise RuntimeError(f"p2p kernel launched {runner_launches} times in "
                           f"{P2P_RUNNER_STEPS} runner steps")

    # ---- the kernel against its plain version, state at step 100 ----
    dev = snap.pos.device
    cid_key = torch.cat([
        p2ps._cell_key(snap.pos, meta, active_mask(snap)),
        torch.full((n_k - n,), meta.num_cells, dtype=torch.int32, device=dev)])
    rows = torch.cat([p2ps._state_rows(snap), p2ps._pad_columns(n_k - n, dev)], dim=1)
    perm, starts, cnt = p2ps._sorted_runs(cid_key, meta)
    rows_s = rows[:, perm]
    plans, err = {}, 0.0
    for w in (window, P2P_SMALL_WINDOW):
        rel, ws, k_cap, overflow = p2ps._window_geometry(starts, cnt, w)
        rows_pad = torch.cat([rows_s, p2ps._pad_columns(w, dev)], dim=1)
        args = (rows_s[0:3], rows_s[3:6], rows_s[6], rows_s[7], rows_pad, rel,
                cnt, ws, k_cap)
        plans[w] = args
        pk_, vk, nk = pk.p2p_window_collide_sorted(*args, w=w, beta=0.5)
        pp, vp, npl = pk.p2p_window_collide_sorted_plain(*args, w=w, beta=0.5)
        torch.cuda.synchronize()
        bad_n, bad_p, bad_v = (lane_diff(torch, nk, npl), lane_diff(torch, pk_, pp),
                               lane_diff(torch, vk, vp))
        real = torch.abs(rows_s[0]) < 5e37
        w_err = max(float(torch.abs(pk_ - pp)[:, real].max()),
                    float(torch.abs(vk - vp).max()))
        err = max(err, w_err)
        pad = perm >= n
        pads_inert = bool((nk[pad] == 0).all() and (vk[:, pad] == 0).all()
                          and (pk_[:, pad] == 1e38).all())
        print(f"[{card}] B3 p2p window kernel (w={w}, N={n_k}) vs plain on every "
              f"lane: ncon differs on {bad_n} lanes, pos on {bad_p}, vel on "
              f"{bad_v}, max |diff| {w_err:.3e}; contacts {int(nk.sum())}; "
              f"overflow lanes {int(overflow.sum())}; {int(pad.sum())} pad "
              f"columns inert: {pads_inert}")
        if bad_n or bad_p or bad_v:
            raise RuntimeError(f"p2p window kernel (w={w}) disagrees with its plain version")
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
    args = plans[window]
    ms = median_ms(torch, lambda: pk.p2p_window_collide_sorted(*args, w=window, beta=0.5))
    plain_ms = median_ms(
        torch, lambda: pk.p2p_window_collide_sorted_plain(*args, w=window, beta=0.5))
    rows_pad, rel, cnt, ws, k_cap = args[4:]
    nb = n_k // pk.BLOCK
    ws_l = ws.permute(1, 0, 2).reshape(pk.N_GROUPS, nb * pk.SUB).repeat_interleave(
        pk.LANE, dim=1)
    bound = torch.minimum(torch.minimum(
        cnt, k_cap.t().repeat_interleave(pk.BLOCK, dim=1)), window - rel)
    n_cand = int(bound.sum())
    # distinct candidate columns: the union of the intervals [col0, col0 + bound)
    col0 = (ws_l + rel).long()
    live = bound > 0
    diff = torch.zeros(rows_pad.shape[1] + 1, dtype=torch.int32, device=dev)
    one = torch.ones(int(live.sum()), dtype=torch.int32, device=dev)
    diff.index_add_(0, col0[live], one)
    diff.index_add_(0, (col0 + bound)[live], -one)
    n_cols = int((torch.cumsum(diff, 0) > 0).sum())
    # each lane's pos/vel/radius/restitution (32 B), rel and cnt (72 B),
    # ws and k_cap, every distinct candidate column once (32 B), out 28 B
    n_bytes = n_k * (32 + 72) + 4 * ws.numel() + 4 * k_cap.numel() \
        + 32 * n_cols + 28 * n_k
    n_ops = P2P_OPS_PER_CANDIDATE * n_cand + P2P_OPS_PER_LANE * n_k
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_F32_OPS_PER_S * 1e3
    print(f"[{card}] B3 p2p window kernel: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
          f"bound {max(bytes_ms, ops_ms):.4f} ms ({n_cand} candidates, {n_cols} "
          f"distinct columns, {n_bytes} B = {bytes_ms:.4f} ms, {n_ops:.3e} ops = "
          f"{ops_ms:.4f} ms)")
    return {"name": name, "route": "cuda",
            "source": PORT_CSRC + "p2p_window_kernel.cu",
            "replaces": f"{JAX_P2P_KERNEL}:77",
            "launches": step_launches + runner_launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


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
    from particlesystemhybridcollisiondetection_tpu_torch.ops.grid import (
        lookup_pos, morton_key,
    )
    from particlesystemhybridcollisiondetection_tpu_torch.utils.profiling import fence

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

    # ---- phase 3: each kernel against its plain version, step 650 ----
    nb = n // wk.BLOCK
    key = morton_key(lookup_pos(snap.pos, snap.vel, cfg.dt), sp.meta)
    key_s, perm = torch.sort(key, stable=True)
    rows = torch.cat([snap.pos, snap.vel, snap.radius[None],
                      snap.restitution[None]], dim=0)[:, perm]
    sorted_state = (rows[0:3].contiguous(), rows[3:6].contiguous(),
                    rows[6].contiguous(), rows[7].contiguous())
    kr = key_s.reshape(nb * wk.SUB, wk.LANE)
    lo = (kr.min(dim=1).values // 128) * 128
    hi = torch.clamp(((kr.max(dim=1).values - S._CODE_WC + 128) // 128) * 128, min=0)
    b2_args = (key_s, lo, hi, sp.ctab)
    start_k, count_k = wk.cells_window_lookup(*b2_args, wc=S._CODE_WC)
    start_p, count_p = wk.cells_window_lookup_plain(*b2_args, wc=S._CODE_WC)
    torch.cuda.synchronize()
    hit_cnt = count_p >= 0
    b2_bad = int((count_k != count_p).sum() + ((start_k != start_p) & hit_cnt).sum())
    print(f"[{card}] B2 cells lookup vs plain at N={n}: {b2_bad} lanes differ "
          f"(misses {int((~hit_cnt).sum())})")
    if b2_bad:
        raise RuntimeError(f"cells kernel disagrees with its plain version on {b2_bad} lanes")

    rel, count, ws, k_cap, overflow, _ = S._window_plan_coded(
        key_s, sp.ctab, sp.window, nb, demote=sp.demote)
    kw = dict(k_static=sp.meta.max_tris_per_cell, gravity=cfg.gravity,
              dt=cfg.dt, backoff=cfg.backoff)
    b1_main = (*sorted_state, rel, count, ws, k_cap, sp.tables)
    m1 = 8192
    pick = S._phase1_order(overflow, key_s)[:m1]
    _, chunk_state, (rel_c, cnt_c, ws_c, kcap_c, _) = S._rescue_chunk(
        sorted_state, overflow, pick, sp.tables, sp.meta, cfg, sp.rescue_window)
    b1_rescue = (*chunk_state, rel_c, cnt_c, ws_c, kcap_c, sp.tables)
    b1_err = {}
    for tag, args, w in (("main", b1_main, sp.window),
                         ("rescue", b1_rescue, sp.rescue_window)):
        pk, vk, hk = wk.window_collide_sorted(*args, w=w, **kw)
        pp, vp, hp = wk.window_collide_sorted_plain(*args, w=w, **kw)
        torch.cuda.synchronize()
        act = torch.abs(args[0][0]) < 5e37
        hit_bad = int(((hk != hp) & act).sum())
        close = (torch.isclose(pk, pp, rtol=RTOL, atol=ATOL).all(0)
                 & torch.isclose(vk, vp, rtol=RTOL, atol=ATOL).all(0))
        far = int((~close).sum())
        err = max(float(torch.abs(pk - pp)[:, act].max()),
                  float(torch.abs(vk - vp)[:, act].max()))
        b1_err[tag] = err
        print(f"[{card}] B1 window kernel ({tag}, w={w}, N={args[0].shape[1]}) "
              f"vs plain: hit differs on {hit_bad} active lanes, pos/vel "
              f"outside rtol={RTOL} atol={ATOL} on {far} lanes, max |diff| "
              f"{err:.3e}, hits {int(hk.sum())}")
        if hit_bad or far:
            raise RuntimeError(f"window kernel ({tag}) disagrees with its plain version")

    # ---- phase 4: timings and bounds at the main path's shapes ----
    def b2_kernel():
        wk.cells_window_lookup(*b2_args, wc=S._CODE_WC)

    def b2_plain():
        wk.cells_window_lookup_plain(*b2_args, wc=S._CODE_WC)

    def b1_kernel(args=b1_main, w=sp.window):
        wk.window_collide_sorted(*args, w=w, **kw)

    def b1_plain(args=b1_main, w=sp.window):
        wk.window_collide_sorted_plain(*args, w=w, **kw)

    b2_ms, b2_plain_ms = median_ms(torch, b2_kernel), median_ms(torch, b2_plain)
    b1_ms, b1_plain_ms = median_ms(torch, b1_kernel), median_ms(torch, b1_plain)
    r_args = dict(args=b1_rescue, w=sp.rescue_window)
    b1r_ms = median_ms(torch, lambda: b1_kernel(**r_args))
    b1r_plain_ms = median_ms(torch, lambda: b1_plain(**r_args))

    # B2 bound: key in, (start, count) out, lo/hi, one table entry per
    # distinct key
    n_keys = int(torch.unique(key_s).numel())
    b2_bytes = 4 * n + 8 * n + 8 * (n // wk.LANE) + 4 * n_keys
    b2_bound = b2_bytes / H100_BYTES_PER_S * 1e3

    # B1 bound: lane inputs and outputs, every distinct candidate row once
    # (36 B), and the float operations of the candidates evaluated
    ws_l = ws.reshape(-1).repeat_interleave(wk.LANE)
    kb = torch.clamp(k_cap, max=sp.meta.max_tris_per_cell).repeat_interleave(wk.BLOCK)
    bound = torch.clamp(torch.minimum(torch.minimum(count, kb), sp.window - rel), min=0)
    n_cand = int(bound.sum())
    row0 = (ws_l + rel).long()
    diff = torch.zeros(sp.tables.pairs.shape[1] + 1, dtype=torch.int32,
                       device=key_s.device)
    live = bound > 0
    diff.index_add_(0, row0[live], torch.ones_like(row0[live], dtype=torch.int32))
    diff.index_add_(0, (row0 + bound)[live], -torch.ones_like(row0[live], dtype=torch.int32))
    n_rows = int((torch.cumsum(diff, 0) > 0).sum())
    b1_bytes = n * (12 + 12 + 4 + 4 + 4 + 4) + 4 * (n // wk.LANE) + 4 * nb \
        + 36 * n_rows + n * (12 + 12 + 4)
    b1_ops = WINDOW_OPS_PER_CANDIDATE * n_cand + WINDOW_OPS_PER_LANE * n
    b1_bytes_ms = b1_bytes / H100_BYTES_PER_S * 1e3
    b1_ops_ms = b1_ops / H100_F32_OPS_PER_S * 1e3
    print(f"[{card}] B2 cells lookup: {b2_ms:.4f} ms (plain {b2_plain_ms:.4f} "
          f"ms), bound {b2_bound:.4f} ms ({b2_bytes} B, {n_keys} distinct keys)")
    print(f"[{card}] B1 window kernel main: {b1_ms:.4f} ms (plain "
          f"{b1_plain_ms:.4f} ms), bound {max(b1_bytes_ms, b1_ops_ms):.4f} ms "
          f"({n_cand} candidates, {n_rows} distinct rows, {b1_bytes} B, "
          f"{b1_ops:.3e} ops); rescue chunk w={sp.rescue_window}: "
          f"{b1r_ms:.4f} ms (plain {b1r_plain_ms:.4f} ms)")

    # ---- phase 5: the particle-particle path ----
    b3 = drive_p2p(torch, card)

    kernels = [
        {"name": "cells_window_lookup", "route": "cuda",
         "source": PORT_CSRC + "cells_kernel.cu",
         "replaces": f"{JAX_KERNELS}:192", "launches": launches["cells_window_lookup"],
         "max_abs_err": 0.0 if not b2_bad else float(b2_bad),
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "window_collide_sorted", "route": "cuda",
         "source": PORT_CSRC + "window_kernel.cu",
         "replaces": f"{JAX_KERNELS}:346", "launches": launches["window_collide_sorted"],
         "max_abs_err": max(b1_err.values()),
         "ms": b1_ms, "plain_ms": b1_plain_ms,
         "bound_ms": max(b1_bytes_ms, b1_ops_ms),
         "bound_by": "operations" if b1_ops_ms >= b1_bytes_ms else "bytes",
         "library_ms": None},
        b3,
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
