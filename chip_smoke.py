#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and passed over):
  1. print the card (nvidia-smi name and power limit), the torch and CUDA
     versions, and build both CUDA kernels from ops/cuda/csrc;
  2. drive the main path: the persistent sorted episode runner of the
     spatial method on DragonScene at 1,048,576 particles (128^2 x 64
     layers), cells lookup "kernel", resort_every "auto", 700 steps from
     spawn; check no NaN on active lanes, sentinels intact, collisions > 0
     and both kernels launched (launch counters reset just before);
  3. on the state at step 650, hold each kernel against its plain PyTorch
     version at the main path's shapes (cells lookup; window kernel at the
     main window and on the first phase-1 rescue chunk);
  4. time each kernel and its plain version (CUDA events, median of 20)
     and print the kernel table as one JSON line.
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

    kernels = [
        {"name": "cells_window_lookup", "route": "cuda",
         "source": "particlesystemhybridcollisiondetection_tpu_torch/ops/cuda/csrc/cells_kernel.cu",
         "replaces": f"{JAX_KERNELS}:192", "launches": launches["cells_window_lookup"],
         "max_abs_err": 0.0 if not b2_bad else float(b2_bad),
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "window_collide_sorted", "route": "cuda",
         "source": "particlesystemhybridcollisiondetection_tpu_torch/ops/cuda/csrc/window_kernel.cu",
         "replaces": f"{JAX_KERNELS}:346", "launches": launches["window_collide_sorted"],
         "max_abs_err": max(b1_err.values()),
         "ms": b1_ms, "plain_ms": b1_plain_ms,
         "bound_ms": max(b1_bytes_ms, b1_ops_ms),
         "bound_by": "operations" if b1_ops_ms >= b1_bytes_ms else "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
