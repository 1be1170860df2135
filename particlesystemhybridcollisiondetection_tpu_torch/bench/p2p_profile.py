"""Where a particle-particle step spends its time on the card.

    python3 -m particlesystemhybridcollisiondetection_tpu_torch.bench.p2p_profile

Runs the 1,000,000-particle gravity box of ``configs.config_4`` and
prints one JSON object per line, each with the card's name and power
limit:

  * ``sweep``: ms/step of ``make_p2p_step`` (variant "kernel") for each
    window size, with the lanes redone by the fallback, the host reads
    and the kernel launches per step;
  * ``stages``: the stages of one step at the default window, each timed
    with CUDA events (median over the steps), on states advanced by the
    real step; once as the step runs it (the kernel's entry point that
    derives its plan) and once with the plan built by ``ops/p2p_plan.py``
    and handed to the kernel's other entry point;
  * ``density``: the window kernel alone (the entry point the step
    calls) on the falling box at step 100 and on the pile at step
    ``--settled-step``: candidates per lane, contacts, lanes that
    overflow the window, CUDA events around one call and device time
    from ``torch.profiler``;
  * ``device``: the share of wall time in which the device ran a kernel,
    from ``torch.profiler`` ("not measured" when it reports no device
    time).

Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from particlesystemhybridcollisiondetection_tpu_torch.bench.configs import (
    _box_state,
    card_line,
)
from particlesystemhybridcollisiondetection_tpu_torch.config import SimConfig
from particlesystemhybridcollisiondetection_tpu_torch.core import step as S
from particlesystemhybridcollisiondetection_tpu_torch.core.state import active_mask
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    p2p_window_kernel as pk,
)

CFG = SimConfig(particle_radius=0.4, dt=0.005, bounciness=0.3)


def _box(n: int):
    side = round(n ** (1 / 3) * 4 * 0.4)
    return (0.0, 0.0, 0.0), (side, side / 2, side)


def sweep(n: int, windows, warm: int, steps: int, card: str) -> None:
    lo, hi = _box(n)
    for w in windows:
        step = S.make_p2p_step(lo, hi, CFG, capacity=8, variant="kernel",
                               with_stats=True, window=w)
        s = _box_state(n, lo, hi, 0.4, 0.3, seed=0)
        for _ in range(warm):
            s, _ = step(s)
        torch.cuda.synchronize()
        pk.reset_launches()
        reads0, ovf = step.syncs.count, []
        t0 = time.perf_counter()
        for _ in range(steps):
            s, st = step(s)
            ovf.append(st["cell_overflow"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0 / steps
        print(json.dumps({
            "sweep": {"window": w, "particles": n, "warm_steps": warm,
                      "steps": steps, "ms_per_step": ms,
                      "fallback_lanes_min": min(ovf),
                      "fallback_lanes_median": statistics.median(ovf),
                      "fallback_lanes_max": max(ovf),
                      "host_reads_per_step": (step.syncs.count - reads0) / steps,
                      "launches_per_step":
                          pk.LAUNCHES["p2p_window_collide_cells"] / steps},
            "card": card}), flush=True)


def stages(n: int, warm: int, steps: int, window: int, plan: str, card: str) -> None:
    """One step taken apart as p2p_collide_window + walls + integrate
    runs it (``plan`` "kernel"), or with the plan arrays built by
    ops/p2p_plan.py and the kernel's explicit-plan entry point
    ("explicit"); the state advances through the real step in between."""
    lo, hi = _box(n)
    step = S.make_p2p_step(lo, hi, CFG, capacity=8, variant="kernel", window=window)
    meta = S._p2p_meta(lo, hi, CFG, None, 8, None)
    gravity = torch.tensor(CFG.gravity, dtype=torch.float32, device="cuda")
    s = _box_state(n, lo, hi, 0.4, 0.3, seed=0)
    for _ in range(warm):
        s = step(s)
    n_k = -(-n // pk.BLOCK) * pk.BLOCK
    plan_stages = () if plan == "kernel" else ("run_table", "run_bounds",
                                               "window_geometry")
    names = ("key_and_pad", "sort", "csr_offsets", *plan_stages, "gather_rows",
             "kernel", "overflow_read", "unsort", "walls_integrate")
    times = {k: [] for k in names}
    for _ in range(steps):
        ev = []

        def mark():
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        mark()
        key = torch.cat([
            p2ps._cell_key(s.pos, meta, active_mask(s)),
            torch.full((n_k - n,), meta.num_cells, dtype=torch.int32, device="cuda")])
        rows = torch.cat([p2ps._state_rows(s), p2ps._pad_columns(n_k - n, "cuda")], 1)
        mark()
        cid_s, perm = torch.sort(key, stable=True)
        mark()
        offsets = p2p_plan.csr_offsets(key, meta.num_cells)
        mark()
        if plan == "explicit":
            tab = p2p_plan.run_table(offsets, meta)
            mark()
            starts, cnt = p2p_plan.run_bounds(cid_s, tab, meta)
            mark()
            rel, ws, k_cap, overflow = p2p_plan.window_geometry(starts, cnt, window)
            mark()
        rows_s = rows[:, perm]
        rows_pad = torch.cat([rows_s, p2ps._pad_columns(window, "cuda")], dim=1)
        mark()
        if plan == "explicit":
            out = pk.p2p_window_collide_sorted(
                rows_s[0:3], rows_s[3:6], rows_s[6], rows_s[7], rows_pad, rel, cnt,
                ws, k_cap, w=window, beta=0.5)
        else:
            *out, overflow = pk.p2p_window_collide_cells(
                rows_pad, cid_s, offsets, meta, w=window, beta=0.5)
        mark()
        int(overflow.sum().item())
        mark()
        st = p2ps._unsort(s, *out, perm)
        mark()
        S._walls_integrate(st, lo, hi, gravity, CFG.dt)
        mark()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            times[k].append(ev[i].elapsed_time(ev[i + 1]))
        s = step(s)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({"stages": {"plan": plan, "window": window, "particles": n,
                                 "steps": steps, "median_ms": med,
                                 "sum_ms": sum(med.values())},
                      "card": card}), flush=True)


def _kernel_device_ms(fn, reps: int):
    """Summed device time of the CUDA kernels one call of ``fn`` launches
    (torch.profiler, mean of ``reps`` calls); None where the profiler's
    device trace came back empty (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1000.0 / reps if total > 0 else None


def density(n: int, at_steps, window: int, card: str, reps: int = 20) -> None:
    """The window kernel alone at states of growing density (the episode
    runner advances the box from spawn to each step of ``at_steps``)."""
    lo, hi = _box(n)
    runner = S.make_p2p_episode_runner(lo, hi, CFG, capacity=8, window=window)
    meta = runner.meta
    s = _box_state(n, lo, hi, 0.4, 0.3, seed=0)
    n_k = -(-n // pk.BLOCK) * pk.BLOCK
    done = 0
    for at in at_steps:
        s, ovf = runner(s, at - done, with_stats=True)
        done = at
        key = torch.cat([
            p2ps._cell_key(s.pos, meta, active_mask(s)),
            torch.full((n_k - n,), meta.num_cells, dtype=torch.int32, device="cuda")])
        rows = torch.cat([p2ps._state_rows(s), p2ps._pad_columns(n_k - n, "cuda")], 1)
        cid_s, perm = torch.sort(key, stable=True)
        offsets = p2p_plan.csr_offsets(key, meta.num_cells)
        rows_pad = torch.cat([rows[:, perm], p2ps._pad_columns(window, "cuda")], dim=1)
        starts, cnt = p2p_plan.run_bounds(
            cid_s, p2p_plan.run_table(offsets, meta), meta)
        rel, _, _, overflow = p2p_plan.window_geometry(starts, cnt, window)
        n_cand = int(torch.minimum(cnt, window - rel).sum())
        del starts, cnt, rel

        def call():
            return pk.p2p_window_collide_cells(rows_pad, cid_s, offsets, meta,
                                               w=window, beta=0.5)

        ncon = call()[2]
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        print(json.dumps({
            "density": {"step": at, "particles": n, "window": window,
                        "candidates_per_lane": n_cand / n_k,
                        "contacts": int(ncon.sum()),
                        "overflow_lanes": int(overflow.sum()),
                        "fallback_lanes_last_step": ovf[-1],
                        "mean_height": float(s.pos[1].mean()),
                        "call_ms": statistics.median(times),
                        "device_ms": _kernel_device_ms(call, reps)},
            "card": card}), flush=True)


def device_share(n: int, warm: int, steps: int, card: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lo, hi = _box(n)
    step = S.make_p2p_step(lo, hi, CFG, capacity=8, variant="kernel")
    s = _box_state(n, lo, hi, 0.4, 0.3, seed=0)
    for _ in range(warm):
        s = step(s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            s = step(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    # device-side rows only: the host-side row of an operator repeats the
    # time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1000.0, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    out = {"particles": n, "steps": steps, "wall_ms_per_step_profiled": wall_ms / steps}
    if busy_ms > 0:
        out.update({
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels_ms_per_step": [
                {"name": k[:80], "ms": ms / steps, "calls_per_step": c / steps}
                for k, ms, c in rows[:12]]})
    else:
        out["device_busy_ms_per_step"] = "not measured"
    print(json.dumps({"device": out, "card": card}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--windows", type=int, nargs="*", default=[128, 256, 512, 1024])
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--settled-step", type=int, default=1500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("p2p_profile: CUDA is not available")
    card = card_line()
    sweep(args.n, args.windows, args.warm, args.steps, card)
    for plan in ("kernel", "explicit"):
        stages(args.n, args.warm, args.steps, 512, plan, card)
    density(args.n, (100, args.settled_step), 512, card)
    device_share(args.n, args.warm, args.steps, card)
    print(card_line())


if __name__ == "__main__":
    main()
