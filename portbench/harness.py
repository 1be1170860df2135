"""One run of one cell: set-up, the measured window, the per-layer
readings, and the check against the plain reference.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (the file the entry gives, under ``configs/``) and
a traffic mix (``traffic/<name>.json``); the configuration names its
inputs (``inputs/<name>.py``: the scene and the spawn of a seed), its
system (``systems/<name>.py``: the adapter that builds the program from
those inputs) and its reference (``reference/<name>.py``); each metric,
end-to-end or per-layer, is read by ``metrics/<metric name>.py``.  A new cell, mix, configuration or metric
is new files and entries; nothing here changes.

The mix is a closed loop of steps: the system runs ``chunk_steps`` steps
a call from the spawn, and the state returns there after every
``episode_steps`` steps (ParticleSys.cs:520-526; the collision counters
carry on).  The host waits for the device after each call and reads the
clock; the window ends at the first episode's end after ``seconds`` by
which every chunk to be compared or traced has run, so that the rate is
always taken over whole episodes, every phase in its share.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from portbench import guard, ranks as ranks_, roofline, trace

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
CACHE = os.path.join(ROOT, ".cache")
STATE_KEYS = ("pos", "vel", "collisions")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(path: str = "") -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: str = ROOT, repo: str = REPO):
    """Everything one cell names: (its entry, the configuration, the mix,
    its end-to-end and its per-layer metrics, each with its reader)."""
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(repo, entry["file"]), encoding="utf-8") as f:
        cfg = json.load(f)
    with open(os.path.join(root, "traffic", f"{w['traffic']}.json"), encoding="utf-8") as f:
        mix = json.load(f)

    def readers(metrics):
        return [(m, load_module(os.path.join(root, "metrics", f"{m['name']}.py"),
                                f"portbench_metric_{m['name']}"))
                for m in metrics if workload in m.get("workloads", [workload])]

    return w, cfg, mix, readers(bench["end_to_end"]), readers(bench["per_layer"])


def chunk_plan(mix: dict, seed: int, trace_on: bool):
    """(chunks an episode, the chunk indices whose output is compared
    with the reference, those that are traced).  The compared set is the
    mix's fixed indices and ``compare_drawn`` more drawn from the seed."""
    per = mix["episode_steps"] // mix["chunk_steps"]
    fixed = sorted({i % per for i in mix["compare_fixed"]})
    rest = [i for i in range(per) if i not in fixed]
    rng = np.random.default_rng([seed % (1 << 63), 1])
    drawn = rng.choice(rest, size=min(mix["compare_drawn"], len(rest)), replace=False)
    traced = sorted(set(mix["traced_chunks"])) if trace_on else []
    return per, sorted(set(fixed) | {int(i) for i in drawn}), traced


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _readings(system, dev) -> tuple:
    """(the device's memory peak, the system's ``counters()`` or None)."""
    counters = getattr(system, "counters", None)
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
            counters and counters())


class Keeper:
    """Host copies of the states at chosen chunk boundaries, into pinned
    buffers made in set-up (on the CPU, plain copies)."""

    def __init__(self, n: int, slots: int, device):
        cuda = torch.device(device).type == "cuda"
        self.free = [{k: torch.empty((3, n) if k != "collisions" else (n,),
                                     dtype=torch.int32 if k == "collisions" else torch.float32,
                                     pin_memory=cuda) for k in STATE_KEYS}
                     for _ in range(slots)]

    def take(self, state) -> dict:
        buf = self.free.pop() if self.free else {
            k: torch.empty_like(getattr(state, k), device="cpu") for k in STATE_KEYS}
        for k in STATE_KEYS:
            buf[k].copy_(getattr(state, k), non_blocking=True)
        return buf


def lanes_off(out: dict, ref: dict, n_real: int):
    """(real lanes whose position, velocity or collision count differs
    from the reference's in any bit, the widest position gap)."""
    bad = torch.zeros(n_real, dtype=torch.bool, device=ref["pos"].device)
    gap = 0.0
    for k in ("pos", "vel"):
        a = out[k][:, :n_real].to(ref[k].device).float()
        b = ref[k][:, :n_real].float()
        bad |= ((a != b) & ~(torch.isnan(a) & torch.isnan(b))).any(0)
        if k == "pos":
            gap = float(torch.nan_to_num((a - b).abs(), nan=float("inf")).max())
    bad |= out["collisions"][:n_real].to(ref["collisions"].device) != ref["collisions"][:n_real]
    return int(bad.sum()), gap


def judge(out: dict, ref: dict, start_collisions, n_real: int, dt: float, tol: float):
    """The numbers ``correct`` is decided on, for one call's output against
    the reference's from the same input.  A lane is *in contact* where its
    collision count moved during the call on either side; its *gap* is the
    larger of its widest position difference and its widest velocity
    difference times ``dt`` (NaN on one side only: infinite).  Returns
    (the widest gap of the lanes in contact on neither side, the lanes in
    contact whose gap exceeds ``tol`` or whose counts differ, the lanes in
    contact)."""
    dev = ref["pos"].device
    gap = torch.zeros(n_real, dtype=torch.float64, device=dev)
    for k, scale in (("pos", 1.0), ("vel", dt)):
        a = out[k][:, :n_real].to(dev).double()
        b = ref[k][:, :n_real].double()
        d = torch.nan_to_num((a - b).abs(), nan=float("inf"))
        d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
        gap = torch.maximum(gap, d.amax(0) * scale)
    c0 = start_collisions[:n_real].to(dev)
    c_out = out["collisions"][:n_real].to(dev)
    c_ref = ref["collisions"][:n_real].to(dev)
    contact = (c_out != c0) | (c_ref != c0)
    free_gap = float(gap[~contact].max()) if bool((~contact).any()) else 0.0
    far = contact & ((gap > tol) | (c_out != c_ref))
    return free_gap, int(far.sum()), int(contact.sum())


def _inputs(cfg: dict):
    return load_module(os.path.join(ROOT, "inputs", f"{cfg['inputs']}.py"),
                       f"portbench_inputs_{cfg['inputs']}")


def build_scene(cfg: dict) -> dict:
    return _inputs(cfg).make_scene(cfg)


def build_spawn(cfg: dict, seed: int, device):
    """The spawn of ``seed``: (host arrays with ``n_real``, device tensors)."""
    sp = _inputs(cfg).make_spawn(cfg, seed)
    dev = torch.device(device)
    t = {k: torch.from_numpy(sp[k]).to(dev) for k in ("pos", "vel", "radius", "restitution")}
    t["collisions"] = torch.zeros(sp["pos"].shape[1], dtype=torch.int32, device=dev)
    return sp, t


def build_inputs(cfg: dict, seed: int, device):
    """The scene and the spawn (host arrays and device tensors)."""
    return (build_scene(cfg),) + build_spawn(cfg, seed, device)


def load_system(cfg: dict, sc: dict, device, group=None):
    """The configuration's system; on more than one rank ``build`` is
    given the group (its ``rank`` and ``world``)."""
    mod = load_module(os.path.join(ROOT, "systems", f"{cfg['system']}.py"),
                      f"portbench_system_{cfg['system']}")
    if group is None or group.world == 1:
        return mod.build(sc, cfg, device)
    return mod.build(sc, cfg, device, group)


def profiler_warm(dev):
    """A profiler session a call (``tracer()``), after the profiler's own
    first-use costs are paid."""
    from torch.profiler import ProfilerActivity, profile

    # one session a traced chunk: its records are read at its end
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts):
        torch.ones(8, device=dev).sum().item()
    return lambda: profile(activities=acts)


def set_up(cfg: dict, mix: dict, seed: int, trace_on: bool, dev, ranks,
           lap=lambda name: None, wrap=None):
    """The set-up every rank makes, in this order: the inputs, its share
    of the system, the warm calls, the profiler.  ``lap(name)`` marks
    each stage's end on rank 0's clock.  Returns (the scene, the spawn's
    host arrays and device tensors, the system, its spawn state, the
    tracer: a profiler session a call, or None untraced)."""
    sc, sp, spawn_t = build_inputs(cfg, seed, dev)
    lap("inputs")
    system = load_system(cfg, sc, dev, ranks)
    if wrap is not None:
        system = wrap(system)
    spawn_state = system.state(**spawn_t)
    lap("program")
    for _ in range(mix["warm_chunks"]):
        system.run(spawn_state, mix["chunk_steps"], with_stats=trace_on)
    _sync(dev)
    lap("warm")
    tracer = profiler_warm(dev) if trace_on else None
    return sc, sp, spawn_t, system, spawn_state, tracer


def load_reference(cfg: dict, sc: dict, device, dtype=torch.float32):
    mod = load_module(os.path.join(ROOT, "reference", f"{cfg['reference']}.py"),
                      f"portbench_reference_{cfg['reference']}")
    return mod.Reference(sc, cfg, device, dtype=dtype,
                         cache_dir=os.path.join(CACHE, "reference_bake"))


def run_cell(spec, seed: int, seconds: float, trace_on: bool, *, t0: float,
             device="cuda", wrap=None, ranks=None) -> dict:
    """One run: returns the result line (a dict) and prints its context
    and checks on stderr.  ``wrap(system)`` (tests) puts another system in
    the program's place (rank 0's).  ``ranks``: rank 0 of a group
    (``ranks.join``), whose workers run ``follow``; by default one
    rank."""
    w, cfg, mix, e2e, layers = spec
    ranks = ranks or ranks_.Solo()
    dev = torch.device(device)
    chunk = mix["chunk_steps"]
    per, compare, traced = chunk_plan(mix, seed, trace_on)
    log(f"[portbench] {w['name']} seed {seed}: chunks of {chunk} steps, "
        f"{per} an episode; compared {compare}, traced {traced}")

    # ---------------------------------------------------------- set-up
    laps = [("imports", time.perf_counter())]
    sc, sp, spawn_t, system, spawn_state, tracer = set_up(
        cfg, mix, seed, trace_on, dev, ranks,
        lambda name: laps.append((name, time.perf_counter())), wrap)
    n_real = sp["n_real"]
    keeper = Keeper(spawn_t["pos"].shape[1], 2 * (len(compare) + len(traced)) + 2, dev)
    laps.append(("profiler, buffers", time.perf_counter()))
    if ranks.world > 1:  # every rank has finished its warm call
        ranks.join(ranks_.SETUP_WAIT_S)
        laps.append(("the other ranks", time.perf_counter()))
    setup_s = laps[-1][1] - t0
    marks = [t0] + [t for _, t in laps]
    log("[portbench] set-up laps: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, _), a, b in zip(laps, marks, marks[1:])))

    # ---------------------------------------------------------- window
    # the inputs and outputs of the calls to compare or trace, kept on the
    # host; a traced call whose session recorded no device time is traced
    # again in the next episode (``pending``)
    want = set(compare) | set(traced)
    kept_in, kept_out, sessions, pending = {}, {}, {}, set(traced)
    overflow, reads0 = [], system.host_reads()
    state, idx, calls, steps = spawn_state, 0, 0, 0
    call_s, episode_s = [], []
    kept_in[0] = keeper.take(ranks.whole(system, state))
    _sync(dev)
    start = last = mark = time.perf_counter()
    while True:
        ranks.run(idx if idx in pending else -1)
        with tracer() if idx in pending else contextlib.nullcontext() as prof:
            out, ovf = system.run(state, chunk, with_stats=trace_on)
            _sync(dev)
        ranks.join()
        now = time.perf_counter()
        call_s.append(now - last)
        calls += 1
        steps += chunk
        if ovf is not None:
            overflow.extend(ovf)
        if prof is not None:
            s = trace.record(prof, chunk)
            if ranks.all(bool(s.device) or dev.type != "cuda"):
                sessions[idx] = s
                pending.discard(idx)
            else:
                log(f"[portbench] chunk {idx}: the profiler recorded no device "
                    "time on some rank; traced again in the next episode")
        if idx in want and idx in kept_in and idx not in kept_out and idx not in pending:
            kept_out[idx] = keeper.take(ranks.whole(system, out))
        idx = (idx + 1) % per
        if idx:
            state = out
        else:  # the reference's reset at the episode's end
            episode_s.append(now - mark)
            mark = now
            state = ranks.reset(system, spawn_state, out)
        if idx in pending or (idx in want and idx not in kept_in):
            kept_in[idx] = keeper.take(ranks.whole(system, state))
        _sync(dev)
        last = time.perf_counter()
        if idx == 0 and now - start >= seconds and want <= kept_out.keys():
            break
    window_s = now - start
    peaks, rank_counters, rank_sessions = ranks.report(*_readings(system, dev), sessions)
    host_reads = system.host_reads() - reads0
    if ranks.world > 1:
        log(f"[portbench] peak device memory by rank {peaks} B")
    peak = max(peaks)
    log(f"[portbench] window: {calls} calls, {steps} steps in {window_s:.6f} s; "
        f"peak device memory {peak} B; host reads {host_reads}; whole episodes "
        f"{[round(e, 4) for e in episode_s]} s; calls {min(call_s):.4f} / "
        f"{statistics.median(call_s):.4f} / {max(call_s):.4f} s (least / median / most)")
    slow = [(i, round(sum(call_s[:i]), 3), round(c, 4)) for i, c in enumerate(call_s)
            if c > 1.5 * statistics.median(call_s)]
    if slow:
        log(f"[portbench] calls over 1.5x the median (index, s into the window, s): {slow}")

    bad_modules = guard.loaded_forbidden()
    if bad_modules:
        raise SystemExit(f"[portbench] loaded in this process: {bad_modules}")

    ctx = SimpleNamespace(
        cfg=cfg, mix=mix, workload=w["name"], device=dev, n_real=n_real,
        steps=steps, seconds=window_s, setup_s=setup_s, host_reads=host_reads,
        overflow=overflow,
        sessions=[sessions[i] for i in sorted(sessions)], system=system,
        rank_sessions=[[r[i] for i in sorted(r)] for r in rank_sessions],
        rank_counters=rank_counters,
        kept_out=kept_out, values={}, log=log,
        state_of=lambda h: system.state(
            **{k: h[k].to(dev) for k in STATE_KEYS}, radius=spawn_t["radius"],
            restitution=spawn_t["restitution"]))
    if trace_on:
        for _, reader in layers:
            if hasattr(reader, "probe"):
                reader.probe(ctx)
    ctx.system = None
    system.close()
    del system, state, out, spawn_state
    ranks.stop()

    # ------------------------------------------------ the reference's check
    t_ref = time.perf_counter()
    ref = load_reference(cfg, sc, dev)
    log(f"[portbench] reference built in {time.perf_counter() - t_ref:.3f} s")
    checks, failed = {}, 0
    lim = cfg["limits"]
    tol = lim["gap_tolerance"]
    dt = float(cfg["sim"]["dt"])
    for i in sorted(kept_out):
        src = dict(kept_in[i], radius=spawn_t["radius"], restitution=spawn_t["restitution"])
        got = ref.run(src, chunk, count_work=i in sessions)
        if i in sessions:
            sessions[i].work.extend(ref.work)
        free_gap, far, contact = judge(kept_out[i], got, kept_in[i]["collisions"],
                                         n_real, dt, tol)
        off, gap = lanes_off(kept_out[i], got, n_real)
        far_pct = 100.0 * far / contact if contact else 0.0
        checks[f"free_gap.chunk{i}"] = {"value": free_gap, "limit": tol}
        checks[f"contact_far_pct.chunk{i}"] = {"value": far_pct, "limit": lim["contact_far_pct"]}
        log(f"[portbench] chunk {i} (steps {i * chunk}-{(i + 1) * chunk}): widest gap of "
            f"the lanes in no contact {free_gap:.6g} (limit {tol}); {far} of {contact} "
            f"lanes in contact beyond it, {far_pct:.4f}% (limit {lim['contact_far_pct']}%); "
            f"{off} of {n_real} lanes differ from the reference in some bit, widest "
            f"position gap {gap:.6g}")
        failed += free_gap > tol or far_pct > lim["contact_far_pct"]
    checks["chunks_compared"] = {"value": len(kept_out), "limit": len(compare)}
    log(f"[portbench] reference took {time.perf_counter() - t_ref:.3f} s")
    correct = failed == 0 and checks["chunks_compared"]["value"] >= len(compare)

    # ------------------------------------------------------------- line
    metrics = {}
    for m, reader in layers if trace_on else e2e:
        v = reader.read(ctx)
        if v is None:
            log(f"[portbench] {m['name']}: nothing to read")
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": calls, "failed": int(failed),
            "metrics": metrics, "device": device_info(dev, peaks, w["chips"])}
    if trace_on:
        # each device's mean over the ranks: busy and traced seconds, and
        # the breakdown's seconds
        k = len(ctx.rank_sessions)
        bw = [[trace.busy_window_us(s) for s in r] for r in ctx.rank_sessions]
        if k > 1:
            log("[portbench] idle share of the traced chunks by rank: " + ", ".join(
                f"{roofline.idle_pct(sum(b for b, _ in x), sum(v for _, v in x))}"
                for x in bw))
        every = [s for r in ctx.rank_sessions for s in r]
        line["device"]["busy_s"] = sum(b for x in bw for b, _ in x) / 1e6 / k
        line["device"]["window_s"] = sum(v for x in bw for _, v in x) / 1e6 / k
        line["breakdown"] = {"device_ops": trace.top_device_ops(every, devices=k),
                             "idle_gaps": trace.idle_gaps(every, devices=k)}
    line["checks"] = checks
    return line


def device_info(dev, peaks: list, chips: int) -> dict:
    """The line's ``device``: the fullest device's peak, and with more
    than one rank each rank's beside it."""
    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": int(max(peaks))}
    if len(peaks) > 1:
        info["count"] = len(peaks)
        info["memory_peak_bytes_by_rank"] = [int(p) for p in peaks]
    return info


def follow(spec, seed: int, trace_on: bool, device, ranks) -> None:
    """A worker rank's part of a run (``workers.worker``): the set-up that
    rank 0 makes (``set_up``), then what rank 0 orders until it orders the
    end (``ranks.Group.orders``)."""
    _, cfg, mix, _, _ = spec
    dev = torch.device(device)
    _, _, _, system, spawn_state, tracer = set_up(cfg, mix, seed, trace_on, dev, ranks)
    ranks.join()
    state, sessions = spawn_state, {}
    for order, arg in ranks.orders():
        if order == ranks_.RUN:
            with tracer() if arg >= 0 else contextlib.nullcontext() as prof:
                state, _ = system.run(state, mix["chunk_steps"], with_stats=trace_on)
                _sync(dev)
            ranks.join()
            if prof is not None:
                s = trace.record(prof, mix["chunk_steps"])
                if ranks.all(bool(s.device) or dev.type != "cuda"):
                    sessions[arg] = s
        elif order == ranks_.WHOLE:
            ranks.whole(system, state)
        elif order == ranks_.RESET:
            state = ranks.reset(system, spawn_state, state)
        elif order == ranks_.REPORT:
            ranks.report(*_readings(system, dev), sessions)
    system.close()
