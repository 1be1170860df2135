"""The domain-decomposed box on B3's route and its episode runner
(``parallel/domain.py``), against the benchmark's slab reference
(``portbench/reference/domain.py``), on the CPU (gloo ranks of one
thread each; about 4,096 particles in a box of two slabs):

  * the slab reference with one slab is ``reference/p2p.py`` bit for bit
    (a step from a state in id order), and with two slabs finds the same
    contacts as the undivided box and agrees with it to within rounding;
  * ``make_domain_step`` on B3's cells route gives its former route's
    bits (the sorted-segment pass, ``ops/p2p_sorted.py::
    p2p_collide_sorted``) over 50 steps with migration;
  * ``DomainEpisodeRunner`` gives the slab reference's bits call by
    call, ``gather_whole`` returns the state in spawn order after
    migrations, ``carry_collisions`` carries the counters by id;
  * the cell through ``harness.run_cell`` on two ranks
    (``portbench/tests/ranks_run.py``) reads ``correct`` true, and false
    with one rank's answer altered; the bfloat16 control is judged not
    correct.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as p2ps
from particlesystemhybridcollisiondetection_tpu_torch.parallel import domain as dom
from particlesystemhybridcollisiondetection_tpu_torch.parallel.dryrun import run_ranks
from portbench import harness

torch.set_num_threads(1)

REPO = harness.REPO
CELL = "box5_domain_4chip.pile"
SEED = 2**31 + 11


def small_cfg(shards: int = 2, n: int = 4096, pile_step: int = 30) -> dict:
    """The cell's configuration at a small size: a 16 x 16 x 16 box a slab
    (about config 5's fill at ``n`` = 2,048 a slab), capacities by its
    rules."""
    with open(os.path.join(REPO, "portbench", "configs", "box5_domain_4chip.json"),
              encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["scene"]["box_hi"] = [16.0 * shards, 16.0, 16.0]
    cfg["particles"].update(n=n, pile_step=pile_step)
    cap = int(np.ceil(n / shards * 2 / 128)) * 128
    cfg["domain"] = {"n_shards": shards, "shard_capacity": cap,
                     "halo_capacity": cap // 8, "migrate_capacity": cap // 8}
    return cfg


def _inputs():
    return harness.load_module(os.path.join(harness.ROOT, "inputs", "box_hetero.py"),
                               "portbench_inputs_box_hetero")


def reference(cfg: dict, dtype=torch.float32):
    return harness.load_reference(cfg, _inputs().make_scene(cfg), "cpu", dtype=dtype)


def drop(cfg: dict, seed: int = 3, speed: float = 1.0) -> dict:
    d = {k: torch.from_numpy(v) for k, v in _inputs().drop(cfg, seed).items()}
    d["vel"] = d["vel"] * speed
    d["collisions"] = torch.zeros(cfg["particles"]["n"], dtype=torch.int32)
    return d


def _p2p_reference(cfg: dict):
    return harness.load_module(os.path.join(harness.ROOT, "reference", "p2p.py"),
                               "portbench_reference_p2p").Reference(
        _inputs().make_scene(cfg), cfg, "cpu")


# ---- the slab reference ------------------------------------------------------

def test_slab_reference_with_one_slab_is_the_p2p_reference():
    """One slab: each step starts from the particles in id order, as a
    one-step call of ``reference/p2p.py`` does; positions and velocities
    bit for bit over three steps, the counters with the wall hits beside
    the contacts."""
    cfg = small_cfg(shards=1, n=2048)
    d = drop(cfg)
    got = reference(cfg).run(d, 3)
    p2p = _p2p_reference(cfg)
    want = dict(d)
    for _ in range(3):
        want = p2p.run(want, 1)
    for k in ("pos", "vel"):
        assert torch.equal(got[k], want[k]), k
    extra = got["collisions"] - want["collisions"]
    assert want["collisions"].sum() > 0
    assert ((extra >= 0) & (extra <= 3)).all() and extra.sum() > 0  # wall hits


def test_slab_reference_with_two_slabs_matches_the_whole_box():
    """Two slabs against one, one step from the same state: the same
    contacts on every particle, positions and velocities within rounding
    (the ghosts' contacts accumulate in another order)."""
    d = drop(small_cfg())
    one = reference(dict(small_cfg(), domain=dict(small_cfg(shards=1)["domain"],
                                                  n_shards=1))).run(d, 1)
    two = reference(small_cfg()).run(d, 1)
    assert torch.equal(one["collisions"], two["collisions"])
    assert one["collisions"].sum() > 0
    for k in ("pos", "vel"):
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), rtol=1e-5, atol=1e-5)


# ---- the domain step's route ------------------------------------------------

def _sorted_contacts(self, merged, act, n, tap):
    """The domain step's former route: the sorted-segment pass over the
    merged slots, the own slots' results."""
    out, _ = p2ps.p2p_collide_sorted(dom.rows_state(merged)[0], self.meta, active=act)
    ncon = out.collisions[:n] - dom.rows_state(merged)[0].collisions[:n]
    return out.pos[:, :n], out.vel[:, :n], ncon, torch.zeros((), dtype=torch.int32)


def _route_rank(rank, world, out_path, route):
    from test_torch_domain import STATS_CFG, _parity_inputs, _run_domain, _stats_dcfg

    if route == "sorted":
        dom._Body._window_contacts = _sorted_contacts
    dcfg = _stats_dcfg(world)
    _, _, stats, kept = _run_domain(dcfg, STATS_CFG, _parity_inputs()[:4], 50,
                                    keep=(1, 25, 50))
    if rank == 0:
        np.savez(out_path, stats=stats,
                 **{f"{f}{k}": kept[k][f] for k in kept for f in kept[k]})


def test_domain_step_window_route_equals_sorted_route(tmp_path):
    """``make_domain_step`` on B3's cells route (its plain version here)
    against the same step with the former sorted-segment pass in its
    place, two ranks, 50 steps of the parity scenario (8x the
    velocities, so particles migrate): every field of every slot, bit
    for bit, after steps 1, 25 and 50."""
    got = {}
    for route in ("window", "sorted"):
        path = tmp_path / f"{route}.npz"
        run_ranks(_route_rank, 2, str(path), route, device_type="cpu")
        got[route] = dict(np.load(path))
    assert got["window"].keys() == got["sorted"].keys()
    for k, v in got["sorted"].items():
        np.testing.assert_array_equal(got["window"][k], v, err_msg=k)
    live = {k: np.abs(got["window"][f"pos{k}"][0]) < 1e37 for k in (1, 25, 50)}
    assert live[50].sum() == 512 and got["window"]["collisions50"].sum() > 0
    # particles migrated: rank 0's share of the slots changed
    assert len({int(v[:384].sum()) for v in live.values()}) > 1


# ---- the runner against the slab reference ---------------------------------

def _runner_rank(rank, world, out_path, cfg_json):
    cfg = json.loads(cfg_json)
    mod = harness.load_module(os.path.join(harness.ROOT, "systems", "domain_runner.py"),
                              "portbench_system_domain_runner")
    system = mod.build(_inputs().make_scene(cfg), cfg, "cpu",
                       SimpleNamespace(rank=rank, world=world))
    d = drop(cfg, speed=6.0)
    spawn = system.state(**d)
    out, s = {}, spawn
    for call in range(3):
        w_in = system.whole(s)
        s, over = system.run(s, 10, with_stats=True)
        w_out = system.whole(s)
        if rank == 0:
            for tag, w in (("in", w_in), ("out", w_out)):
                for k in ("pos", "vel", "collisions"):
                    out[f"{tag}{call}_{k}"] = getattr(w, k).numpy()
            out[f"over{call}"] = np.asarray(over)
        out[f"owner{call}"] = s.ids[dom._active(dom.state_rows(s.state))].numpy()
    back = system.whole(system.reset(spawn, s))
    c = system.counters()
    if rank == 0:
        out.update(reset_pos=back.pos.numpy(), reset_collisions=back.collisions.numpy(),
                   drops=np.asarray(c["drops"]), ghosts=np.asarray(
                       [x[3]["ghosts"] for x in c["calls"]]),
                   migrants=np.asarray([x[3]["migrants"] for x in c["calls"]]))
    np.savez(f"{out_path}.{rank}.npz", **out)
    system.close()


def test_runner_on_two_ranks_gives_the_slab_reference_bits(tmp_path):
    """``DomainEpisodeRunner`` on two gloo ranks, three calls of 10 steps
    from a fast drop (6x the velocities): each call's output, gathered in
    spawn order, equals the slab reference's from the call's input in
    every bit; particles changed owner; the reset returns the spawn with
    each particle's counter; nothing was dropped; ghosts were received."""
    cfg = small_cfg()
    path = str(tmp_path / "run")
    run_ranks(_runner_rank, 2, path, json.dumps(cfg), device_type="cpu")
    got = dict(np.load(f"{path}.0.npz"))
    ref = reference(cfg)
    d = drop(cfg, speed=6.0)
    for call in range(3):
        src = {k: torch.from_numpy(got[f"in{call}_{k}"]) for k in ("pos", "vel", "collisions")}
        want = ref.run(dict(src, radius=d["radius"], restitution=d["restitution"]), 10)
        for k in ("pos", "vel", "collisions"):
            np.testing.assert_array_equal(got[f"out{call}_{k}"], want[k].numpy(),
                                          err_msg=f"call {call} {k}")
        assert got[f"over{call}"].shape == (10,)
    ranks = [dict(np.load(f"{path}.{r}.npz")) for r in range(2)]
    assert got["out2_collisions"].sum() > 0
    ids = [np.sort(np.concatenate([r[f"owner{c}"] for r in ranks])) for c in range(3)]
    assert all(np.array_equal(i, np.arange(cfg["particles"]["n"])) for i in ids)
    moved = set(ranks[0]["owner0"]) ^ set(ranks[0]["owner2"])
    assert moved, "no particle changed owner"
    np.testing.assert_array_equal(got["reset_pos"], d["pos"].numpy())
    np.testing.assert_array_equal(got["reset_collisions"], got["out2_collisions"])
    assert got["drops"].tolist() == [0, 0, 0]
    assert got["ghosts"].sum() > 0 and got["migrants"].sum() > 0


# ---- the cell through the harness on two ranks -----------------------------

FAULTY = '''"""The domain adapter with one rank's answer altered from its second
window call on (a test's planted fault): its particles 0.25 higher."""
import os

import torch

from portbench import harness

base = harness.load_module(os.path.join(harness.ROOT, "systems", "domain_runner.py"),
                           "portbench_system_domain_runner")


class System(base.System):
    calls = 0

    def run(self, state, steps, with_stats=False):
        out, over = super().run(state, steps, with_stats)
        self.calls += 1
        if self.rank == 1 and self.calls >= 3:
            pos = out.state.pos.clone()
            pos[1] = torch.where(pos[0].abs() < 1e37, pos[1] + 0.25, pos[1])
            out = out._replace(state=out.state._replace(pos=pos))
        return out, over


def build(scene, cfg, device, group=None):
    return System(scene, cfg, device, group)
'''


def domain_bench(root: str, fault: bool = False) -> None:
    """A small benchmark of the one cell on two ranks: its configuration
    at the small size (2,048 particles), 30-step episodes of 10-step calls
    from a 20-step pile, its end-to-end metrics and new readers."""
    for d in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    cfg = small_cfg(n=2048, pile_step=20)
    if fault:
        path = os.path.join(root, "faulty_domain.py")
        with open(path, "w", encoding="utf-8") as f:
            f.write(FAULTY)
        cfg["system"] = path[:-3]
    with open(os.path.join(root, "configs", "box5_domain_4chip.json"), "w",
              encoding="utf-8") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "pile.json"), "w", encoding="utf-8") as f:
        json.dump({"name": "pile", "episode_steps": 30, "chunk_steps": 10, "warm_chunks": 1,
                   "compare_fixed": [0, 2], "compare_drawn": 0, "traced_chunks": [1]}, f)
    bench = harness.load_bench()
    names = ("particle_steps_per_s", "setup_s", "domain.halo_ms_per_step",
             "domain.migrate_ms_per_step", "domain.ghost_lanes_per_step",
             "domain.exchange_bytes_per_step")
    for m in names:
        with open(os.path.join(harness.ROOT, "metrics", f"{m}.py"), encoding="utf-8") as f:
            src = f.read()
        with open(os.path.join(root, "metrics", f"{m}.py"), "w", encoding="utf-8") as f:
            f.write(src)
    small = {
        "configs": [{"name": "box5_domain_4chip",
                     "file": os.path.join(root, "configs", "box5_domain_4chip.json")}],
        "workloads": [{"name": CELL, "config": "box5_domain_4chip", "traffic": "pile",
                       "chips": 2}],
        "end_to_end": [m for m in bench["end_to_end"] if m["name"] in names],
        "per_layer": [dict(m, workloads=[CELL]) for m in bench["per_layer"]
                      if m["name"] in names]}
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(small, f)


def run_cell_on_ranks(root: str, trace_on: bool):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(harness.ROOT, "tests", "ranks_run.py"),
                          root, CELL, str(SEED), "0", str(int(trace_on))],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("fault", [False, True])
def test_domain_cell_on_two_ranks_through_the_harness(tmp_path, fault):
    """The cell on two gloo ranks: sound, ``correct`` true with no lane
    off the reference and the new readers' numbers in the traced line
    (the ghosts, the bytes sent: a ghost and a migrant buffer to the one
    neighbour, 10 float32 rows a slot); with rank 1's answer altered,
    ``correct`` false."""
    root = str(tmp_path)
    domain_bench(root, fault)
    line, err = run_cell_on_ranks(root, trace_on=not fault)
    assert line["correct"] is not fault, line["checks"]
    assert line["device"]["count"] == 2
    if fault:
        assert line["failed"] >= 1
        return
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k != "chunks_compared")
    assert "0 of 2048 lanes differ from the reference in some bit" in err
    m = {k: v["value"] for k, v in line["metrics"].items()}
    cap = small_cfg(n=2048)["domain"]["halo_capacity"]
    assert m["domain.exchange_bytes_per_step"] == 2 * 10 * 4 * cap
    assert m["domain.ghost_lanes_per_step"] > 0
    assert m["domain.halo_ms_per_step"] > 0 and m["domain.migrate_ms_per_step"] > 0


def test_bfloat16_control_is_not_correct():
    """The slab reference computed in bfloat16 in the program's place, one
    10-step call from a 30-step pile, judged as a run judges: beyond the
    limits of ``correct``; the float32 reference against itself reads 0."""
    cfg = small_cfg()
    pile = reference(cfg).run(drop(cfg), 30)
    src = dict(pile, collisions=pile["collisions"].clone())
    good = reference(cfg).run(src, 10)
    low = reference(cfg, torch.bfloat16).run(src, 10)
    lim = cfg["limits"]
    n = cfg["particles"]["n"]
    free_gap, far, contact = harness.judge(low, good, src["collisions"], n,
                                           cfg["sim"]["dt"], lim["gap_tolerance"])
    assert contact > 0
    assert free_gap > lim["gap_tolerance"] or 100.0 * far / contact > lim["contact_far_pct"]
    same = harness.judge(reference(cfg).run(src, 10), good, src["collisions"], n,
                         cfg["sim"]["dt"], lim["gap_tolerance"])
    assert same[:2] == (0.0, 0)
