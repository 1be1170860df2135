"""The schedule of B1's worklist entry point (rescue phase 2), held on the
CPU through its plain version ``window_kernel.worklist_schedule``: the
scan of the listed lanes' bounds by chunk, the shares of (lane, k) items
over the collide kernel's blocks, each share's owners by the kernel's
two-level search, and the edge slots of lanes across shares.  The
items are expanded as the collide kernel walks them (batches of staged
entries, each clipped to the share) and must cover every (listed lane,
k < bound) exactly once, finish every listed lane exactly once and touch
no unlisted lane.  On the card, the kernels against the plain version on
lists of random lanes, bit for bit."""

import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk


def _inputs(seed: int, n: int, listed: str, k_static: int):
    """count i32[n] (zeros and counts above ``k_static`` among them) and a
    list of ``listed`` lanes: "none", "one", "all" or a random third."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, k_static + 20, n).astype(np.int32)
    count[rng.random(n) < 0.2] = 0
    take = {"none": np.zeros(n, bool), "one": np.arange(n) == rng.integers(n),
            "all": np.ones(n, bool), "some": rng.random(n) < 0.3}[listed]
    lanes, n_lanes = twk.compact_lanes(torch.from_numpy(take))
    return torch.from_numpy(count), lanes, n_lanes, take


def _owner_two_level(x, off, bsum, m, scan_blocks):
    """The collide kernel's search for the entry owning item ``x``: the
    last chunk whose base is <= x (binary search), then within the chunk
    rounds of 32 probes (a warp), the last probe at or below x - base
    narrowing the range to one step."""
    chunk = -(-m // scan_blocks)
    base = np.concatenate([[0], np.cumsum(bsum)])
    lo, hi = 0, (m - 1) // chunk
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if base[mid] <= x else (lo, mid - 1)
    rx = x - base[lo]
    a, z = lo * chunk, min(m, lo * chunk + chunk)
    while z - a > 1:
        step = -(-(z - a) // 32)
        below = [a + w * step < z and off[a + w * step] <= rx for w in range(32)]
        assert below == sorted(below, reverse=True)  # a prefix of the warp
        a += (sum(below) - 1) * step
        z = min(z, a + step)
    return a


def _walk(sched, m):
    """The collide kernel's walk of ``sched``: (entry, k) of every
    candidate evaluated, the entries each block finishes outright, and
    each straddling entry's parts by slot."""
    units, bound, first = (x.numpy() for x in (sched.units, sched.bound, sched.first))
    edges, owners, slot = sched.edges.numpy(), sched.owners.numpy(), sched.slot.numpy()
    evaluated, finished, parts = [], [], {}
    for b in range(len(edges) - 1):
        s_b, e_b = edges[b], edges[b + 1]
        if s_b == e_b:
            assert tuple(owners[b]) == (-1, -1)
            continue
        o_first, o_last = owners[b]
        for jb in range(o_first, o_last + 1, twk.WORKLIST_BATCH):
            for j in range(jb, min(jb + twk.WORKLIST_BATCH, o_last + 1)):
                klo = max(first[j], s_b) - first[j]
                khi = min(first[j] + units[j], e_b) - first[j]
                assert khi > klo, (b, j)
                evaluated += [(j, k) for k in range(klo, min(khi, bound[j]))]
                if klo == 0 and khi == units[j]:
                    assert slot[j] == -1
                    finished.append(j)
                else:
                    parts.setdefault((slot[j], j), []).append(khi - klo)
    return evaluated, finished, parts


CASES = [(seed, n, listed, k_static, blocks, scan_blocks)
         for seed, n, listed in ((0, 1, "one"), (1, 64, "none"), (2, 64, "one"),
                                 (3, 300, "all"), (4, 1000, "some"), (5, 3000, "all"),
                                 (6, 5000, "some"))
         for k_static, blocks, scan_blocks in ((24, 7, 5), (40, 396, 256), (7, 1, 1))]


@pytest.mark.parametrize("seed,n,listed,k_static,blocks,scan_blocks", CASES)
def test_schedule_covers_every_item_once(seed, n, listed, k_static, blocks, scan_blocks):
    """Every (listed lane, k < min(count, k_static)) is evaluated exactly
    once, every listed lane is finished exactly once (outright, or by the
    block that completes its edge slot), no unlisted lane is touched, and
    the shares are even to one item."""
    count, lanes, n_lanes, take = _inputs(seed, n, listed, k_static)
    sched = twk.worklist_schedule(count, lanes, n_lanes, k_static=k_static,
                                  blocks=blocks, scan_blocks=scan_blocks)
    m = int(n_lanes)
    assert m == int(take.sum())
    evaluated, finished, parts = _walk(sched, m)

    bound = np.clip(count.numpy()[lanes[:m].numpy()], 0, k_static)
    want = [(j, k) for j in range(m) for k in range(bound[j])]
    assert sorted(evaluated) == want
    assert len(set(evaluated)) == len(evaluated)
    # a straddling entry's parts add up to its units: its slot's count is
    # completed exactly once; one entry a slot
    units = sched.units.numpy()
    for (slot, j), p in parts.items():
        assert len(p) >= 2 and sum(p) == units[j]
    slots = [s for s, _ in parts]
    assert len(set(slots)) == len(slots)
    done = sorted(finished + [j for _, j in parts])
    assert done == list(range(m))
    # lanes reached are the listed ones
    reached = set(lanes[:m].numpy()[[j for j, _ in evaluated]].tolist()) if evaluated else set()
    assert reached <= set(np.nonzero(take)[0].tolist())
    sizes = np.diff(sched.edges.numpy())
    assert sizes.sum() == units.sum() and sizes.max(initial=0) - sizes.min() <= 1


@pytest.mark.parametrize("seed,n,listed,k_static,blocks,scan_blocks", CASES)
def test_schedule_scan_and_owner_search(seed, n, listed, k_static, blocks, scan_blocks):
    """The scan kernel's outputs (each entry's offset within its chunk of
    ceil(m / scan_blocks) entries, each chunk's sum) recomputed chunk by
    chunk; each share's first and last owner by the collide kernel's
    two-level search (chunks of up to 3,000 entries: several rounds of
    probes); each straddling entry's slot is the share of its first item,
    whose last owner it is."""
    count, lanes, n_lanes, _ = _inputs(seed, n, listed, k_static)
    sched = twk.worklist_schedule(count, lanes, n_lanes, k_static=k_static,
                                  blocks=blocks, scan_blocks=scan_blocks)
    m = int(n_lanes)
    units, off, bsum = sched.units.numpy(), sched.off.numpy(), sched.bsum.numpy()
    assert (units >= 1).all() and (units == np.maximum(sched.bound.numpy(), 1)).all()
    chunk = max(1, -(-m // scan_blocks))
    for c in range(scan_blocks):
        u = units[c * chunk:(c + 1) * chunk]
        assert bsum[c] == u.sum()
        np.testing.assert_array_equal(off[c * chunk:(c + 1) * chunk], np.cumsum(u) - u)
    edges, owners = sched.edges.numpy(), sched.owners.numpy()
    for b in range(blocks):
        if edges[b] < edges[b + 1]:
            assert owners[b, 0] == _owner_two_level(edges[b], off, bsum, m, scan_blocks)
            assert owners[b, 1] == _owner_two_level(edges[b + 1] - 1, off, bsum, m,
                                                    scan_blocks)
    first, slot = sched.first.numpy(), sched.slot.numpy()
    for j in np.nonzero(slot >= 0)[0]:
        s = slot[j]
        assert edges[s] <= first[j] < edges[s + 1] and owners[s, 1] == j
        assert first[j] + units[j] > edges[s + 1]


def _random_scene(seed: int, n: int, n_tri: int):
    """A pair table of random triangles in the unit box and ``n`` sorted
    lanes moving through it, with (start, count) rows that fit a window of
    2048 alone; counts include 0 and values above the k_static used."""
    rng = np.random.default_rng(seed)
    c = rng.random((3, n_tri)).astype(np.float32)
    tri = [c + rng.normal(0, 0.08, (3, n_tri)).astype(np.float32) for _ in range(3)]
    pairs = np.full((9, n_tri + 2048 + 128), 1.0e38, np.float32)
    pairs[:, :n_tri] = np.concatenate(tri, 0)
    pos = rng.random((3, n)).astype(np.float32)
    vel = rng.normal(0, 4.0, (3, n)).astype(np.float32)
    count = rng.integers(0, 90, n).astype(np.int32)
    count[rng.random(n) < 0.15] = 0
    start = rng.integers(0, n_tri - 90, n).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    state = (t(pos), t(vel), torch.full((n,), 0.03), torch.full((n,), 0.6))
    return state, t(start), t(count), twk.WindowTables(t(pairs), torch.zeros((2, 1),
                                                                            dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("listed", ["none", "one", "all", "some"])
def test_worklist_kernel_matches_plain_on_card(listed):
    """On the card: the worklist kernels write every listed lane with the
    plain version's bits and leave every other lane as it was, on random
    lists (none, one, all and a third of 8,192 lanes; lanes with no
    candidate and with more than k_static)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, k_static = 8192, 64
    state, start, count, tables = _random_scene(7, n, 20_000)
    rng = np.random.default_rng(11)
    take = {"none": np.zeros(n, bool), "one": np.arange(n) == 4321,
            "all": np.ones(n, bool), "some": rng.random(n) < 0.3}[listed]
    dev = [x.cuda() for x in state]
    tab = twk.WindowTables(*(x.cuda() for x in tables))
    lanes, n_lanes = twk.compact_lanes(torch.from_numpy(take).cuda())
    kw = dict(w=2048, k_static=k_static, gravity=(0.0, -9.81, 0.0), dt=0.01,
              backoff=0.001)
    outs = []
    for fn in (twk.window_collide_worklist, twk.window_collide_worklist_plain):
        o = [torch.full((3, n), 7.0).cuda(), torch.full((3, n), 7.0).cuda(),
             torch.full((n,), 7, dtype=torch.int32).cuda()]
        fn(*dev, start.cuda(), count.cuda(), lanes, n_lanes, tab, *o, **kw)
        outs.append(o)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if listed in ("all", "some"):
        assert int(outs[0][2][torch.from_numpy(take).cuda()].sum()) > 0
