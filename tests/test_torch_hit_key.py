"""PyTorch port, the window kernel's nearest-hit reduction (B1): a row's
candidates are evaluated by many threads in no order and reduced with an
unsigned 64-bit minimum over the key ``(bits(t2) << 32) | k``.  That
minimum must be what the sequential strict-< fold in candidate order
keeps (the plain version, the TPU kernel): the earliest candidate among
those with the smallest t2, and no winner when every t2 is INF.

  * hypothesis: the key minimum equals the fold on arbitrary candidate
    lists with ties, +0, subnormals and INF;
  * on planned synthetic inputs (dense lanes, empty rows) the key
    minimum over the plain version's per-candidate values reproduces the
    plain version's hit mask and winning candidate;
  * ``row_split`` (blocks per row of a launch) at the main path's shapes.

The CUDA kernel itself runs only on the card (``-m cuda``): there both of
its forms (one block per row; several blocks per row + finishing kernel)
are held against the plain version bit for bit."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

INF = np.float32(np.inf)
# "no hit" key of the reduction (NO_HIT in csrc/window_kernel.cu): above
# every key that pack_hit_keys can give
NO_HIT_KEY = (0x7F800000 << 32) | 0xFFFFFFFF
NO_HIT = np.uint64(NO_HIT_KEY)


def pack_hit_keys(t2: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The window kernel's reduction key of candidate ``k`` with squared
    hit time ``t2`` (float32, never NaN, never negative):
    ``(bits(t2) << 32) | k`` as uint64.  Non-negative floats order as
    their bit patterns, so the unsigned minimum over a lane's keys is the
    lexicographic minimum of (t2, k): what the sequential strict-< fold
    in candidate order keeps."""
    bits = np.ascontiguousarray(t2, dtype=np.float32).view(np.uint32)
    return (bits.astype(np.uint64) << np.uint64(32)) | k.astype(np.uint64)

# squared hit times: exact ties come from the small pool, the rest from
# all non-negative floats (zero, subnormals and infinity included)
_T2 = st.one_of(
    st.sampled_from([0.0, 1e-45, 1e-38, 0.25, 0.5, 1.0, 3.0e38, float("inf")]),
    st.floats(min_value=0.0, max_value=float("inf"), allow_nan=False, width=32),
)


def fold(t2, tri_hit):
    """The sequential fold of csrc/window_kernel.cu's first version and
    of the plain version: (best_t2, best_k or -1, any_hit)."""
    best_t2, best_k, any_hit = INF, -1, False
    for k, (c_t2, hit) in enumerate(zip(t2, tri_hit)):
        c = np.float32(c_t2) if hit else INF
        if c < best_t2:
            best_t2, best_k = c, k
        any_hit = any_hit or bool(hit)
    return best_t2, best_k, any_hit


def key_min(t2, tri_hit):
    """The kernel's reduction: candidates that pass the span check with a
    finite t2 post a key; the unsigned minimum wins."""
    t2 = np.asarray(t2, dtype=np.float32)
    post = np.asarray(tri_hit, dtype=bool) & (t2 < INF)
    keys = pack_hit_keys(t2[post], np.nonzero(post)[0])
    return keys.min() if keys.size else NO_HIT


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_T2, st.booleans()), min_size=0, max_size=40))
def test_key_minimum_equals_sequential_fold(cands):
    t2 = [c[0] for c in cands]
    tri_hit = [c[1] for c in cands]
    best_t2, best_k, any_hit = fold(t2, tri_hit)
    key = key_min(t2, tri_hit)
    # "a key was posted" is the fold's any_hit && best_t2 < INF
    assert (key != NO_HIT) == (any_hit and best_t2 < INF)
    if key != NO_HIT:
        assert int(key & np.uint64(0xFFFFFFFF)) == best_k
        bits = np.array([key >> np.uint64(32)], dtype=np.uint64).astype(np.uint32)
        assert bits.view(np.float32)[0] == best_t2
        assert bits[0] == np.array([best_t2], np.float32).view(np.uint32)[0]
    else:
        assert best_k == -1


def test_key_order_is_float_order_on_the_edge_values():
    vals = np.array([0.0, 1e-45, 1.1754944e-38, 1.0, 3.4028235e38, np.inf], np.float32)
    keys = pack_hit_keys(vals, np.zeros(len(vals), np.int64))
    assert (np.diff(keys.astype(object)) > 0).all()
    # equal t2: the smaller k wins; INF with any k stays below NO_HIT
    same = pack_hit_keys(np.full(3, 0.5, np.float32), np.array([7, 2, 9]))
    assert int(same.min() & np.uint64(0xFFFFFFFF)) == 2
    assert pack_hit_keys(np.array([np.inf], np.float32), np.array([483]))[0] < NO_HIT
    assert NO_HIT_KEY == 0x7F800000FFFFFFFF < 2**63  # fits torch.int64


@pytest.mark.parametrize("n,sms,want", [
    (1_048_576, 132, 1),   # the main launch: 8192 rows
    (8192, 132, 4),        # the rescue chunk: 64 rows on 132 SMs
    (1024, 132, 16),       # one block of particles: capped
    (33_792, 132, 1),      # 264 rows: two blocks per SM already
    (1024, 1, 1),
])
def test_row_split(n, sms, want):
    assert twk.row_split(n, sms) == want


def synthetic_plan(n, w, seed=0, device="cpu"):
    """Planned inputs of the window kernel with the main path's mix: most
    rows without candidates, some lanes dense (up to 400 candidates);
    random small triangles, particles flying through them."""
    rng = np.random.default_rng(seed)
    p = 4096
    centre = rng.uniform(0.0, 10.0, size=(p, 1, 3))
    tris = (centre + rng.normal(scale=0.4, size=(p, 3, 3))).astype(np.float32)
    p_pad = ((p + w) // twk.LANE + 1) * twk.LANE
    pairs = np.full((9, p_pad), 1.0e38, dtype=np.float32)
    pairs[:, :p] = tris.reshape(p, 9).T
    pos = rng.uniform(0.0, 10.0, size=(3, n)).astype(np.float32)
    vel = (rng.normal(size=(3, n)) * 60.0).astype(np.float32)
    vel[:, 5] = 0.0  # a lane at rest never hits
    rows = n // twk.LANE
    dense_row = rng.random(rows) < 0.3
    count = np.where(np.repeat(dense_row, twk.LANE) & (rng.random(n) < 0.5),
                     rng.integers(1, 400, size=n), 0).astype(np.int32)
    rel = rng.integers(0, w, size=n).astype(np.int32)
    ws = (rng.integers(0, (p - w) // twk.LANE, size=rows) * twk.LANE).astype(np.int32)
    k_cap = count.reshape(-1, twk.BLOCK).max(axis=1).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (t(pos), t(vel), torch.full((n,), 0.3, device=device),
            torch.full((n,), 0.5, device=device), t(rel), t(count),
            t(ws).reshape(-1, twk.SUB), t(k_cap),
            twk.WindowTables(pairs=t(pairs), cells2=None))
    kw = dict(w=w, k_static=483, gravity=(0.0, -9.81, 0.0), dt=0.01, backoff=0.01)
    return args, kw


def test_key_minimum_reproduces_plain_hits():
    n, w = 1024, 512
    args, kw = synthetic_plan(n, w)
    pos, vel, rad, _, rel, count, ws, k_cap, tables = args
    _, _, hit = twk.window_collide_sorted_plain(*args, **kw)
    assert 0 < int(hit.sum()) < n
    speed2 = (vel * vel).sum(0)
    dirn = vel / torch.sqrt(torch.clamp(speed2, min=1e-37))[None]
    seg2 = speed2 * (kw["dt"] * kw["dt"])
    ws_l = ws.reshape(-1).repeat_interleave(twk.LANE)
    bound = torch.minimum(torch.minimum(count, k_cap.repeat_interleave(twk.BLOCK)),
                          w - rel).clamp(min=0, max=kw["k_static"])
    posted = 0
    for i in torch.nonzero(bound > 0).squeeze(1).tolist():
        cols = int(ws_l[i] + rel[i]) + torch.arange(int(bound[i]))
        comp = tables.pairs[:, cols][:, :, None]  # [9, K, 1]
        tri_hit, c_t2, _, _ = twk._candidate(
            pos[:, i, None, None], dirn[:, i, None, None], rad[i, None, None],
            seg2[i, None, None], comp[0:3], comp[3:6], comp[6:9])
        t2, th = c_t2[:, 0].numpy(), tri_hit[:, 0].numpy()
        key = key_min(t2, th)
        best_t2, best_k, any_hit = fold(t2, th)
        assert (key != NO_HIT) == (any_hit and best_t2 < INF)
        assert bool(hit[i]) == (key != NO_HIT and float(speed2[i]) != 0.0)
        if key != NO_HIT:
            assert int(key & np.uint64(0xFFFFFFFF)) == best_k
            posted += 1
    assert posted > 0 and not bool(hit[bound == 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(40_960, 1024), (8192, 2048), (1024, 512)])
def test_cuda_window_kernel_flat_rows_match_plain(n, w):
    """On the card: the window kernel against its plain version, bit for
    bit, with one block per row (40,960 lanes) and with several blocks
    per row and the finishing kernel (8192 and 1024 lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, kw = synthetic_plan(n, w, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (twk.row_split(n, sms) == 1) == (n == 40_960)
    before = twk.LAUNCHES["window_collide_sorted"]
    pk, vk, hk = twk.window_collide_sorted(*args, **kw)
    torch.cuda.synchronize()
    assert twk.LAUNCHES["window_collide_sorted"] == before + 1
    pp, vp, hp = twk.window_collide_sorted_plain(*args, **kw)
    assert 0 < int(hp.sum()) < n
    assert torch.equal(hk, hp)
    assert torch.equal(pk, pp) and torch.equal(vk, vp)
    with pytest.raises(ValueError, match="window"):
        twk.window_collide_sorted(*args, **{**kw, "w": twk.MAX_WINDOW + 1})
