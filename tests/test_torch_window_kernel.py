"""PyTorch port, sorted window kernels: the host tables equal the JAX
package's; the plain versions of the cells kernel (B2) and the window
kernel (B1) agree with the JAX package's Pallas kernels run in interpret
mode on the same planned inputs; the plan tail is bit-identical.  The
CUDA kernels themselves run only on the card (``-m cuda``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.config import GridConfig as JGridConfig
from particlesystemhybridcollisiondetection_tpu.core import step as jstep
from particlesystemhybridcollisiondetection_tpu.geometry.scenes import (
    sample_scene as j_sample_scene,
)
from particlesystemhybridcollisiondetection_tpu.ops import grid as jgrid
from particlesystemhybridcollisiondetection_tpu.ops.pallas import window_kernel as jwk
from particlesystemhybridcollisiondetection_tpu_torch import convert
from particlesystemhybridcollisiondetection_tpu_torch.core import step as tstep
from particlesystemhybridcollisiondetection_tpu_torch.core.state import spawn_grid
from particlesystemhybridcollisiondetection_tpu_torch.ops import grid as tgrid
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import window_kernel as twk

W_MAIN, W_RESCUE = 512, 2048
IMPACT_STEP = 44


def _fast_cfg():
    """sample_scene with 20x dt: first impacts within ~55 steps (as the
    JAX package's window-kernel tests)."""
    scene = j_sample_scene(width=128, height=128)
    return scene, dataclasses.replace(scene.config, dt=scene.config.dt * 20)


@pytest.fixture(scope="module")
def setup():
    scene, cfg = _fast_cfg()
    jg, jm = jgrid.build_triangle_grid(scene.triangles, cfg.grid)
    tg, tm = convert.grid_from_numpy(
        *(np.asarray(x) for x in jg), dataclasses.asdict(jm), device="cpu")
    jt = jwk.build_window_tables(jg, jm, W_RESCUE)
    tt = twk.build_window_tables(tg, tm, W_RESCUE)
    jc = jwk.build_code_table(jg, jm, tstep._CODE_WC)
    tc = twk.build_code_table(tg, tm, tstep._CODE_WC)
    # impact-regime state: 44 port steps from spawn (the next step hits)
    step = tstep.make_spatial_step_sorted(scene.triangles, cfg, device="cpu")
    s = spawn_grid(cfg, 1, device="cpu")
    for _ in range(IMPACT_STEP):
        s = step(s)
    # sort and plan as the step does
    key = tgrid.morton_key(tgrid.lookup_pos(s.pos, s.vel, cfg.dt), tm)
    key_s, perm = torch.sort(key, stable=True)
    rows = torch.cat([s.pos, s.vel, s.radius[None], s.restitution[None]], 0)[:, perm]
    sorted_state = tuple(x.contiguous() for x in (rows[0:3], rows[3:6], rows[6], rows[7]))
    return dict(cfg=cfg, jg=jg, jm=jm, tg=tg, tm=tm, jt=jt, tt=tt, jc=jc,
                tc=tc, key_s=key_s, sorted_state=sorted_state)


def _lo_hi(key_s):
    rows = key_s.reshape(-1, twk.LANE)
    lo = (rows.min(1).values // 128) * 128
    hi = torch.clamp(((rows.max(1).values - tstep._CODE_WC + 128) // 128) * 128, min=0)
    return lo, hi


def test_window_tables_equal(setup):
    jt, tt = setup["jt"], setup["tt"]
    assert tt.pairs.shape == (9, jt.pairs.shape[1])
    np.testing.assert_array_equal(tt.pairs.numpy(), np.asarray(jt.pairs)[:9])
    np.testing.assert_array_equal(tt.cells2.numpy(), np.asarray(jt.cells2))
    # and from the port's own grid build
    scene, cfg = _fast_cfg()
    g, m = tgrid.build_triangle_grid(scene.triangles, cfg.grid, device="cpu")
    np.testing.assert_array_equal(
        twk.build_window_tables(g, m, W_RESCUE).pairs.numpy(), tt.pairs.numpy())


def test_code_table_equal(setup):
    np.testing.assert_array_equal(setup["tc"].packed.numpy(),
                                  np.asarray(setup["jc"].packed)[0])


def _cells_both(key_s, jc, tc):
    lo, hi = _lo_hi(key_s)
    js, jn = jwk.cells_window_lookup(
        jnp.asarray(key_s.numpy()), jnp.asarray(lo.numpy()),
        jnp.asarray(hi.numpy()), jc, wc=tstep._CODE_WC, interpret=True)
    before = dict(twk.LAUNCHES)
    ts, tn = twk.cells_window_lookup(key_s, lo, hi, tc, wc=tstep._CODE_WC)
    assert twk.LAUNCHES == before  # CPU tensors: the plain version, no launch
    return (ts.numpy(), tn.numpy()), (np.asarray(js), np.asarray(jn))


def test_cells_plain_matches_pallas(setup):
    key_s = setup["key_s"].clone()
    # a few drifted strays per row, so both windows and misses occur
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.choice(key_s.numel(), 40, replace=False))
    key_s[idx] = key_s[idx] + torch.from_numpy(
        rng.integers(-3000, 3000, 40).astype(np.int32))
    key_s = torch.clamp(key_s, 0, int(setup["tc"].packed.numel()) - 1)
    key_s, _ = torch.sort(key_s)
    (ts, tn), (js, jn) = _cells_both(key_s, setup["jc"], setup["tc"])
    np.testing.assert_array_equal(tn, jn)
    ok = tn >= 0
    np.testing.assert_array_equal(ts[ok], js[ok])
    assert ok.sum() > 0 and (~ok).sum() > 0


def test_cells_dense_cell_marks_miss():
    """Mirror of the JAX package's dense-cell test: cells with >= 255
    triangles are misses (count -1), sparse cells decode exactly, in the
    port's plain version and the Pallas kernel alike."""
    rng = np.random.default_rng(0)
    base = np.array([5.0, 5.0, 5.0])
    dense = base + rng.normal(scale=0.05, size=(300, 3, 3)) * 0.1
    sparse = rng.uniform(12.0, 19.0, size=(8, 3, 3))
    tris = np.concatenate([dense, sparse]).astype(np.float32)
    jg, jm = jgrid.build_triangle_grid(tris, JGridConfig(cell_size=4.0))
    from particlesystemhybridcollisiondetection_tpu_torch.config import GridConfig

    tg, tm = tgrid.build_triangle_grid(tris, GridConfig(cell_size=4.0), device="cpu")
    counts = np.diff(tg.offsets.numpy())
    assert counts.max() >= 255
    jc = jwk.build_code_table(jg, jm, 512)
    tc = twk.build_code_table(tg, tm, 512)
    np.testing.assert_array_equal(tc.packed.numpy(), np.asarray(jc.packed)[0])
    codes = tgrid.morton_cell_codes(tm)
    dense_code = int(codes[int(np.argmax(counts))])
    sparse_cid = int(np.argwhere((counts > 0) & (counts < 255))[0][0])
    key = np.full((twk.BLOCK,), dense_code, dtype=np.int32)
    key[1] = int(codes[sparse_cid])
    key.sort()
    (ts, tn), (js, jn) = _cells_both(torch.from_numpy(key), jc, tc)
    np.testing.assert_array_equal(tn, jn)
    assert (tn[key == dense_code] == -1).all()
    sl = key == int(codes[sparse_cid])
    assert (tn[sl] == counts[sparse_cid]).all()
    np.testing.assert_array_equal(ts[sl], js[sl])


def test_plan_tail_bitwise(setup):
    """_plan_tail (window geometry, overflow, demotion, miss folding) on
    the same (start, count, miss) in both packages, across windows."""
    key_s = setup["key_s"]
    lo, hi = _lo_hi(key_s)
    start, count = twk.cells_window_lookup(key_s, lo, hi, setup["tc"],
                                           wc=tstep._CODE_WC)
    miss = count < 0
    count = torch.where(miss, 0, count)
    nb = key_s.numel() // twk.BLOCK
    for window, demote in ((128, None), (512, 2), (2048, 192)):
        t_out = tstep._plan_tail(start, count, window, nb, miss=miss, demote=demote)
        j_out = jstep._plan_tail(jnp.asarray(start.numpy()), jnp.asarray(count.numpy()),
                                 window, nb, miss=jnp.asarray(miss.numpy()),
                                 demote=demote)
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(t_out[4].any())


def _b1_inputs(setup, which):
    s = setup["sorted_state"]
    tm, tt, cfg = setup["tm"], setup["tt"], setup["cfg"]
    nb = s[0].shape[1] // twk.BLOCK
    # main: no demotion, so the lanes hitting the dense cells stay in
    # the main window; rescue: the overflow of the demoting plan
    demote = None if which == "main" else 192
    rel, count, ws, k_cap, overflow, _ = tstep._window_plan_coded(
        setup["key_s"], setup["tc"], W_MAIN, nb, demote=demote)
    if which == "main":
        return s, (rel, count, ws, k_cap), W_MAIN
    # the first phase-1 rescue chunk, as _chunked_rescue builds it
    pick = tstep._phase1_order(overflow, setup["key_s"])[:twk.BLOCK]
    _, chunk, plan = tstep._rescue_chunk(s, overflow, pick, tt, tm, cfg, W_RESCUE)
    return chunk, plan[:4], W_RESCUE


@pytest.mark.parametrize("which", ["main", "rescue"])
def test_window_plain_matches_pallas(setup, which):
    cfg = setup["cfg"]
    (pos, vel, rad, res), (rel, count, ws, k_cap), w = _b1_inputs(setup, which)
    kw = dict(w=w, k_static=setup["tm"].max_tris_per_cell, gravity=cfg.gravity,
              dt=cfg.dt, backoff=cfg.backoff)
    before = dict(twk.LAUNCHES)
    tp, tv, th = twk.window_collide_sorted(pos, vel, rad, res, rel, count, ws,
                                           k_cap, setup["tt"], **kw)
    assert twk.LAUNCHES == before
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jp, jv, jh = jwk.window_collide_sorted(
        j(pos), j(vel), j(rad), j(res), j(rel), j(count), j(ws), j(k_cap),
        setup["jt"], interpret=True, **kw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    assert int(th.sum()) > 0, "inputs must hold real hits"


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: each CUDA kernel against its plain version on the
    same inputs (impact regime of the fast sample scene), exact hits and
    counts, pos/vel within rtol=1e-6, atol=1e-5; bad inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene, cfg = _fast_cfg()
    step = tstep.make_spatial_step_sorted(scene.triangles, cfg, device="cpu")
    s = spawn_grid(cfg, 1, device="cpu")
    for _ in range(IMPACT_STEP):
        s = step(s)
    dev = torch.device("cuda")
    tg, tm = tgrid.build_triangle_grid(scene.triangles, cfg.grid, device=dev)
    tt = twk.build_window_tables(tg, tm, W_RESCUE)
    tc = twk.build_code_table(tg, tm, tstep._CODE_WC)
    pos, vel = s.pos.to(dev), s.vel.to(dev)
    key_s, perm = torch.sort(tgrid.morton_key(tgrid.lookup_pos(pos, vel, cfg.dt), tm),
                             stable=True)
    rows = torch.cat([pos, vel, s.radius.to(dev)[None],
                      s.restitution.to(dev)[None]], 0)[:, perm]
    st = tuple(x.contiguous() for x in (rows[0:3], rows[3:6], rows[6], rows[7]))
    lo, hi = _lo_hi(key_s)
    before = twk.LAUNCHES["cells_window_lookup"]
    sk, ck = twk.cells_window_lookup(key_s, lo, hi, tc, wc=tstep._CODE_WC)
    sp_, cp = twk.cells_window_lookup_plain(key_s, lo, hi, tc, wc=tstep._CODE_WC)
    assert twk.LAUNCHES["cells_window_lookup"] == before + 1
    assert torch.equal(ck, cp)
    assert torch.equal(sk[cp >= 0], sp_[cp >= 0])
    with pytest.raises(ValueError):
        twk.cells_window_lookup(key_s.long(), lo, hi, tc, wc=tstep._CODE_WC)

    nb = key_s.numel() // twk.BLOCK
    rel, count, ws, k_cap, _, _ = tstep._window_plan_coded(key_s, tc, W_MAIN, nb)
    overflow = tstep._window_plan_coded(key_s, tc, W_MAIN, nb, demote=192)[4]
    pick = tstep._phase1_order(overflow, key_s)[:twk.BLOCK]
    _, chunk, plan = tstep._rescue_chunk(st, overflow, pick, tt, tm, cfg, W_RESCUE)
    for args, w in (((*st, rel, count, ws, k_cap), W_MAIN),
                    ((*chunk, *plan[:4]), W_RESCUE)):
        kw = dict(w=w, k_static=tm.max_tris_per_cell, gravity=cfg.gravity,
                  dt=cfg.dt, backoff=cfg.backoff)
        pk, vk, hk = twk.window_collide_sorted(*args, tt, **kw)
        pp, vp, hp = twk.window_collide_sorted_plain(*args, tt, **kw)
        assert int(hp.sum()) > 0
        assert torch.equal(hk, hp)
        torch.testing.assert_close(pk, pp, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(vk, vp, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        twk.window_collide_sorted(st[0][:, ::2], *st[1:], rel, count, ws, k_cap,
                                  tt, w=W_MAIN, k_static=tm.max_tris_per_cell,
                                  gravity=cfg.gravity, dt=cfg.dt, backoff=cfg.backoff)
