"""PyTorch port, the p2p window kernel (B3): its plain version agrees
with the JAX package's Pallas kernel (interpret mode) on the same planned
inputs; the wrapper takes the plain version only for CPU tensors and
checks what it is given; the CUDA source is listed in ``build.SOURCES``.
The CUDA kernel itself runs only on the card (``-m cuda``)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesystemhybridcollisiondetection_tpu.ops.pallas import (
    p2p_window_kernel as jk,
)
from particlesystemhybridcollisiondetection_tpu_torch.core import state as tstate
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan as tplan
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_sorted as tp2ps
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as tpg
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    p2p_window_kernel as tk,
)

from test_torch_p2p import both
from test_torch_p2p_sorted import two_blocks_with_sentinels

PORT = os.path.dirname(os.path.abspath(tk.__file__))


def planned_inputs(window, device="cpu"):
    """The kernel's arguments for n = 1400 (two blocks, 60 sentinels),
    planned as phase 1 plans them."""
    d, (lo, hi, h, cap) = two_blocks_with_sentinels()
    tm = tpg.make_meta(lo, hi, h, capacity=cap)
    _, ts = both(d)
    n, n_k = 1400, 2048
    key = torch.cat([
        tp2ps._cell_key(ts.pos, tm, tstate.active_mask(ts)),
        torch.full((n_k - n,), tm.num_cells, dtype=torch.int32),
    ]).to(device)
    rows = torch.cat([tp2ps._state_rows(ts), tp2ps._pad_columns(n_k - n, "cpu")],
                     dim=1).to(device)
    perm, starts, cnt = tp2ps._sorted_runs(key, tm)
    rel, ws, k_cap, overflow = tplan.window_geometry(starts, cnt, window)
    rows_s = rows[:, perm]
    rows_pad = torch.cat([rows_s, tp2ps._pad_columns(window, device)], dim=1)
    return (rows_s[0:3], rows_s[3:6], rows_s[6], rows_s[7], rows_pad, rel, cnt,
            ws, k_cap), overflow


@pytest.mark.parametrize("window", [512, 128])
def test_plain_matches_pallas_interpret(window):
    """Every lane, overflow lanes included: both sides apply the same
    clip to ``rel``.  Counts exact; pos rtol=1e-5 atol=1e-5, vel
    rtol=1e-4 atol=1e-5 (XLA on the CPU fuses multiply-adds)."""
    args, overflow = planned_inputs(window)
    assert bool(overflow.any()) == (window == 128)
    before = dict(tk.LAUNCHES)
    tp, tv, tn = tk.p2p_window_collide_sorted(*args, w=window, beta=0.5)
    assert tk.LAUNCHES == before  # CPU tensors: the plain version, no launch
    jp, jv, jn = jk.p2p_window_collide_sorted(
        *(jnp.asarray(a.numpy()) for a in args), w=window, beta=0.5,
        interpret=True)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)
    assert int(tn.sum()) > 0 and torch.isfinite(tv).all()
    assert (tn[1340:] == 0).all()  # sentinels and block padding


def test_k_cap_bounds_the_candidates():
    """A k_cap of 0 switches a block's group off in the plain version, as
    the TPU kernel's loop bound does."""
    args, _ = planned_inputs(512)
    *head, k_cap = args
    _, _, full = tk.p2p_window_collide_sorted_plain(*args, w=512, beta=0.5)
    _, _, none = tk.p2p_window_collide_sorted_plain(
        *head, torch.zeros_like(k_cap), w=512, beta=0.5)
    assert int(full.sum()) > 0 and int(none.sum()) == 0


def test_wrapper_refuses_bad_shapes():
    args, _ = planned_inputs(512)
    with pytest.raises(ValueError, match="1024"):
        tk.p2p_window_collide_sorted(
            args[0][:, :1000], args[1][:, :1000], args[2][:1000], args[3][:1000],
            *args[4:], w=512, beta=0.5)
    with pytest.raises(ValueError, match="rows_pad"):
        tk.p2p_window_collide_sorted(*args[:4], args[4][:, :2048], *args[5:],
                                     w=512, beta=0.5)


def test_source_is_registered_and_named():
    assert "p2p_window_kernel" in build.SOURCES
    src, so = build._paths("p2p_window_kernel")
    assert os.path.exists(src) and so.endswith("libp2p_window_kernel.so")
    text = open(src).read()
    assert 'extern "C" int psys_p2p_window_collide(' in text
    assert 'extern "C" int psys_p2p_window_collide_cells(' in text
    assert 'extern "C" int psys_p2p_collide_worklist(' in text
    assert tk.LAUNCHES == {"p2p_window_collide_sorted": 0,
                           "p2p_window_collide_cells": 0,
                           "p2p_collide_worklist": 0}
    assert tk.N_GROUPS == 9 and (tk.SUB, tk.LANE, tk.BLOCK) == (8, 128, 1024)


def test_slice_sources_import_no_jax():
    """No module of this slice names jax or the JAX package in an import
    (test_torch_foundation.py::test_port_imports_no_jax imports them all
    in a clean interpreter; this reads the sources)."""
    root = os.path.dirname(os.path.dirname(PORT))
    ref = "particlesystemhybridcollisiondetection_tpu"
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|%s)(\.|\s|$)" % ref, re.M)
    files = ["ops/pgrid.py", "ops/p2p.py", "ops/p2p_dense.py", "ops/p2p_sorted.py",
             "ops/p2p_plan.py",
             "ops/cuda/p2p_window_kernel.py", "core/step.py", "bench/configs.py",
             "convert.py"]
    for f in files:
        assert not pat.search(open(os.path.join(root, f)).read()), f
    smoke = os.path.join(os.path.dirname(root), "chip_smoke.py")
    assert not pat.search(open(smoke).read())


@pytest.mark.cuda
def test_cuda_p2p_kernel_matches_plain():
    """On the card: B3 against its plain version on the same planned
    inputs, with and without window overflow: contact counts equal and
    pos/vel equal bit for bit (same operations, --fmad=false); one launch
    per call; bad inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for window in (512, 128):
        args, overflow = planned_inputs(window, device="cuda")
        before = tk.LAUNCHES["p2p_window_collide_sorted"]
        pk, vk, nk = tk.p2p_window_collide_sorted(*args, w=window, beta=0.5)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["p2p_window_collide_sorted"] == before + 1
        pp, vp, npl = tk.p2p_window_collide_sorted_plain(*args, w=window, beta=0.5)
        assert int(npl.sum()) > 0
        assert torch.equal(nk, npl)
        assert torch.equal(pk, pp) and torch.equal(vk, vp)
    with pytest.raises(ValueError):
        tk.p2p_window_collide_sorted(args[0].double(), *args[1:], w=128, beta=0.5)
