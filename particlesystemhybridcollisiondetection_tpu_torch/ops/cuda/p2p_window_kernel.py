"""Sorted 9-run window kernel of particle-particle collisions, for CUDA.

Port of the JAX package's ``ops/pallas/p2p_window_kernel.py`` (TPU kernel
``_p2p_kernel``): ``p2p_window_collide_sorted`` launches the hand-written
CUDA kernel B3 (``csrc/p2p_window_kernel.cu``), and
``p2p_window_collide_sorted_plain`` beside it is the same function in
plain PyTorch.  ``p2p_window_collide_cells`` is the kernel's second entry
point, which the sorted paths of ``ops/p2p_sorted.py`` call: it takes the
sorted cell ids and the CSR offsets over cells and derives the plan
inside the kernel, so a step builds no run table and no [9, N] plan
array; its plain version composes ``ops/p2p_plan.py`` with
``p2p_window_collide_sorted_plain``.  A wrapper runs its plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel (on
the current stream) or raises.  Each launch adds one to ``LAUNCHES`` under
the wrapper's name.

Inputs are the plan of ``ops/p2p_plan.py::window_geometry``: particles
sorted by cell; for each of the nine (dx, dy) groups every particle's
candidates are a run of consecutive sorted particles, read from the
window that its row of 128 sorted particles has in ``rows_pad`` (the
sorted [8, N] rows pos3/vel3/radius/restitution plus ``w`` inert pad
columns).  Candidate k of group g is column
``ws[b, g, j] + clip(rel[g] + k, 0, w - 1)``, valid iff
``k < min(cnt[g], k_cap[b, g])`` and ``rel[g] + k < w``; contacts
accumulate in (g, k) order with the model of ``ops/p2p.py``.  The self
pair needs no index test: ``dist2 > 0`` rejects it.

The TPU kernel's layout devices (72 up-front DMAs into a staging
scratch, the MXU sublane permutation, the in-register lane gather, flat
scalar-prefetch arrays) have no counterpart here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import (
    BLOCK,
    LANE,
    SUB,
    _check,
    _ptr,
    _raise_on,
    _stream,
)
from particlesystemhybridcollisiondetection_tpu_torch.ops import p2p_plan as plan
from particlesystemhybridcollisiondetection_tpu_torch.ops import pgrid as pg
from particlesystemhybridcollisiondetection_tpu_torch.ops.p2p import pair_contact
from particlesystemhybridcollisiondetection_tpu_torch.ops.p2p_plan import N_GROUPS

#: kernel launches per wrapper (plain-version calls are not counted)
LAUNCHES = {"p2p_window_collide_sorted": 0, "p2p_window_collide_cells": 0}

# The kernel stages three [4][w] float buffers in shared memory (an SM has
# 227 KB for a block); above this window it cannot launch
MAX_WINDOW = 4096


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_window(n: int, n_pad: int, w: int) -> None:
    if n % BLOCK:
        raise ValueError(f"particle count {n} is not a multiple of {BLOCK}")
    if not 0 < w <= MAX_WINDOW:
        raise ValueError(f"window {w} is outside (0, {MAX_WINDOW}]")
    if n_pad < n + w:
        raise ValueError(f"rows_pad holds {n_pad} columns, the windows need "
                         f"{n + w}")


def p2p_window_collide_sorted_plain(
    pos_s, vel_s, radius_s, restit_s, rows_pad, rel, cnt, ws, k_cap, *,
    w: int, beta: float,
):
    """Plain PyTorch version of the window kernel
    (csrc/p2p_window_kernel.cu): the same candidates in the same order
    and the same operations, every lane evaluated at every k up to the
    group's longest run, invalid candidates masked (they add exact
    zeros)."""
    n = pos_s.shape[-1]
    nb = n // BLOCK
    dev = pos_s.device
    mass = radius_s * radius_s * radius_s
    # per-lane window start and candidate bound, [9, N]
    ws_l = ws.permute(1, 0, 2).reshape(N_GROUPS, nb * SUB).repeat_interleave(
        LANE, dim=1)
    bound = torch.minimum(
        torch.minimum(cnt, k_cap.t().repeat_interleave(BLOCK, dim=1)), w - rel)

    dv = torch.zeros_like(vel_s)
    dp = torch.zeros_like(pos_s)
    ncon = torch.zeros((n,), dtype=torch.int32, device=dev)
    for g in range(N_GROUPS):
        k_max = int(bound[g].max())
        for k in range(k_max):
            cand = rows_pad[:, ws_l[g] + torch.clamp(rel[g] + k, max=w - 1)]
            rj = cand[6]
            ddv, ddp, touching = pair_contact(
                pos_s, vel_s, radius_s, restit_s, mass,
                cand[0:3], cand[3:6], rj, cand[7], rj * rj * rj,
                k < bound[g], beta,
            )
            dv = dv + ddv
            dp = dp + ddp
            ncon = ncon + touching.to(torch.int32)
    return pos_s + dp, vel_s + dv, ncon


def p2p_window_collide_sorted(
    pos_s,  # f32[3, N] sorted by cell
    vel_s,
    radius_s,  # f32[N]
    restit_s,
    rows_pad,  # f32[8, >= N + w] sorted rows, then w pad columns
    rel,  # i32[9, N] run start - own row's window start, in [0, w-1]
    cnt,  # i32[9, N] run length
    ws,  # i32[N/1024, 9, 8] per-row window starts, in [0, N]
    k_cap,  # i32[N/1024, 9] per-block candidate bound
    *,
    w: int,
    beta: float,
):
    """Contact pass over the nine runs for every sorted particle.
    Returns (pos + dp, vel + dv, ncon i32[N]) in the sorted order."""
    n = pos_s.shape[-1]
    _check_window(n, rows_pad.shape[-1], w)
    if pos_s.device.type == "cpu":
        return p2p_window_collide_sorted_plain(
            pos_s, vel_s, radius_s, restit_s, rows_pad, rel, cnt, ws, k_cap,
            w=w, beta=beta,
        )
    dev = pos_s.device
    nb = n // BLOCK
    n_pad = rows_pad.shape[-1]
    for name, t, dt_, shape in (
        ("pos_s", pos_s, torch.float32, (3, n)),
        ("vel_s", vel_s, torch.float32, (3, n)),
        ("radius_s", radius_s, torch.float32, (n,)),
        ("restit_s", restit_s, torch.float32, (n,)),
        ("rows_pad", rows_pad, torch.float32, (8, n_pad)),
        ("rel", rel, torch.int32, (N_GROUPS, n)),
        ("cnt", cnt, torch.int32, (N_GROUPS, n)),
        ("ws", ws, torch.int32, (nb, N_GROUPS, SUB)),
        ("k_cap", k_cap, torch.int32, (nb, N_GROUPS)),
    ):
        _check(name, t, dt_, shape, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    c = ctypes
    fn = build.kernel_function("p2p_window_kernel", "psys_p2p_window_collide", [
        *([c.c_void_p] * 5), c.c_int64, *([c.c_void_p] * 7), c.c_int64,
        c.c_int32, c.c_float, c.c_void_p,
    ])
    pos_o = torch.empty_like(pos_s)
    vel_o = torch.empty_like(vel_s)
    ncon_o = torch.empty((n,), dtype=torch.int32, device=dev)
    err = fn(
        _ptr(pos_s), _ptr(vel_s), _ptr(radius_s), _ptr(restit_s),
        _ptr(rows_pad), n_pad, _ptr(rel), _ptr(cnt), _ptr(ws), _ptr(k_cap),
        _ptr(pos_o), _ptr(vel_o), _ptr(ncon_o), n, w,
        # rounded to float32 as the plain version's tensor-by-scalar
        # product rounds it
        float(np.float32(beta)), _stream(dev),
    )
    _raise_on(err, "p2p_window_collide_sorted")
    LAUNCHES["p2p_window_collide_sorted"] += 1
    return pos_o, vel_o, ncon_o


def p2p_window_collide_cells_plain(rows_pad, cid_s, offsets, meta: pg.PGridMeta,
                                   *, w: int, beta: float):
    """Plain PyTorch version of the kernel's second entry point: the plan
    of ``ops/p2p_plan.py`` (run table, run bounds, window geometry) and
    then ``p2p_window_collide_sorted_plain``."""
    n = cid_s.shape[0]
    starts, cnt = plan.run_bounds(cid_s, plan.run_table(offsets, meta), meta)
    rel, ws, k_cap, overflow = plan.window_geometry(starts, cnt, w)
    pos_k, vel_k, ncon_k = p2p_window_collide_sorted_plain(
        rows_pad[0:3, :n], rows_pad[3:6, :n], rows_pad[6, :n], rows_pad[7, :n],
        rows_pad, rel, cnt, ws, k_cap, w=w, beta=beta,
    )
    return pos_k, vel_k, ncon_k, overflow


def p2p_window_collide_cells(
    rows_pad,  # f32[8, >= N + w] sorted rows, then w pad columns
    cid_s,  # i32[N] sorted linear cell ids, parked particles = num_cells
    offsets,  # i32[num_cells + 2] CSR offsets over cells (csr_offsets)
    meta: pg.PGridMeta,
    *,
    w: int,
    beta: float,
):
    """Contact pass over the nine runs for every sorted particle, the
    plan (runs, per-row windows, overflow) derived inside the kernel.
    Returns (pos + dp, vel + dv, ncon i32[N], overflow bool[N]) in the
    sorted order; overflow marks the particles with a run outside its
    window, whose results the caller must redo."""
    n = cid_s.shape[0]
    n_pad = rows_pad.shape[-1]
    _check_window(n, n_pad, w)
    if rows_pad.device.type == "cpu":
        return p2p_window_collide_cells_plain(rows_pad, cid_s, offsets, meta,
                                              w=w, beta=beta)
    dev = rows_pad.device
    for name, t, dt_, shape in (
        ("rows_pad", rows_pad, torch.float32, (8, n_pad)),
        ("cid_s", cid_s, torch.int32, (n,)),
        ("offsets", offsets, torch.int32, (meta.num_cells + 2,)),
    ):
        _check(name, t, dt_, shape, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    c = ctypes
    fn = build.kernel_function(
        "p2p_window_kernel", "psys_p2p_window_collide_cells", [
            c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p, *([c.c_int32] * 4),
            *([c.c_void_p] * 4), c.c_int64, c.c_int32, c.c_float, c.c_void_p,
        ])
    pos_o = torch.empty((3, n), dtype=torch.float32, device=dev)
    vel_o = torch.empty((3, n), dtype=torch.float32, device=dev)
    ncon_o = torch.empty((n,), dtype=torch.int32, device=dev)
    ovf_o = torch.empty((n,), dtype=torch.bool, device=dev)
    err = fn(
        _ptr(rows_pad), n_pad, _ptr(cid_s), _ptr(offsets), int(meta.num_cells),
        *(int(d) for d in meta.dims), _ptr(pos_o), _ptr(vel_o), _ptr(ncon_o), _ptr(ovf_o), n, w,
        float(np.float32(beta)), _stream(dev),
    )
    _raise_on(err, "p2p_window_collide_cells")
    LAUNCHES["p2p_window_collide_cells"] += 1
    return pos_o, vel_o, ncon_o, ovf_o
