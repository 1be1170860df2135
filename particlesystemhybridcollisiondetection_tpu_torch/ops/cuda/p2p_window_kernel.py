"""Sorted 9-run window kernel of particle-particle collisions, for CUDA.

Port of the JAX package's ``ops/pallas/p2p_window_kernel.py`` (TPU kernel
``_p2p_kernel``): ``p2p_window_collide_sorted`` launches the hand-written
CUDA kernel B3 (``csrc/p2p_window_kernel.cu``), and
``p2p_window_collide_sorted_plain`` beside it is the same function in
plain PyTorch.  The wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel (on the current stream)
or raises.  Each launch adds one to
``LAUNCHES["p2p_window_collide_sorted"]``.

Inputs are the plan of ``ops/p2p_sorted.py::_window_geometry``: particles
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
from particlesystemhybridcollisiondetection_tpu_torch.ops.p2p import pair_contact

N_GROUPS = 9

#: kernel launches of the wrapper (plain-version calls are not counted)
LAUNCHES = {"p2p_window_collide_sorted": 0}


def reset_launches() -> None:
    LAUNCHES["p2p_window_collide_sorted"] = 0


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
    if n % BLOCK:
        raise ValueError(f"particle count {n} is not a multiple of {BLOCK}")
    if rows_pad.shape[-1] < n + w:
        raise ValueError(f"rows_pad holds {rows_pad.shape[-1]} columns, the "
                         f"windows need {n + w}")
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
