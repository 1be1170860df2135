"""The screen-space collision stage for CUDA (``csrc/screenspace_kernel.cu``):
one launch projects each lane through the camera, gathers its texel,
responds and writes the hybrid's undecided mask.  Two entry points:

  * ``screen_space_collide``: fresh pos, vel and collision count for every
    lane, and the mask where it is asked for;
  * ``screen_space_collide_rows``: in place on a runner's carried rows
    (f32[8, N]: pos, vel, radius, restitution), writing pos, vel and the
    count only where a lane collides and the mask on every lane.

``ops/screenspace.py`` calls them for CUDA tensors; its
``screen_space_collide_plain`` is the plain version, which runs for
tensors on the CPU and is the kernel's oracle on the card.  The camera's
constants are read from the device (the texture's tensors and the
gravity vector), so a launch reads nothing on the host and can be
captured.  Each launch adds one to ``LAUNCHES["screen_space_collide"]``.
"""

from __future__ import annotations

import ctypes

import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.build import LaunchCounter
from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda.window_kernel import (
    _check,
    _ptr,
    _raise_on,
    _sm_count,
    _stream,
)

#: kernel launches, both entry points, since the last ``reset_launches``
LAUNCHES = LaunchCounter("screen_space_collide")
reset_launches = LAUNCHES.reset

# the grid-stride loop's blocks of 256 threads per SM: 8 fill an SM's
# 2,048 threads
BLOCKS_PER_SM = 8

_CAMERA_ARGTYPES = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                    *([ctypes.c_void_p] * 5), ctypes.c_float, ctypes.c_int64,
                    ctypes.c_int32, ctypes.c_void_p]


def _camera_args(tex, gravity, dev) -> list:
    """The interleaved texel table and the camera constants, checked, as
    launch arguments."""
    h, w = tex.screen_size
    if h * w >= 2**31:
        raise ValueError(f"a {h} x {w} texture does not index in 32 bits")
    _check("tex.texels", tex.texels, torch.float32, (h * w, 4), dev)
    if tex.texels.data_ptr() % 16:
        raise ValueError("tex.texels must be 16-byte aligned")
    for name, shape in (("view", (4, 4)), ("proj", (4, 4)), ("cam_pos", (3,)),
                        ("cam_fwd", (3,))):
        _check(f"tex.{name}", getattr(tex, name), torch.float32, shape, dev)
    _check("gravity", gravity, torch.float32, (3,), dev)
    return [_ptr(tex.texels), h, w, _ptr(tex.view), _ptr(tex.proj), _ptr(tex.cam_pos),
            _ptr(tex.cam_fwd), _ptr(gravity)]


def _tail(dt: float, n: int, dev) -> list:
    return [dt, n, BLOCKS_PER_SM * _sm_count(dev), _stream(dev)]


def screen_space_collide(pos, vel, collisions, radius, restitution, tex, gravity,
                         dt: float, *, hybrid: bool):
    """One pass over f32[3, N] ``pos``/``vel``, i32[N] ``collisions``, f32[N]
    ``radius``/``restitution`` (all contiguous, on one CUDA device) against
    ``tex`` (``ops/screenspace.py::CameraTextures``).  Returns (pos, vel,
    collisions, undecided bool[N]), new tensors; undecided is None
    unless ``hybrid``."""
    dev = pos.device
    n = pos.shape[-1]
    for name, t, dtype, shape in (
            ("pos", pos, torch.float32, (3, n)), ("vel", vel, torch.float32, (3, n)),
            ("collisions", collisions, torch.int32, (n,)),
            ("radius", radius, torch.float32, (n,)),
            ("restitution", restitution, torch.float32, (n,))):
        _check(name, t, dtype, shape, dev)
    camera = _camera_args(tex, gravity, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    fn = build.kernel_function("screenspace_kernel", "psys_screen_space_collide",
                               [*([ctypes.c_void_p] * 9), *_CAMERA_ARGTYPES])
    pos_o = torch.empty_like(pos)
    vel_o = torch.empty_like(vel)
    coll_o = torch.empty_like(collisions)
    und = torch.empty((n,), dtype=torch.bool, device=dev) if hybrid else None
    err = fn(_ptr(pos), _ptr(vel), _ptr(radius), _ptr(restitution), _ptr(collisions),
             _ptr(pos_o), _ptr(vel_o), _ptr(coll_o),
             ctypes.c_void_p(None) if und is None else _ptr(und), *camera,
             *_tail(dt, n, dev))
    _raise_on(err, "screen_space_collide")
    LAUNCHES["screen_space_collide"] += 1
    return pos_o, vel_o, coll_o, und


def screen_space_collide_rows(rows8, collisions, undecided, tex, gravity,
                              dt: float) -> None:
    """The hybrid's pass in place: f32[8, N] ``rows8`` (pos 0-2, vel 3-5,
    radius 6, restitution 7), i32[N] ``collisions`` and bool[N]
    ``undecided``, all contiguous on one CUDA device.  Rows 0-5 and the
    count change only where a lane collides; ``undecided`` is written on
    every lane."""
    dev = rows8.device
    n = rows8.shape[-1]
    _check("rows8", rows8, torch.float32, (8, n), dev)
    _check("collisions", collisions, torch.int32, (n,), dev)
    _check("undecided", undecided, torch.bool, (n,), dev)
    camera = _camera_args(tex, gravity, dev)
    from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import build

    fn = build.kernel_function("screenspace_kernel", "psys_screen_space_collide_rows",
                               [*([ctypes.c_void_p] * 3), *_CAMERA_ARGTYPES])
    err = fn(_ptr(rows8), _ptr(collisions), _ptr(undecided), *camera, *_tail(dt, n, dev))
    _raise_on(err, "screen_space_collide_rows")
    LAUNCHES["screen_space_collide"] += 1
