"""ctypes bindings + on-demand build of the native tier
(psys_native.cpp: the grid binner and the sphere-BVH oracle).

Compiled lazily with g++ into ``build/native/`` at the repository root
(never into the package directory).  The grid builder has a NumPy
fallback with bit-identical output, so a missing toolchain only makes
scene setup slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "psys_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_SO = os.path.join(_BUILD_DIR, "libpsys_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent test workers may
    # build at the same time, and a half-written .so must never be loaded
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        # -ffp-contract=off: the L2 prefilter must produce the
        # bit-identical doubles as the NumPy path (no FMA contraction)
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
        "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, _SO)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _failed = True
            return None

        c = ctypes
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.psys_bvh_build.restype = c.c_void_p
        lib.psys_bvh_build.argtypes = [f32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32]
        lib.psys_bvh_num_nodes.restype = c.c_int64
        lib.psys_bvh_num_nodes.argtypes = [c.c_void_p]
        lib.psys_bvh_export.restype = None
        lib.psys_bvh_export.argtypes = [c.c_void_p, f32p, i64p]
        lib.psys_bvh_free.restype = None
        lib.psys_bvh_free.argtypes = [c.c_void_p]
        lib.psys_bvh_query.restype = None
        lib.psys_bvh_query.argtypes = [
            c.c_void_p, f32p, f32p, c.c_int64, f32p, c.c_float, i64p, f32p,
            c.c_int32,
        ]
        lib.psys_grid_build.restype = c.c_void_p
        lib.psys_grid_build.argtypes = [
            f32p, c.c_int64, c.c_double, c.c_double, c.c_double, c.c_int32,
        ]
        lib.psys_grid_info.restype = None
        lib.psys_grid_info.argtypes = [c.c_void_p, i64p, f64p, i64p]
        lib.psys_grid_export.restype = None
        lib.psys_grid_export.argtypes = [c.c_void_p, i64p, i32p]
        lib.psys_grid_free.restype = None
        lib.psys_grid_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
