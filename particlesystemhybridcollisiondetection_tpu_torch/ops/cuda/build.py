"""Build the hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with nvcc into its own shared library with a plain C
interface under ``build/torch_kernels/`` at the repository root, and is
loaded with ctypes (no PyTorch headers, so a build takes seconds).  All
stale sources compile at once, one nvcc process each.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` and IEEE division and
square root, so every kernel rounds exactly as its plain PyTorch version
(which runs each operation as its own, unfused kernel).

Each kernel module counts its launches in a ``LaunchCounter``, its
``LAUNCHES``, which registers its wrapper names in ``COUNTERS``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "torch_kernels",
)
SOURCES = ("cells_kernel", "p2p_window_kernel", "screenspace_kernel",
           "telemetry_kernel", "window_kernel")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
#: per-source ptxas report (registers, shared memory, spills) of the
#: builds made by this process
build_log: dict = {}
#: wrapper name -> the ``LaunchCounter`` that counts its launches
COUNTERS: dict = {}


class LaunchCounter(dict):
    """A kernel module's launches by wrapper name (plain-version calls are
    not counted), registered in ``COUNTERS``: wrapper names are unique
    across modules, so a graph capture can take out every launch it
    counted and each replay add them back to their counters
    (``core/graphed.py``)."""

    def __init__(self, *names: str):
        super().__init__(dict.fromkeys(names, 0))
        for k in names:
            COUNTERS[k] = self

    def reset(self) -> None:
        for k in self:
            self[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(_CSRC, f"{name}.cu"),
            os.path.join(_BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build_all() -> float:
    """Compile every missing or stale kernel library, all nvcc processes
    started together.  Returns the wall seconds spent (0.0 when nothing
    was stale).  Raises with nvcc's output when a build fails."""
    with _lock:
        return _build_locked([n for n in SOURCES if _stale(n)])


def _build_locked(names) -> float:
    if not names:
        return 0.0
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in names:
            src, so = _paths(name)
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, so)
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            build_log[name] = out
            os.replace(tmp, so)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def kernel_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name`` (built on
    first use), returning the launch's ``cudaError_t`` as an int.  The
    bound function is kept: a wrapper asks for it on every call."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _build_locked([n for n in SOURCES if _stale(n)])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
