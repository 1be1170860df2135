"""IO helpers: dependency-free PNG writing and state checkpointing (port
of the JAX package's ``utils/io.py``).

The reference saves 1920x1080 screenshots via Unity
(ParticleSys.cs:791-830) and has no checkpoint system (episode reset
re-uploads initial buffers, ParticleSys.cs:520-526).  Here: a zlib PNG
encoder (byte for byte the JAX package's) and an ``.npz`` round trip of
the state with the JAX package's keys, so each package reads the other's
checkpoints.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.core.state import (
    ParticleState,
    resolve_device,
)


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb: uint8[H, W, 3] (row 0 = top of image)."""
    rgb = np.ascontiguousarray(rgb.astype(np.uint8))
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def save_state(path: str, state) -> None:
    """Checkpoint a ParticleState (any NamedTuple of tensors) as ``.npz``."""
    np.savez_compressed(
        path, **{k: v.detach().cpu().numpy() for k, v in state._asdict().items()})


def load_state(path: str, cls=ParticleState, device="cuda"):
    """A checkpoint back as ``cls`` of tensors on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        return cls(**{k: torch.from_numpy(data[k]).to(dev) for k in data.files})
