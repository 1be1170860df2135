"""The benchmark's particle inputs, frozen: a NumPy copy of the port's
``core/state.py::spawn_grid`` (the reference's SetupParticleDependentData,
ParticleSys.cs:227-255) with the ensemble study's per-axis jitter drawn
from the run's seed.  ``portbench/tests`` holds it to the program's bit
for bit.
"""

from __future__ import annotations

import numpy as np

FLOAT_SENTINEL = 1.0e38


def spawn(sim: dict, layers_y: int, cap: int, pad_multiple: int,
          jitter: float, seed: int) -> dict:
    """A ``num_particles_xz^2 x layers_y`` grid centred on
    ``spawn_origin`` (XZ spacing ``offset_xz``, Y spacing 4x), cut to
    ``cap``, each coordinate moved by U(-jitter, jitter) * offset_xz drawn
    from ``seed``, at rest; padded to ``pad_multiple`` with sentinels at
    1e38.  Returns NumPy arrays ``pos``/``vel`` f32[3, N], ``radius``/
    ``restitution`` f32[N] and ``n_real``."""
    d = sim["num_particles_xz"]
    offset = sim["offset_xz"]
    origin = np.asarray(sim["spawn_origin"], dtype=np.float64)
    n_real = min(d * d * layers_y, cap)

    xz_start = (d - 1) / 2.0
    star = np.array([xz_start * offset, 0.0, xz_start * offset]) + origin
    idx = np.arange(n_real)
    k = idx % d
    j = (idx // d) % layers_y
    i = idx // (d * layers_y)
    pos = np.empty((3, n_real), dtype=np.float64)
    pos[0] = star[0] - offset * i
    pos[1] = star[1] + offset * j * 4.0
    pos[2] = star[2] - offset * k
    if jitter:
        rng = np.random.default_rng(seed)
        pos += rng.uniform(-jitter * offset, jitter * offset, size=(3, n_real))

    n_pad = -(-n_real // pad_multiple) * pad_multiple
    pos_p = np.full((3, n_pad), FLOAT_SENTINEL, dtype=np.float32)
    pos_p[:, :n_real] = pos.astype(np.float32)
    return {
        "pos": pos_p,
        "vel": np.zeros((3, n_pad), dtype=np.float32),
        "radius": np.full((n_pad,), sim["particle_radius"], dtype=np.float32),
        "restitution": np.full((n_pad,), sim["bounciness"], dtype=np.float32),
        "n_real": n_real,
    }
