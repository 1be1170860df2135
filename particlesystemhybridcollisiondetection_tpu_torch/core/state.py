"""Particle state and initializers.

Mirrors the reference's SoA ComputeBuffers (particlesPosCb /
particlesVelCb, ParticleSys.cs:54-55) as a ``NamedTuple`` of planar
``f32[3, N]`` tensors, plus the per-particle collision counter
(ParticleSys.cs:115-117) carried in-state so it stays on the device for
the whole episode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from particlesystemhybridcollisiondetection_tpu_torch.config import (
    FLOAT_SENTINEL,
    PARTICLE_PAD,
    REFERENCE_PARTICLE_CAP,
    SimConfig,
)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (every entry
    point's default) raises when CUDA is absent: nothing falls back to
    the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


_constants: dict = {}


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` (a flat sequence of numbers) on ``device``,
    made once and kept: a host-to-device copy cannot be captured in a
    CUDA graph, so the code of a captured step takes its constants (grid
    origins, box corners) from here."""
    key = (tuple(float(x) for x in values), dtype, torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return t


class ParticleState(NamedTuple):
    """All tensors share the padded particle axis N.

    pos, vel:    f32[3, N] planar SoA (reference: RWStructuredBuffer<float3>)
    collisions:  i32[N] per-particle resolved-collision counter
    radius:      f32[N] per-particle radius
    restitution: f32[N] per-particle bounciness
    """

    pos: torch.Tensor
    vel: torch.Tensor
    collisions: torch.Tensor
    radius: torch.Tensor
    restitution: torch.Tensor

    @property
    def n_padded(self) -> int:
        return self.pos.shape[-1]


def _pad_count(n: int, multiple: int = PARTICLE_PAD) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def spawn_grid(
    cfg: SimConfig,
    layers_y: int = 1,
    *,
    pad_multiple: int = PARTICLE_PAD,
    radius: Optional[np.ndarray] = None,
    restitution: Optional[np.ndarray] = None,
    cap: Optional[int] = REFERENCE_PARTICLE_CAP,
    jitter: float = 0.0,
    seed: int = 0,
    device="cuda",
) -> ParticleState:
    """Spawn the reference's particle block (SetupParticleDependentData,
    ParticleSys.cs:227-255): a ``numParticlesXZ^2 x layers_y`` grid
    centred on ``spawn_origin`` with XZ spacing ``offset_xz`` and Y
    spacing ``4 * offset_xz``, at rest.  Particles beyond ``cap`` are
    dropped and the arrays are padded to ``pad_multiple`` with sentinel
    particles at 1e38 and zero velocity.  Spawn-loop order is the
    reference's (i over x, j over y, k over z).  The arrays are built in
    NumPy exactly as the JAX package builds them, then moved to
    ``device``.
    """
    dev = resolve_device(device)
    d = cfg.num_particles_xz
    offset = cfg.offset_xz
    origin = np.asarray(cfg.spawn_origin, dtype=np.float64)

    n_logical = d * d * layers_y
    if cap is not None:
        n_logical = min(n_logical, cap)

    xz_start = (d - 1) / 2.0
    star = np.array([xz_start * offset, 0.0, xz_start * offset]) + origin

    idx = np.arange(n_logical)
    k = idx % d
    j = (idx // d) % layers_y
    i = idx // (d * layers_y)
    pos = np.empty((3, n_logical), dtype=np.float64)
    pos[0] = star[0] - offset * i
    pos[1] = star[1] + offset * j * 4.0
    pos[2] = star[2] - offset * k

    if jitter:
        # ensemble-study perturbation (not part of the reference spawn)
        rng = np.random.default_rng(seed)
        pos += rng.uniform(-jitter * offset, jitter * offset,
                           size=(3, n_logical))

    n_pad = _pad_count(n_logical, pad_multiple)
    pos_p = np.full((3, n_pad), FLOAT_SENTINEL, dtype=np.float32)
    pos_p[:, :n_logical] = pos.astype(np.float32)
    vel_p = np.zeros((3, n_pad), dtype=np.float32)

    r = np.full((n_pad,), cfg.particle_radius, dtype=np.float32)
    if radius is not None:
        r[:n_logical] = np.asarray(radius, dtype=np.float32)
    e = np.full((n_pad,), cfg.bounciness, dtype=np.float32)
    if restitution is not None:
        e[:n_logical] = np.asarray(restitution, dtype=np.float32)

    return ParticleState(
        pos=torch.from_numpy(pos_p).to(dev),
        vel=torch.from_numpy(vel_p).to(dev),
        collisions=torch.zeros((n_pad,), dtype=torch.int32, device=dev),
        radius=torch.from_numpy(r).to(dev),
        restitution=torch.from_numpy(e).to(dev),
    )


def active_mask(state: ParticleState) -> torch.Tensor:
    """bool[N]: True for real (non-sentinel) particles.

    Sentinels are spawned at 1e38 and, like the reference's padding
    threads, still get integrated each step -- so "active" is defined by
    position magnitude, not a stored count.
    """
    return torch.abs(state.pos[0]) < FLOAT_SENTINEL * 0.5


def reset_episode(state: ParticleState, initial: ParticleState) -> ParticleState:
    """Episode reset: re-upload initial pos/vel (ParticleSys.cs:520-526).

    Collision counters are preserved, matching the reference (they are
    only reset by ResetBenchmarkCollisons, BenchmarkManager.cs:160).
    """
    return state._replace(pos=initial.pos, vel=initial.vel)


def snapshot(state: ParticleState) -> dict:
    """Checkpoint: a host-side dict of numpy arrays (np.savez-able), with
    the JAX package's keys and dtypes."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def restore(data: dict, device="cuda") -> ParticleState:
    """ParticleState on ``device`` from a ``snapshot`` dict (copies)."""
    dev = resolve_device(device)
    return ParticleState(
        **{k: torch.tensor(np.asarray(v), device=dev) for k, v in data.items()})
