"""Semi-implicit Euler integrator.

Reference kernel: PSReactionUpdate.compute:13-29 -- ``v += g*dt; p +=
v*dt`` for every particle, padding included (sentinels at 1e38 stay at
1e38 in float32).
"""

from __future__ import annotations

import torch


def integrate(
    pos: torch.Tensor,
    vel: torch.Tensor,
    gravity: torch.Tensor,
    dt: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """pos, vel: f32[3, N]; gravity: f32[3]; returns updated (pos, vel)."""
    new_vel = vel + gravity[:, None] * dt
    new_pos = pos + new_vel * dt
    return new_pos, new_vel
