"""Planar 3-vector helpers on ``[3, ...]`` tensors (axis 0 = xyz).

Written out component by component in a fixed order, ``(a0*b0 + a1*b1)
+ a2*b2``, so the plain PyTorch paths and the CUDA kernels (built with
``--fmad=false``) round identically.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Component dot product: [3, ...] x [3, ...] -> [...]."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def norm2(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(norm2(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """HLSL-style normalize: a / length(a); inf/nan for zero vectors,
    which callers mask exactly where the reference kernels early-out."""
    return a / norm(a)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL reflect: i - 2*dot(i, n)*n."""
    return i - 2.0 * dot(i, n) * n


def where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select on a [...] mask between [3, ...] vector fields."""
    return torch.where(mask[None], a, b)


def scale(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply a [3, ...] vector field by a scalar field [...]."""
    return v * s[None]


def vec3(x, y, z, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([x, y, z], dtype=dtype, device=device)
