"""Timing fence for the eager PyTorch port."""

from __future__ import annotations

import torch


def fence(t: torch.Tensor) -> None:
    """Wait until the device has finished every queued kernel (CUDA
    tensors; a no-op on the CPU, where PyTorch runs synchronously)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
