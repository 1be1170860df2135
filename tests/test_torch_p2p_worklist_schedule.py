"""PyTorch port, the schedule of the p2p kernel's worklist entry point
(``ops/cuda/p2p_window_kernel.py::worklist_schedule``, the plain version
of how ``p2p_worklist_kernel`` shares the list out on the card) on the
CPU: one thread a listed entry; warp w of W takes ``width`` neighbouring
entries at each step s, [(w + W s) width, (w + W s + 1) width), with
width = min(32, ceil(m / W)).  The list lengths run from none and one
entry through fewer entries than warps, the window-128 list's every 97th
lane (9,628 at 1M particles, config 4), to a full list of the window-128
overflow (933,888); the grids from one block to the 528 an H100 keeps
resident (4 blocks of 256 threads on each of 132 SMs).  The kernel
itself runs only on the card (``-m cuda`` in
``test_torch_p2p_device_loop.py``)."""

import pytest
import torch

from particlesystemhybridcollisiondetection_tpu_torch.ops.cuda import (
    p2p_window_kernel as tk,
)

BLOCKS = (1, 3, 528)
LENGTHS = (0, 1, 5, 100, 9_628, 933_888)


def _warps(blocks):
    return blocks * tk.WORKLIST_THREADS // 32


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("m", LENGTHS)
def test_every_listed_entry_is_walked_once(blocks, m):
    """Each listed entry has exactly one (warp, step, thread), the thread
    inside the width and the warp inside the grid."""
    s = tk.worklist_schedule(torch.tensor(m, dtype=torch.int32), blocks=blocks)
    warps = _warps(blocks)
    assert s.warp.shape == s.step.shape == s.lane.shape == (m,)
    if m == 0:
        return
    assert 0 <= int(s.warp.min()) and int(s.warp.max()) < warps
    assert 0 <= int(s.lane.min()) and int(s.lane.max()) < s.width
    slot = (s.warp + warps * s.step) * s.width + s.lane
    assert torch.equal(slot, torch.arange(m))


def test_empty_and_single_entry():
    """No entry: nothing walked.  One entry: warp 0's thread 0 at step 0."""
    s = tk.worklist_schedule(torch.tensor(0, dtype=torch.int32), blocks=528)
    assert s.width == 1 and s.warp.numel() == 0
    s = tk.worklist_schedule(torch.tensor(1, dtype=torch.int32), blocks=528)
    assert (s.width, s.warp.tolist(), s.step.tolist(), s.lane.tolist()) == (1, [0], [0], [0])
