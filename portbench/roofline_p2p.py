"""The bytes and operations of the B3 kernel's cells entry point
(``p2p_window_kernel``, the particle-particle window pass of the p2p
runner) and its bound on the card, from the work the reference counts
(``reference/p2p.py``: ``Reference._work``).

A frozen copy of the repository's ``chip_smoke.py`` B3 arithmetic for
that entry point, applied to a step's work: per particle its column
(pos, vel, radius, restitution: 32 B) and cell id (4 B) read and its
result (pos, vel, contact count: 28 B) and overflow flag (1 B) written;
every distinct candidate column its windows read (32 B) and every
distinct CSR offset its runs read (4 B), once each; 53 float operations
a candidate tested and 8 a particle.  Peaks: ``roofline.py``.
"""

from __future__ import annotations

from portbench.roofline import BYTES_PER_S, F32_OPS_PER_S

OPS_PER_CANDIDATE = 53
OPS_PER_LANE = 8


def b3_bound_s(work: dict) -> float:
    """Least seconds of one step's B3 cells-kernel work: bytes over
    3.35 TB/s or operations over 67 TFLOP/s, whichever is larger."""
    n = work["lanes"]
    n_bytes = n * (32 + 4) + 4 * work["offsets"] + 32 * work["columns"] + 29 * n
    n_ops = OPS_PER_CANDIDATE * work["candidates"] + OPS_PER_LANE * n
    return max(n_bytes / BYTES_PER_S, n_ops / F32_OPS_PER_S)
