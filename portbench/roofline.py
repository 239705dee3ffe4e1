"""The card's published peak and the bytes that the port's probe kernels
must move, from the shapes of their inputs and outputs.

A kernel's roofline share is the least time the card could take, its bytes
over the peak memory rate, over its measured time. Each input byte is
counted once and each output byte once, whatever a kernel reads again;
where the work depends on the data, the count is what these inputs need at
least, so a later kernel that does the same work is held to the same bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM 80 GB: HBM3 at 3.35 TB/s (NVIDIA's data sheet; 700 W)
HBM_BYTES_PER_S = 3.35e12

# K1 (mono2_probe_kernel) a lane: its 8-byte key, the two 7-word slots of
# its bucket's 64-byte row that it must compare (56 bytes), and its nine
# outputs (six int64, three one-byte): the count of chip_smoke.py's K1
# bound.
K1_LANE_BYTES = 8 + 2 * 7 * 4 + (6 * 8 + 3)


def k1_bytes(lanes: float) -> float:
    return lanes * K1_LANE_BYTES


def share_pct(n_bytes: float, seconds: float) -> float:
    """Percent of the memory roofline: ``n_bytes`` at the peak rate over
    ``seconds``."""
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds
