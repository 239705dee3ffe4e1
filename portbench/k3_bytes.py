"""The bytes that K3 (``capacity_probe_kernel``, the MPHF capacity tier's
main probe) must move at least a lane, from ``chip_smoke.py``'s K3 bound
(``k3_lane_cost``) at its least: a lane reads its 8-byte key and at least
one u32 word of the MPHF's first level, and writes its 59 bytes of outputs.
Whatever else a lane reads (more levels, its rank, its bucket's bounds and
rows, its window's words, its ``uproj`` row) depends on the data, so a
share of the roofline from this count can only read low, never above 100%.
"""

K3_LANE_BYTES = 8 + 4 + 59


def k3_bytes(lanes: float) -> float:
    return lanes * K3_LANE_BYTES
