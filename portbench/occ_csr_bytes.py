"""The bytes that the ragged phase 2 (``occ_csr_kernel``, ``mazu_tpu_torch/
csrc/occ_csr.cu``) must move at least: for each real phase-2 lane its key
(the unitig id, 8 bytes) and its unitig's two offsets (16), and for each
occurrence written its occurrence word (8) and its four written fields
(``qid`` 4, ``ref_id`` 4, ``ref_pos`` 8, ``orient`` 1). What the kernel
reads or writes besides (the lanes' positions and lengths, the per-slot
outputs, the scan's tile sums, the unused half of each 16-byte pair row) is
left out, so a share of the roofline from this count can only read low."""

LANE_BYTES = 8 + 2 * 8
OCC_BYTES = 8 + 4 + 4 + 8 + 1


def occ_csr_bytes(lanes: float, occurrences: float) -> float:
    return lanes * LANE_BYTES + occurrences * OCC_BYTES
