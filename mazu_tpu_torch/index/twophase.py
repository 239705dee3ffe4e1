"""Zero-gather main-phase projection (counterpart of
``mazu_tpu.index.twophase._project_fused``)."""

from __future__ import annotations

import torch

from .. import MATCH_IDENTITY
from .unitig_table import decode_words


def _project_fused(arrays: dict, r: dict) -> dict:
    """Project the (up to two) occurrence words that the K2U row carried.

    Lanes whose unitig has more occurrences than the row carries, or that
    need the skew structure, are flagged ``overflow`` for phase 2. The
    projection math follows the reference's ``index.rs:193-216``: a forward
    occurrence maps k-mer offset ``kpos`` to ``occ_pos + kpos``, a reverse
    one to ``occ_pos + (ulen - kpos) - k``."""
    u2 = arrays["u2pos"]
    k = arrays["meta"].k
    hit = r["mt"] > 0
    cnt = torch.where(hit, r["occ_cnt"], 0)
    overflow = r["use_skew"] | (cnt > 2)
    kpos = r["pos"]
    ulen = r["unitig_len"]
    o_match = (r["mt"] == MATCH_IDENTITY).to(torch.int32)

    def proj(word):
        ref_id, occ_pos, occ_o = decode_words(u2, word)
        fw = occ_o == 1
        ref_pos = torch.where(fw, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
        return ref_id, ref_pos, torch.where(fw, o_match, 1 - o_match)

    r1, p1, o1 = proj(r["occ_word"])
    r2, p2, o2 = proj(r["occ_word2"])
    base_valid = hit & ~overflow
    return {
        **{kk: r[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
        "n_occs": cnt,
        "ref_id": torch.stack([r1, r2], dim=1),
        "ref_pos": torch.stack([p1, p2], dim=1),
        "orient": torch.stack([o1, o2], dim=1),
        "valid": torch.stack([base_valid & (cnt >= 1), base_valid & (cnt >= 2)], dim=1),
        "overflow": overflow,
    }
