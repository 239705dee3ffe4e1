"""The plain reference of a k-mer lookup: where each query k-mer lies in
the genome's unitigs, and its projection onto the references.

It works everything out again from the genome and the queries that the
benchmark made: the unitigs are the genome's ``accum`` bounds, and a k-mer
of the index is a window of k bases inside one unitig. ``locate`` scans
every such window of the genome, chunk by chunk, for the canonical forms of
the queries (a sorted search), so no table of every k-mer of a 3 Gbp genome
is ever held. A query's answer is the unitig and offset of the window that
holds it, whether the query reads that window forward (``mt`` 1) or
reverse-complemented (2), and every occurrence of that unitig on the
references: reference, position of the k-mer there, and orientation. A
query that no window holds is a miss (unitig 0, offset 0, ``mt`` 0, no
occurrences), as the program reports one.

A k-mer that two windows hold (two random 31-mers of a 3 Gbp genome agree
about once) has two right answers: ``locate`` keeps every position of such
a k-mer, and the comparison takes either.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .kmers import canonical, kmer_at

SCAN_CHUNK = 1 << 26


@dataclass
class Located:
    """Per query lane: ``count`` windows hold its k-mer, the first at
    genome position ``first`` (-1 for a miss); ``more`` maps a lane whose
    k-mer more than one window holds to all their positions."""

    count: torch.Tensor
    first: torch.Tensor
    more: dict = field(default_factory=dict)


class Layout:
    """A genome's unitig bounds and occurrence table as tensors."""

    def __init__(self, genome, device):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)  # noqa: E731
        self.k = genome.k
        self.words = t(genome.host_words.view(np.int64))
        self.accum = t(genome.accum)
        self.offsets = t(genome.offsets)
        self.occ_ref, self.occ_pos, self.occ_o = t(genome.occ_ref), t(genome.occ_pos), t(genome.occ_o)
        self.max_occs = int((genome.offsets[1:] - genome.offsets[:-1]).max())


def locate(layout: Layout, queries: torch.Tensor, chunk: int = SCAN_CHUNK) -> Located:
    """Find every query k-mer (int64 words, any shape, flattened) among the
    genome's windows by one scan of the genome."""
    k = layout.k
    q = queries.reshape(-1)
    keys, inv = torch.unique(canonical(q, k), sorted=True, return_inverse=True)
    counts = torch.zeros_like(keys)
    first = torch.full_like(keys, torch.iinfo(torch.int64).max)
    accum = layout.accum
    total = int(accum[-1])
    found_key, found_pos = [], []
    for s in range(0, total, chunk):
        p = torch.arange(s, min(s + chunk, total), dtype=torch.int64, device=q.device)
        u = torch.searchsorted(accum, p, right=True) - 1
        inside = p + k <= accum[u + 1]
        c = canonical(kmer_at(layout.words, p, k), k)
        idx = torch.searchsorted(keys, c).clamp_(max=keys.shape[0] - 1)
        hit = inside & (keys[idx] == c)
        hk, hp = idx[hit], p[hit]
        counts.index_add_(0, hk, torch.ones_like(hk))
        first.scatter_reduce_(0, hk, hp, "amin")
        found_key.append(hk)
        found_pos.append(hp)
    cnt = counts[inv]
    out = Located(cnt, torch.where(cnt > 0, first[inv], -1))
    multi = torch.nonzero(counts > 1).reshape(-1)
    if multi.numel():
        fk, fp = torch.cat(found_key), torch.cat(found_pos)
        for key in multi.tolist():
            where = fp[fk == key].sort().values.tolist()
            for lane in torch.nonzero(inv == key).reshape(-1).tolist():
                out.more[lane] = where
    return out


def answer(layout: Layout, q: torch.Tensor, pos: torch.Tensor) -> dict:
    """The answer fields of lanes ``q`` whose k-mer lies at genome position
    ``pos`` (-1: a miss): unitig_id, pos (offset in the unitig), unitig_len
    and mt."""
    hit = pos >= 0
    p = torch.where(hit, pos, 0)
    uid = torch.searchsorted(layout.accum, p, right=True) - 1
    kpos = p - layout.accum[uid]
    fw = kmer_at(layout.words, p, layout.k)
    mt = torch.where(q == fw, 1, 2)
    zero = torch.zeros_like(p)
    return {
        "hit": hit,
        "unitig_id": torch.where(hit, uid, zero),
        "pos": torch.where(hit, kpos, zero),
        "unitig_len": torch.where(hit, layout.accum[uid + 1] - layout.accum[uid], zero),
        "mt": torch.where(hit, mt, zero),
    }


def occurrence_sum(layout: Layout, a: dict, max_occs: int | None = None) -> torch.Tensor:
    """Per lane, the sum of reference id and reference position over the
    occurrences of its unitig, at most ``max_occs`` of them (all by
    default). A forward occurrence at ``occ_pos`` puts the k-mer at offset
    ``pos`` of the unitig at ``occ_pos + pos``, a reverse one at ``occ_pos +
    unitig_len - pos - k``."""
    start = layout.offsets[a["unitig_id"]]
    n = torch.where(a["hit"], layout.offsets[a["unitig_id"] + 1] - start, 0)
    top = layout.occ_ref.shape[0] - 1
    s = torch.zeros_like(start)
    for j in range(layout.max_occs if max_occs is None else min(max_occs, layout.max_occs)):
        i = (start + j).clamp(max=top)
        rp = torch.where(layout.occ_o[i] == 1, layout.occ_pos[i] + a["pos"],
                         layout.occ_pos[i] + a["unitig_len"] - a["pos"] - layout.k)
        s = s + torch.where(j < n, layout.occ_ref[i] + rp, 0)
    return s


def orientations(layout: Layout, a: dict) -> list:
    """Per lane, the list of (reference, position, forward) of every
    occurrence (host lists; for tests and debugging)."""
    out = []
    off = layout.offsets.tolist()
    for h, u, p, ln, mt in zip(*(a[kk].tolist() for kk in ("hit", "unitig_id", "pos",
                                                              "unitig_len", "mt"))):
        occ = []
        if h:
            for i in range(off[u], off[u + 1]):
                o = int(layout.occ_o[i])
                rp = int(layout.occ_pos[i]) + (p if o == 1 else ln - p - layout.k)
                occ.append((int(layout.occ_ref[i]), rp, int((o == 1) == (mt == 1))))
        out.append(occ)
    return out
