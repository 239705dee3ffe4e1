"""The reference's read sums for genomes whose unitigs occur thousands of
times: each lane's occurrence sum in closed form.

``checksums.read_sums`` sums a lane's occurrences one column at a time, up
to the genome's largest occurrence count, which on a genome with repeats
is tens of thousands of passes. Here each unitig's occurrences are summed
once over the occurrence table (``unitig_sums``): the sum of their
reference ids, the sum of their positions, and how many are forward and
how many reverse. A forward occurrence at ``occ_pos`` puts the k-mer at
offset ``pos`` of the unitig at ``occ_pos + pos``, a reverse one at
``occ_pos + unitig_len - pos - k``, so a lane's occurrence sum is

    refs[u] + poss[u] + n_fw[u] * pos + n_rev[u] * (unitig_len - pos - k),

the same number as ``lookup.occurrence_sum`` with no cap, and independent
of the program's per-occurrence projection. Each occurrence also adds its
orientation (1 where the k-mer reads the reference forward: a forward
occurrence of a lane that matches its unitig as is, or a reverse one of a
lane that matches its reverse complement) and twice the lane's k-mer
word ``q``, so a lane adds ``n_fw[u]`` or ``n_rev[u]``, and ``2 * q *
(n_fw[u] + n_rev[u])``: the orientation of every occurrence and the k-mer
it answers are in the sum. All sums wrap as int64.

``read_sums`` is ``checksums.read_sums`` with that lane value: the same
(map, pseudoalignment) sums of each chunk, a set each, from ``locate``'s
result. It reuses ``lookup.locate`` and ``lookup.answer`` and
``checksums.color_bits``.
"""

from __future__ import annotations

import itertools

import torch

from .checksums import MAX_CHOICES, wrap
from .lookup import Layout, answer


def unitig_sums(layout: Layout) -> dict:
    """Per unitig, int64: ``refs`` (its occurrences' reference ids summed),
    ``poss`` (their positions summed), ``n_fw`` and ``n_rev``."""
    n_u = layout.offsets.shape[0] - 1
    dev = layout.offsets.device
    uid = torch.repeat_interleave(torch.arange(n_u, device=dev),
                                  layout.offsets[1:] - layout.offsets[:-1])
    out = {}
    fw = (layout.occ_o == 1).to(torch.int64)
    for key, v in (("refs", layout.occ_ref), ("poss", layout.occ_pos), ("n_fw", fw),
                   ("n_rev", 1 - fw)):
        out[key] = torch.zeros(n_u, dtype=torch.int64, device=dev).index_add_(0, uid, v)
    return out


def lane_values(layout: Layout, sums: dict, q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Each lane's share of a chunk's map sum: unitig id, offset, and its
    occurrences' reference ids, positions and orientations and twice its
    k-mer word ``q`` each (0 for a miss)."""
    a = answer(layout, q, pos)
    u, p = a["unitig_id"], a["pos"]
    n_fw, n_rev = sums["n_fw"][u], sums["n_rev"][u]
    occ = sums["refs"][u] + sums["poss"][u] + n_fw * p + n_rev * (a["unitig_len"] - p - layout.k)
    orient = torch.where(a["mt"] == 1, n_fw, n_rev)
    return torch.where(a["hit"], u + p + occ + orient + 2 * q * (n_fw + n_rev), 0)


def _read_sums(layout, sums, ubits, q, pos, valid):
    """(k-mer sum, pseudoalignment sum) of reads [R, L] whose lanes lie at
    ``pos``."""
    R, L = q.shape
    flat = q.reshape(-1)
    m = lane_values(layout, sums, flat, pos.reshape(-1)).sum()
    a = answer(layout, flat, pos.reshape(-1))
    hit = a["hit"].reshape(R, L) & valid
    rows = ubits[torch.where(hit, a["unitig_id"].reshape(R, L), ubits.shape[0] - 1)]
    acc = torch.full_like(rows[:, 0], -1)
    for j in range(L):
        acc = torch.where(hit[:, j, None], acc & rows[:, j], acc)
    n_hit = hit.sum(dim=1)
    acc = torch.where((n_hit > 0)[:, None], acc, 0)
    return int(m), int(acc.sum() + n_hit.sum())


def read_sums(layout: Layout, sums: dict, ubits: torch.Tensor, words: torch.Tensor,
              valid: torch.Tensor, loc, reads_per_chunk: int) -> list:
    """The right (map, pseudoalignment) sums of each chunk of
    ``reads_per_chunk`` reads of [R, L] lanes, a set each, from ``locate``'s
    result over the flattened lanes: ``checksums.read_sums`` with the
    closed-form lane value."""
    R, L = words.shape
    first = loc.first.reshape(R, L)
    out = []
    for r0 in range(0, R, reads_per_chunk):
        sl = slice(r0, r0 + reads_per_chunk)
        base = _read_sums(layout, sums, ubits, words[sl], first[sl], valid[sl])
        right = {(wrap(base[0]), wrap(base[1]))}
        reads = sorted({f // L for f in loc.more if r0 <= f // L < r0 + reads_per_chunk})
        for r in reads:
            lanes = [f for f in range(r * L, (r + 1) * L) if f in loc.more]
            one = _read_sums(layout, sums, ubits, words[r : r + 1], first[r : r + 1],
                             valid[r : r + 1])
            deltas = set()
            for choice in itertools.product(*(loc.more[f] for f in lanes)):
                pos = first[r : r + 1].clone()
                for f, p in zip(lanes, choice):
                    pos[0, f - r * L] = p
                alt = _read_sums(layout, sums, ubits, words[r : r + 1], pos, valid[r : r + 1])
                deltas.add((alt[0] - one[0], alt[1] - one[1]))
            right = {(wrap(a + d0), wrap(b + d1)) for a, b in right for d0, d1 in deltas}
            if len(right) > MAX_CHOICES:
                raise RuntimeError(f"more than {MAX_CHOICES} right sums in a chunk")
        out.append(right)
    return out
