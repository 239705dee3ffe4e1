"""The reference's checksums of the answers that the timed passes return.

The program's passes reduce each chunk of answers to sums on the device
and return those. The reference computes the same sums from its own
answers (``lookup``), so a batch's result is compared whole, exactly.

A k-mer lane contributes its unitig id and offset and, over every
occurrence of its unitig, the reference id and the reference position; a
miss contributes nothing. The k-mer cells also compare, per batch, a sum
that weighs each lane's unitig id, offset and orientation by its place in
the batch: ``(lane + 1) * (2 * (unitig_id + pos) + (mt == 2))``, so an
answer moved to another lane or read in the wrong orientation changes it.

A read chunk gives two sums: the k-mer lanes' as above, over every window
of every read (a window with a non-ACGT base is queried as the word 0, as
the program's k-merizer hands it on), and the pseudoalignment's: each
read's references are those that every hitting valid window's unitig
occurs on, as a bitset (bit r of word w is reference 64 w + r), and the
sum runs over the int64 words of every read's bitset, plus every read's
count of hitting windows.

Sums wrap as int64. Where some k-mer has two right answers, a batch has
one right sum for each choice.
"""

from __future__ import annotations

import itertools

import torch

from .kmers import words_of_codes
from .lookup import Layout, answer, occurrence_sum

MAX_CHOICES = 1 << 12


def wrap(x: int) -> int:
    """``x`` as a signed 64-bit integer."""
    return ((int(x) + (1 << 63)) % (1 << 64)) - (1 << 63)


def _sumset(sums: set, deltas) -> set:
    out = {tuple(wrap(a + b) for a, b in zip(s, d)) for s in sums for d in deltas}
    if len(out) > MAX_CHOICES:
        raise RuntimeError(f"more than {MAX_CHOICES} right sums: the genome repeats too many k-mers")
    return out


def lane_values(layout: Layout, q: torch.Tensor, pos: torch.Tensor,
                max_occs: int | None = None) -> torch.Tensor:
    """Each lane's share of a chunk's sum: its answer's unitig id and
    offset and, over its occurrences, reference ids and positions.
    ``max_occs`` counts at most that many occurrences (the control)."""
    a = answer(layout, q, pos)
    return a["unitig_id"] + a["pos"] + occurrence_sum(layout, a, max_occs)


def lane_term(uid: torch.Tensor, pos: torch.Tensor, mt: torch.Tensor,
              lane: torch.Tensor) -> torch.Tensor:
    """Each lane's place-weighted term: ``(lane + 1) * (2 * (unitig_id +
    pos) + (mt == 2))``, 0 for a miss."""
    return (lane + 1) * (2 * (uid + pos) + (mt == 2).to(uid.dtype))


def _terms(layout, q, pos, lane):
    a = answer(layout, q, pos)
    return lane_term(a["unitig_id"], a["pos"], a["mt"], lane)


def kmer_sums(layout: Layout, pool: torch.Tensor, loc, max_occs: int | None = None) -> list:
    """The right (pass sum, place-weighted sum) pairs, a set each, of each
    batch of a [P, CH, N] pool of k-mer words, from ``locate``'s result over
    the flattened pool."""
    P, CH, N = pool.shape
    q = pool.reshape(-1)
    lane = torch.arange(CH * N, device=q.device).repeat(P)
    v = lane_values(layout, q, loc.first, max_occs=max_occs)
    w = _terms(layout, q, loc.first, lane)
    sums = [{(wrap(s), wrap(t))} for s, t in zip(v.reshape(P, -1).sum(dim=1).tolist(),
                                                  w.reshape(P, -1).sum(dim=1).tolist())]
    for flat, where in loc.more.items():
        b = flat // (CH * N)
        one = q[flat : flat + 1].expand(len(where))
        at = torch.tensor(where, device=q.device)
        dv = lane_values(layout, one, at, max_occs=max_occs) - v[flat]
        dw = _terms(layout, one, at, lane[flat : flat + 1].expand(len(where))) - w[flat]
        sums[b] = _sumset(sums[b], set(zip(dv.tolist(), dw.tolist())))
    return sums


def color_bits(layout: Layout, n_refs: int) -> torch.Tensor:
    """[n_unitigs + 1, W] int64 bitsets of the references each unitig
    occurs on (the last row empty)."""
    W = max(1, -(-n_refs // 64))
    n_u = layout.offsets.shape[0] - 1
    uid = torch.repeat_interleave(torch.arange(n_u, device=layout.offsets.device),
                                  layout.offsets[1:] - layout.offsets[:-1])
    pair = torch.unique(uid * n_refs + layout.occ_ref)
    u, r = pair // n_refs, pair % n_refs
    bits = torch.zeros((n_u + 1) * W, dtype=torch.int64, device=uid.device)
    # each (unitig, reference) bit once, so the sum sets it
    bits.index_add_(0, u * W + r // 64, torch.ones_like(r) << (r % 64))
    return bits.reshape(n_u + 1, W)


def read_lanes(codes: torch.Tensor, k: int):
    """([R, L] k-mer words, [R, L] valid) of [R, read_len] base codes (4 for
    a non-ACGT base): a window holding such a base is invalid and queried
    as the word 0."""
    bad = codes > 3
    words = words_of_codes(torch.where(bad, 0, codes), k)
    L = words.shape[1]
    nbad = torch.cumsum(torch.nn.functional.pad(bad.to(torch.int64), (1, 0)), dim=1)
    valid = nbad[:, k : k + L] == nbad[:, :L]
    return torch.where(valid, words, 0), valid


def _read_sums(layout, ubits, q, pos, valid, max_occs):
    """(k-mer sum, pseudoalignment sum) of reads [R, L] whose lanes lie at
    ``pos``."""
    R, L = q.shape
    flat = q.reshape(-1)
    m = lane_values(layout, flat, pos.reshape(-1), max_occs=max_occs).sum()
    a = answer(layout, flat, pos.reshape(-1))
    hit = a["hit"].reshape(R, L) & valid
    rows = ubits[torch.where(hit, a["unitig_id"].reshape(R, L), ubits.shape[0] - 1)]
    acc = torch.full_like(rows[:, 0], -1)
    for j in range(L):
        acc = torch.where(hit[:, j, None], acc & rows[:, j], acc)
    n_hit = hit.sum(dim=1)
    acc = torch.where((n_hit > 0)[:, None], acc, 0)
    return int(m), int(acc.sum() + n_hit.sum())


def read_sums(layout: Layout, ubits: torch.Tensor, words: torch.Tensor, valid: torch.Tensor,
              loc, reads_per_chunk: int, max_occs: int | None = None) -> list:
    """The right (map, pseudoalignment) sums of each chunk of
    ``reads_per_chunk`` reads of [R, L] lanes, a set each, from ``locate``'s
    result over the flattened lanes."""
    R, L = words.shape
    first = loc.first.reshape(R, L)
    out = []
    for r0 in range(0, R, reads_per_chunk):
        sl = slice(r0, r0 + reads_per_chunk)
        base = _read_sums(layout, ubits, words[sl], first[sl], valid[sl], max_occs)
        sums = {(wrap(base[0]), wrap(base[1]))}
        reads = sorted({f // L for f in loc.more if r0 <= f // L < r0 + reads_per_chunk})
        for r in reads:
            lanes = [f for f in range(r * L, (r + 1) * L) if f in loc.more]
            one = _read_sums(layout, ubits, words[r : r + 1], first[r : r + 1],
                             valid[r : r + 1], max_occs)
            deltas = set()
            for choice in itertools.product(*(loc.more[f] for f in lanes)):
                pos = first[r : r + 1].clone()
                for f, p in zip(lanes, choice):
                    pos[0, f - r * L] = p
                alt = _read_sums(layout, ubits, words[r : r + 1], pos, valid[r : r + 1],
                                 max_occs)
                deltas.add((alt[0] - one[0], alt[1] - one[1]))
            sums = {(wrap(a + d0), wrap(b + d1)) for a, b in sums for d0, d1 in deltas}
            if len(sums) > MAX_CHOICES:
                raise RuntimeError(f"more than {MAX_CHOICES} right sums in a chunk")
        out.append(sums)
    return out
