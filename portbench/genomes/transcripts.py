"""A transcript set as an annotation gives it, and its compacted de Bruijn
graph, made from the seed.

The gene models (the annotation) are drawn once, from the configuration's
``annotation_seed``: ``n_genes`` genes, their numbers of transcripts
following a geometric law with mean ``transcripts_per_gene`` and their
numbers of distinct exons one with mean ``exons_per_gene`` (at most
``exons_max``), each taken at the quantiles (i + 1/2) / n_genes, the exon
counts shuffled over the genes, a single exon only to a gene of one
transcript. A gene's first transcript holds all its exons; each other one
holds each exon with probability ``exon_kept``, at least one and not all,
in the gene's order. An exon is ``k`` bases plus a geometric number with
mean ``exon_len_mean - k``, at most ``exon_len_max`` in all.

The run's seed orders the genes and draws every exon's bases, at random
on the device. So every seed has the same sizes and sharing, and with them
the same work. A transcript is its exons' bases in turn, forward.

The unitigs are the maximal unitigs of the transcripts' k-mers, as a
compacted reference graph gives them, where each transcript's first and
last k-mer ends a unitig (``tiling``). Each unitig occurs, whole and
forward, on every transcript that passes through it, and consecutive
unitigs on a transcript overlap by k - 1 bases.
"""

from __future__ import annotations

import numpy as np
import torch

from ..genome import Genome, pack_codes, random_words, streams, torch_generator
from ..reference.kmers import bases_at, kmer_at


def quantiles(n: int, mean: float) -> np.ndarray:
    """The geometric law on 1, 2, ... with this mean at the quantiles
    (i + 1/2) / n."""
    u = (np.arange(n) + 0.5) / n
    return 1 + np.floor(np.log1p(-u) / np.log1p(-1.0 / mean)).astype(np.int64)


def segments(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenation of ``arange(s, s + n)`` over (start, length)."""
    total = int(lens.sum())
    first = np.repeat(np.cumsum(lens) - lens, lens)
    return np.arange(total, dtype=np.int64) - first + np.repeat(starts, lens)


def transcripts(cfg: dict, seed: int) -> dict:
    """The gene models of the configuration, in the order that ``seed``
    gives the genes: per transcript entry (in transcript order, each
    transcript's exons in turn) its transcript ``te_tx`` and exon
    ``te_exon``, and per exon its length. The models themselves come from
    the configuration's ``annotation_seed``, so every seed has the same
    ones, as every user of one annotation has."""
    k, G = int(cfg["k"]), int(cfg["n_genes"])
    r_perm, r_len, r_pick = streams(int(cfg["annotation_seed"]), 3)
    t = quantiles(G, float(cfg["transcripts_per_gene"]))
    q = np.minimum(quantiles(G, float(cfg["exons_per_gene"])), int(cfg["exons_max"]))
    n1 = int((q == 1).sum())
    single = np.zeros(G, dtype=bool)
    single[r_perm.choice(np.flatnonzero(t == 1), n1, replace=False)] = True
    e = np.ones(G, dtype=np.int64)
    e[~single] = r_perm.permutation(q[n1:])
    n_ex = int(e.sum())
    grow = r_len.geometric(1.0 / (float(cfg["exon_len_mean"]) - k + 1), n_ex) - 1
    exon_len = k + np.minimum(grow, int(cfg["exon_len_max"]) - k)
    exon_first = np.cumsum(e) - e

    # one row a transcript over its gene's exons: keep or not
    tx_gene = np.repeat(np.arange(G), t)
    row_len = e[tx_gene]
    row_start = np.cumsum(row_len) - row_len
    first_tx = np.zeros(len(tx_gene), dtype=bool)
    first_tx[np.cumsum(t) - t] = True
    keep = r_pick.random(int(row_len.sum())) < float(cfg["exon_kept"])
    keep[np.repeat(first_tx, row_len)] = True
    n_kept = np.add.reduceat(keep, row_start)
    alt = ~first_tx
    fix = np.flatnonzero(alt & ((n_kept == 0) | (n_kept == row_len)))
    at = row_start[fix] + (r_pick.random(len(fix)) * row_len[fix]).astype(np.int64)
    keep[at] = n_kept[fix] == 0
    cell = np.flatnonzero(keep)
    row = np.repeat(np.arange(len(tx_gene)), row_len)[cell]
    te_exon = exon_first[tx_gene[row]] + (cell - row_start[row])

    # the seed's order of the genes, each gene's exons and transcripts kept
    # in their order
    place = streams(seed, 4)[0].permutation(G)
    exon_gene = np.repeat(np.arange(G), e)
    exon_order = np.argsort(place[exon_gene], kind="stable")
    tx_order = np.argsort(place[tx_gene], kind="stable")
    exon_new = np.empty(n_ex, dtype=np.int64)
    exon_new[exon_order] = np.arange(n_ex)
    tx_new = np.empty(len(tx_gene), dtype=np.int64)
    tx_new[tx_order] = np.arange(len(tx_gene))
    te_tx = tx_new[row]
    order = np.argsort(te_tx, kind="stable")
    return {
        "te_tx": te_tx[order],
        "te_exon": exon_new[te_exon][order],
        "exon_len": exon_len[exon_order],
        "n_tx": len(tx_gene),
    }


def _lookup(vals: torch.Tensor, table: torch.Tensor, x: torch.Tensor, other):
    """``table`` at ``x``'s place in the sorted ``vals``, ``other`` where
    ``x`` is not among them."""
    i = torch.searchsorted(vals, x).clamp_(max=vals.shape[0] - 1)
    return torch.where(vals[i] == x, table[i], other)


def tiling(k: int, words: torch.Tensor, ref_accum: torch.Tensor,
           junctions: torch.Tensor) -> dict:
    """The maximal unitigs of the references (packed ``words``, bounds
    ``ref_accum``) whose exons meet at the base positions ``junctions``:
    per occurrence, its first base and length on the concatenated
    references, and its first k-mer, which names its unitig.

    A k-mer that lies inside an exon, apart from the exon's first and
    last, occurs nowhere else, so it has one predecessor and one successor
    and its unitig runs on through it. Only around a junction (the k + 1
    k-mers from the first exon's last to the second's first) and at a
    reference's ends can a unitig end: there the k-mers' successors and
    predecessors are counted over every reference, and a unitig ends
    after a k-mer with more or fewer than one successor, before one with
    more or fewer than one predecessor, and at each reference's first and
    last k-mer."""
    dev = words.device
    starts, ends = ref_accum[:-1], ref_accum[1:] - k  # first and last k-mer
    d = torch.arange(k + 1, device=dev)
    z = torch.unique(torch.cat([(junctions[:, None] - k + d).reshape(-1), starts, ends]))
    ref = torch.searchsorted(ref_accum, z, right=True) - 1
    v = kmer_at(words, z, k)
    nxt_ok, prv_ok = z < ends[ref], z > starts[ref]
    vn = kmer_at(words, torch.where(nxt_ok, z + 1, z), k)
    vp = kmer_at(words, torch.where(prv_ok, z - 1, z), k)
    pairs = torch.cat([torch.stack([v, vn], 1)[nxt_ok], torch.stack([vp, v], 1)[prv_ok]])
    pairs = pairs[torch.argsort(pairs[:, 1], stable=True)]
    pairs = pairs[torch.argsort(pairs[:, 0], stable=True)]
    pairs = pairs[torch.cat([pairs.new_ones(1, dtype=torch.bool),
                             (pairs[1:] != pairs[:-1]).any(dim=1)])]
    vals = torch.unique(v)

    def degree(col):
        x = pairs[:, col].contiguous()
        i = torch.searchsorted(vals, x).clamp_(max=vals.shape[0] - 1)
        hit = vals[i] == x
        return torch.bincount(i[hit], minlength=vals.shape[0])

    outdeg, indeg = degree(0), degree(1)
    no = torch.zeros_like(vals, dtype=torch.bool)
    first = no.clone()
    first[torch.searchsorted(vals, kmer_at(words, starts, k))] = True
    last = no.clone()
    last[torch.searchsorted(vals, kmer_at(words, ends, k))] = True

    def joined(x, y):
        return ((_lookup(vals, outdeg, x, 1) == 1) & (_lookup(vals, indeg, y, 1) == 1)
                & ~_lookup(vals, last, x, False) & ~_lookup(vals, first, y, False))

    breaks = torch.unique(torch.cat([starts, (z + 1)[nxt_ok & ~joined(v, vn)],
                                     z[prv_ok & ~joined(vp, v)]]))
    ref = torch.searchsorted(ref_accum, breaks, right=True) - 1
    stop = torch.minimum(torch.cat([breaks[1:], ref_accum[-1:]]), ends[ref] + 1)
    return {"start": breaks, "len": stop - breaks + k - 1, "ref": ref,
            "key": kmer_at(words, breaks, k)}


def make(cfg: dict, seed: int, device) -> Genome:
    """The transcript set of ``cfg`` for ``seed``, its bases on ``device``."""
    k = int(cfg["k"])
    m = transcripts(cfg, seed)
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)  # noqa: E731

    # exon bases, then the transcripts' bases gathered from them
    exon_len = m["exon_len"]
    exon_start = np.cumsum(exon_len) - exon_len
    gen = torch_generator(streams(seed, 4)[3], dev)
    exome = torch.cat([random_words(-(-int(exon_len.sum()) // 32), gen, dev),
                       torch.zeros(1, dtype=torch.int64, device=dev)])
    te_tx, te_len = m["te_tx"], exon_len[m["te_exon"]]
    ref_words = pack_codes(bases_at(exome, as_t(segments(exon_start[m["te_exon"]], te_len))))
    del exome
    ref_accum = np.r_[0, np.cumsum(np.bincount(te_tx, weights=te_len).astype(np.int64))]
    te_start = np.cumsum(te_len) - te_len
    junctions = te_start[1:][te_tx[1:] == te_tx[:-1]]
    t = tiling(k, ref_words, as_t(ref_accum), as_t(junctions))

    # one unitig a first k-mer, its bases read off its first occurrence
    keys, first, uid = np.unique(t["key"].cpu().numpy(), return_index=True, return_inverse=True)
    lens = t["len"].cpu().numpy()
    ulen = lens[first]
    if not np.array_equal(ulen[uid], lens):
        raise RuntimeError("a unitig's occurrences differ in length")
    accum = np.r_[0, np.cumsum(ulen)].astype(np.int64)
    src = segments(t["start"].cpu().numpy()[first], ulen)
    words = pack_codes(bases_at(ref_words, as_t(src)))
    del src

    ref, start = t["ref"].cpu().numpy(), t["start"].cpu().numpy()
    order = np.argsort(uid, kind="stable")
    offsets = np.r_[0, np.cumsum(np.bincount(uid, minlength=len(keys)))].astype(np.int64)
    return Genome(
        k=k, n_bases=int(accum[-1]),
        words=words, host_words=words.cpu().numpy().view(np.uint64),
        accum=accum,
        ref_words=ref_words, ref_host_words=ref_words.cpu().numpy().view(np.uint64),
        ref_accum=ref_accum,
        occ_uid=uid[order].astype(np.int64), occ_ref=ref[order],
        occ_pos=(start - ref_accum[ref])[order],
        occ_o=np.ones(len(order), dtype=np.int64), offsets=offsets,
    )
