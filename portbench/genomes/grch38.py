"""A genome shaped as GRCh38's primary chromosomes with the human genome's
repeats, and its compacted de Bruijn graph, made from the seed.

The chromosomes are the configuration's (``chromosomes``: name and length,
every length and copy count times ``scale``), laid end to end; every base
is A, C, G or T. Into unique sequence go, at uniform places:

- the copies of each interspersed family (``families``): ``copies`` of
  them, their lengths an exponential law capped at the consensus length
  whose mean puts the family's ``share`` of the genome in its copies; a
  ``3prime`` family's copy is the last bases of the consensus, an ``any``
  family's a uniform window of it; each copy forward or reverse-
  complemented, with a substitution rate drawn from a gamma law of shape
  ``divergence_shape`` around the family's ``divergence``;
- simple sequence repeats (``ssr``): tandem arrays of a motif drawn
  uniformly among the primitive words of period 1 to ``period_max``, of
  ``len_min`` bases plus a geometric length, ``share`` of the genome;
- segmental duplications (``segdup``): copies of a stretch of the genome
  (as it stands before any such copy is written) of a log-uniform length
  in [``len_min``, ``len_max``], forward or reverse, at a uniform identity
  in [``identity_min``, ``identity_max``], until its copies hold half of
  ``share`` (the sources hold the other half).

A substituted base is replaced by the base 1 to 3 codes on, mod 4. The
annotation (every element's kind, place, length, orientation, consensus
window, rate, motif or source) is drawn once from the configuration's
``annotation_seed``, and whether a base of an element is substituted, and
by what, is a hash of that seed and the base's place: so every run's seed
has the same repeats, and the same multiplicities and work but where a
random base happens to extend a repeat. The run's seed draws the bases:
the consensus sequences and the unique sequence, on the device.

The unitigs are the maximal unitigs of the chromosomes' canonical k-mers,
as a compacted reference de Bruijn graph gives them (``tiling``): each
chromosome's first and last k-mer ends a unitig, and every distinct
canonical k-mer lies in exactly one unitig. A unitig occurs on the
chromosomes forward or reverse-complemented, and consecutive occurrences
on a chromosome overlap by k - 1 bases.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..genome import Genome, random_words, streams, torch_generator
from ..reference.kmers import bases_at, canonical, kmer_at, srl

FAMILY, SSR, SEGDUP = 0, 1, 2
CHUNK = 1 << 26  # positions a step of the device passes
PARTITIONS = 16  # hash partitions of the canonical k-mers, sorted one at a time

_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_POP4 = (0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finaliser of int64 words (wrapping arithmetic)."""
    x = x + _GOLDEN
    x = (x ^ srl(x, 30)) * _MIX1
    x = (x ^ srl(x, 27)) * _MIX2
    return x ^ srl(x, 31)


def exp_mean(mean: float, cap: int) -> float:
    """The mean of an exponential law X such that ``min(ceil(X), cap)`` has
    mean ``mean`` (bisection)."""
    if not 1.0 < mean < cap:
        raise ValueError(f"a mean copy length of {mean:.1f} does not fit a consensus of {cap}")
    lo, hi = 1e-3, 1e9
    for _ in range(200):
        mu = math.sqrt(lo * hi)
        if mu * -math.expm1(-cap / mu) + 0.5 < mean:
            lo = mu
        else:
            hi = mu
    return mu


def primitive_motifs(pmax: int) -> tuple:
    """(codes, periods) of every word of period 1 to ``pmax`` that is no
    power of a shorter word, base i of a code at bits [2i, 2i + 2)."""
    codes, periods = [], []
    for p in range(1, pmax + 1):
        w = np.arange(4 ** p, dtype=np.int64)
        digits = (w[:, None] >> (2 * np.arange(p))) & 3
        prim = np.ones(len(w), dtype=bool)
        for d in range(1, p):
            if p % d == 0:
                prim &= ~(digits == np.roll(digits, -d, axis=1)).all(axis=1)
        codes.append(w[prim])
        periods.append(np.full(int(prim.sum()), p, dtype=np.int64))
    return np.concatenate(codes), np.concatenate(periods)


def annotation(cfg: dict) -> dict:
    """The genome's layout from the configuration's ``annotation_seed``:
    chromosome lengths, the families' consensus lengths, and per element
    (in genome order) its ``kind``, ``start``, ``len``, ``rev``, ``rate``
    (substitutions a base), ``fam``, ``lo`` (a family copy's first
    consensus base, an array's motif code, a duplication's source) and
    ``period`` (an array's)."""
    scale = float(cfg.get("scale", 1.0))
    names = [c[0] for c in cfg["chromosomes"]]
    lens = np.array([max(int(round(c[1] * scale)), 2 * int(cfg["k"]))
                     for c in cfg["chromosomes"]], dtype=np.int64)
    G = int(lens.sum())
    r_fam, r_ssr, r_dup, r_place = streams(int(cfg["annotation_seed"]), 4)
    cols = {key: [] for key in ("kind", "len", "rev", "rate", "fam", "lo", "period")}

    def add(kind, length, rev, rate, fam, lo, period):
        n = len(length)
        for key, v in (("kind", np.full(n, kind)), ("len", length), ("rev", rev),
                       ("rate", rate), ("fam", np.full(n, fam) if np.isscalar(fam) else fam),
                       ("lo", lo), ("period", period)):
            cols[key].append(np.asarray(v))

    shape = float(cfg["divergence_shape"])
    fam_len = []
    for f, fam in enumerate(cfg["families"]):
        n = max(1, int(round(fam["copies"] * scale)))
        C = int(fam["consensus"])
        fam_len.append(C)
        mu = exp_mean(fam["share"] * G / n, C)
        length = np.minimum(np.ceil(r_fam.exponential(mu, n)).astype(np.int64), C)
        if fam["anchor"] == "3prime":
            lo = C - length
        else:
            lo = np.floor(r_fam.random(n) * (C - length + 1)).astype(np.int64)
        rate = np.minimum(r_fam.gamma(shape, fam["divergence"] / shape, n), 0.5)
        add(FAMILY, length, r_fam.random(n) < 0.5, rate, f, lo, np.zeros(n, dtype=np.int64))

    s = cfg["ssr"]
    motif, period = primitive_motifs(int(s["period_max"]))
    lmin, lmean = int(s["len_min"]), float(s["len_mean"])
    n = max(1, int(round(s["share"] * G / lmean)))
    length = lmin + r_ssr.geometric(1.0 / (lmean - lmin + 1), n) - 1
    pick = r_ssr.integers(0, len(motif), n)
    add(SSR, length, np.zeros(n, dtype=bool), np.zeros(n), -1, motif[pick], period[pick])

    d = cfg["segdup"]
    target = d["share"] * G / 2
    lo_l, hi_l = math.log(d["len_min"]), math.log(d["len_max"])
    est = max(1, int(2 * target / ((d["len_max"] - d["len_min"]) / (hi_l - lo_l))) + 8)
    length = np.exp(r_dup.uniform(lo_l, hi_l, est)).astype(np.int64)
    n = int(np.searchsorted(np.cumsum(length), target)) + 1
    length = length[:n]
    ident = r_dup.uniform(d["identity_min"], d["identity_max"], n)
    src = np.floor(r_dup.random(n) * (G - length)).astype(np.int64)
    add(SEGDUP, length, r_dup.random(n) < 0.5, 1.0 - ident, -1, src, np.zeros(n, dtype=np.int64))

    el = {key: np.concatenate(v) for key, v in cols.items()}
    order = r_place.permutation(len(el["len"]))
    el = {key: v[order] for key, v in el.items()}
    E = int(el["len"].sum())
    if E >= G:
        raise ValueError(f"the elements hold {E} of the genome's {G} bases")
    gaps = r_place.exponential(1.0, len(order) + 1)
    cut = np.floor(np.cumsum(gaps) / gaps.sum() * (G - E)).astype(np.int64)
    cut[-1] = G - E
    gap = np.diff(np.concatenate([[0], cut]))
    el["start"] = np.cumsum(gap[:-1]) + np.concatenate([[0], np.cumsum(el["len"])[:-1]])
    el["rate"] = el["rate"].astype(np.float64)
    el["rev"] = el["rev"].astype(bool)
    return {"names": names, "lens": lens, "fam_len": np.array(fam_len, dtype=np.int64),
            "elements": el}


def _t(a, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _substitute(base: torch.Tensor, p: torch.Tensor, thr: torch.Tensor, salt: int):
    """``base`` with the bases at places ``p`` whose hash falls below ``thr``
    (out of 2^32) moved 1 to 3 codes on."""
    h = mix64(p * 8 + salt)
    sub = (h & 0xFFFFFFFF) < thr
    step = 1 + (srl(h, 32) & 0xFFFF) % 3
    return torch.where(sub, (base + step) & 3, base)


def bases(cfg: dict, ann: dict, seed: int, device) -> torch.Tensor:
    """uint8 [G] base codes of the genome for ``seed`` on ``device``."""
    dev = torch.device(device)
    el = ann["elements"]
    G = int(ann["lens"].sum())
    salt = int(cfg["annotation_seed"]) * 4
    gen = torch_generator(streams(seed, 2)[1], dev)
    unique = random_words(-(-G // 32) + 1, gen, dev)
    fam_first = np.concatenate([[0], np.cumsum(ann["fam_len"])])
    cons = random_words(-(-int(fam_first[-1]) // 32) + 1, gen, dev)
    start, end = _t(el["start"], dev), _t(el["start"] + el["len"], dev)
    kind, rev = _t(el["kind"], dev), _t(el["rev"], dev, torch.bool)
    thr = _t(np.round(el["rate"] * 2.0 ** 32), dev)
    lo, period, length = _t(el["lo"], dev), _t(el["period"], dev), _t(el["len"], dev)
    cfirst = _t(fam_first[np.maximum(el["fam"], 0)], dev)
    out = torch.empty(G, dtype=torch.uint8, device=dev)
    for a in range(0, G, CHUNK):
        p = torch.arange(a, min(a + CHUNK, G), dtype=torch.int64, device=dev)
        b = bases_at(unique, p)
        e = (torch.searchsorted(start, p, right=True) - 1).clamp_(min=0)
        off = p - start[e]
        inside = (p >= start[e]) & (p < end[e])
        fam = inside & (kind[e] == FAMILY)
        r = rev[e]
        cpos = cfirst[e] + torch.where(r, lo[e] + length[e] - 1 - off, lo[e] + off)
        c = bases_at(cons, torch.where(fam, cpos, 0))
        c = _substitute(torch.where(r, 3 - c, c), p, thr[e], salt + FAMILY)
        b = torch.where(fam, c, b)
        ssr = inside & (kind[e] == SSR)
        m = srl(lo[e], 2 * (off % period[e].clamp(min=1))) & 3
        out[a : a + p.shape[0]] = torch.where(ssr, m, b).to(torch.uint8)
    # segmental duplications read the genome as it stands before them
    dup = np.flatnonzero(el["kind"] == SEGDUP)
    if len(dup):
        n = el["len"][dup]
        first = np.repeat(np.cumsum(n) - n, n)
        off = _t(np.arange(int(n.sum()), dtype=np.int64) - first, dev)
        which = _t(np.repeat(dup, n), dev)
        p = start[which] + off
        src = lo[which] + torch.where(rev[which], length[which] - 1 - off, off)
        v = out[src].to(torch.int64)
        v = _substitute(torch.where(rev[which], 3 - v, v), p, thr[which], salt + SEGDUP)
        out[p] = v.to(torch.uint8)
    return out


def pack(codes: torch.Tensor) -> torch.Tensor:
    """Packed int64 words of uint8 base codes (base i at bits [2i, 2i + 2)
    of word i // 32), with one zero guard word at the end."""
    n = codes.shape[0]
    nw = -(-n // 32)
    words = torch.zeros(nw + 1, dtype=torch.int64, device=codes.device)
    step = CHUNK // 32
    for w0 in range(0, nw, step):
        w1 = min(w0 + step, nw)
        c = torch.zeros((w1 - w0) * 32, dtype=torch.int64, device=codes.device)
        part = codes[w0 * 32 : min(w1 * 32, n)]
        c[: part.shape[0]] = part.to(torch.int64)
        c = c.reshape(-1, 32) << (2 * torch.arange(32, device=codes.device))
        words[w0:w1] = c.sum(dim=1)
    return words


def _side_masks(words, p, k, first, last, ref_end):
    """Per k-mer start ``p``: its canonical word and its 11-bit mask: the
    bases on its canonical form's prefix side (bits 0-3) and suffix side
    (4-7), a chromosome end on the prefix (8) or suffix (9) side, and
    whether the k-mer reads as its canonical form (10)."""
    x = kmer_at(words, p, k)
    c = canonical(x, k)
    f = x == c
    nxt = bases_at(words, torch.clamp(p + k, max=ref_end - 1))
    prv = bases_at(words, torch.clamp(p - 1, min=0))
    # the base after the k-mer attaches to the suffix side of its reading,
    # the base before to the prefix side; read reverse, the sides swap and
    # the bases complement
    in_b = torch.where(f, prv, 3 - nxt)
    out_b = torch.where(f, nxt, 3 - prv)
    in_end = torch.where(f, first, last)
    out_end = torch.where(f, last, first)
    one = torch.ones_like(p)
    m = (torch.where(in_end, 1 << 8, one << in_b)
         | torch.where(out_end, 1 << 9, one << (4 + out_b))
         | (f.to(torch.int64) << 10))
    return c, m


def tiling(k: int, words: torch.Tensor, ref_accum: np.ndarray) -> dict:
    """The maximal unitigs of the chromosomes (packed ``words``, bounds
    ``ref_accum``): per occurrence, its first base on the concatenated
    chromosomes, its last k-mer's start, its chromosome, its unitig key (the
    smaller canonical form of its two end k-mers) and whether it reads the
    unitig forward.

    Every k-mer start gets its canonical form and the bases next to it on
    each side of that form; the canonical k-mers are sorted, a hash
    partition at a time, and each side's bases and chromosome ends are
    gathered over all the k-mer's places. Two consecutive k-mers of a
    chromosome are joined where each has exactly one base on the side that
    faces the other, no chromosome end there, and they differ: a unitig ends
    everywhere else."""
    dev = words.device
    G = int(ref_accum[-1])
    acc = _t(ref_accum, dev)
    n = G - k + 1
    canon = torch.empty(n, dtype=torch.int64, device=dev)
    mask = torch.empty(n, dtype=torch.int16, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    for a in range(0, n, CHUNK):
        p = torch.arange(a, min(a + CHUNK, n), dtype=torch.int64, device=dev)
        r = torch.searchsorted(acc, p, right=True) - 1
        ok = p + k <= acc[r + 1]
        c, m = _side_masks(words, p, k, p == acc[r], p + k == acc[r + 1], acc[-1])
        canon[a : a + p.shape[0]] = c
        mask[a : a + p.shape[0]] = m.to(torch.int16)
        valid[a : a + p.shape[0]] = ok
    # gather each side's bases and ends over every place of a canonical k-mer
    part = torch.empty(n, dtype=torch.int8, device=dev)
    for a in range(0, n, CHUNK):
        part[a : a + CHUNK] = mix64(canon[a : a + CHUNK]) & (PARTITIONS - 1)
    for i in range(PARTITIONS):
        idx = torch.nonzero(valid & (part == i)).flatten()
        if idx.numel() == 0:
            continue
        key, perm = torch.sort(canon[idx])
        idx = idx[perm]
        del perm
        starts = torch.nonzero(torch.cat([key.new_ones(1, dtype=torch.bool),
                                          key[1:] != key[:-1]])).flatten()
        del key
        ends = torch.cat([starts[1:], starts.new_tensor([idx.shape[0]])]) - 1
        m = mask[idx].to(torch.int32)
        agg = torch.zeros(starts.shape[0], dtype=torch.int32, device=dev)
        for b in range(10):
            cs = torch.cumsum((m >> b) & 1, 0)
            before = torch.where(starts > 0, cs[(starts - 1).clamp(min=0)], 0)
            agg |= ((cs[ends] - before) > 0).to(torch.int32) << b
        run = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev),
                                      ends - starts + 1)
        mask[idx] = (agg[run] | (m & (1 << 10))).to(torch.int16)
        del idx, starts, ends, m, agg, run
    del part
    pop4 = torch.tensor(_POP4, dtype=torch.int32, device=dev)
    joined = torch.empty(n, dtype=torch.bool, device=dev)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        m = mask[a : min(b + 1, n)].to(torch.int32)
        f = ((m >> 10) & 1) == 1
        sides = torch.stack([m & 15, (m >> 4) & 15])
        ends_ = torch.stack([(m >> 8) & 1, (m >> 9) & 1]) == 1
        single = (pop4[sides] == 1) & ~ends_
        leave = torch.where(f, single[1], single[0])  # the side facing the next k-mer
        enter = torch.where(f, single[0], single[1])  # the side facing the one before
        c = canon[a : min(b + 1, n)]
        v = valid[a : min(b + 1, n)]
        j = v & leave
        j[:-1] &= v[1:] & enter[1:] & (c[1:] != c[:-1])
        if b == n:
            j[-1] = False
        joined[a:b] = j[: b - a]
    # occurrences: maximal runs of joined k-mers
    prev = torch.cat([joined.new_zeros(1), joined[:-1]])
    first = torch.nonzero(valid & ~prev).flatten()
    last = torch.nonzero(valid & ~joined).flatten()
    del prev, joined
    cf, cl = canon[first], canon[last]
    fw = (mask[first].to(torch.int32) >> 10) & 1 == 1
    forward = (cf < cl) | ((cf == cl) & fw)
    ref = torch.searchsorted(acc, first, right=True) - 1
    return {"start": first, "last": last, "ref": ref, "key": torch.minimum(cf, cl),
            "forward": forward}


def make(cfg: dict, seed: int, device) -> Genome:
    """The genome of ``cfg`` for ``seed``, its bases on ``device``."""
    k = int(cfg["k"])
    dev = torch.device(device)
    ann = annotation(cfg)
    codes = bases(cfg, ann, seed, dev)
    ref_words = pack(codes)
    del codes
    ref_accum = np.concatenate([[0], np.cumsum(ann["lens"])]).astype(np.int64)
    t = tiling(k, ref_words, ref_accum)

    # one unitig a key, numbered in the order of its first occurrence
    keys, group = torch.unique(t["key"], return_inverse=True)
    n_occ, n_u = group.shape[0], keys.shape[0]
    del keys
    first_occ = torch.full((n_u,), n_occ, dtype=torch.int64, device=dev)
    first_occ.scatter_reduce_(0, group, torch.arange(n_occ, device=dev), "amin")
    order = torch.argsort(first_occ)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_u, device=dev)
    uid = rank[group]
    rep = first_occ[order]  # each unitig's first occurrence, in unitig order
    ulen = t["last"][rep] - t["start"][rep] + k
    accum = torch.cat([ulen.new_zeros(1), torch.cumsum(ulen, 0)])
    total = int(accum[-1])
    codes = torch.empty(total, dtype=torch.uint8, device=dev)
    for a in range(0, total, CHUNK):
        j = torch.arange(a, min(a + CHUNK, total), dtype=torch.int64, device=dev)
        u = torch.searchsorted(accum, j, right=True) - 1
        off = j - accum[u]
        o = rep[u]
        fwd = t["forward"][o]
        src = t["start"][o] + torch.where(fwd, off, ulen[u] - 1 - off)
        b = bases_at(ref_words, src)
        codes[a : a + j.shape[0]] = torch.where(fwd, b, 3 - b).to(torch.uint8)
    words = pack(codes)
    del codes

    by_unitig = torch.argsort(uid, stable=True)
    occ_ref = t["ref"][by_unitig]
    acc = _t(ref_accum, dev)
    occ = [uid[by_unitig], occ_ref, t["start"][by_unitig] - acc[occ_ref],
           t["forward"][by_unitig].to(torch.int64)]
    counts = torch.bincount(uid, minlength=n_u)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    host = lambda x: x.cpu().numpy()  # noqa: E731
    occ_uid, occ_ref, occ_pos, occ_o = (host(x) for x in occ)
    del occ, by_unitig, t
    return Genome(
        k=k, n_bases=total,
        words=words, host_words=host(words).view(np.uint64),
        accum=host(accum),
        ref_words=ref_words, ref_host_words=host(ref_words).view(np.uint64),
        ref_accum=ref_accum,
        occ_uid=occ_uid, occ_ref=occ_ref, occ_pos=occ_pos, occ_o=occ_o, offsets=host(offsets),
    )
