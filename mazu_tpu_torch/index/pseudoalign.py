"""Pseudo-alignment: a read's candidate references from the color sets of
its k-mers (counterpart of ``mazu_tpu.index.pseudoalign``).

Color sets are bitset rows, u64 [n_classes, W] with W = ceil(n_refs / 64)
(int64 bit patterns on tensors): bit r of word w is reference 64 w + r. A
read gathers one row per hitting k-mer and reduces them along the read:
AND (``intersect``: the references every hitting k-mer covers) or OR
(``union``: any). A missing k-mer contributes the neutral row. The
``threshold`` policy counts, per reference, the hitting k-mers that cover
it, in bit-sliced counters, and keeps the references at or over
ceil(tau * n_hit).
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import srl_var
from ..convert import arrays_from_numpy, resolve_device
from ..pytree import meta
from .modindex import QueryIndex, k2u_batch


def color_bitsets(cc) -> dict:
    """NumPy bitset rows of a ``ColorClasses`` and its ``u2c``, with a Meta
    (n_refs, n_classes, W)."""
    W = max(1, -(-cc.n_refs // 64))
    bits = np.zeros((max(cc.n_classes, 1), W * 64), dtype=bool)
    if len(cc.refs):
        cls = np.searchsorted(cc.offsets, np.arange(len(cc.refs), dtype=np.int64),
                              side="right") - 1
        bits[cls, cc.refs] = True
    words = np.packbits(bits, axis=1, bitorder="little").view(np.uint64)
    return {
        "u2c": cc.u2c,
        "bitsets": words,
        "meta": meta(n_refs=cc.n_refs, n_classes=cc.n_classes, W=W),
    }


def _lane_classes(cb: dict, r: dict, valid: torch.Tensor):
    """(hit [R, L], class id int32 [R, L], 0's class where the lane misses)
    from flat K2U fields over the R * L lanes of ``valid``."""
    R, L = valid.shape
    hit = (r["mt"].reshape(R, L) > 0) & valid
    uid = torch.where(hit, r["unitig_id"].reshape(R, L), 0)
    return hit, cb["u2c"][uid]


def _class_rows(cb: dict, r: dict, valid: torch.Tensor):
    """(hit [R, L], the class bitset row of each lane [R, L, W])."""
    hit, cid = _lane_classes(cb, r, valid)
    return hit, cb["bitsets"][cid.to(torch.int64)]


def _reduce_rows(rows: torch.Tensor, op) -> torch.Tensor:
    """``op`` (a bitwise AND or OR) over dim 1 of [R, L, W] rows by a
    halving tree: the first step folds the rows past the largest power of
    two below L onto the first ones, so no neutral padding is needed."""
    n = rows.shape[1]
    h = 1 << ((n - 1).bit_length() - 1) if n > 1 else 1
    if n > h:
        head = rows[:, :h].clone()
        head[:, : n - h] = op(head[:, : n - h], rows[:, h:])
        rows = head
    while rows.shape[1] > 1:
        h = rows.shape[1] // 2
        rows = op(rows[:, :h], rows[:, h:])
    return rows[:, 0]


def pseudoalign_from_k2u(cb: dict, r: dict, valid: torch.Tensor, policy: str = "intersect"):
    """(bitset [R, W] int64, n_hit [R], n_kmers [R]) of flat K2U fields
    ``r`` over the R * L lanes of ``valid`` [R, L]. A read with no hit gets
    an empty set. Equals ``np.bitwise_and.reduce`` (or ``_or``) of the
    rows bit for bit."""
    assert policy in ("intersect", "union"), policy
    hit, rows = _class_rows(cb, r, valid)
    if policy == "intersect":
        neutral, op = -1, torch.bitwise_and
    else:
        neutral, op = 0, torch.bitwise_or
    rows = torch.where(hit[:, :, None], rows, neutral)
    out = _reduce_rows(rows, op)
    n_hit = hit.sum(dim=1)
    out = torch.where((n_hit > 0)[:, None], out, 0)
    return out, n_hit, valid.sum(dim=1)


def pseudoalign_batch(index_arrays: dict, cb: dict, kmat: torch.Tensor, valid: torch.Tensor,
                      policy: str = "intersect"):
    """[R, L] k-mer words -> ``pseudoalign_from_k2u`` over the exact K2U."""
    R, L = kmat.shape
    return pseudoalign_from_k2u(cb, k2u_batch(index_arrays, kmat.reshape(R * L)), valid,
                                policy=policy)


def tau_q32(tau: float) -> int:
    """The threshold fraction in 32 fractional bits: both counting paths
    take ``need = max(1, ceil(num * n_hit / 2**32))`` from this integer."""
    assert 0.0 < tau <= 1.0
    return max(1, min(int(round(tau * (1 << 32))), 1 << 32))


def pseudoalign_threshold_batch(index_arrays: dict, cb: dict, kmat: torch.Tensor,
                                valid: torch.Tensor, tau_num: int):
    """(bitset [R, W] of the references covered by at least
    ceil(tau * n_hit) of a read's hitting k-mers, n_hit, n_kmers).

    The counts live in P = bit_length(L) bit planes [R, W]: each of the L
    rows ripple-carries into them (64 references a word), then each plane
    is spread to per-reference bits by logical shifts."""
    R, L = kmat.shape
    r = k2u_batch(index_arrays, kmat.reshape(R * L))
    hit, rows = _class_rows(cb, r, valid)
    rows = torch.where(hit[:, :, None], rows, 0)
    W = rows.shape[2]
    P = max(1, int(L).bit_length())  # counts <= L < 2**P
    planes = [torch.zeros((R, W), dtype=torch.int64, device=rows.device) for _ in range(P)]
    for col in range(L):
        carry = rows[:, col]
        for b in range(P):
            planes[b], carry = planes[b] ^ carry, planes[b] & carry
    shifts = torch.arange(64, dtype=torch.int64, device=rows.device)
    counts = torch.zeros((R, W, 64), dtype=torch.int32, device=rows.device)
    for b in range(P):
        bit = (srl_var(planes[b][:, :, None], shifts) & 1).to(torch.int32)
        counts = counts + (bit << b)
    n_hit = hit.sum(dim=1)
    # ceil(tau_num * n_hit / 2**32): tau_num <= 2**32 and n_hit <= L < 2**30,
    # so the sum stays below 2**63 and the shift of a non-negative int64 is logical
    need = torch.clamp((tau_num * n_hit + ((1 << 32) - 1)) >> 32, min=1)
    cand = (counts >= need[:, None, None]) & (n_hit > 0)[:, None, None]
    words = (cand.to(torch.int64) << shifts).sum(dim=2)
    return words, n_hit, valid.sum(dim=1)


def classify_kmers(index_arrays: dict, cb: dict, kmat: torch.Tensor, valid: torch.Tensor):
    """(class id int32 [R, L], -1 where the k-mer misses; hit [R, L]): the
    device half of the host-counted threshold policy."""
    R, L = kmat.shape
    hit, cid = _lane_classes(cb, k2u_batch(index_arrays, kmat.reshape(R * L)), valid)
    return torch.where(hit, cid.to(torch.int32), -1), hit


def count_threshold_host(cc, cid: np.ndarray, hit: np.ndarray, valid: np.ndarray,
                         tau_num: int) -> list:
    """The threshold policy counted on the host from ``classify_kmers``'
    class ids: per read (sorted reference ids covered by at least
    ``max(1, ceil(tau_num * n_hit / 2**32))`` hitting k-mers, n_hit,
    n_kmers); a loop over the reads and their distinct classes."""
    out = []
    for i in range(len(cid)):
        cids = cid[i][hit[i]]
        n_hit, n_k = len(cids), int(valid[i].sum())
        if n_hit == 0:
            out.append((np.zeros(0, dtype=np.int64), 0, n_k))
            continue
        need = max(1, -(-tau_num * n_hit // (1 << 32)))
        uc, cnt = np.unique(cids, return_counts=True)
        ref_counts = np.zeros(cc.n_refs, dtype=np.int64)
        for c, n in zip(uc.tolist(), cnt.tolist()):
            ref_counts[cc.refs_of_class(c)] += n
        out.append((np.flatnonzero(ref_counts >= need), n_hit, n_k))
    return out


class PseudoAligner:
    """Batched pseudo-aligner over a ``ModIndex`` and its color classes,
    with the index and bitsets on ``device`` (the card by default).

    Policies: ``intersect`` (references covering every hitting k-mer),
    ``union`` (any), ``threshold`` (at least ceil(tau * n_hit)), counted on
    the device, or with ``threshold_on="host"`` on the host from the
    k-mers' class ids. tau is quantized by ``tau_q32``, so both counts
    agree exactly."""

    def __init__(self, index, cc=None, policy: str = "intersect", tau: float = 0.7,
                 threshold_on: str = "device", device=None):
        assert policy in ("intersect", "union", "threshold"), policy
        assert threshold_on in ("device", "host"), threshold_on
        assert 0.0 < tau <= 1.0
        self.index = index
        self.k = index.k
        self.cc = index.color_classes() if cc is None else cc
        self.policy = policy
        self.tau = float(tau)
        self.threshold_on = threshold_on
        self._tau_num = tau_q32(self.tau)
        self.device = resolve_device(device)
        self._qi = QueryIndex(arrays_from_numpy(index.device_arrays(), "cpu")).to(self.device)
        self._cb = arrays_from_numpy(color_bitsets(self.cc), self.device)

    def _run(self, kmat: np.ndarray, valid: np.ndarray):
        km = torch.from_numpy(np.ascontiguousarray(kmat).view(np.int64)).to(self.device)
        v = torch.from_numpy(np.ascontiguousarray(valid)).to(self.device)
        arrays = self._qi.arrays()
        if self.policy == "threshold" and self.threshold_on == "host":
            out = classify_kmers(arrays, self._cb, km, v)
        elif self.policy == "threshold":
            out = pseudoalign_threshold_batch(arrays, self._cb, km, v, self._tau_num)
        else:
            out = pseudoalign_batch(arrays, self._cb, km, v, self.policy)
        return tuple(t.cpu().numpy() for t in out)

    def map_kmer_matrix(self, kmat: np.ndarray, valid: np.ndarray):
        """(bitset u64 [R, W], n_hit, n_kmers) of a host k-mer matrix."""
        bits, n_hit, n_k = self._run(kmat, valid)
        return bits.view(np.uint64), n_hit, n_k

    def map_reads(self, reads: list[str]):
        """Per read: (sorted reference ids, n_hit, n_kmers)."""
        from .streaming import kmerize_reads

        kmat, valid, _ = kmerize_reads(reads, self.k)
        if self.policy == "threshold" and self.threshold_on == "host":
            cid, hit = self._run(kmat, valid)
            return count_threshold_host(self.cc, cid, hit, valid, self._tau_num)
        inter, n_hit, n_k = self.map_kmer_matrix(kmat, valid)
        bits = np.unpackbits(inter.view(np.uint8), bitorder="little", axis=1)[:, : self.cc.n_refs]
        return [(np.flatnonzero(bits[i]), int(n_hit[i]), int(n_k[i])) for i in range(len(reads))]

    def map_file(self, path: str):
        from ..io.fastq import read_seqs

        return self.map_reads([seq for _, seq in read_seqs(path)])
