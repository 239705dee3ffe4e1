"""Batched k-mer lookups: a closed loop of one client that hands the port
a stack of ``chunks`` x ``lanes`` k-mer words at a time.

Each word is the k-mer at a uniform position over every k-mer position of
the references, so a k-mer that several references hold is drawn as
often as they hold it; it is reverse-complemented with probability
``rc_share`` and replaced by a random word (a miss) with probability
``foreign_share``. A pool of ``pool`` batches is made on the device in
set-up and cycled.

The timed call is the program's own ``OneGraphIndexQuery.checksum_pass``
(one CUDA graph a pass, one host read) with the configuration's query
settings and the cell's phase-2 capacities; its result, the pass's sum of
every answer's unitig, offset and occurrences, is compared with the
reference's. Those sums leave each answer's orientation out, so once the
window has closed the same query object answers every pool batch that ran
again, chunk by chunk on its eager path, and each lane's unitig, offset
and orientation, weighed by its place in the batch
(``reference.checksums``), are compared too.
"""

from __future__ import annotations

import torch

from mazu_tpu_torch.index.modindex import get_ref_pos_compact, merge_compact_k2u
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery

from ..genome import random_words, streams, torch_generator
from ..reference.checksums import kmer_sums, lane_term
from ..reference.kmers import kmer_at, revcomp
from ..reference.lookup import Layout, locate


def sample(genome, n: int, mix: dict, gen: torch.Generator) -> torch.Tensor:
    """``n`` query words on the genome's device."""
    dev, k = genome.ref_words.device, genome.k
    ref_accum = torch.from_numpy(genome.ref_accum).to(dev)
    span = (ref_accum[1:] - ref_accum[:-1] - k + 1).clamp(min=0)
    ends = torch.cumsum(span, 0)
    r = torch.randint(0, int(ends[-1]), (n,), generator=gen, device=dev)
    ref = torch.searchsorted(ends, r, right=True)
    w = kmer_at(genome.ref_words, ref_accum[ref] + r - (ends[ref] - span[ref]), k)
    flip = torch.rand(n, generator=gen, device=dev) < float(mix["rc_share"])
    w = torch.where(flip, revcomp(w, k), w)
    foreign = torch.rand(n, generator=gen, device=dev) < float(mix["foreign_share"])
    return torch.where(foreign, random_words(n, gen, dev) & ((1 << (2 * k)) - 1), w)


class Traffic:
    unit = "queries"

    def __init__(self, cell: dict, genome, seed: int, device):
        """The pool of ``cell``'s mix over ``genome`` for ``seed``."""
        self.cell, self.mix, self.genome, self.device = cell, cell["mix"], genome, device
        self.CH, self.N = int(self.mix["chunks"]), int(self.mix["lanes"])
        gen = torch_generator(streams(seed, 5)[4], device)
        self.pool = torch.stack([sample(genome, self.CH * self.N, self.mix, gen).reshape(self.CH, self.N)
                                 for _ in range(int(self.mix["pool"]))])
        self.query = None
        self.worst = 0

    def attach(self, index, qi) -> None:
        """The port's driver over the index ``qi`` (a ``QueryIndex`` on the
        device), with the configuration's query settings and the cell's
        capacity."""
        q = self.cell["config"].get("query", {})
        self.m2 = int(self.cell["capacity"]["m2"])
        self.query = OneGraphIndexQuery(qi, self.N, n_chunks=self.CH, m2=self.m2,
                                        probe_limit=q.get("probe_limit", 2))

    def __len__(self) -> int:
        return self.pool.shape[0]

    def warm_ids(self) -> list:
        """Pool batches whose first run captures a graph: one shape."""
        return [0]

    def run(self, i: int, span) -> tuple:
        """(result, queries answered) of pool batch ``i``; ``span(name)``
        opens a labelled host span."""
        with span("pass"):
            tot, worst = self.query.checksum_pass(self.pool[i])
        self.worst = max(self.worst, worst)
        return tot, self.CH * self.N

    def after_window(self, ids: list) -> dict:
        """Per pool batch of ``ids``, the place-weighted sum of every lane's
        unitig, offset and orientation, from the same query object's eager
        path, chunk by chunk."""
        q = self.query
        arrays = q.index.arrays()
        out = {}
        for i in ids:
            s = torch.zeros((), dtype=torch.int64, device=self.device)
            for c, chunk in enumerate(self.pool[i]):
                m = merge_compact_k2u(get_ref_pos_compact(arrays, chunk, q.max_occs, **q.query_kw))
                lane = torch.arange(c * self.N, (c + 1) * self.N, device=chunk.device)
                s = s + lane_term(m["unitig_id"].to(torch.int64), m["pos"].to(torch.int64),
                                  m["mt"].to(torch.int64), lane).sum()
            out[i] = int(s)
        return out

    def probe_lanes(self) -> int:
        """Lanes of one launch of the main probe kernel: one a chunk."""
        return self.N

    def release(self) -> None:
        """Drop the port's objects (the index's graphs with them)."""
        self.query = None

    def expected(self, ids: list, max_occs: int | None = None) -> dict:
        """The reference's right results of pool batches ``ids``: a set of
        (pass sum, place-weighted sum) pairs each."""
        layout = Layout(self.genome, self.device)
        sub = self.pool[ids]
        return dict(zip(ids, kmer_sums(layout, sub, locate(layout, sub), max_occs)))

    def matches(self, result, right, after=None) -> bool:
        return (result if after is None else (result, after)) in right

    def diagnostics(self) -> str:
        return f"the most phase-2 lanes of a chunk: {self.worst} of capacity {self.m2}"
