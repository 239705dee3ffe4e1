"""Whole-genome read mapping: the reads traffic (``traffic/reads.py``: a
closed loop of one client handing the port a batch of FASTQ text in host
memory) on a genome whose unitigs occur thousands of times, where the
port's phase 2 is ragged (``mazu_tpu_torch.ops.occ_csr``).

The reads are drawn and written as ``reads.py`` draws and writes them
(``sample_codes``, ``fastq_text``, ``parse_codes``); the timed path is the
same, ``io.native.fastq_pack`` and one ``RunServePass`` call, here with the
configuration's query settings (``probe_limit``, ``defer_valid``,
``mphf_level_limit``: the MPHF path's) and the cell's capacities
``capacity.m2`` and ``capacity.occ_budget`` (occurrences a chunk). Each
chunk's two sums are compared with ``reference.occ_ragged``'s.

Every call appends (phase-2 lanes, occurrences written, chunks) of its
batch to the module's ``CALLS``, which the pass read back for its capacity
checks: the per-layer readers of the ragged phase take their bytes from
the last ``trace_batches`` entries.
"""

from __future__ import annotations

import time

import torch

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.pipeline import RunServePass
from mazu_tpu_torch.index.pseudoalign import color_bitsets
from mazu_tpu_torch.io.native import fastq_pack

from ..reference.checksums import color_bits, read_lanes
from ..reference.lookup import Layout, locate
from ..reference.occ_ragged import read_sums, unitig_sums
from . import reads
from .reads import parse_codes

CALLS = []  # (phase-2 lanes, occurrences, chunks) of every batch run, in order


class Traffic(reads.Traffic):
    """``reads.Traffic``'s pool and window on the ragged path."""

    def attach(self, index, qi) -> None:
        """The port's serve pass over the index ``qi`` (a ``QueryIndex`` on
        the device) and the colour classes of ``index``, with the cell's
        capacities and the configuration's query settings."""
        CALLS.clear()
        bits = color_bitsets(index.color_classes(device=self.device))
        cap, q = self.cell["capacity"], self.cell["config"].get("query", {})
        self.serve_m2 = int(cap["m2"])
        self.occ_budget = int(cap["occ_budget"])
        self.serve = RunServePass(qi, arrays_from_numpy(bits, self.device), self.R, self.CH,
                                  self.serve_m2, int(self.mix["read_len"]),
                                  probe_limit=q.get("probe_limit", 2),
                                  defer_valid=bool(q.get("defer_valid", False)),
                                  mphf_level_limit=q.get("mphf_level_limit"),
                                  occ_budget=self.occ_budget)
        if not self.serve.ragged:
            raise RuntimeError("the port's phase 2 is not ragged on this index")
        self.worst_occ = 0

    def run(self, i: int, span) -> tuple:
        """(result, reads mapped) of pool batch ``i``."""
        t0 = time.perf_counter()
        with span("pack"):
            packed = fastq_pack(self.text[i], self.k)
        self.pack_s.append(time.perf_counter() - t0)
        if packed is None:
            raise RuntimeError("the host library did not frame the benchmark's FASTQ text")
        with span("pass"):
            maps, pas, n_ovf = self.serve(packed)
        totals = self.serve.occ_totals
        CALLS.append((sum(n_ovf), sum(totals), len(totals)))
        self.worst = max(self.worst, max(n_ovf))
        self.worst_occ = max(self.worst_occ, max(totals))
        return (tuple(maps), tuple(pas)), self.CH * self.R

    def expected(self, ids: list) -> dict:
        """The reference's right results of pool batches ``ids``: for each,
        per chunk, the set of right (map, pseudoalignment) sums."""
        layout = Layout(self.genome, self.device)
        sums = unitig_sums(layout)
        ubits = color_bits(layout, self.n_refs)
        lanes = [read_lanes(torch.from_numpy(parse_codes(self.text[i])).to(self.device), self.k)
                 for i in ids]
        words = torch.cat([w for w, _ in lanes])
        valid = torch.cat([v for _, v in lanes])
        loc = locate(layout, words)
        per = self.CH * self.R
        width = words.shape[1]
        out = {}
        for j, i in enumerate(ids):
            sl = slice(j * per, (j + 1) * per)
            sub = type(loc)(loc.count.reshape(words.shape)[sl].reshape(-1),
                            loc.first.reshape(words.shape)[sl].reshape(-1),
                            {f - j * per * width: v for f, v in loc.more.items()
                             if sl.start * width <= f < sl.stop * width})
            out[i] = read_sums(layout, sums, ubits, words[sl], valid[sl], sub, self.R)
        return out

    def diagnostics(self) -> str:
        return (f"the most phase-2 lanes of a chunk {self.worst} of capacity {self.serve_m2}; the "
                f"most occurrences of a chunk {self.worst_occ} of budget {self.occ_budget}; "
                f"fastq_pack mean {1e3 * sum(self.pack_s) / max(1, len(self.pack_s)):.3f} ms")
