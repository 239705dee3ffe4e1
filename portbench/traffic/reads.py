"""Read mapping: a closed loop of one client that hands the port a batch
of FASTQ text at a time, already decompressed and held in host memory (as
a mapper reads from ``<(zcat ...)``), and takes back each chunk's mapping
and pseudoalignment sums.

Each read is ``read_len`` bases of one reference, from a uniform start
over every start that fits a read on a reference (as
``mazu_tpu_torch.synth``'s ``serve_reads_truth`` draws them over its
references), reverse-complemented with probability ``rc_share``, replaced
by random sequence with probability ``foreign_share``, and with one base
turned to N with probability ``n_share``. A pool of ``pool`` batches of ``chunks`` x ``reads_per_chunk``
reads is made in set-up and cycled; each record is named by its number in
the pool and has a quality line of I.

The timed path per batch: ``io.native.fastq_pack`` on the host (the
benchmark's span ``pack``), then one ``RunServePass`` call (padding,
upload, one CUDA graph: k-merisation on the device, the main probe,
compaction, projection, intersecting pseudoalignment over the color
classes), its results read back.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.pipeline import RunServePass
from mazu_tpu_torch.index.pseudoalign import color_bitsets
from mazu_tpu_torch.io.native import fastq_pack

from ..genome import streams
from ..reference.checksums import color_bits, read_lanes, read_sums
from ..reference.kmers import bases_at
from ..reference.lookup import Layout, locate

NAME_DIGITS = 8


def sample_codes(genome, n: int, mix: dict, rng) -> np.ndarray:
    """[n, read_len] uint8 base codes (4 for N) of ``n`` reads."""
    L = int(mix["read_len"])
    span = np.maximum(np.diff(genome.ref_accum) - L + 1, 0)
    ends = np.cumsum(span)
    r = rng.integers(0, int(ends[-1]), n)
    ref = np.searchsorted(ends, r, side="right")
    starts = genome.ref_accum[ref] + r - (ends[ref] - span[ref])
    pos = torch.from_numpy(starts[:, None] + np.arange(L)).to(genome.ref_words.device)
    codes = bases_at(genome.ref_words, pos).to(torch.uint8).cpu().numpy()
    rc = rng.random(n) < float(mix["rc_share"])
    codes[rc] = 3 - codes[rc, ::-1]
    foreign = rng.random(n) < float(mix["foreign_share"])
    codes[foreign] = rng.integers(0, 4, (int(foreign.sum()), L), dtype=np.uint8)
    with_n = np.flatnonzero(rng.random(n) < float(mix["n_share"]))
    codes[with_n, rng.integers(0, L, len(with_n))] = 4
    return codes


def fastq_text(codes: np.ndarray, first: int) -> bytes:
    """FASTQ records of the reads ``codes``, named @<number> from ``first``."""
    R, L = codes.shape
    rec = np.empty((R, 1 + NAME_DIGITS + 1 + L + 3 + L + 1), dtype=np.uint8)
    rec[:, 0] = ord("@")
    num = first + np.arange(R, dtype=np.int64)
    for j in range(NAME_DIGITS):
        rec[:, 1 + j] = ord("0") + (num // 10 ** (NAME_DIGITS - 1 - j)) % 10
    c = 1 + NAME_DIGITS
    rec[:, c] = ord("\n")
    rec[:, c + 1 : c + 1 + L] = np.frombuffer(b"ACGTN", dtype=np.uint8)[codes]
    c += 1 + L
    rec[:, c : c + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, c + 3 : c + 3 + L] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def parse_codes(text: bytes) -> np.ndarray:
    """[R, read_len] base codes (A, C, G, T = 0..3, else 4) of the FASTQ
    text's sequence lines (all of one length)."""
    buf = np.frombuffer(text, dtype=np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], nl[:-1] + 1])
    seq_start, seq_end = starts[1::4], nl[1::4]
    L = int(seq_end[0] - seq_start[0])
    if not (seq_end - seq_start == L).all():
        raise ValueError("the reads are not all of one length")
    table = np.full(256, 4, dtype=np.uint8)
    for code, base in enumerate(b"ACGT"):
        table[base] = code
    return table[buf[seq_start[:, None] + np.arange(L)]]


class Traffic:
    unit = "reads"

    def __init__(self, cell: dict, genome, seed: int, device):
        """The pool of ``cell``'s mix over ``genome`` for ``seed``."""
        self.cell, self.mix, self.genome, self.device = cell, cell["mix"], genome, device
        self.k = genome.k
        self.CH, self.R = int(self.mix["chunks"]), int(self.mix["reads_per_chunk"])
        rng = streams(seed, 5)[4]
        n = self.CH * self.R
        self.text, self.has_n = [], []
        for b in range(int(self.mix["pool"])):
            codes = sample_codes(genome, n, self.mix, rng)
            self.text.append(fastq_text(codes, b * n))
            self.has_n.append(bool((codes == 4).any()))
        self.n_refs = len(genome.ref_accum) - 1
        self.serve = None
        self.worst = 0
        self.pack_s = []

    def attach(self, index, qi) -> None:
        """The port's serve pass over the index ``qi`` (a ``QueryIndex`` on
        the device) and the colour classes of ``index`` (its ``ModIndex``),
        with the cell's capacity."""
        bits = color_bitsets(index.color_classes())
        self.serve_m2 = int(self.cell["capacity"]["m2"])
        self.serve = RunServePass(qi, arrays_from_numpy(bits, self.device), self.R, self.CH,
                                  self.serve_m2, int(self.mix["read_len"]),
                                  probe_limit=self.cell["config"].get("query", {}).get("probe_limit", 2))

    def __len__(self) -> int:
        return len(self.text)

    def warm_ids(self) -> list:
        """One batch of each kind the pool holds (with and without a
        non-ACGT base): each is a graph of its own."""
        return sorted({self.has_n.index(v) for v in set(self.has_n)})

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
        self.worst = max(self.worst, max(n_ovf))
        return (tuple(maps), tuple(pas)), self.CH * self.R

    def after_window(self, ids: list) -> dict:
        """Nothing more to read from the program once the window has
        closed: the serve pass's sums hold everything compared."""
        return {}

    def probe_lanes(self) -> int:
        """Lanes of one launch of the main probe kernel: a chunk's windows."""
        return self.R * (int(self.mix["read_len"]) - self.k + 1)

    def release(self) -> None:
        self.serve = None

    def expected(self, ids: list, max_occs: int | None = None) -> dict:
        """The reference's right results of pool batches ``ids``: for each,
        per chunk, the set of right (map, pseudoalignment) sums."""
        layout = Layout(self.genome, self.device)
        ubits = color_bits(layout, self.n_refs)
        lanes = [read_lanes(torch.from_numpy(parse_codes(self.text[i])).to(self.device), self.k)
                 for i in ids]
        words = torch.cat([w for w, _ in lanes])
        valid = torch.cat([v for _, v in lanes])
        loc = locate(layout, words)
        per = self.CH * self.R
        out = {}
        for j, i in enumerate(ids):
            sl = slice(j * per, (j + 1) * per)
            sub = type(loc)(loc.count.reshape(words.shape)[sl].reshape(-1),
                            loc.first.reshape(words.shape)[sl].reshape(-1),
                            {f - j * per * words.shape[1]: v for f, v in loc.more.items()
                             if sl.start * words.shape[1] <= f < sl.stop * words.shape[1]})
            out[i] = read_sums(layout, ubits, words[sl], valid[sl], sub, self.R, max_occs)
        return out

    def matches(self, result, right, after=None) -> bool:
        maps, pas = result
        return all((m, p) in s for m, p, s in zip(maps, pas, right)) and len(maps) == len(right)

    def diagnostics(self) -> str:
        return (f"the most phase-2 lanes of a chunk {self.worst} of capacity {self.serve_m2}; "
                f"fastq_pack mean {1e3 * sum(self.pack_s) / max(1, len(self.pack_s)):.3f} ms")
