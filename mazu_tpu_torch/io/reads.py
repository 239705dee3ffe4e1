"""Packed reads and their k-merization on the device (counterpart of
``mazu_tpu.io.reads``).

The host ships the bases, not the k-mer words: ``pack_reads`` packs each
read 2-bit (A/C/G/T -> 0..3) into a row of a fixed stride of bases (a
multiple of 32, so every read starts on a word), with a 1-bit-a-base mask
of non-ACGT bases only when a read holds one, and the reads' lengths.
``kmerize_device`` rebuilds the [R, L] k-mer word matrix from them with
two consecutive-word reads a k-mer and derives which windows are valid
(inside the read, no non-ACGT base). Its result equals the host oracle
``index.streaming.kmerize_reads`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .._words import read_window
from ..kmer import seq_to_codes
from ..pytree import meta

U64 = np.uint64


def row_shape(maxlen: int, k: int) -> tuple[int, int]:
    """(stride, L) of a packed batch whose longest read has ``maxlen``
    bases: the stride a multiple of 32 bases, at least 32; L at least 1."""
    return max(((maxlen + 31) // 32) * 32, 32), max(maxlen - k + 1, 1)


def pack_reads(reads: list[str], k: int) -> dict:
    """Pack reads into NumPy arrays: ``words`` u64 [R * stride / 32 + 1]
    (2-bit codes, one zero pad word for the last window), ``lengths``
    int32 [R], ``bad`` u64 words (one bit a base, set on non-ACGT; present
    only when some base is) and a Meta (R, stride, L, k, has_bad). L is
    max(len) - k + 1, at least 1, as ``kmerize_reads`` sizes it."""
    k = int(k)
    R = len(reads)
    stride, L = row_shape(max((len(r) for r in reads), default=0), k)
    codes = np.zeros(R * stride, dtype=np.uint8)
    bad = np.zeros(R * stride, dtype=bool)
    lengths = np.zeros(R, dtype=np.int32)
    for i, r in enumerate(reads):
        c = seq_to_codes(r)  # non-ACGT -> 255
        lengths[i] = len(c)
        row = codes[i * stride : i * stride + len(c)]
        b = c == 255
        row[:] = np.where(b, 0, c)
        if b.any():
            bad[i * stride : i * stride + len(c)] = b
    # 2-bit pack, first base in the low bits of each u64 (SeqVector's layout)
    cw = codes.astype(np.uint64).reshape(-1, 32)
    shifts = (np.arange(32, dtype=np.uint64) * U64(2))[None, :]
    words = np.bitwise_or.reduce(cw << shifts, axis=1)
    words = np.concatenate([words, np.zeros(1, dtype=np.uint64)])
    out = {
        "words": words,
        "lengths": lengths,
        "meta": meta(R=R, stride=stride, L=L, k=k, has_bad=bool(bad.any())),
    }
    if out["meta"].has_bad:
        bw = np.packbits(bad, bitorder="little")
        pad = (-len(bw)) % 8
        bw = np.concatenate([bw, np.zeros(pad + 8, dtype=np.uint8)])
        out["bad"] = bw.view(np.uint64)
    return out


def pad_reads(packed: dict, length: int) -> dict:
    """A ``pack_reads`` dict laid out as if its longest read had ``length``
    bases: every row widened to that stride with zero bases (and zero bad
    bits), L raised to match. The reads and their lengths are unchanged, so
    the added windows are invalid. Raises when a read is longer."""
    m = packed["meta"]
    longest = int(packed["lengths"].max(initial=0))
    if longest > length:
        raise ValueError(f"a read of {longest} bases; the batch is padded to {length}")
    stride, L = row_shape(length, m.k)
    if (stride, L) == (m.stride, m.L):
        return packed

    def widen(rows: np.ndarray, width: int) -> np.ndarray:
        out = np.zeros((m.R, width), dtype=rows.dtype)
        out[:, : rows.shape[1]] = rows
        return out.reshape(-1)

    words = widen(packed["words"][:-1].reshape(m.R, m.stride // 32), stride // 32)
    out = {
        "words": np.concatenate([words, np.zeros(1, dtype=np.uint64)]),
        "lengths": packed["lengths"],
        "meta": m.replace(stride=stride, L=L),
    }
    if m.has_bad:
        rows = packed["bad"].view(np.uint8)[: m.R * m.stride // 8]
        bw = widen(rows.reshape(m.R, m.stride // 8), stride // 8)
        bw = np.concatenate([bw, np.zeros((-len(bw)) % 8 + 8, dtype=np.uint8)])
        out["bad"] = bw.view(np.uint64)
    return out


def pack_fastq(path: str, k: int) -> dict:
    """A FASTQ(.gz) file's reads as ``pack_reads`` packs them, in one fused
    pass: the file is decompressed once, and the host library
    (``io.native.fastq_pack``) frames the records and writes the packed
    words, with no Python object a read. Only text it does not take (a
    malformed or truncated record, an empty sequence, a carriage return,
    which the Python reader's universal newlines read as a line end) goes
    through ``read_fastq`` and ``pack_reads``, which give the same result
    where the text is valid and raise ``InvalidData`` where it is not."""
    from .fasta import open_binary
    from .native import fastq_pack

    with open_binary(path) as f:
        buf = f.read()
    out = fastq_pack(buf, k)
    if out is not None:
        return out
    from .fastq import read_fastq

    return pack_reads([s for _, s in read_fastq(path)], k)


def kmerize_device(packed: dict, row_start: int = 0, rows: int | None = None):
    """([rows, L] int64 k-mer words, [rows, L] bool valid) of reads
    ``row_start`` .. ``row_start + rows`` of a ``pack_reads`` dict carried
    to tensors (``convert.arrays_from_numpy``). Invalid lanes hold 0.

    A k-mer is a 2k-bit window of ``words`` and its bad-base check a k-bit
    window of ``bad``; either may straddle two words (``_words.read_window``
    shifts logically). With bad bases a read's valid windows move to the
    front of its row in order, as the host k-merizer restarts after a
    non-ACGT base: a stable sort of an integer key, no host sync."""
    m = packed["meta"]
    L, k, stride = m.L, m.k, m.stride
    rows = m.R if rows is None else int(rows)
    words = packed["words"]
    dev = words.device
    ridx = row_start + torch.arange(rows, dtype=torch.int64, device=dev)
    base = (ridx * stride)[:, None] + torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    kms = read_window(words, base * 2, 2 * k)
    col = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    valid = col <= packed["lengths"][ridx][:, None] - k
    if m.has_bad:
        valid = valid & (read_window(packed["bad"], base, k) == 0)
        order = torch.sort((~valid).to(torch.int32), dim=1, stable=True).indices
        kms = torch.gather(kms, 1, order)
        valid = col < valid.sum(dim=1, dtype=torch.int32)[:, None]
    return torch.where(valid, kms, 0), valid
