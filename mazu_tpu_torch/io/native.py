"""ctypes bindings of the port's host library, ``csrc/host_reads.cpp``
(counterpart of ``fastq_pack`` and ``kmerize_batch`` in
``mazu_tpu.io.native``).

The library is built at first use with the system C++ compiler
(``ops.cuda_build.compile_host_library``) into ``build/``. A failed build
raises: nothing falls back to Python for want of the library.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kmer import seq_to_codes
from ..ops.cuda_build import CSRC, compile_host_library
from ..pytree import meta
from .reads import row_shape

SOURCE = CSRC / "host_reads.cpp"

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
ARGTYPES = {  # every entry of SOURCE, its parameters in order; each returns int64
    "fastq_count": [ctypes.c_char_p, _I64, _P],
    "fastq_fill": [ctypes.c_char_p, _I64, _I64, _I64, _P, _P, _P],
    "kmerize_batch": [_P, _P, _I64, _I64, _P, _P, _P, _P],
}
_LIB = None


def library() -> ctypes.CDLL:
    """The host library, built and loaded once a process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(compile_host_library(SOURCE)))
        for name, types in ARGTYPES.items():
            f = getattr(lib, name)
            f.argtypes = types
            f.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def fastq_pack(buf: bytes, k: int) -> dict | None:
    """The FASTQ text ``buf`` (decompressed) as ``io.reads.pack_reads``
    packs its reads, in two C passes (count, then fill) with no Python
    object a read. None when the text is not framed as the C passes take it
    (a malformed or truncated record, an empty sequence): the caller then
    reads it with ``io.fastq.read_fastq``, which raises the error."""
    lib = library()
    n = len(buf)
    maxlen = ctypes.c_int64(0)
    records = lib.fastq_count(buf, n, ctypes.addressof(maxlen))
    if records < 0:
        return None
    k = int(k)
    stride, L = row_shape(int(maxlen.value), k)
    words = np.zeros(records * stride // 32 + 1, dtype=np.uint64)
    badw = np.zeros(-(-records * stride // 64) + 1, dtype=np.uint64)
    lengths = np.zeros(records, dtype=np.int32)
    has_bad = lib.fastq_fill(buf, n, records, stride, _ptr(words), _ptr(badw), _ptr(lengths))
    if has_bad < 0:
        return None
    out = {
        "words": words,
        "lengths": lengths,
        "meta": meta(R=int(records), stride=stride, L=L, k=k, has_bad=bool(has_bad)),
    }
    if has_bad:
        out["bad"] = badw
    return out


def kmerize_batch(reads: list, k: int):
    """All-ACGT k-mer windows of many reads (str or bytes) in one call:
    ``(bounds, positions, words)``, ``bounds`` int64 [len(reads) + 1] the
    CSR bounds of each read's windows in ``positions`` (int64, within the
    read) and ``words`` (u64), in read order. Each read's windows are those
    of ``index.validate.valid_kmer_windows``."""
    k = int(k)
    n = len(reads)
    if n == 0:
        return np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int64), np.zeros(0, np.uint64)
    blob = "".join(reads).encode() if isinstance(reads[0], str) else b"".join(reads)
    codes = np.ascontiguousarray(seq_to_codes(blob))
    lens = np.fromiter((len(r) for r in reads), dtype=np.int64, count=n)
    rbounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=rbounds[1:])
    caps = np.maximum(lens - k + 1, 0)
    cap_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(caps, out=cap_off[1:])
    pos = np.empty(cap_off[-1], dtype=np.int64)
    words = np.empty(cap_off[-1], dtype=np.uint64)
    counts = np.empty(n, dtype=np.int64)
    library().kmerize_batch(_ptr(codes), _ptr(rbounds), n, k, _ptr(cap_off), _ptr(pos),
                            _ptr(words), _ptr(counts))
    bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    if bounds[-1] == cap_off[-1]:  # every window valid
        return bounds, pos, words
    # some windows were invalid: keep the first counts[r] of each read's room
    sel = np.repeat(np.arange(n), caps)
    keep = (np.arange(cap_off[-1]) - cap_off[sel]) < counts[sel]
    return bounds, pos[keep], words[keep]
