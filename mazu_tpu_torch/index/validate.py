"""Validation oracles (counterpart of ``mazu_tpu.index.validate``).

Every k-mer of every indexed reference must project back to its true
(ref_id, pos); an external FASTA is k-merized with the reference's restart
at non-ACGT bases; every unitig k-mer, forward and reverse-complemented,
must return its exact K2U answer. The k-mers are made on the host, the
queries and the check run on the device that holds the results (one host
read a chunk), and a failure raises the reference's ``AssertionError``
text for the first failing k-mer.

``validate_self`` takes its chunks across references, so a query sees
``chunk`` k-mers whatever the reference lengths; its first failure, and
so its message, is the reference's, which chunks each reference alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import MATCH_IDENTITY, MATCH_TWIN
from .._words import from_numpy
from ..convert import arrays_from_numpy, resolve_device
from ..kmer import revcomp, seq_to_codes
from .modindex import ModIndex, k2u_batch


def _first_false(ok: torch.Tensor) -> int | None:
    """Index of the first False of a bool vector, None when all hold (one
    host read)."""
    if bool(ok.all()):
        return None
    return int(torch.argmin(ok.to(torch.int32)))


def _check_chunk(out: dict, ref_id: torch.Tensor, positions: torch.Tensor, label: str):
    """Some valid occurrence of each lane names its (ref_id, position)."""
    found = (out["valid"] & (out["ref_id"] == ref_id[:, None])
             & (out["ref_pos"] == positions[:, None])).any(dim=1)
    bad = _first_false(found)
    if bad is not None:
        raise AssertionError(
            f"{label}: no matching MappedRefPos for true +ve k-mer in ref "
            f"{int(ref_id[bad])} @ pos {int(positions[bad])} (mt={int(out['mt'][bad])})"
        )


def _query(index: ModIndex, query_fn, device):
    """(device, query function of int64 word tensors on it): ``query_fn``, or
    the exact padded query of ``index`` moved to ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    if query_fn is None:
        _, query_fn = index.make_query_fn(device=dev)
    return dev, query_fn


def validate_self(index: ModIndex, query_fn=None, chunk: int = 1 << 14, device=None):
    """Query every k-mer of the index's own references, ``chunk`` at a time,
    through ``query_fn`` (a function of int64 word tensors on ``device``
    returning a dict with ``valid``, ``ref_id``, ``ref_pos`` [N, m] and
    ``mt`` [N]) or the exact padded query."""
    assert index.refs.has_seq, "validate_self requires reference sequences"
    dev, query_fn = _query(index, query_fn, device)
    k = index.k
    ps = index.refs.prefix_sum
    counts = np.maximum(ps[1:] - ps[:-1] - k + 1, 0)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s in range(0, int(starts[-1]), chunk):
        g = np.arange(s, min(s + chunk, int(starts[-1])), dtype=np.int64)
        ri = np.searchsorted(starts, g, side="right") - 1
        pos = g - starts[ri]
        words = index.refs.seq.get_kmer_u64(ps[ri] + pos, k)
        out = query_fn(from_numpy(words, dev))
        _check_chunk(out, from_numpy(ri, dev), from_numpy(pos, dev), "validate_self")


def windows_from_codes(codes: np.ndarray, k: int):
    """(positions, forward words) of every k-mer window of base codes that
    holds only valid codes (< 4): the reference's skip and restart at an
    invalid base."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    bad = (codes > 3).astype(np.int64)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    pos = np.arange(n - k + 1, dtype=np.int64)
    ok = (cbad[pos + k] - cbad[pos]) == 0
    pos = pos[ok]
    words = np.zeros(len(pos), dtype=np.uint64)
    c = np.where(codes > 3, 0, codes).astype(np.uint64)
    for i in range(k):
        words |= c[pos + i] << np.uint64(2 * i)
    return pos, words


def valid_kmer_windows(seq: str | bytes, k: int):
    """(positions, forward words) of the all-ACGT k-mer windows of an ASCII
    read."""
    return windows_from_codes(seq_to_codes(seq), k)


def validate_ckmers(index: ModIndex, ref_id: int, seq: str, query_fn=None,
                    chunk: int = 1 << 14, device=None):
    """Every valid k-mer of one external sequence must map to ``ref_id`` at
    its position. ``query_fn`` and ``device`` as for ``validate_self``."""
    dev, query_fn = _query(index, query_fn, device)
    positions, words = valid_kmer_windows(seq, index.k)
    for s in range(0, len(words), chunk):
        part = from_numpy(words[s : s + chunk], dev)
        out = query_fn(part)
        rid = torch.full(part.shape, int(ref_id), dtype=torch.int64, device=dev)
        _check_chunk(out, rid, from_numpy(positions[s : s + chunk], dev), "validate_ckmers")


FASTA_CHUNK = 1 << 20  # k-mers a query of validate_fasta


def validate_fasta(index: ModIndex, path: str, query_fn=None, device=None):
    """``validate_ckmers`` on each record of a FASTA file, record i against
    reference i. The k-mers of consecutive records share query chunks of
    ``FASTA_CHUNK``; the first failing k-mer, and so the message, is the
    one of a record-by-record check."""
    chunk = FASTA_CHUNK
    from ..io.fasta import read_fasta

    dev, query_fn = _query(index, query_fn, device)
    parts, held = [], 0

    def check(upto: int):
        nonlocal parts, held
        ri, pos, words = (np.concatenate(a) for a in zip(*parts))
        for s in range(0, upto, chunk):
            e = min(s + chunk, upto)
            _check_chunk(query_fn(from_numpy(words[s:e], dev)), from_numpy(ri[s:e], dev),
                         from_numpy(pos[s:e], dev), "validate_ckmers")
        parts = [(ri[upto:], pos[upto:], words[upto:])]
        held = len(ri) - upto

    for ri, (_name, seq) in enumerate(read_fasta(path)):
        pos, words = valid_kmer_windows(seq, index.k)
        parts.append((np.full(len(pos), ri, dtype=np.int64), pos, words))
        held += len(pos)
        if held >= chunk:
            check(held - held % chunk)
    if held:
        check(held)


def validate_k2u_self(k2u, k2u_fn=None, chunk: int = 1 << 14, device=None):
    """Every unitig k-mer, forward and reverse-complemented, must return its
    exact (unitig_id, pos, unitig_len) and match type through ``k2u_fn`` (a
    function of int64 word tensors on ``device`` returning the K2U fields)
    or ``k2u_batch`` over the dictionary moved to ``device``."""
    dev = resolve_device(device)
    us = k2u.unitigs
    k = us.k
    if k2u_fn is None:
        d = {"k2u": arrays_from_numpy(k2u.device_arrays(), dev)}

        def k2u_fn(w):
            return k2u_batch(d, w)

    pos = us.kmer_start_positions()
    for s in range(0, len(pos), chunk):
        p = pos[s : s + chunk]
        uid = us.pos_to_id(p)
        want = {
            "unitig_id": from_numpy(uid, dev),
            "pos": from_numpy(p - us.accum[uid], dev),
            "unitig_len": from_numpy(us.unitig_len(uid), dev),
        }
        fw = from_numpy(us.get_kmer_u64(p), dev)
        for words, want_mt in ((fw, MATCH_IDENTITY), (revcomp(fw, k), MATCH_TWIN)):
            r = k2u_fn(words)
            ok = (r["mt"] == want_mt) & (r["unitig_id"] == want["unitig_id"]) \
                & (r["pos"] == want["pos"]) & (r["unitig_len"] == want["unitig_len"])
            bad = _first_false(ok)
            if bad is not None:
                w = {kk: int(v[bad]) for kk, v in want.items()}
                raise AssertionError(
                    f"k2u self-validation failed at global kmer {s + bad}: "
                    f"want (uid={w['unitig_id']}, pos={w['pos']}, mt={want_mt}), "
                    f"got (uid={int(r['unitig_id'][bad])}, pos={int(r['pos'][bad])}, "
                    f"mt={int(r['mt'][bad])})"
                )


def merge_sharded_out(out: dict) -> dict:
    """Host merge of a ``merge=False`` sharded query result into per-lane
    unitig_id, unitig_len, pos and mt: each data shard's phase-2 rows
    scattered over its lanes (NumPy; takes NumPy arrays or CPU tensors)."""
    main = {kk: np.asarray(out["main"][kk]).copy()
            for kk in ("unitig_id", "unitig_len", "pos", "mt")}
    lanes = np.asarray(out["lanes"])
    sr = np.asarray(out["slot_real"])
    n_data = int(np.asarray(out["n_ovf"]).shape[0])
    M2 = lanes.shape[0] // n_data
    N = main["mt"].shape[0]
    per = N // n_data
    for d in range(n_data):
        sl = slice(d * M2, (d + 1) * M2)
        real = sr[sl]
        glo = lanes[sl][real] + d * per
        for kk in main:
            main[kk][glo] = np.asarray(out["phase2"][kk])[sl][real]
    return main


def validate_k2u_self_sharded(qf, k2u, batch: int, n_kmers: int | None = None):
    """``validate_k2u_self`` through a sharded full query ``qf`` (a
    ``parallel.sharding`` or ``io.sharded_ckpt`` query, words as int64
    tensors in, ``merge=False`` pieces out): every unitig k-mer (the first
    ``n_kmers`` when given), forward and reverse-complemented, must give
    its exact K2U answer once the phases are merged (``merge_sharded_out``).
    A batch is padded to ``batch`` lanes with its first k-mer."""
    from ..convert import words_to
    from ..kmer import revcomp_np

    us = k2u.unitigs
    k = us.k
    pos = us.kmer_start_positions()
    if n_kmers is not None:
        pos = pos[: int(n_kmers)]
    uid_true = us.pos_to_id(pos)
    upos_true = pos - us.accum[uid_true]
    ulen_true = us.unitig_len(uid_true)
    fw = us.get_kmer_u64(pos)
    for s in range(0, len(pos), batch):
        sl = slice(s, min(s + batch, len(pos)))
        n_real = sl.stop - sl.start
        for words, want_mt in ((fw[sl], MATCH_IDENTITY), (revcomp_np(fw[sl], k), MATCH_TWIN)):
            padded = np.zeros(batch, dtype=np.uint64)
            padded[:n_real] = words
            padded[n_real:] = words[0] if n_real else 0
            out = qf(words_to(padded, "cpu"))
            if bool(out["over_budget"].any()):
                raise AssertionError("phase-2 over budget")
            r = merge_sharded_out({kk: _host_tree(out[kk]) for kk in
                                   ("main", "lanes", "slot_real", "n_ovf", "phase2")})
            ok = ((r["mt"][:n_real] == want_mt) & (r["unitig_id"][:n_real] == uid_true[sl])
                  & (r["pos"][:n_real] == upos_true[sl])
                  & (r["unitig_len"][:n_real] == ulen_true[sl]))
            if not ok.all():
                bad = int(np.flatnonzero(~ok)[0])
                raise AssertionError(
                    f"sharded k2u self-validation failed at global kmer {s + bad}: "
                    f"want (uid={uid_true[sl][bad]}, pos={upos_true[sl][bad]}, mt={want_mt}), "
                    f"got (uid={r['unitig_id'][bad]}, pos={r['pos'][bad]}, mt={r['mt'][bad]})"
                )


def _host_tree(x):
    if isinstance(x, dict):
        return {kk: _host_tree(v) for kk, v in x.items()}
    return x.cpu().numpy()
