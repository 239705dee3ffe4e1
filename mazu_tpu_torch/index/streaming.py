"""Streaming queries: the k-mer cache, batched (counterpart of
``mazu_tpu.index.streaming``).

Consecutive k-mers of a read usually continue on the same unitig: a warm
query checks the neighbouring position of the previous k-mer's unitig
(one fetch and an equivalency test) before a cold probe of the whole
dictionary. The results equal the cold query's; the cache only saves work.

Reads are lanes of a [R, L] k-mer matrix. ``StreamingIndex`` has the
reference's three modes, with identical results and cold-probe counts:

- ``host``: a column loop; the warm kernel runs on all R lanes, the lanes
  it misses are compacted on the host and probed cold in a batch padded to
  a power of two. Least work, one host read a column.
- ``scan``: one pass over the columns with the warm kernel and the cold
  probe run on every lane, masked; no host read.
- ``flat``: the cold probe over all R * L k-mers at once, and the warm
  flags derived from the results: k-mers in a unitig set are unique, so
  ``warm(i, j) = hit(i, j) & hit(i, j - 1) & same unitig & |dpos| == 1``
  is exactly when the sequential warm probe succeeds.

On a CUDA index each ``scan`` and ``flat`` pass is one CUDA graph
(``pipeline.replay_latest``), kept in the index's ``graphs``: one a kind,
captured again when the batch's shape changes, so a caller whose shapes vary
holds one graph's memory, not one a shape. ``graph=False`` runs the pass
eagerly, the oracle. The reference's ``use_jit`` has no meaning here.

``kmerize_reads`` is the host k-merization of reads into that matrix, and
``validate_fasta_streaming`` the streaming oracle over a FASTA file.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import MATCH_IDENTITY
from ..containers.unitig_set import us_get_kmer
from ..kmer import revcomp, word_equivalency
from ..pytree import meta
from .modindex import ModIndex, QueryIndex, k2u_batch
from ..convert import words_to
from .pipeline import _drop_graphs, _unserve, _use_graph, replay_latest, serve_buffer
from .twophase import _host
from .unitig_table import decode_occs

_FIELDS = ("unitig_id", "unitig_len", "pos", "mt")
_MODES = ("host", "scan", "flat")


def _warm_kernel(arrays: dict, carry: dict, fw: torch.Tensor) -> dict:
    """Whether each lane's k-mer ``fw`` continues the previous one's unitig.

    The reference's cache (its ``src/index/caching.rs:73-97``) probes only
    pos + 1, which goes cold on reads that run along a unitig in reverse.
    This probes pos + 1, then pos - 1 where that missed: the results are the
    same (a cold probe would find the same hit), and reverse-strand reads
    stay warm. Positions and lengths are int64 values, not bit patterns, so
    signed compares are right, and the k-mer's position is clipped into
    the unitig set before it is read."""
    us = arrays["k2u"]["us"]
    k = arrays["meta"].k
    rc = revcomp(fw, k)
    last = max(int(us["meta"].total_len) - k, 0)
    out = None
    for step in (1, -1):
        next_pos = carry["pos"] + step
        ok_next = carry["valid"] & (next_pos >= 0) & (next_pos <= carry["unitig_len"] - k)
        gpos = torch.clamp(us["accum"][carry["unitig_id"]] + next_pos, 0, last)
        mt = word_equivalency(fw, rc, us_get_kmer(us, gpos), k)
        warm = ok_next & (mt > 0)
        if out is None:
            out = {"warm": warm, "unitig_id": carry["unitig_id"],
                   "unitig_len": carry["unitig_len"], "pos": next_pos, "mt": mt}
        else:
            take = warm & ~out["warm"]
            out["pos"] = torch.where(take, next_pos, out["pos"])
            out["mt"] = torch.where(take, mt, out["mt"])
            out["warm"] = out["warm"] | warm
    return out


def _bucket_size(n: int) -> int:
    """The smallest power of two at least ``n`` (1 for n <= 1)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def _cold(arrays: dict, fw: torch.Tensor) -> dict:
    """The cold probe's four fields, int64 and uint8 ``mt``."""
    c = k2u_batch(arrays, fw)
    return {"unitig_id": c["unitig_id"].to(torch.int64),
            "unitig_len": c["unitig_len"].to(torch.int64),
            "pos": c["pos"].to(torch.int64), "mt": c["mt"].to(torch.uint8)}


def _new_carry(n: int, device) -> dict:
    z = torch.zeros(n, dtype=torch.int64, device=device)
    return {"unitig_id": z, "unitig_len": z, "pos": z,
            "valid": torch.zeros(n, dtype=torch.bool, device=device)}


def _flat_pass(arrays: dict, kmat: torch.Tensor, valid: torch.Tensor):
    """(fields [R, L], cold count) of ``mode="flat"``: the cold probe on all
    R * L k-mers and the warm flags derived from the results."""
    R, L = kmat.shape
    c = {kk: v.reshape(R, L) for kk, v in _cold(arrays, kmat.reshape(R * L)).items()}
    uid, pos = c["unitig_id"], c["pos"]
    hit = (c["mt"] > 0) & valid
    dpos = pos[:, 1:] - pos[:, :-1]
    warm_tail = (hit[:, 1:] & hit[:, :-1] & (uid[:, 1:] == uid[:, :-1])
                 & ((dpos == 1) | (dpos == -1)))
    warm = torch.cat([torch.zeros_like(warm_tail[:, :1]), warm_tail], dim=1)
    n_cold = (valid & ~warm).sum()
    return {kk: torch.where(valid, v, 0).to(v.dtype) for kk, v in c.items()}, n_cold


def _scan_pass(arrays: dict, kmat: torch.Tensor, valid: torch.Tensor):
    """(fields [R, L], cold count) of ``mode="scan"``: column by column, the
    warm kernel and the cold probe on every lane, the warm result taken
    where it holds, the cold one elsewhere on valid lanes."""
    R, L = kmat.shape
    cols = {kk: [] for kk in _FIELDS}
    carry = _new_carry(R, kmat.device)
    n_cold = torch.zeros((), dtype=torch.int64, device=kmat.device)
    kT, vT = kmat.T.contiguous(), valid.T.contiguous()
    for j in range(L):
        fw, val = kT[j], vT[j]
        w = _warm_kernel(arrays, carry, fw)
        c = _cold(arrays, fw)
        warm = w["warm"] & val
        res = {kk: torch.where(warm, w[kk], torch.where(val, c[kk], 0)).to(c[kk].dtype)
               for kk in _FIELDS}
        for kk in _FIELDS:
            cols[kk].append(res[kk])
        carry = {"unitig_id": res["unitig_id"], "unitig_len": res["unitig_len"],
                 "pos": res["pos"], "valid": res["mt"] > 0}
        n_cold = n_cold + (val & ~warm).sum()
    return {kk: torch.stack(v, dim=1) for kk, v in cols.items()}, n_cold


def _host_pass(arrays: dict, kmat: torch.Tensor, valid: torch.Tensor):
    """(fields [R, L], cold count) of ``mode="host"``: column by column, the
    warm kernel on every lane, then the cold probe only on the lanes it
    missed, compacted on the host and padded to a power of two."""
    R, L = kmat.shape
    cols = {kk: [] for kk in _FIELDS}
    carry = _new_carry(R, kmat.device)
    n_cold = 0
    for j in range(L):
        fw, val = kmat[:, j].contiguous(), valid[:, j]
        w = _warm_kernel(arrays, carry, fw)
        warm = w["warm"] & val
        res = {kk: torch.where(warm, w[kk], 0).to(w[kk].dtype) for kk in _FIELDS}
        cold_lanes = torch.nonzero(~warm & val).flatten()
        n = cold_lanes.shape[0]
        if n:
            n_cold += n
            padded = torch.zeros(_bucket_size(n), dtype=fw.dtype, device=fw.device)
            padded[:n] = fw[cold_lanes]
            c = _cold(arrays, padded)
            for kk in _FIELDS:
                res[kk][cold_lanes] = c[kk][:n].to(res[kk].dtype)
        for kk in _FIELDS:
            cols[kk].append(res[kk])
        carry = {"unitig_id": res["unitig_id"], "unitig_len": res["unitig_len"],
                 "pos": res["pos"], "valid": res["mt"] > 0}
    return {kk: torch.stack(v, dim=1) for kk, v in cols.items()}, n_cold


def _project(arrays: dict, r: dict, max_occs: int) -> dict:
    """The occurrences of flat k2u results ``r`` ([N] fields): n_occs [N] and
    ref_id, ref_pos, orient, valid [N, max_occs], slot for slot the
    reference's (a slot past a lane's count holds the clipped neighbour's
    decoded values and valid False)."""
    u2 = arrays["u2pos"]
    hit = r["mt"] > 0
    uid = torch.where(hit, r["unitig_id"], 0)
    start = u2["offsets"][uid]
    cnt = torch.where(hit, u2["offsets"][uid + 1] - start, 0)
    j = torch.arange(max_occs, dtype=start.dtype, device=start.device)
    occ_idx = torch.clamp(start[:, None] + j[None, :], 0, max(int(u2["meta"].n_occs) - 1, 0))
    ref_id, occ_pos, occ_o = decode_occs(u2, occ_idx)
    k = arrays["meta"].k
    kpos, ulen = r["pos"][:, None], r["unitig_len"][:, None]
    fwd = occ_o == 1
    o_match = (r["mt"] == MATCH_IDENTITY).to(torch.int32)[:, None]
    return {
        "n_occs": cnt.to(torch.int64),
        "ref_id": ref_id.to(torch.int64),
        "ref_pos": torch.where(fwd, kpos + occ_pos, occ_pos + (ulen - kpos) - k).to(torch.int64),
        "orient": torch.where(fwd, o_match, 1 - o_match).to(torch.int32),
        "valid": j[None, :] < cnt[:, None],
    }


_BARE_LAYOUT = ("prefix_kind", "pos_kind", "bucket_inline")


class StreamingIndex:
    """The streaming query of a ``ModIndex``, or of a bare K2U dictionary
    (then only ``k2u_reads`` and ``k2u_reads_packed`` answer; the
    reference's StreamingK2U, its ``src/index/caching.rs:13-17``).

    ``index``: a ``ModIndex`` or a bare K2U, whose ``device_arrays`` (with
    ``layout``'s keywords) go to ``device`` (the card by default), or a
    ``QueryIndex``, queried where it lies. ``layout`` is passed through:
    with none an SSHash takes the reference's default for its engine
    (inline rows with flat32 bounds for direct and fast32, packed positions
    with Elias-Fano bounds for parity); a bare SSHash takes only the K2U's
    own knobs
    (``prefix_kind``, ``pos_kind``, ``bucket_inline``). The results do not
    depend on the layout.

    ``mode``: ``host`` (the reference's default), ``scan`` or ``flat`` (see
    the module). ``graph``: on a CUDA index each ``scan`` and ``flat`` pass
    is one CUDA graph, one a kind (matrix or packed), captured again when
    the batch's shape changes and dropped with this object; False runs them
    eagerly. Batches of one shape pay one capture.
    ``last_cold_fraction`` is the share of valid k-mers the last call
    probed cold."""

    def __init__(self, index, mode: str = "host", graph: bool = True, device=None,
                 layout: dict | None = None):
        from ..convert import arrays_from_numpy, resolve_device

        layout = dict(layout or {})
        if isinstance(index, QueryIndex):
            if layout or device is not None:
                raise ValueError("a QueryIndex has its layout and device already")
            qi = index
        else:
            if isinstance(index, ModIndex):
                host = index.device_arrays(**layout)
            else:  # a bare K2U dictionary
                extra = set(layout) - set(_BARE_LAYOUT)
                if extra:
                    raise ValueError(f"a bare K2U takes no {sorted(extra)}: those records need "
                                     f"an occurrence table")
                host = {"k2u": index.device_arrays(**layout),
                        "meta": meta(k=index.k, index_type="K2U")}
            qi = QueryIndex(arrays_from_numpy(host, "cpu")).to(resolve_device(device))
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, not {mode!r}")
        self.index = qi
        self.k = int(qi.arrays()["meta"].k)
        self.mode = mode
        self.graph = bool(graph)
        self.has_occs = "u2pos" in qi.arrays()
        self.last_cold_fraction = None
        self._key = object()  # this object's graphs in qi.graphs
        weakref.finalize(self, _drop_graphs, qi, self._key, "stream")

    @property
    def device(self) -> torch.device:
        return next(self.index.buffers()).device

    def _replayed(self, kind: str, x: torch.Tensor, fn, variant=None):
        """``fn(x)``, as this object's one CUDA graph ``kind`` where it may
        be; ``variant`` is what else of the batch ``fn`` depends on."""
        if _use_graph(self.graph, x):
            family = ("stream", self._key, kind)
            return replay_latest(self.index, family, family + (variant,), x, fn)
        return fn(x)

    def k2u_device(self, kmat: torch.Tensor, valid: torch.Tensor):
        """(fields [R, L] on the device, cold count): the streaming k2u of an
        int64 k-mer matrix and its bool validity, both on the index's
        device. In ``scan`` and ``flat`` mode the fields are a graph's
        output, which the next replay overwrites."""
        qi = self.index  # a graph's function holds the index, not this object
        if self.mode == "host":
            out, n_cold = _host_pass(qi.arrays(), kmat, valid)
            return out, torch.tensor(n_cold)
        step = _flat_pass if self.mode == "flat" else _scan_pass

        def run(x: torch.Tensor):
            return step(qi.arrays(), x[0], x[1] != 0)

        return self._replayed(self.mode, torch.stack([kmat, valid.to(torch.int64)]), run)

    def k2u_reads(self, kmer_matrix: np.ndarray, valid: np.ndarray) -> dict:
        """Streaming k2u over a read-major k-mer matrix: ``kmer_matrix``
        u64 [R, L] forward words, ``valid`` bool [R, L] (False entries are
        skipped and reported as misses). Returns host arrays [R, L]:
        unitig_id, unitig_len, pos (int64) and mt (uint8), equal to the
        cold k2u's on valid entries and 0 elsewhere."""
        out, n_cold = self.k2u_device(*self._upload(kmer_matrix, valid))
        out = _host(out)
        self.last_cold_fraction = int(n_cold) / max(1, int(np.asarray(valid).sum()))
        return out

    def _upload(self, kmer_matrix, valid):
        dev = self.device
        return (words_to(kmer_matrix, dev),
                torch.from_numpy(np.ascontiguousarray(valid, dtype=bool)).to(dev))

    def k2u_reads_packed(self, packed: dict) -> dict:
        """``k2u_reads`` of a ``pack_reads`` dict, in the ``flat`` form
        whatever the mode (as the reference's): the bases go to the device
        as one buffer (``pipeline.serve_buffer``), are k-merized there
        (``io.reads.kmerize_device``) and queried. Equals
        ``k2u_reads(*kmerize_reads(reads, k)[:2])``."""
        from ..io.reads import kmerize_device

        m, qi = packed["meta"], self.index

        def run(x: torch.Tensor):
            kmat, valid = kmerize_device(_unserve(x, m))
            out, n_cold = _flat_pass(qi.arrays(), kmat, valid)
            return out, n_cold, valid.sum()

        flat = torch.from_numpy(serve_buffer(packed)).to(self.device)
        out, n_cold, n_valid = self._replayed("packed", flat, run, m)
        out = _host(out)
        self.last_cold_fraction = int(n_cold) / max(1, int(n_valid))
        return out

    def ref_pos_device(self, kmat: torch.Tensor, valid: torch.Tensor,
                       max_occs: int | None = None) -> dict:
        """``get_ref_pos_reads`` on device tensors, returning device tensors."""
        if not self.has_occs:
            raise ValueError("the projection needs an occurrence table: this is a bare K2U")
        mo = self.index.max_occs if max_occs is None else int(max_occs)
        r, n_cold = self.k2u_device(kmat, valid)
        self.last_cold_fraction = int(n_cold) / max(1, int(valid.sum()))
        R, L = kmat.shape
        flat = {kk: v.reshape(R * L) for kk, v in r.items()}
        proj = _project(self.index.arrays(), flat, mo)
        return {**r, "n_occs": proj["n_occs"].reshape(R, L),
                **{kk: proj[kk].reshape(R, L, mo)
                   for kk in ("ref_id", "ref_pos", "orient", "valid")}}

    def get_ref_pos_reads(self, kmer_matrix: np.ndarray, valid: np.ndarray,
                          max_occs: int | None = None) -> dict:
        """Streaming get_ref_pos: ``k2u_reads`` and the occurrence
        projection, as host arrays: the four k2u fields and n_occs [R, L];
        ref_id, ref_pos (int64), orient (int32, 1 = forward) and valid
        (bool) [R, L, max_occs] (the index's maximum occurrence count by
        default)."""
        return _host(self.ref_pos_device(*self._upload(kmer_matrix, valid), max_occs))


def kmerize_reads(reads: list[str], k: int):
    """(k-mer words u64 [R, L], valid bool [R, L], positions int64 [R, L]):
    each read's all-ACGT windows from the left of its row, L the longest
    read's window count (at least 1)."""
    from .validate import valid_kmer_windows

    R = len(reads)
    L = max((len(r) - k + 1 for r in reads), default=0)
    L = max(L, 1)
    kms = np.zeros((R, L), dtype=np.uint64)
    valid = np.zeros((R, L), dtype=bool)
    positions = np.zeros((R, L), dtype=np.int64)
    for i, read in enumerate(reads):
        pos, words = valid_kmer_windows(read, k)
        kms[i, : len(words)] = words
        valid[i, : len(words)] = True
        positions[i, : len(words)] = pos
    return kms, valid, positions


def validate_fasta_streaming(index, path: str, lanes: int = 256, window: int = 2048,
                             device=None):
    """Streaming oracle (the reference's ``src/index/caching.rs:204-218``):
    every valid k-mer of every record of the FASTA file ``path`` must have
    an occurrence at its own (record, position). Raises AssertionError
    with the reference's text at the first that has none.

    Records are cut into ``window``-base pieces that overlap by k - 1
    bases, ``lanes`` pieces a batch (the cache is exact whatever the lane
    boundaries; a piece's first k-mer takes a cold probe). Every batch has
    one shape, [min(lanes, pieces), the longest piece's windows], its spare
    rows and columns invalid, so a CUDA pass is captured once. ``index``: a
    ``StreamingIndex`` (its mode and graphs), or what ``StreamingIndex``
    takes, then queried in ``flat`` mode with graphs on ``device`` (the
    reference's oracle runs the ``host`` loop; the mode changes no result):
    an SSHash is given as a ``QueryIndex`` in its layout."""
    from ..io.fasta import read_fasta

    si = index if isinstance(index, StreamingIndex) else \
        StreamingIndex(index, mode="flat", device=device)
    k = si.k
    step = window - (k - 1)
    pieces = []  # (ref_id, window_start, subsequence)
    for ri, (_name, seq) in enumerate(read_fasta(path)):
        for s in range(0, max(len(seq) - k + 1, 1), step):
            pieces.append((ri, s, seq[s : s + window]))
    R = min(lanes, len(pieces))
    L = max([len(p[2]) - k + 1 for p in pieces] + [1])

    dev = si.device
    for s in range(0, len(pieces), lanes):
        chunk = pieces[s : s + lanes]
        kms, valid, positions = (np.pad(a, ((0, R - a.shape[0]), (0, L - a.shape[1])))
                                 for a in kmerize_reads([p[2] for p in chunk], k))
        kmat, v = si._upload(kms, valid)
        out = si.ref_pos_device(kmat, v)
        ri = torch.tensor([p[0] for p in chunk] + [-1] * (R - len(chunk)), dtype=torch.int64,
                          device=dev)
        want = torch.from_numpy(positions).to(dev) + torch.tensor(
            [p[1] for p in chunk] + [0] * (R - len(chunk)), dtype=torch.int64, device=dev)[:, None]
        ok = (out["valid"] & (out["ref_id"] == ri[:, None, None])
              & (out["ref_pos"] == want[..., None])).any(dim=2)
        bad = v & ~ok
        if bool(bad.any()):
            i, j = (int(x) for x in torch.nonzero(bad)[0])
            raise AssertionError(f"streaming: no matching MRP in ref {chunk[i][0]} @ pos "
                                 f"{int(want[i, j])}")
