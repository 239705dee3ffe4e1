"""Run-sharing read query (counterpart of ``mazu_tpu.kphf.runshare``): the
batched form of the reference's streaming k-mer cache
(``src/index/caching.rs``).

Consecutive k-mers of a read usually share a minimizer bucket. The batch is
cut into runs of equal bucket id (a run never spans two reads); each run's
bucket rows are read once into a compacted buffer, copied to the lane where
the run starts and forward-filled over the run, so every lane holds its
bucket's rows with one row read a run instead of one a lane. The candidate
checks then run lane by lane on the filled rows (``sshash.inline_hits``).
The results equal ``sshash_k2u(mode="main")``'s at the full probe depth.

Plain torch on the index's device: the reference computes this in plain
``jnp`` (no Pallas kernel). Its associative scan becomes a ``cummax`` of
the run starts' lane indices and one gather, its MXU prefix sum a
``cumsum``, its ``.at[].max`` scatters ``scatter_reduce("amax")`` and its
``.at[].set`` an ``index_copy_`` into a buffer with a sacrificial row N.
"""

from __future__ import annotations

import torch

from .._words import mask32
from ..kmer import canonical_minimizer_batch, revcomp
from .boophf32 import fold_hash32
from .sshash import fused_kind, inline_hits, occ_fields


def _forward_fill(valid: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Row i of ``data`` [N, C] replaced by the row of the last lane at or
    before i with ``valid``; lanes before the first valid one take row 0
    (the reference's scan leaves them so)."""
    n = valid.shape[0]
    idx = torch.where(valid, torch.arange(n, device=valid.device), 0)
    return data[torch.cummax(idx, dim=0).values]


def run_starts(d: dict, fw: torch.Tensor, new_read: torch.Tensor):
    """(bool [N] run starts, the lanes' buckets, their minimizer offsets) of
    a batch of read k-mers on a direct-engine SSHash: a run starts where a
    read begins or the bucket changes. The canonical minimizer follows the
    k-mer's canonical strand, so on reads a run lasts about two k-mers."""
    m = d["meta"]
    mm, offset, _, _ = canonical_minimizer_batch(fw, m.k, m.w, m.seed, ordering=m.ordering)
    hc = fold_hash32(mm) & (m.direct_t - 1)
    return new_read | (hc != torch.cat([hc[:1] - 1, hc[:-1]])), hc, offset.to(torch.int64)


def sshash_k2u_reads_runshare(d: dict, fw: torch.Tensor, new_read: torch.Tensor) -> dict:
    """``sshash_k2u``'s main-mode fields over consecutive read k-mers, on a
    direct-engine SSHash's inline rows with flat32 bounds or its fixedcap
    rows (fused or not). On fixedcap rows a run reads its bucket's B =
    ``meta.cap`` rows at ``bucket * B``, every run has B occurrences, and
    a heavy bucket is the marker in its slot 0.

    ``fw``: int64 k-mer words in read order; ``new_read``: bool [N], True
    where a read begins. Returns unitig_id, unitig_len, pos, mt, ``use_skew``
    (heavy-bucket lanes, for the caller's overflow pass), on fused rows
    occ_word and occ_cnt, and ``run_overflow``: a bool tensor, True when the
    batch had more runs than run slots; the caller raises on it. There is a
    slot a lane, since a run has one lane at least, so it never fires. (The
    reference has ``N // 2`` slots, assuming runs of ~8 k-mers; read batches
    have ~2, ``run_starts``, and overflow it: C11.)"""
    m = d["meta"]
    if not m.direct_t:
        raise ValueError("run sharing reads a direct-engine SSHash's inline or fixedcap rows")
    fixedcap = m.pos_kind == "fixedcap"
    if not (fixedcap or (m.pos_kind == "inline" and "flat2" in d["prefix"])):
        raise ValueError(f"run sharing reads inline rows with flat32 bounds or fixedcap rows, "
                         f"not {m.pos_kind!r} rows with {m.prefix_kind!r} bounds")
    k, w = m.k, m.w
    B = m.cap if fixedcap else m.probe_bound
    N = fw.shape[0]
    M = N  # run slots: a run has one lane at least
    dev = fw.device
    rc = revcomp(fw, k)
    run_start, hc, offset = run_starts(d, fw, new_read)
    run_id = torch.cumsum(run_start.to(torch.int64), dim=0) - 1
    n_runs = run_id[-1] + 1
    rid = torch.clamp(run_id, 0, M - 1)

    # each run's bucket rows, read once into slot run_id
    neg = torch.full((N,), -1, dtype=torch.int64, device=dev)
    starts_h = torch.zeros(M, dtype=torch.int64, device=dev).scatter_reduce(
        0, rid, torch.where(run_start, hc, neg), "amax")
    rows = d["pos"]["inline"]
    if fixedcap:
        first = torch.clamp(starts_h, min=0) * B
        n_occs_m = torch.full_like(first, B)
    else:
        pair = d["prefix"]["flat2"][torch.clamp(starts_h, min=0)].to(torch.int64)
        first, n_occs_m = pair[:, 0], pair[:, 1] - pair[:, 0]
    K = rows.shape[1]
    last = max(rows.shape[0] - 1, 0)
    fetched = [rows[torch.clamp(first + j, 0, last)] for j in range(B)]
    fetched.append(n_occs_m.to(rows.dtype)[:, None])
    rows_m = torch.cat(fetched, dim=1)  # [M, B * K + 1]

    # each slot's rows to its run's first lane (unused slots to row N), then
    # forward-filled over the run
    starts_i = torch.zeros(M, dtype=torch.int64, device=dev).scatter_reduce(
        0, rid, torch.where(run_start, torch.arange(N, device=dev), neg), "amax")
    slot_active = torch.arange(M, device=dev) < n_runs
    dest = torch.where(slot_active, torch.clamp(starts_i, 0, N - 1), N)
    buf = torch.zeros(N + 1, B * K + 1, dtype=rows.dtype, device=dev)
    buf.index_copy_(0, dest, rows_m)
    filled = _forward_fill(run_start, buf[:N])

    n_occs = mask32(filled[:, B * K])
    if fixedcap:
        use_skew = mask32(filled[:, 1]) == 0xFFFFFFFE
    else:
        use_skew = n_occs > m.skew_param
    js = torch.arange(B, device=dev)
    active = (js[None, :] < n_occs[:, None]) & ~use_skew[:, None]
    fused, fused14 = fused_kind(m.pos_kind, K)
    any_hit, win = inline_hits(filled[:, : B * K].reshape(N, B, K), active, fw, rc,
                               (offset, (k - w) - offset), k, w, m.pos_kind, fused, fused14)
    win = {kk: torch.where(any_hit, v, 0) for kk, v in win.items()}
    out = {kk: win[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")}
    out.update(use_skew=use_skew, run_overflow=n_runs > M)
    if fused:
        # the reference's run-sharing path reads the count alone
        occ = occ_fields(win, fused14)
        out.update(occ_word=occ["occ_word"], occ_cnt=occ["occ_cnt"])
    return out
