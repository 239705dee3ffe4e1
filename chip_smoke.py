"""Run the port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py [--mbp 50] [--cap-mbp 300] [--mphf-mbp 300] [--gbp-mbp 3000]

Phases, each printing its own lines; any failure exits non-zero:

1. card check (fails without CUDA) and the card's name and power limit;
2. build of the five kernel sources from ``mazu_tpu_torch/csrc``, and of
   K3's source with the MPHF layout's far reads plain (written into the
   build directory, phase 20's comparison), one nvcc each, run together
   (phases 3, 9 and 13 print the reports of the lab, second and third
   sources);
3. the lab kernels L1-L5 (``csrc/gather_lab.cu``) against their plain torch
   versions on the card at the labs' shapes, N=1, a ragged N and all-same
   indices, bit-identical; L1 also on an unaligned index view, all-0 and
   all-(M-1) indices each called twice, ragged tables (M = 37, 2^18 - 1,
   2^18 + 1) and inputs written by the kernels just before it (its
   launch overlaps theirs), and L1's frozen first design (``sector_reads``)
   at the lab's shape; L3 and L4 also on ``xor_cases`` (ragged sizes
   around a 32-index group, fewer rows than warps, 3 x the warps + 5,
   only row 0, only row T - 1, pairs that cancel to zero; each called
   twice in a row); then the two lab entry points
   (``mazu_tpu_torch.labs.gather_probe`` and ``dma_lab``) as their main
   path; each kernel timed beside its plain version, its bound and the
   torch call that computes the same (``tbl[idx]``, ``index_select``), L1
   in turns with ``sector_reads``;
   the rates L1, L3 and L4 reach from L2 on larger batches (L1: 2^24
   random 4-byte reads of the 1 MB table; L3, L4: 2^21 random 512-byte rows
   of the 8 MB table); the card's L2 read rate, from ``l2_stream`` (an 8 MB
   and a 32 MB table read ~2 GB a launch with loads that no L1 serves, in
   order and in random orders), beside torch's ``.sum()`` over stride-0
   views as a cross-check, and L1's, L3's and L4's L2 floors at it, and
   whether any L3/L4 rate of the run exceeds it; the L2's random-sector
   rate, from ``l2_sectors`` (random 4-byte words of a 1 MB and an 8 MB
   table that no L1 serves), and L1's sector floor at it; then the card's
   random-read rates from device memory: ``sector_reads`` over a 1 GB
   table of u32 (2^22 random 4-byte reads: sectors/s; L1 on the same
   beside it) and L5 over a 1 GB table of 512-byte rows (2^18 random
   rows), all bit-identical to their plain versions;
4. the synthetic mono2-occ32 KCDict index (random genome, k=31, 10 kb
   unitigs, every 16th unitig with 3 occurrences, load 0.25), moved to the
   card, where its main table takes K1's 64-byte rows;
5. the mono2 kernel (K1) against its plain torch version on the card, all
   nine fields bit-identical: the adversarial batches of ``k1_cases``
   (ragged sizes around the 256-lane block and 2^20 + 37, foreign words,
   side-table, slot-1 and khi-bit-31 keys, the last occupied row, words
   whose bucket is row T - 1, all-A and all-T), then 2^20 queries (uniform over
   the index, half reverse-complemented, 5% foreign); both timed; the DRAM
   sectors and 64-byte blocks of a lane's row in the reference's 56-byte
   rows and in the card's 64-byte rows, and the floors they give;
5b. the phase-2 kernel (``ops/mono2_phase2``, ``csrc/mono2_phase2.cu``)
   against its plain version (``get_ref_pos_padded`` on the compacted
   lanes) on the same card tensors, every field of the real slots
   bit-identical and its side-table count exact: K1's adversarial batches
   and a tile of the most-occurring unitigs' keys, each at n_ovf = N, 0
   and N + 5 and through ``get_ref_pos_compact``; the benchmark cells'
   chunk shapes (2^20 and 245,760 slots) on the lanes the main phase
   leaves, at n_ovf 0 and M, and replayed from one CUDA graph whose n_ovf
   buffer is rewritten between replays; each timed in turns with the
   plain version, alone and inside the compacted query, beside its byte
   bound and its sector floor; then an index with a unitig of 300
   occurrences (more cells than a block's threads), also against the CPU;
5c. the ragged phase 2 (``ops/occ_csr``, ``csrc/occ_csr.cu``) on a fast32
   SSHash whose unitig 0 lies on 300 places (so the padded phase 2 would
   be wider than ``occ_csr.COLUMNS``): the kernel against its plain
   version (``occ_csr_plain``) on the same card tensors, every per-slot
   output, the total and every written entry bit-identical: lanes with 0,
   1, 3 and 300 occurrences, and 245,760 lanes (the benchmark's read
   chunk) uniform over the index with 5% foreign words, each at an exactly
   full budget, one short of it, a generous one and 1, and at n_ovf N, 0
   and N / 2; ``get_ref_pos_compact`` on the card against its CPU oracle,
   its slots' K2U (the full-depth main probe, the residue's full K2U)
   against the full K2U of every slot; the kernel and the block's
   checksum timed at the chunk beside the block's byte bound, and the
   slots' K2U beside the full K2U of every slot. Then the residue K2U
   (``ops/residue_k2u``, ``csrc/residue_k2u.cu``) on the benchmark's
   GRCh38-shaped genome at ``RESIDUE_SCALE``: ``_ragged_k2u`` with the
   kernel against the same with the plain residue K2U, every slot's K2U
   fields and the residue's count bit-identical, on ``residue_cases`` (a
   read chunk of the benchmark's mix, its heavy-bucket lanes alone,
   deferred winners that fail validation alone, foreign k-mers in heavy
   buckets), each at a residue capacity above, equal to and half of its
   count and with no real slot; the kernel timed at the chunk beside the
   plain residue K2U and its sector floor;
6. the mono2 main path: ``OneGraphIndexQuery.checksum_pass_rolled`` over
   16 rolled chunks of that batch, checked against the port's plain path
   on CPU tensors for chunk 0. Before it, ``TwoPhaseIndexQuery``'s
   ``checksum_query`` and ``query`` (K1 in the main phase) and
   ``get_ref_pos_csr`` on the whole batch, each equal to the same on CPU
   tensors. The pass runs as one CUDA graph (its first run: an eager
   warm-up, the capture, a replay; the capture's seconds and memory pool
   printed) and eagerly, the two checksums equal to each other and to 16
   x the oracle, then 7 passes of each timed in turns (median, min, max);
   a tensor derived from the index first asked for inside a capture must
   raise;
6e. phase 8b's reads1graph pass (the same read k-mers) on this index, K1
   in its main phase, replayed and eager, 3 passes each, against a CPU
   oracle of every chunk (listed here, it runs after phase 6);
6a. the serve pass (``bench.py::run_serve``'s device half,
   ``index.pipeline.RunServePass``) on that index: its color classes and
   bitsets (host seconds, classes, W, bytes on the card); 8 x 2,048 reads
   of 150 bases (``synth.serve_reads``, seed 1: uniform starts over the
   whole genome, half reverse-complemented, 1 in 100 with an N, 1 in 20
   foreign) written to a gzipped FASTQ and packed; the port's plain pass on
   CPU tensors gives every chunk's (map, pa, overflow) and sizes M2 from
   chunk 0 as run_serve does; the pass as one CUDA graph (capture seconds,
   pool bytes, K1's launches) and eagerly, both equal to the oracle chunk
   for chunk, and again with chunks 0 and 1 swapped; 3 passes of each timed
   in turns, end to end (``pack_fastq``, the fused parse and pack of the
   host library, then upload, pass, read-back) and the device pass alone,
   in read k-mers/s; the host's share split (``[serve host]``: gunzip,
   the fused parse and pack, the upload) and ``pack_fastq`` beside the
   Python reader and ``pack_reads`` on the same file; chunk 0 through the
   union and threshold (tau 0.7) policies and the class ids, card against
   CPU, and the host threshold count against the device count;
6b. the validation oracles on the card: ``validate_self`` over every k-mer
   of the 5,000 references through ``get_ref_pos_compact(merge=True)`` in
   chunks of 2^20 (K1 in the main phase), ``validate_fasta`` on a FASTA of
   the first 64 references, ``validate_k2u_self`` through ``k2u_batch``,
   each timed;
6c. the streaming index (``index.streaming.StreamingIndex``) on that index
   over phase 6a's reads (k-merized on the host): ``flat`` mode's
   ``k2u_reads`` and ``k2u_reads_packed`` replayed as CUDA graphs and
   eagerly, equal to each other with the same cold fraction (capture
   seconds and pools printed), then 3 passes of each and of the device
   pass alone timed in turns, in k-mers/s; ``scan`` mode once replayed;
   ``host`` mode on the first 2,048 reads; all equal to the flat pass, cold
   fractions too, and the first 512 reads equal to the plain path on CPU
   tensors; ``get_ref_pos_reads`` (flat), where every valid k-mer of every
   read drawn from the genome inside one reference (no N, not foreign)
   hits its true (ref, pos, orient); ``validate_fasta_streaming`` over all
   5,000 references, 4,096 lanes a batch, timed;
6d. the read mapper (``index.mapping.ReadMapper.map_file``) on a gzipped
   FASTQ of 8 x 2,048 reads drawn from the index's genome (``serve_reads``),
   on the card's copy of the index: the CSR hits of the first and the last
   512 reads (the first batch and the ragged last one) and of every foreign,
   N-holding or straddling read equal to the plain padded query on CPU
   tensors, every genome read's k-mers at
   their true (ref, pos, orient), K1 launched and counted; 3 runs timed
   (reads/s, k-mers/s); the same on the capacity index after phase 12 (K2)
   and on the MPHF index after phase 17 (K3); then the mono2 index leaves
   the card;
7. the pufferfish dense index (PFHash over a 64-bit BooPHF, the pf1
   occurrence table) over phase 4's genome, its MPHF lookup on the card;
   the 64-bit ``boophf_lookup`` on the card against the CPU on phase 5's
   2^20 canonical words; the padded path (``get_ref_pos_padded`` and
   ``bench.py``'s full-mode checksum) on phase 5's batch: a CPU oracle for
   chunk 0 that must hit every sampled lane at its sampled unitig and
   offset, then 16 rolled chunks on the card, replayed as one CUDA graph
   and run eagerly, both equal to 16 x the oracle, 3 passes of each timed
   in turns;
8. the same for pufferfish's sparse index (SampledPFHash, sample 9,
   extension 4);
8a. the SSHash speed tier's index over phase 4's genome (``bench.py``'s
   direct build of its read paths: w=15, skew 4, load 0.25, the minimizer
   scan on the card) in its fused inline2 rows (``synth.SPEED_LAYOUT``) and
   its fused inline rows, their bytes on the card (held to
   ``tuning.speed_bytes``);
8b. ``bench.py``'s reads1graph pass: a stack of 8 distinct chunks of 2^18
   k-mers of 150-base reads drawn over the whole genome
   (``OneGraphIndexQuery.checksum_pass``), at probe limit 2 on the inline2
   rows, M2 from the CPU oracle's overflow (``bench.py:991-1000``, here the
   worst chunk's); replayed and eager equal to the sum of the chunks' CPU
   oracles, 3 passes of each timed in turns (read k-mers/s);
8c. ``bench.py``'s reads path (BASELINE config 3): 8,192 reads k-merized on
   the host and padded to a power of two; ``TwoPhaseIndexQuery`` (fused
   inline rows) and ``ReadBatchQuery`` (run sharing) on the same words,
   both equal to the two-phase checksum on CPU tensors; the runs against
   the reference's run budget (N / 2 slots; the port has one a lane); 3 of
   each timed in turns;
8d. phase 5's 2^20 uniform queries through ``OneGraphIndexQuery`` on the
   inline2 rows, 16 rolled chunks, checked and timed as in phase 6;
8e. phase 6d's read mapper on the speed index: the speed tier by the tier
   rule, ``TwoPhaseIndexQuery`` on the fused inline rows, no kernel; in
   turns with it the capacity tier asked for (``CompactQuery``, K2), its
   hits equal;
21. (runs after 8e, on the speed index) the rest of the SSHash's layouts
   and the wavelet-matrix occurrence table, each against its CPU oracle:
   21a. synth50-fixedcap: the fused fixedcap2 and fixedcap rows (host
   seconds, host peak RSS, bytes on the card), phase 5's 2^20 uniform
   queries through ``OneGraphIndexQuery`` at probe limit 2, 16 rolled
   chunks, a CPU oracle of chunk 0 that must hit every sampled lane,
   replayed and eager, 3 passes each, beside 8d's inline2 rate; 21b. the
   records, flat32-position and packed-position (grouped32, flat and
   flat32 bounds) layouts beside the default inline rows:
   ``get_ref_pos_padded`` on those queries equal to the CPU's on every
   lane, timed; 21c. ``TwoPhaseSSHash`` (``bench.py``'s 2phase mode) on
   those queries, equal to one full-mode call and to the CPU, 10
   iterations timed with host words in and out; 21d. ``ReadBatchQuery``
   on the fused fixedcap rows over phase 8c's read k-mers, equal to
   ``TwoPhaseIndexQuery``'s on the same rows and to the CPU's, 3 of each
   timed in turns; 21e. four bucket shards laid out as the reference's
   ``shard_fused_arrays``: ``sshash_k2u(..., bucket_range=)`` exact zeros
   off each shard's lanes, their one-hot sum equal to the unsharded
   full-mode answer, timed; 21f. ``WMUnitigTable`` over the index's piscem
   table (both tables' ``num_bits``): a ``ModIndex`` over it answers the
   padded query equal to the piscem table's lane for lane, timed; and
   ``wm_access``, ``wm_rank`` and ``wm_select`` on 2^20 random arguments
   (absent symbols among them) over 2^20 random bytes and over the
   table's first plane, equal to the CPU, timed;
9. the bpos probe kernel's (K2) ptxas report;
10. the synthetic capacity index: an SSHash direct engine (w=15, skew 64,
    load 0.5) over a random genome with a planted skew bucket, its
    minimizer scan on the card; grouped16 bounds, packed positions, bpos
    rows and useqrec window records;
11. K2 against its plain torch version on the card, all nine fields
    bit-identical: N=1, N=257 with a foreign word and a skew lane, probe
    limits 1-3, then 2^20 queries; then the adversarial batches of a tiled
    kernel (``tile_cases``) at probe limits 1-3; both timed; its DRAM
    sectors and sector floor;
12. the capacity path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, middle phase 4; the
    port's plain path on CPU tensors gives chunk 0's oracle, which must hit
    every sampled lane at its sampled unitig and offset; replayed and
    eager as in phase 6, 3 passes of each; then ``TwoPhaseIndexQuery`` (K2
    in the main phase) and ``get_ref_pos_compact`` on these arrays without
    bpos rows and window records (K3 on the direct layout, the main phase
    projected through the offsets table), each equal to CPU tensors'; the
    mapper (6d), which the tier rule puts in the capacity tier (probe bound
    64), and in turns with it the speed tier asked for on the fused inline
    rows (12b, their host seconds printed), its hits equal;
12a. the same build laid out as the reference's tier rule lays it out on
    this card, fused inline2 rows (the host's fusion seconds and the bytes
    printed; the port's rule keeps it in the capacity tier), its 8 x 2^20
    queries through ``OneGraphIndexQuery`` at probe limit 2 against a CPU
    oracle for chunk 0, replayed and eager, 3 passes each, and its phase 2
    alone timed;
13. the capacity probe kernel's (K3) ptxas report;
14. K3 on the direct layout: phase 10's arrays on the card without bpos and
    useqrec, plus the per-unitig ``uproj`` records; against its plain
    torch version, all ten fields bit-identical, at probe limits 1-3 on
    N=1, N=257, 2^20 and phase 11's adversarial batches; both timed;
15. the synthetic MPHF index: an SSHash fast32 engine (BooPHF32 minimizer
    MPHF, w=19, skew 64, gamma 1.7) over a random genome with a planted
    skew minimizer, its minimizer scan and MPHF lookup on the card;
    grouped16 bounds, packed positions, paired arrays, uproj records;
16. K3 against its plain version on the MPHF index, all ten fields
    bit-identical, at MPHF level limits None and 4 and probe limits 1-3:
    N=1, N=257 (a skew lane, a foreign word, all-T, k-mers read across
    unitig boundaries) and 2^20; then the adversarial batches, with a tile
    that the one-level chain cannot place and the lanes that reach the
    final-hash table, at level limits None, 4, 2 and 1; both timed, its L2 and
    DRAM sectors and sector floor, and K3 at other level limits;
17. the MPHF path: ``OneGraphIndexQuery.checksum_pass_rolled`` over 8
    rolled chunks of 2^20 queries at probe limit 2, level limit 4,
    deferred validation, middle phase 4, checked against a CPU oracle and
    replayed and eager as in phase 12;
17a. reference fault C10 on the card: the fast32 index at its default
    fused inline layout through ``TwoPhaseIndexQuery``'s default on phase
    16's 2^20 queries, its skew lanes among them, equal lane for lane to the
    padded query on the capacity layout; then the mapper (6d) in the
    capacity tier by the rule and, in turns with it, the speed tier on those
    rows (17b), as in phase 12;
19. the reference's own entry point, the CLI (``mazu_tpu_torch.cli.main``
    in this process, with its defaults: the card, engine parity, w 15, skew
    64): phase 4's genome written as cuttlefish files, a FASTA of its
    references and a FASTQ of phase 6a's reads; ``index build piscem``
    (timed, with the checkpoint's save time and bytes), ``index stats``
    (bits/k-mer; once more as ``python -m mazu_tpu_torch.cli`` in a process
    of its own, the same lines), ``index validate-fasta`` and ``index map``
    (reads/s). Checks: ``load_index`` of the file gives arrays byte-identical
    to the built index's; ``validate_self`` on the card over every k-mer of
    the loaded index (its references read from the FASTA); the mapper's
    hits on the card equal the CLI's count and, for the first 1,024 reads,
    ``ReadMapper`` on CPU tensors read by read; phase 5's 2^20 uniform
    queries through ``OneGraphIndexQuery`` on the layout the tier rule
    picks, 16 rolled chunks, replayed and eager, against a CPU oracle of one
    chunk. Then the same build, ``validate-fasta`` and ``map`` with
    ``--engine mono2`` on a ``--cli-mono2-mbp`` genome (2 Mbp: the 50 Mbp
    table would spend minutes compressed into the file, and the run's time
    limit leaves this leg about 20 s), its K1 launches
    counted into K1's and its first 1,024 reads' hits held to the CPU's;
20. synth3000-mphf, the MPHF tier at 2^31 bases or more (runs after
    phase 19, before phase 18): the earlier indexes' card memory left for
    phase 18 is printed; ``synth.mphf_genome`` at ``--gbp-mbp`` (3,000
    Mbp: 300,000 unitigs, the tagged 19-mer planted) on the host, its
    seconds and peak host memory; the fast32 SSHash (w=19, skew 64, gamma
    1.7) built on the card, its seconds by stage, the card's peak
    allocation and the host's peak; ``device_arrays(**MPHF_LAYOUT)`` on
    the host by part, the move to the card and its bytes by array; the
    tier rule must keep it in the capacity tier; the card's build against
    the same build on CPU tensors at ``--mphf-check-mbp`` (10 Mbp), byte
    for byte; K3 against its plain version on 2^20 uniform queries (~28%
    of lanes past base 2^31) at level limits None and 4 and probe limits
    1-3 and on phase 16's tiles plus the k-mers of the five unitigs around
    base 2^31 and of the last unitig; K3 timed in turns with its
    plain-far-read build (does evict-first still pay when the MPHF misses
    the L2?), its bound and its sector floor with the MPHF's sectors in
    DRAM; the ``mrows`` MPHF's lookup of the batch's minimizers equal to
    the lean layout's, K3's layout check refusing it and the compact query
    on it taking the plain probe; every k-mer of the unitigs over bases
    [2^31 - 2^25, 2^31 + 2^25), every other one reverse-complemented,
    found at its unitig and offset through ``get_ref_pos_compact``;
    ``validate_ckmers`` on the references of those five unitigs and of the
    last; the MPHF path as in phase 17 (8 x 2^20, replayed and eager, CPU
    oracle);
    the mapper (6d) by the tier rule and the first 1,024 reads' hits equal
    to ``ReadMapper`` on CPU tensors; its profiled passes; then the index
    is freed;
22. the rest of the KCDict (after 19): a cuckoo KCDict through the CLI
    (``index build piscem --engine cuckoo`` over ``--cuckoo-mbp`` of the
    genome as cuttlefish files, ``validate-fasta``; ``kphf build cuckoo
    --validate`` over ``--cuckoo-kphf-mbp``), its padded query of 2^20 on the card against the CPU and
    the sampled truth; a wide-slot mono2 dictionary over a 2^24-base
    unitig and the mono layout of the same keys, main and full K2U on the
    card against the CPU, ``get_ref_pos_compact`` on it launching no K1;
    22c (after 6d, on the mono2 index): ``bucket_range`` on four shards of
    its table, whose one-hot sum is the whole table's answer, side-table
    hits from their owner alone;
23. the sharded queries, each held to the unsharded query on the card
    (itself held to the CPU on 2^16 lanes or to the sampled truth): 23a
    (after 22c) a ``DistMesh`` over NCCL at world size 1 (the
    data-parallel and mono sharded queries), then ``SerialMesh`` at 1x4
    and 2x4 (the data-parallel query launching K1 on every rank, the mono
    sharded query); 23b (after 21, on synth50-speed's fused inline2 rows)
    the fused sharded query at 1x4 and 2x4, a sharded checkpoint of four
    shards saved, loaded shard by shard onto the card and queried, and
    ``validate_k2u_self_sharded`` through it (every k-mer, or a stated
    prefix where that would pass 60 s); 23c (after 14, on
    synth300-capacity's direct SSHash) the bucket-sharded and all-to-all
    K2U (the all-to-all's ``routed_ok`` share) and the compact sharded
    query with and without the ``bpos`` rows and ``useqrec`` records, at
    1x4 and 2x4; per-shard seconds, bytes a shard and the whole;
18. one profiled replayed pass and one profiled eager pass of each of the
    paths of phases 6, 6a and 6c (its index moved to the card again; the
    serve pass's device pass alone; the flat streaming pass on the device),
    7, 8, 8b, 8d, 21a's fixedcap2 path (its rows built again), 12, 17 and
    19, recording the device alone: device busy share and the kernels that
    take the time (an eager pass is not profiled once the run passes
    ``EAGER_PROFILE_UNTIL_S``, and a line says so). It runs last
    because a profiler session slows the host's launches for the rest of
    the process (measured: the MPHF pass took 1.6-2x longer after one).

Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the bytes it must move (each input read once, only the rows a
lane reads; each output written once) over 3.35 TB/s, or its integer
operations over 67 T/s where that is larger. K1's, K2's and K3's
``sector_floor_ms`` is the DRAM sectors their lanes touch over phase 3's
random-sector rate (K1's ``block_floor_ms``: its 64-byte blocks at the
same rate); the phase-2 kernel's is its real slots' row sectors at that
rate plus its output bytes at 3.35 TB/s, and its ``compact_ms`` and
``compact_plain_ms`` time ``get_ref_pos_compact`` with it and with the
plain phase 2. L1's, L3's and L4's ``large_batch_ms`` is their work at the
rate the same kernel reaches from L2 on phase 3's larger batch: it shows
the launch and tail share, and is no floor, since the kernel's own costs
set it. Their ``l2_floor_ms`` is: the bytes they move through the L2 (a
32-byte sector per random 4-byte read, 512 bytes per row, and the index
and output streams) over the L2 read rate of phase 3, which
``l2_stream`` sets. L1's ``sector_floor_ms`` is its N random reads at the
L2's random-sector rate (``l2_sectors``) plus its 8N bytes of index and
output streams at that read rate; its ``before_ms`` is its frozen first
design's time in the same turns. A kernel's ``launches`` on a path run as a
graph count the eager warm-up's and the captured launches: a replay
adds none; K1's are those of phase 6's, 6e's and 6a's first replayed
passes, of phase 6d's first mapper run, of phase 23a's data-parallel
queries and of phase 19's mono2 CLI calls, K2's and K3's those of their
main path's first replayed pass and of their mapper's first run (K3's on
phases 17 and 20). K3's record also holds phase 20's numbers (``gbp_*``). The last
two lines are the kernels' JSON record and the result
JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import resource
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mazu_tpu_torch._words import mask32, umin
from mazu_tpu_torch.containers.unitig_set import us_get_kmer
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import (
    ModIndex, QueryIndex, _ragged_k2u, build_uproj, get_ref_pos_compact, get_ref_pos_csr,
    get_ref_pos_padded, k2u_batch, merge_compact_k2u, residue_full_k2u,
)
from mazu_tpu_torch.index.pipeline import (
    OneGraphIndexQuery, RunServePass, checksum_padded_rolled, padded_checksum, serve_buffer,
)
from mazu_tpu_torch.index.pseudoalign import (
    classify_kmers, color_bitsets, count_threshold_host, pseudoalign_batch,
    pseudoalign_threshold_batch, tau_q32,
)
from mazu_tpu_torch.index.mapping import BatchHits, ReadMapper
from mazu_tpu_torch.index.tuning import query_tier, speed_bytes
from mazu_tpu_torch.index.streaming import (
    StreamingIndex, kmerize_reads, validate_fasta_streaming,
)
from mazu_tpu_torch.index.validate import (
    validate_ckmers, validate_fasta, validate_k2u_self, validate_self,
)
from mazu_tpu_torch.io.fasta import open_binary
from mazu_tpu_torch.io.fastq import read_fastq
from mazu_tpu_torch.io.native import fastq_pack, kmerize_batch
from mazu_tpu_torch.io.reads import kmerize_device, pack_fastq, pack_reads, pad_reads
from mazu_tpu_torch.index.twophase import ReadBatchQuery, TwoPhaseIndexQuery, _host, _main_probe
from mazu_tpu_torch.bits.seqvector import SeqVector
from mazu_tpu_torch.bits.wm import WaveletMatrix, wm_access, wm_rank, wm_select
from mazu_tpu_torch.index.unitig_table import WMUnitigTable
from mazu_tpu_torch.kphf.runshare import run_starts
from mazu_tpu_torch.ops.derived import derived
from mazu_tpu_torch.kmer import canonical_minimizer_batch, mask2k, revcomp, revcomp_np
from mazu_tpu_torch.kphf.boophf import boophf_lookup
from mazu_tpu_torch.kphf.boophf32 import (
    _C2, _GOLD, chain_next, fold_hash32, fold_hash32_np, key_fold32, mix32_np, unmix32_np,
)
from mazu_tpu_torch.kphf.kcdict import SLOTS, SW, kcdict_k2u
from mazu_tpu_torch.kphf.sshash import (
    TwoPhaseSSHash, _pos_get, _prefix_pair, mphf_lookup, shard_arrays, sshash_k2u,
)
from mazu_tpu_torch.labs import cuda_ms, dma_lab, gather_probe
from mazu_tpu_torch.ops import (
    bpos_probe, capacity_probe, gather_lab, mono2_phase2, mono2_probe, occ_csr, residue_k2u,
)
from mazu_tpu_torch.ops.compact import flagged_lanes
from mazu_tpu_torch.ops.cuda_build import compile_all
from mazu_tpu_torch import synth

BATCH = 1 << 20
CH = 16
PASSES = 7  # timed passes of the mono2 main path
CAP_CH = 8  # rolled chunks per capacity pass (bench.py:366)
PLIM, PLIM2 = 2, 4  # capacity probe limits: main phase, middle phase
FIELDS = ("unitig_id", "unitig_len", "pos", "occ_cnt", "mt", "occ_word", "occ_word2",
          "use_skew", "unresolved")
FIELDS3 = FIELDS + ("occ_start",)  # K3 with uproj records
MLIM = synth.MPHF_QUERY["mphf_level_limit"]  # the MPHF path's main-phase level limit
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
INT_OPS = 67e12  # H100 SXM non-tensor rate (the guide's float32 figure), operations/s
K2U_OUT = 6 * 8 + 3  # bytes of a lane's nine K1/K2 outputs (six int64, three u8/bool)
SERVE_PASSES = 3  # timed serve passes of each kind
STREAM_PASSES = 3  # timed flat streaming passes of each kind
HOST_READS = 2048  # reads of the host-loop streaming pass
ORACLE_READS = 512  # reads held to the CPU's plain path in phases 6c and 6d
STREAM_LANES = 4096  # lanes a batch of validate_fasta_streaming
MAP_PASSES = 3  # timed read-mapper runs an index
TAU = 0.7  # the threshold policy's fraction on chunk 0
VALIDATE_CHUNK = 1 << 20
SPEED_CH = 8  # rolled chunks of a reads1graph pass (bench.py:946-1010, MAZU_BENCH_CHUNKS)
READ_BATCH = 1 << 18  # read k-mers a reads1graph chunk (MAZU_BENCH_BATCH)
READS = 8192  # reads of the reads path (bench.py:637-657, MAZU_BENCH_READS)
LAYOUT_ORACLE = 1 << 18  # lanes of phase 21b's CPU oracles
SHARD_M2 = BATCH // 4  # phase-2 lanes a data shard of the sharded queries (phase 23)
# (lanes, m2) of a chunk of the benchmark's cells: tx50-mono2.kmers, tx50-mono2.reads
P2_SHAPES = ((1 << 20, 1 << 20), (2048 * 120, 2048 * 120))
P2_TURNS = 3  # timed turns of the phase-2 kernel and its plain version
P2_OUT = 7 * 8 + 1  # bytes of a phase-2 slot's K2U fields and count
P2_CELL = 8 + 8 + 4 + 1  # bytes of a phase-2 output cell: ref_id, ref_pos, orient, valid
MANY_OCCS = 300  # occurrences of one unitig of phase 5b's many-occurrence index
SERVE_LANES = synth.SERVE_READS * (synth.READ_LEN - synth.K + 1)  # a read chunk's lanes
# phase 5c's residue K2U: the benchmark's GRCh38-shaped genome at this share
# of its lengths and copy counts (154 Mbp), and a chunk of its read traffic
RESIDUE_SCALE = 0.05
RESIDUE_CONFIG = "portbench/configs/hg-scale-fast32.json"
RESIDUE_TRAFFIC = "portbench/traffic/genome-reads-16k.json"
RESIDUE_OUT = 3 * 8 + 1  # bytes of a residue slot's K2U fields
# phase 18 profiles no more eager passes past this many seconds of the run,
# so that a slow machine still ends inside the 1,200 s limit
EAGER_PROFILE_UNTIL_S = 1100.0


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def mark(phase: str) -> None:
    """A phase's start, in seconds since the script started."""
    log(f"[time] phase {phase} starts at {time.perf_counter() - T0:.1f} s")


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """(milliseconds, what bounds it): the larger of ``n_bytes`` over the
    card's memory rate and ``n_ops`` over its integer rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / INT_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name: str, source: str, replaces: str, launches: int, max_err: int, ms: float,
           plain_ms: float, bound_ms: tuple[float, str], library_ms=None, **extra) -> dict:
    """One kernel's entry of the kernels line (``extra``: the floors, K1-K3's
    and L1's ``sector_floor_ms``, K1's ``block_floor_ms``, L1/L3/L4's
    ``large_batch_ms`` and ``l2_floor_ms``, L1's ``before_ms``)."""
    return {
        "name": name, "route": "cuda", "source": f"mazu_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
        "library_ms": library_ms, **extra,
    }


def distinct(ids: torch.Tensor) -> torch.Tensor:
    """The distinct ids >= 0 in each row of ``ids`` [N, m] (-1 pads)."""
    s = torch.sort(ids, dim=1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return ((s >= 0) & new).sum(dim=1)


def sector_ids(lo: torch.Tensor, n_bytes: int, on: torch.Tensor, size: int = 32) -> list:
    """Ids of the ``size``-byte sectors of the bytes [lo, lo + n_bytes), -1
    where ``on`` is false or past the range's last sector."""
    first, last = lo // size, (lo + n_bytes - 1) // size
    return [torch.where(on & (first + t <= last), first + t, -1)
            for t in range((n_bytes + 2 * size - 2) // size)]


def compare_k2u(d: dict, fw: torch.Tensor, what: str, kernel=None, plain=None,
                fields=FIELDS) -> int:
    """Kernel vs plain version on the same card tensors (by default K1 and
    ``kcdict_k2u``); every field must be bit-identical. Returns the max
    absolute difference (0)."""
    got = (kernel or mono2_probe.mono2_k2u)(d, fw)
    want = (plain or (lambda d_, f_: kcdict_k2u(d_, f_, mode="main")))(d, fw)
    if set(got) != set(want) or not set(fields) <= set(got):
        raise AssertionError(f"{what}: fields {sorted(got)} / {sorted(want)}, expected {fields}")
    err = 0
    for key in fields:
        g, w = got[key], want[key]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {key} is {g.dtype}{tuple(g.shape)}, "
                                 f"plain gives {w.dtype}{tuple(w.shape)}")
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        err = max(err, diff)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel and plain version differ in {key}")
    return err


def tile_cases(work: np.ndarray, skew: torch.Tensor, us, k: int, tile: int) -> dict:
    """Adversarial batches for a tiled kernel (``tile`` lanes a block):
    2^20 + 37 lanes; the tile size -1, exactly and +1; a tile of one key;
    tiles of skew lanes only and of foreign k-mers only; and the 200
    boundary k-mers (deferred winners that fail validation, K2's mt == 3
    sentinel)."""
    skew_words = work[torch.nonzero(skew)[:, 0].cpu().numpy()]
    rng = np.random.default_rng(8)
    return {
        f"N={len(work)}+37": np.concatenate([work, work[:37]]),
        f"N={tile - 1}": work[: tile - 1],
        f"N={tile}": work[:tile],
        f"N={tile + 1}": work[: tile + 1],
        "one key": np.full(tile, work[0]),
        "skew only": np.resize(skew_words, tile),
        "foreign only": rng.integers(0, 1 << (2 * k), tile, dtype=np.uint64),
        "200 boundary": synth.sample_boundary_queries(us, 200, seed=6),
    }


def k1_cases(k2u: dict, work: np.ndarray, tile: int = mono2_probe.TILE, seed: int = 8) -> dict:
    """Adversarial batches for K1 on a host mono2 dict ``k2u`` (NumPy, the
    reference's [T, 14] table): ragged sizes around the ``tile``-lane
    block and 2^20 + 37 lanes; tiles of foreign words, of side-table keys
    (``unresolved`` in main mode), of slot-1 keys, of keys whose slot has
    bit 31 of khi set, of the keys of the last occupied row, and of words
    whose bucket is row T - 1 (its keys where it holds any, then foreign
    words made to hash there), each half reverse-complemented; all-A and
    all-T."""
    table, k, t = k2u["table"], k2u["meta"].k, k2u["meta"].t
    rng = np.random.default_rng(seed)
    u64, u32 = np.uint64, np.uint32

    def keys(tbl, rows, slot):
        c = slot * SW
        return tbl[rows, c].astype(u64) | ((tbl[rows, c + 1] & u32(0x7FFFFFFF)).astype(u64)
                                           << u64(32))

    def row_keys(row):
        return np.concatenate([keys(table, [row], s) for s in range(SLOTS)
                               if table[row, s * SW] != 0xFFFFFFFF] + [np.zeros(0, u64)])

    def both_ways(words):
        words = np.resize(words, tile)
        flip = rng.random(tile) < 0.5
        words[flip] = revcomp_np(words[flip], k)
        return words

    def to_last_row(n):
        # fold_hash32 = mix32(lo ^ GOLD) ^ mix32(hi + C2): pick hi, then the
        # low word whose mix completes the bucket T - 1; keep canonical words
        hi = rng.integers(0, 1 << (2 * k - 32), n, dtype=u64).astype(u32)
        want = (mix32_np(hi + u32(_C2)) ^ u32(t - 1)) & u32(t - 1)
        mixed = (rng.integers(0, 1 << 32, n, dtype=u64).astype(u32) & ~u32(t - 1)) | want
        words = (hi.astype(u64) << u64(32)) | (unmix32_np(mixed) ^ u32(_GOLD)).astype(u64)
        words = words[words <= revcomp_np(words, k)]
        if not (fold_hash32_np(words) & u32(t - 1) == t - 1).all():
            raise AssertionError("words made for row T - 1 hash elsewhere")
        return words

    occ0 = np.flatnonzero(table[:, 0] != 0xFFFFFFFF)
    occ1 = np.flatnonzero(table[:, SW] != 0xFFFFFFFF)
    bit31 = occ0[(table[occ0, 1] >> 31) == 1][:tile]
    last = int(max(occ0[-1], occ1[-1] if len(occ1) else -1))
    cases = {
        "N=1": work[:1],
        f"N={tile - 1}": work[: tile - 1],
        f"N={tile}": work[:tile],
        f"N={tile + 1}": work[: tile + 1],
        f"N={len(work)}+37": np.concatenate([work, work[:37]]),
        "foreign only": rng.integers(0, 1 << (2 * k), tile, dtype=u64),
        "slot-1 keys": both_ways(keys(table, occ1[:tile], 1)),
        "khi bit 31 keys": both_ways(keys(table, bit31, 0)),
        f"row {last} (last occupied)": both_ways(row_keys(last)),
        f"row T - 1 = {t - 1} ({len(row_keys(t - 1))} keys)": both_ways(
            np.concatenate([row_keys(t - 1), to_last_row(tile)])),
        "all-A": np.zeros(tile, dtype=u64),
        "all-T": np.full(tile, mask2k(k), dtype=u64),
    }
    if "side" in k2u:
        side = k2u["side"]
        cases["side-table keys"] = both_ways(np.concatenate(
            [keys(side, np.flatnonzero(side[:, s * SW] != 0xFFFFFFFF), s) for s in range(SLOTS)]))
    return cases


def row_spans(k2u: dict, fw: torch.Tensor, row_bytes: int) -> tuple[int, int]:
    """(32-byte sectors, 64-byte blocks) that the bucket rows of ``fw``
    span, summed over the lanes, for rows of ``row_bytes`` at
    ``h * row_bytes``."""
    m = k2u["meta"]
    lo = (fold_hash32(umin(fw, revcomp(fw, m.k))) & (m.t - 1)) * row_bytes
    hi = lo + row_bytes - 1
    return tuple(int((hi // size - lo // size + 1).sum()) for size in (32, 64))


def compare_cases(tag: str, d: dict, cases: dict, runs, dev) -> int:
    """Every case of ``cases`` through every (label, kernel, plain, fields)
    of ``runs``, bit-identical; returns the max absolute difference (0)."""
    err = 0
    for name, words in cases.items():
        fw = torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(dev)
        for label, kern, plain, fields in runs:
            err = max(err, compare_k2u(d, fw, f"{tag} {name} {label}", kern, plain, fields))
    log(f"[{tag}] {'; '.join(cases)} at {', '.join(r[0] for r in runs)}: bit-identical")
    return err


@contextlib.contextmanager
def plain_phase2():
    """``get_ref_pos_compact``'s phase 2 on its plain path while inside: the
    phase-2 kernel's oracle on the same card tensors."""
    real = mono2_phase2.engages
    mono2_phase2.engages = lambda d, device: False
    try:
        yield
    finally:
        mono2_phase2.engages = real


def side_count(d: dict, fw: torch.Tensor, lanes: torch.Tensor, n: int) -> int:
    """The real slots (the first ``n``) whose key the main table does not
    hold, where the dictionary has a side table: what the phase-2 kernel's
    counter must read."""
    if "side" not in d["k2u"] or not n:
        return 0
    return int(kcdict_k2u(d["k2u"], fw[lanes[:n]], mode="main")["unresolved"].sum())


def same_slots(what: str, got: dict, want: dict, n: int) -> None:
    """Every field of ``got`` equal to ``want``'s on the first ``n`` slots,
    with the same keys, dtypes and shapes."""
    if list(got) != list(want):
        raise AssertionError(f"[p2] {what}: keys {list(got)}, plain gives {list(want)}")
    for key, w in want.items():
        g = got[key]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"[p2] {what}: {key} is {g.dtype}{tuple(g.shape)}, plain gives "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(g[:n], w[:n]):
            raise AssertionError(f"[p2] {what}: kernel and plain version differ in {key} on the "
                                 f"real slots")


def compare_phase2(d: dict, fw: torch.Tensor, lanes: torch.Tensor, n_ovf: int, mo: int,
                   what: str) -> None:
    """The phase-2 kernel against ``get_ref_pos_padded(d, fw[lanes], mo)``
    on the same card tensors: every field bit-identical on the real slots,
    and its side-table count equal to ``side_count``."""
    side = torch.zeros((), dtype=torch.int64, device=fw.device)
    nt = torch.tensor(n_ovf, dtype=torch.int64, device=fw.device)
    got = mono2_phase2.mono2_phase2(d, fw, lanes, nt, mo, side_probes=side)
    n = min(n_ovf, lanes.shape[0])
    same_slots(what, got, get_ref_pos_padded(d, fw[lanes], mo), n)
    if int(side) != side_count(d, fw, lanes, n):
        raise AssertionError(f"[p2] {what}: {int(side)} side probes counted, "
                             f"{side_count(d, fw, lanes, n)} real slots missed the main table")


def same_compact(what: str, got: dict, want: dict) -> None:
    """Two ``get_ref_pos_compact(merge=False)`` results equal: every piece,
    and phase 2 on its real slots."""
    if set(got) != set(want):
        raise AssertionError(f"[p2] {what}: pieces {sorted(got)} / {sorted(want)}")
    for key in ("overflow", "lanes", "slot_real", "n_ovf", "over_budget"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"[p2] {what}: {key} differs")
    for key, w in want["main"].items():
        if not torch.equal(got["main"][key], w):
            raise AssertionError(f"[p2] {what}: main.{key} differs")
    same_slots(what, got["phase2"], want["phase2"], int(want["slot_real"].sum()))


def phase2_cases(host: dict, index, work: np.ndarray, seed: int = 9) -> dict:
    """Adversarial batches for the phase-2 kernel: K1's (``k1_cases``:
    N = 1, ragged sizes around the 256-slot block and 2^20 + 37, all
    misses, all side-table keys, ...) and a tile of keys of the unitigs
    with the index's most occurrences, half reverse-complemented."""
    cases = k1_cases(host["k2u"], work)
    us = index.k2u.unitigs
    accum = np.asarray(us.accum)
    cnt = np.diff(np.asarray(index.u2pos.offsets))
    rng = np.random.default_rng(seed)
    u = rng.choice(np.flatnonzero(cnt == cnt.max()), mono2_phase2.TILE)
    span = accum[u + 1] - accum[u] - us.k + 1
    words = np.asarray(us.get_kmer_u64(accum[u] + (rng.random(len(u)) * span).astype(np.int64)),
                       dtype=np.uint64)
    flip = rng.random(len(u)) < 0.5
    words[flip] = revcomp_np(words[flip], us.k)
    cases[f"max-occurrence unitigs ({cnt.max()})"] = words
    return cases


def many_occ_index(seed: int = 3):
    """A mono2-occ32 index over 64 random unitigs of ``synth.PIECE`` bases,
    each its own reference, where unitig 0 also lies on ``MANY_OCCS`` - 1
    other places of the references: phase 2's cells outnumber a block's
    threads."""
    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.kcdict import KCDict

    rng = np.random.default_rng(seed)
    n = 64
    sv = SeqVector.from_codes(rng.integers(0, 4, n * synth.PIECE, dtype=np.uint8))
    accum = np.arange(n + 1, dtype=np.int64) * synth.PIECE
    unitigs = UnitigSet(synth.K, sv, accum)
    names = [f"r{i}" for i in range(n)]
    extra = MANY_OCCS - 1
    spt = SPT(unitigs, names,
              np.concatenate([np.arange(n), np.zeros(extra, dtype=np.int64)]),
              np.concatenate([np.arange(n), rng.integers(0, n, extra)]),
              np.concatenate([np.zeros(n, dtype=np.int64), rng.integers(0, synth.PIECE, extra)]),
              np.concatenate([np.ones(n, dtype=np.int64), rng.integers(0, 2, extra)]),
              np.full(n, synth.PIECE, dtype=np.int64))
    u2pos = spt.piscem_table()
    k2u = KCDict.from_unitig_set(unitigs, load=synth.LOAD, occ_table=u2pos, scheme="mono2")
    return ModIndex(k2u, u2pos, RefSeqCollection(sv, accum, names), index_type="many-occs")


def phase2_phase(tag: str, index, host: dict, gpu_index, work: np.ndarray, dev, smi,
                 sector_rate: float) -> dict:
    """Phase 5b: the phase-2 kernel (``ops/mono2_phase2``) on the card
    against its plain version on the same card tensors, every field of the
    real slots bit-identical and its side-table count exact: on
    ``phase2_cases`` (each at n_ovf = N, 0 and N + 5, and through
    ``get_ref_pos_compact``), at the benchmark cells' chunk shapes
    (``P2_SHAPES``: the lanes of ``work`` the main phase leaves, and n_ovf
    0 and M; replayed from one CUDA graph at two n_ovf written into its
    buffer; timed in turns with the plain version, alone and inside the
    compacted query) and on ``many_occ_index``. Returns its entry of the
    kernels line (``launches`` filled in by the caller)."""
    d = gpu_index.arrays()
    mo = gpu_index.max_occs
    if not mono2_phase2.engages(d, dev):
        raise AssertionError(f"[{tag}] the phase-2 kernel does not engage on this index")
    cases = phase2_cases(host, index, work)
    for name, words in cases.items():
        fw = torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(dev)
        lanes = torch.arange(fw.shape[0], device=dev)
        for n in (fw.shape[0], 0, fw.shape[0] + 5):
            compare_phase2(d, fw, lanes, n, mo, f"{name}, n_ovf {n}")
        with plain_phase2():
            want = get_ref_pos_compact(d, fw, mo, merge=False, m2=fw.shape[0])
        same_compact(name, get_ref_pos_compact(d, fw, mo, merge=False, m2=fw.shape[0]), want)
    log(f"[{tag}] {'; '.join(cases)}: bit-identical on every field of the real slots at "
        f"n_ovf = N, 0 and N + 5, side probes counted exactly, and through get_ref_pos_compact")
    out = None
    for N, M in P2_SHAPES:
        fw = torch.from_numpy(np.ascontiguousarray(work[:N]).view(np.int64)).to(dev)
        with plain_phase2():
            want = get_ref_pos_compact(d, fw, mo, merge=False, m2=M)
        same_compact(f"N={N} M={M}", get_ref_pos_compact(d, fw, mo, merge=False, m2=M), want)
        lanes, n_ovf = want["lanes"], want["n_ovf"]
        n = min(int(n_ovf), M)
        for nn in (0, M):
            compare_phase2(d, fw, lanes, nn, mo, f"N={N} M={M}, n_ovf {nn}")
        # replayed: one graph of the kernel, its n_ovf read from a buffer
        nbuf = n_ovf.clone()
        side = torch.zeros((), dtype=torch.int64, device=dev)
        mono2_phase2.mono2_phase2(d, fw, lanes, nbuf, mo)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gout = mono2_phase2.mono2_phase2(d, fw, lanes, nbuf, mo, side_probes=side)
        for nn in (n, n // 2):
            nbuf.fill_(nn)
            side.zero_()
            graph.replay()
            same_slots(f"N={N} replayed at n_ovf {nn}", gout, get_ref_pos_padded(d, fw[lanes], mo),
                       nn)
            if int(side) != side_count(d, fw, lanes, nn):
                raise AssertionError(f"[{tag}] N={N} replayed at n_ovf {nn}: side count "
                                     f"{int(side)}")
        del graph, gout

        def kernel():
            return mono2_phase2.mono2_phase2(d, fw, lanes, n_ovf, mo)

        def plain():
            return get_ref_pos_padded(d, fw[lanes], mo)

        def compact():
            return get_ref_pos_compact(d, fw, mo, merge=False, m2=M)

        def compact_plain():
            with plain_phase2():
                return compact()

        times = {"kernel": [], "plain": [], "compact": [], "compact_plain": []}
        for _ in range(P2_TURNS):
            for key, fn, iters in (("kernel", kernel, 20), ("plain", plain, 3),
                                   ("compact", compact, 5), ("compact_plain", compact_plain, 3)):
                times[key].append(cuda_ms(fn, iters))
        med = {key: statistics.median(v) for key, v in times.items()}
        occs = int(want["phase2"]["n_occs"][:n].sum())
        n_side = side_count(d, fw, lanes, n)
        out_bytes = n * (P2_OUT + P2_CELL * mo)
        # each real lane reads its slot's lane index and word, one 64-byte
        # row (two 56-byte side rows where the main row misses), its two
        # offsets and its occurrence words, and writes its outputs
        p2_bound = bound(n * (8 + 8 + 4 * mono2_probe.ROW_WORDS + 16) + 2 * 4 * SLOTS * SW * n_side
                         + 8 * occs + out_bytes)
        sec, _ = row_spans(d["k2u"], fw[lanes[:n]], 4 * mono2_probe.ROW_WORDS)
        floor = (sec / sector_rate + out_bytes / HBM_BPS) * 1e3
        log(f"[{tag}] N={N} M={M} max_occs={mo}: {n} real slots ({n / M:.4f} of M), {occs} "
            f"occurrences ({occs / max(n, 1):.3f} a slot), {n_side} side probes; bit-identical to "
            f"the plain version through get_ref_pos_compact, at n_ovf 0 and M, and replayed at "
            f"n_ovf {n} and {n // 2}")
        log(f"[{tag}] N={N} M={M}: kernel {med['kernel']:.4f} ms {times['kernel']}, plain "
            f"{med['plain']:.4f} ms {times['plain']} ({med['plain'] / med['kernel']:.1f}x); "
            f"get_ref_pos_compact {med['compact']:.4f} ms against {med['compact_plain']:.4f} ms on "
            f"the plain phase 2; bound {p2_bound[0]:.4f} ms ({p2_bound[1]}, kernel at "
            f"{p2_bound[0] / med['kernel']:.1%}); sector floor {floor:.4f} ms ({sec} DRAM row "
            f"sectors at {sector_rate / 1e9:.3f} G/s, {out_bytes} output bytes at "
            f"{HBM_BPS / 1e12:.2f} TB/s; kernel at {floor / med['kernel']:.1%}) ({smi})")
        if out is None:  # the first shape is the record's
            out = record("mono2_phase2", "mono2_phase2.cu",
                         "none (plain jnp: mazu_tpu/index/modindex.py get_ref_pos_compact)", 0, 0,
                         med["kernel"], med["plain"], p2_bound, sector_floor_ms=floor,
                         compact_ms=med["compact"], compact_plain_ms=med["compact_plain"])
        del want, lanes, n_ovf, fw
        torch.cuda.empty_cache()
    mi = many_occ_index()
    mh = mi.device_arrays()
    mq = QueryIndex(arrays_from_numpy(mh, "cpu")).to(dev)
    md, mmo = mq.arrays(), mq.max_occs
    us = mi.k2u.unitigs
    words = np.concatenate([us.get_kmer_u64(np.arange(0, synth.PIECE - us.k + 1, 7)),
                            synth.sample_queries_truth(us, 4096, seed=2)[0]])
    fw = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint64).view(np.int64)).to(dev)
    lanes = torch.arange(fw.shape[0], device=dev)
    for n in (fw.shape[0], 0, 1000):
        compare_phase2(md, fw, lanes, n, mmo, f"many occurrences, n_ovf {n}")
    with plain_phase2():
        want = get_ref_pos_compact(md, fw, mmo, merge=False, m2=fw.shape[0])
    same_compact("many occurrences", get_ref_pos_compact(md, fw, mmo, merge=False,
                                                         m2=fw.shape[0]), want)
    cpu = get_ref_pos_padded(arrays_from_numpy(mh, "cpu"), fw.cpu(), mmo)
    got = mono2_phase2.mono2_phase2(md, fw, lanes, torch.tensor(fw.shape[0], device=dev), mmo)
    same_slots("many occurrences against the CPU", {kk: v.cpu() for kk, v in got.items()}, cpu,
               fw.shape[0])
    log(f"[{tag}] many-occurrence index (max_occs {mmo}, {fw.shape[0]} lanes): bit-identical "
        f"to the plain version on the card and on the CPU")
    del mq, md
    return out



def ragged_index(dev, seed: int = 5):
    """The fast32 SSHash (the MPHF tier's settings) over 64 random unitigs
    of ``synth.PIECE`` bases, each its own reference; unitig 0 also lies on
    ``MANY_OCCS`` - 1 other places and unitig 1 on two: (ModIndex, its
    ``MPHF_LAYOUT`` QueryIndex on ``dev``)."""
    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.sshash import SSHash

    rng = np.random.default_rng(seed)
    n = 64
    sv = SeqVector.from_codes(rng.integers(0, 4, n * synth.PIECE, dtype=np.uint8))
    accum = np.arange(n + 1, dtype=np.int64) * synth.PIECE
    unitigs = UnitigSet(synth.K, sv, accum)
    names = [f"r{i}" for i in range(n)]
    extra = np.concatenate([np.zeros(MANY_OCCS - 1, dtype=np.int64), [1, 1]])
    spt = SPT(unitigs, names, np.concatenate([np.arange(n), extra]),
              np.concatenate([np.arange(n), rng.integers(0, n, len(extra))]),
              np.concatenate([np.zeros(n, dtype=np.int64),
                              rng.integers(0, synth.PIECE, len(extra))]),
              np.concatenate([np.ones(n, dtype=np.int64), rng.integers(0, 2, len(extra))]),
              np.full(n, synth.PIECE, dtype=np.int64))
    ss = SSHash.from_unitig_set(unitigs, w=synth.MPHF_W, skew_param=synth.CAP_SKEW,
                                gamma=synth.MPHF_GAMMA, engine="fast32", device=dev)
    index = ModIndex(ss, spt.piscem_table(), RefSeqCollection(sv, accum, names),
                     index_type="ragged")
    host = index.device_arrays(**synth.MPHF_LAYOUT)
    return index, host, QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)


def same_ragged(what: str, got: dict, want: dict, budget: int) -> int:
    """The kernel's ragged phase 2 ``got`` equals the plain version's
    ``want``: per-slot outputs, the total and the written entries."""
    total = int(want["total"])
    live = min(total, budget)
    if int(got["total"]) != total:
        raise AssertionError(f"[occ_csr] {what}: total {int(got['total'])} != {total}")
    for key in ("occ_start", "occ_count"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"[occ_csr] {what}: {key} differs")
    for key in ("qid", "ref_id", "ref_pos", "orient"):
        if not torch.equal(got[key][:live], want[key][:live]):
            raise AssertionError(f"[occ_csr] {what}: {key} differs on the {live} written entries")
    return total


def occ_csr_phase(dev, smi) -> None:
    """Phase 5c: the ragged phase 2 on the card against its plain version."""
    t0 = time.perf_counter()
    index, host, qi = ragged_index(dev)
    d = qi.arrays()
    mo = qi.max_occs
    if not occ_csr.engages(d, mo) or mo != MANY_OCCS:
        raise AssertionError(f"[occ_csr] the ragged phase does not engage (max_occs {mo})")
    us = index.k2u.unitigs
    k = index.k

    def kmers(uid: int, n: int) -> np.ndarray:
        return us.get_kmer_u64(us.accum[uid] + np.arange(n))

    few = np.concatenate([kmers(0, 3), kmers(1, 3), kmers(2, 3), np.array([5, 6], np.uint64)])
    counts = [MANY_OCCS] * 3 + [3] * 3 + [1] * 3 + [0] * 2
    work, _, _ = synth.sample_capacity_queries(us, SERVE_LANES, seed=4)
    rng = np.random.default_rng(6)
    foreign = rng.random(SERVE_LANES) < 0.05
    work[foreign] = rng.integers(0, 1 << 62, int(foreign.sum()), dtype=np.uint64)
    reset_launches()
    n_cases = 0
    for name, words in (("0, 1, 3 and 300 occurrences", few), ("the read chunk", work)):
        fw = torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(dev)
        r = k2u_batch(d, fw)
        N = fw.shape[0]
        for n_ovf in (N, 0, N // 2):
            nt = torch.tensor(n_ovf, device=dev)
            total = int(occ_csr.occ_csr_plain(d, r, nt, 1)["total"])
            for budget in sorted({total, max(total - 1, 0), total + 1000, 1}):
                want = occ_csr.occ_csr_plain(d, r, nt, budget)
                same_ragged(f"{name}, n_ovf {n_ovf}, budget {budget}",
                            occ_csr.occ_csr(d, r, nt, budget), want, budget)
                n_cases += 1
        if name.startswith("0,"):
            got = occ_csr.occ_csr_plain(d, r, torch.tensor(N, device=dev), 1 << 12)
            if got["occ_count"].tolist() != counts:
                raise AssertionError(f"[occ_csr] counts {got['occ_count'].tolist()}")
    # the compacted query on the card against its CPU oracle
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    kw = dict(synth.MPHF_QUERY, probe_limit2=None, merge=False, m2=SERVE_LANES)
    got = get_ref_pos_compact(d, fw, mo, **kw)
    cpu = QueryIndex(arrays_from_numpy(host, "cpu"))
    want = get_ref_pos_compact(cpu.arrays(), fw.cpu(), mo, **kw)
    budget = want["phase2"]["ref_pos"].shape[0]
    same_ragged("get_ref_pos_compact against the CPU", {kk: v.cpu() for kk, v in
                                                        got["phase2"].items()},
                want["phase2"], budget)
    if int(got["n_ovf"]) != int(want["n_ovf"]) or not torch.equal(got["lanes"].cpu(),
                                                                  want["lanes"]):
        raise AssertionError("[occ_csr] the card's phase-2 lanes differ from the CPU's")
    chk = int(OneGraphIndexQuery.checksum(got))
    if chk != int(OneGraphIndexQuery.checksum(want)):
        raise AssertionError("[occ_csr] the card's checksum differs from the CPU's")
    launches = occ_csr.LAUNCHES
    # the slots' K2U: the full-depth main probe and the residue's full K2U
    # against the full K2U of every slot
    r = k2u_batch(d, fw[got["lanes"]])
    real = got["slot_real"]
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        if not torch.equal(torch.where(real, got["phase2"][key], 0), torch.where(real, r[key], 0)):
            raise AssertionError(f"[occ_csr] the ragged phase's K2U differs in {key}")
    m_c = SERVE_LANES // 4
    ragged_k2u_ms = cuda_ms(lambda: _ragged_k2u(d, fw[got["lanes"]], real, m_c), 5)
    full_k2u_ms = cuda_ms(lambda: k2u_batch(d, fw[got["lanes"]]), 3)
    n_ovf = got["n_ovf"]
    total = int(got["phase2"]["total"])
    out = occ_csr.occ_csr(d, r, n_ovf, total)
    ms = cuda_ms(lambda: occ_csr.occ_csr(d, r, n_ovf, total), 20)
    sum_ms = cuda_ms(lambda: occ_csr.occurrence_sum(out, fw[got["lanes"]]), 20)
    plain_ms = cuda_ms(lambda: occ_csr.occ_csr_plain(d, r, n_ovf, total), 3)
    lanes = int(n_ovf)
    n_bytes = 24 * lanes + 25 * total  # the benchmark's occ_csr_bytes count
    b = bound(n_bytes)
    log(f"[occ_csr] {n_cases} cases bit-identical to the plain version (0, 1, 3 and "
        f"{MANY_OCCS} occurrences; {SERVE_LANES} lanes, 5% foreign; budgets full, one short, "
        f"generous and 1; n_ovf N, 0 and N/2), and get_ref_pos_compact on the card equal to "
        f"its CPU oracle ({int(n_ovf)} phase-2 lanes, {total} occurrences, checksum {chk}); "
        f"{launches} calls; at the chunk the kernel {ms:.4f} ms (plain {plain_ms:.4f} ms), "
        f"the block's checksum {sum_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}: {n_bytes} bytes, "
        f"kernel at {b[0] / ms:.1%}); the slots' K2U equal to the full K2U's, "
        f"{ragged_k2u_ms:.4f} ms eager (the full K2U of every slot {full_k2u_ms:.4f} ms); "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    del index, host, qi, d, cpu, r, out, got, want


@contextlib.contextmanager
def plain_residue():
    """``_ragged_k2u`` with the plain residue K2U where it would launch
    the kernel."""
    engages = residue_k2u.engages
    residue_k2u.engages = lambda d, device: False
    try:
        yield
    finally:
        residue_k2u.engages = engages


def residue_genome(dev, scale: float = RESIDUE_SCALE, n_reads: int | None = None,
                   seed: int = 2**33 + 7):
    """(fast32 ModIndex, its arrays on ``dev``, a read chunk's k-mer
    words): the benchmark's GRCh38-shaped genome at ``scale`` of its
    lengths and copy counts (its repeats put k-mers in heavy buckets), its
    fast32 index, and ``n_reads`` reads (by default a chunk of the hg
    cell: 2,048 reads, 245,760 lanes) of the benchmark's read mix."""
    from portbench import genome as G
    from portbench.builds import fast32
    from portbench.reference.checksums import read_lanes
    from portbench.traffic.reads import sample_codes

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, RESIDUE_CONFIG)) as f:
        cfg = dict(json.load(f), scale=scale)
    with open(os.path.join(root, RESIDUE_TRAFFIC)) as f:
        mix = json.load(f)
    g = G.make(cfg, seed, dev)
    index, qi = fast32.build(g, cfg, dev)
    n = int(mix["reads_per_chunk"]) if n_reads is None else n_reads
    codes = sample_codes(g, n, mix, np.random.default_rng(seed))
    chunk = read_lanes(torch.from_numpy(codes).to(dev), g.k)[0].reshape(-1).contiguous()
    return index, qi.arrays(), chunk


def residue_probe(d: dict, fw: torch.Tensor) -> dict:
    """The ragged phase 2's full-depth main probe of ``fw`` (K3 on the
    card), whose heavy-bucket and unresolved lanes are the residue."""
    return _main_probe(d, fw, int(d["k2u"]["meta"].probe_bound), True, None)[0]


def residue_cases(d: dict, chunk: torch.Tensor, n_max: int = 1 << 15, seed: int = 9) -> dict:
    """Batches for the residue K2U on the fast32 arrays ``d`` (name -> k-mer
    words on ``chunk``'s device): a read chunk; its heavy-bucket (skew)
    lanes alone; deferred winners that fail validation alone (k-mers
    spelled across a unitig boundary and the chunk's own, kept where the
    full-depth probe leaves them unresolved outside a heavy bucket); and
    foreign k-mers in heavy buckets (skew lanes with one base changed that
    still land in a heavy bucket). At most ``n_max`` lanes each but the
    chunk."""
    k2u = d["k2u"]
    us = k2u["us"]
    k = k2u["meta"].k
    dev = chunk.device
    gen = torch.Generator()
    gen.manual_seed(seed)
    r = residue_probe(d, chunk)
    skew = chunk[r["use_skew"]][:n_max]
    starts = us["accum2"][1:, 0]
    pick = torch.randint(0, starts.shape[0], (n_max // (k - 1) + 1,), generator=gen).to(dev)
    pos = torch.clamp(starts[pick][:, None] - torch.arange(1, k, device=dev), min=0)
    failed = torch.cat([us_get_kmer(us, pos.reshape(-1)),
                        chunk[r["unresolved"] & ~r["use_skew"]]])
    rf = residue_probe(d, failed)
    failed = failed[rf["unresolved"] & ~rf["use_skew"]][:n_max]
    j = torch.randint(0, k, skew.shape, generator=gen).to(dev)
    c = torch.randint(1, 4, skew.shape, generator=gen).to(dev)
    mutant = skew ^ (c << (2 * j))
    foreign = mutant[residue_probe(d, mutant)["use_skew"]]
    return {"the read chunk": chunk, "skew lanes": skew, "failed deferred winners": failed,
            "foreign k-mers in heavy buckets": foreign}


def compare_residue(d: dict, fw: torch.Tensor, real: torch.Tensor, m_c: int, what: str) -> int:
    """``_ragged_k2u`` with the kernel against the same with the plain
    residue K2U, on the same card tensors: every slot's K2U fields and the
    residue's count bit-identical. Returns the count."""
    got, n_got = _ragged_k2u(d, fw, real, m_c)
    with plain_residue():
        want, n_want = _ragged_k2u(d, fw, real, m_c)
    if int(n_got) != int(n_want):
        raise AssertionError(f"[residue] {what}: count {int(n_got)} != {int(n_want)}")
    for key in residue_k2u.FIELDS:
        if got[key].dtype != want[key].dtype or not torch.equal(got[key], want[key]):
            bad = int((got[key].to(torch.int64) != want[key].to(torch.int64)).sum())
            raise AssertionError(f"[residue] {what}: {key} differs in {bad} slots")
    return int(n_want)


def residue_sectors(d: dict, fw: torch.Tensor, r: dict, rest: torch.Tensor,
                    n_c: torch.Tensor, out: dict) -> int:
    """The 32-byte sectors of the random reads that the residue K2U's real
    slots need, each read once (the slot stream left out): a lane's word
    and heavy flag; one per MPHF level its key tests up to its hit, plus
    the hit's rank (the block words before the hit share its sector), or
    the final table's binary search; for a heavy-bucket lane (the skew
    MPHF over the canonical k-mer) its skew_pos entry and k-mer row, and
    for a hit its wb2 row and extent; for another lane (the minimizer
    MPHF) its two bucket deltas and group base, and for a hit the winning
    row's position, words2 row, wb2 row and uproj row, for a miss each
    row's position and words2 row. ``r`` is the full-depth probe of the
    slots ``fw``, ``out`` their K2U fields with the residue's resolved. A
    floor: the kernel reads the rows of a warp's lane 32 at a time."""
    k2u = d["k2u"]
    m = k2u["meta"]
    n = int(torch.clamp(n_c, max=rest.shape[0]))
    s = rest[:n]
    x = fw[s]
    skew = r["use_skew"][s]
    mm, _, _, canon = canonical_minimizer_batch(x, m.k, m.w, m.seed, ordering=m.ordering)

    def chain(mp, keys):
        mmeta = mp["meta"]
        n_lv = len(mmeta.n_bits)
        s0, s1 = key_fold32(keys)
        hit = torch.full_like(keys, -1)
        for li in range(n_lv):
            h, s0, s1 = chain_next(s0, s1)
            p = h & (mmeta.n_bits[li] - 1)
            bit = ((mask32(mp["words"][mmeta.word_offsets[li] + (p >> 5)]) >> (p & 31)) & 1) != 0
            hit = torch.where(bit & (hit < 0), li, hit)
        search = n_lv + int(mp["fh_keys"].shape[0]).bit_length() + 1
        return torch.where(hit >= 0, hit + 2, search)

    key_sectors = torch.where(skew, chain(k2u["skew_mphf"], canon), chain(k2u["mphf"], mm))
    hit = out["mt"][s] > 0
    hc = torch.clamp(mphf_lookup(k2u["mphf"], mm).to(torch.int64), min=0)
    ps, pe = _prefix_pair(k2u, hc)
    depth = torch.clamp(pe - ps, max=int(m.probe_bound))
    skew_sectors = 2 + torch.where(hit, 2, 0)
    row_sectors = 2 + torch.where(hit, 4, 2 * depth)
    return int((2 + key_sectors + torch.where(skew, skew_sectors, row_sectors)).sum())


def residue_phase(dev, smi, sector_rate: float) -> None:
    """Phase 5c's residue K2U: the kernel (``ops/residue_k2u``) against the
    plain residue K2U inside ``_ragged_k2u`` on ``residue_cases``, each
    at a residue capacity m_c above its count, equal to it and at half of
    it, and with no real slot; then timed at the chunk (m_c a quarter of
    its lanes, as the benchmark's) beside the plain version and its floor
    (``residue_sectors`` at ``sector_rate`` and its output bytes at
    3.35 TB/s)."""
    t0 = time.perf_counter()
    _, d, chunk = residue_genome(dev, RESIDUE_SCALE)
    build_s = time.perf_counter() - t0
    if not residue_k2u.engages(d, dev):
        raise AssertionError("[residue] the kernel does not engage on the fast32 index")
    residue_k2u.LAUNCHES = 0
    cases = residue_cases(d, chunk)
    notes = []
    for name, fw in cases.items():
        r = residue_probe(d, fw)
        n = int((r["use_skew"] | r["unresolved"]).sum())
        if n == 0:
            raise AssertionError(f"[residue] {name}: no residue")
        real = torch.ones(fw.shape[0], dtype=torch.bool, device=dev)
        for m_c in sorted({n + 37, n, max(n // 2, 1)}):
            compare_residue(d, fw, real, m_c, f"{name}, m_c {m_c}")
        compare_residue(d, fw, torch.zeros_like(real), 64, f"{name}, no real slot")
        hits = int((k2u_batch(d, fw[(r["use_skew"] | r["unresolved"])])["mt"] > 0).sum())
        notes.append(f"{name}: {fw.shape[0]} lanes, residue {n} "
                     f"({int(r['use_skew'].sum())} heavy-bucket, {hits} hits)")
    launches = residue_k2u.LAUNCHES
    # the benchmark's shape: m_c a quarter of the chunk's slots
    r = residue_probe(d, chunk)
    m_c = chunk.shape[0] // 4
    rest, n_c = flagged_lanes(r["use_skew"] | r["unresolved"], m_c)
    want = residue_full_k2u(d, chunk, r, rest, n_c)
    got = residue_k2u.residue_k2u(d, chunk, r, rest, n_c)
    for key in residue_k2u.FIELDS:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"[residue] the timed chunk: {key} differs")
    ms = cuda_ms(lambda: residue_k2u.residue_k2u(d, chunk, r, rest, n_c), 20)
    plain_ms = cuda_ms(lambda: residue_full_k2u(d, chunk, r, rest, n_c), 3)
    n = int(torch.clamp(n_c, max=m_c))
    sectors = residue_sectors(d, chunk, r, rest, n_c, want)
    floor = (sectors / sector_rate + RESIDUE_OUT * n / HBM_BPS) * 1e3
    log(f"[residue] {'; '.join(notes)}: the kernel bit-identical to the plain residue K2U inside "
        f"_ragged_k2u on every slot at m_c above, equal to and half of the residue, and with no "
        f"real slot ({launches} launches)")
    log(f"[residue] at the chunk ({chunk.shape[0]} slots, m_c {m_c}, {n} residue lanes): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; floor {floor:.4f} ms ({sectors} sectors at "
        f"{sector_rate / 1e9:.3f} G/s, {RESIDUE_OUT * n} output bytes at {HBM_BPS / 1e12:.2f} "
        f"TB/s; kernel at {floor / ms:.1%}); genome and index {build_s:.1f} s, "
        f"{time.perf_counter() - t0:.1f} s in all ({smi})")
    del d, chunk, cases, r, rest, got, want


def card() -> tuple[torch.device, str]:
    """The CUDA device, and its name and power limit as nvidia-smi gives
    them; exits without a card."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda", 0), smi


def reset_launches():
    """Set every kernel's launch count to 0 (just before a main path)."""
    for mod in (mono2_probe, bpos_probe, capacity_probe, mono2_phase2, occ_csr, residue_k2u):
        mod.LAUNCHES = 0
    for name in gather_lab.LAUNCHES:
        gather_lab.LAUNCHES[name] = 0


def kernel_name(mangled: str) -> str:
    """The ``*_kernel`` name inside a mangled symbol (a length-prefixed
    identifier)."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        name = mangled[start : start + int(m.group(1))]
        if name.endswith("_kernel"):
            return name
    return mangled


def ptxas_lines(report: str):
    """ptxas's register, shared-memory and spill lines, each after the
    kernel it describes."""
    out = []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append(f"kernel {kernel_name(m.group(1))}:")
        elif "registers" in ln or "spill" in ln:
            out.append(ln.strip())
    return out


def fit(c) -> int:
    """A capacity covering ``c`` lanes, rounded up (bench.py:377)."""
    return max(1024, -(-(int(c) + 256) // 1024) * 1024)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=float, default=50.0, help="mono2 genome size in Mbp")
    ap.add_argument("--cap-mbp", type=float, default=300.0, help="capacity genome size in Mbp")
    ap.add_argument("--mphf-mbp", type=float, default=300.0, help="MPHF genome size in Mbp")
    ap.add_argument("--cli-mono2-mbp", type=float, default=2.0,
                    help="genome size in Mbp of the CLI's mono2 leg")
    ap.add_argument("--cuckoo-mbp", type=float, default=2.0,
                    help="genome size in Mbp of phase 22's cuckoo KCDict leg")
    ap.add_argument("--cuckoo-kphf-mbp", type=float, default=0.5,
                    help="genome size in Mbp of phase 22's `kphf build cuckoo --validate`")
    ap.add_argument("--gbp-mbp", type=float, default=3000.0,
                    help="genome size in Mbp of the MPHF tier at 2^31 bases or more (phase 20)")
    ap.add_argument("--mphf-check-mbp", type=float, default=10.0,
                    help="genome size in Mbp of phase 20's check of the card's build against "
                         "the same build on CPU tensors")
    args = ap.parse_args()

    mark("1")
    # 1. card
    dev, smi = card()

    mark("2")
    # 2. kernel builds, one nvcc per source, together
    t0 = time.perf_counter()
    ((lib, ptxas), (lib2, ptxas2), (lib3, ptxas3), (lib4, ptxas4), (lib5, _), (lib6, ptxas6),
     (lib7, ptxas7)) = compile_all([mono2_probe.SOURCE, bpos_probe.SOURCE, capacity_probe.SOURCE,
                                    gather_lab.SOURCE, k3_plain_reads_source(),
                                    mono2_phase2.SOURCE, residue_k2u.SOURCE])
    log(f"[build] {lib.name}, {lib2.name}, {lib3.name}, {lib4.name}, {lib5.name}, {lib6.name} "
        f"and {lib7.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(ptxas) + ptxas_lines(ptxas6) + ptxas_lines(ptxas7):
        log(f"[build] {line}")

    mark("3")
    # 3. the lab kernels, and the card's random-read rates from device memory
    labs, sector_rate = lab_kernels(dev, smi, lib4.name, ptxas4)

    mark("4")
    # 4. index
    t0 = time.perf_counter()
    n_bases = int(args.mbp * 1e6)
    genome = synth.synthetic_spt(n_bases, seed=0)
    index = synth.build_index(n_bases, seed=0, genome=genome)
    host = index.device_arrays()
    m = host["k2u"]["meta"]
    if not (m.scheme == "mono2" and m.occ32):
        raise AssertionError(f"index is {m.scheme} occ32={m.occ32}, not mono2-occ32")
    t_build = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    us = index.k2u.unitigs
    log(f"[index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"T={m.t} buckets, side T={m.side_t}; max_occs={gpu_index.max_occs}")
    log(f"[index] host build {t_build:.1f} s; to card {time.perf_counter() - t0:.1f} s; "
        f"{gpu_index.nbytes()} bytes on the card")
    d = gpu_index.arrays()
    table = d["k2u"]["table"]
    log(f"[index] main table on the card: {table.dtype} {tuple(table.shape)}, "
        f"{table.numel() * 4} bytes (host: {host['k2u']['table'].shape}, "
        f"{host['k2u']['table'].nbytes} bytes)")

    mark("5")
    # 5. kernel vs plain version
    truth = synth.sample_queries_truth(us, BATCH, seed=1)
    work = truth[0]
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    cases = k1_cases(host["k2u"], work)
    max_err = compare_cases("k1 tiles", d["k2u"], cases, [("main", None, None, FIELDS)], dev)
    # the tiles hold what they name
    last_row = next(n for n in cases if n.endswith("(last occupied)"))
    row_t1 = next(n for n in cases if n.startswith("row T - 1"))
    words = torch.from_numpy(cases[row_t1].view(np.int64)).to(dev)
    if not bool((fold_hash32(umin(words, revcomp(words, m.k))) & (m.t - 1) == m.t - 1).all()):
        raise AssertionError(f"k1 tile {row_t1!r}: a lane's bucket is not row T - 1")
    for name, want_unres in (("foreign only", True), ("side-table keys", True),
                             ("slot-1 keys", False), ("khi bit 31 keys", False),
                             (last_row, False)):
        words = torch.from_numpy(np.ascontiguousarray(cases[name]).view(np.int64)).to(dev)
        r = kcdict_k2u(d["k2u"], words, mode="main")
        if not bool((r["unresolved"] == want_unres).all()):
            raise AssertionError(f"k1 tile {name!r}: not every lane is "
                                 f"{'unresolved' if want_unres else 'resolved'} in main mode")
        if name != last_row and not want_unres and set(r["mt"].tolist()) != {1, 2}:
            raise AssertionError(f"k1 tile {name!r}: mt {sorted(set(r['mt'].tolist()))}")
    max_err = max(max_err, compare_k2u(d["k2u"], fw, f"N={BATCH}"))
    k1_ms = cuda_ms(lambda: mono2_probe.mono2_k2u(d["k2u"], fw), 20)
    plain_ms = cuda_ms(lambda: kcdict_k2u(d["k2u"], fw, mode="main"), 5)
    log(f"[k1] N={BATCH}: bit-identical on all nine fields; kernel {k1_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms ({smi})")
    # the work: the key, one 56-byte row (the reference's two slots, whatever
    # the card's layout) and the nine outputs a lane
    k1_bound = bound(BATCH * (8 + 4 * 2 * SW + K2U_OUT))
    # the floors of the card's layout, the last, go into the kernels line
    for label, row_bytes in (("the reference's", 4 * 2 * SW),
                             ("the card's", 4 * mono2_probe.ROW_WORDS)):
        sec, blk = row_spans(d["k2u"], fw, row_bytes)
        k1_floor, k1_block_floor = sec / sector_rate * 1e3, blk / sector_rate * 1e3
        log(f"[k1] {label} {row_bytes}-byte rows: {sec / BATCH:.4f} DRAM sectors and "
            f"{blk / BATCH:.4f} 64-byte blocks a lane: sector floor {k1_floor:.4f} ms, block "
            f"floor {k1_block_floor:.4f} ms ({smi})")
    log(f"[k1] bound {k1_bound[0]:.4f} ms ({k1_bound[1]}); kernel at {k1_bound[0] / k1_ms:.1%} of "
        f"its bound, {k1_ms / k1_block_floor:.2f}x its block floor; no single torch call "
        f"computes the probe ({smi})")

    mark("5b")
    # 5b. the phase-2 kernel against its plain version
    p2 = phase2_phase("p2", index, host, gpu_index, work, dev, smi, sector_rate)

    mark("5c")
    # 5c. the ragged phase 2 and its residue K2U against their plain versions
    occ_csr_phase(dev, smi)
    residue_phase(dev, smi, sector_rate)

    mark("6")
    # 6. main path
    t0 = time.perf_counter()
    work_cpu = torch.from_numpy(work.view(np.int64))
    # this workload overflows ~13% of lanes (5% foreign, ~6% 3-occurrence
    # unitigs, ~2% side-table keys): size the oracle at N/4
    out0 = get_ref_pos_compact(cpu_index.arrays(), work_cpu, cpu_index.max_occs, merge=False,
                               m2=BATCH // 4)
    if bool(out0["over_budget"]):
        raise AssertionError("CPU oracle over budget")
    host_chk = int(OneGraphIndexQuery.checksum(out0))
    n_ovf = int(out0["n_ovf"])
    M2 = max(1024, -(-(n_ovf + 128) // 256) * 256)
    log(f"[main] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}, "
        f"overflow {n_ovf}/{BATCH} = {n_ovf / BATCH:.4f} -> M2={M2}")

    # small-input agreement of the merged two-phase query on the card with
    # the exact padded query on the CPU (padding slots masked by valid)
    got = get_ref_pos_compact(d, fw[:4096], gpu_index.max_occs, merge=True, m2=4096)
    want = get_ref_pos_padded(cpu_index.arrays(), work_cpu[:4096], cpu_index.max_occs)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid",
                "ref_id", "ref_pos", "orient"):
        g, w = got[key].cpu(), want[key]
        if g.dim() == 2:
            g, w = torch.where(want["valid"], g, 0), torch.where(want["valid"], w, 0)
        if not torch.equal(g, w):
            raise AssertionError(f"merged compact query on the card differs from padded CPU in {key}")
    log("[main] merged compact query on 4096 lanes equals the padded CPU query")
    del got, want

    # the two-phase and CSR drivers on the card against CPU tensors
    mono2_drivers(cpu_index, gpu_index, work, fw)
    del cpu_index, out0

    og = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CH, m2=M2)
    og_eager = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CH, m2=M2, graph=False)
    launches, worst, times = graph_and_eager(
        "main", gpu_index, og.checksum_pass_rolled, og_eager.checksum_pass_rolled, fw,
        CH * host_chk, BATCH * CH, PASSES, mono2_probe, smi)
    if worst > M2:
        raise AssertionError(f"worst overflow {worst} > M2 {M2}")
    p2["launches"] = mono2_phase2.LAUNCHES
    if not p2["launches"]:
        raise AssertionError("[main] the replayed pass never launched the phase-2 kernel")
    derived_capture_raises(dev)
    del og, og_eager
    mark("6e")
    # 6e. bench.py's reads1graph traffic on this index, beside phase 8b's
    reads_launches = mono2_reads(index, host, gpu_index, smi)

    mark("6a-6b")
    # 6a-6b. the serve pass and the validation oracles on this index
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, serve = serve_phase(index, host, gpu_index, dev, smi, tmp)
        validation_phase(index, gpu_index, dev, tmp)
        mark("6c-6d")
        # 6c-6d. the streaming index and the read mapper on this index
        stream = streaming_phase(index, host, gpu_index, dev, smi, tmp)
        map_launches = mapping_phase("map mono2", index, gpu_index,
                                     QueryIndex(arrays_from_numpy(host, "cpu")), mono2_probe,
                                     smi, tmp)
    mark("22c, 23a")
    # 22c, 23a. bucket_range and the data-parallel and mono sharded queries
    dp_launches = mono2_shards(index, host, gpu_index, work, fw, dev, smi)
    log(f"[main] mono2_probe launches: {launches} on the main path, {reads_launches} on "
        f"reads1graph, {serve_launches} on the serve pass, {map_launches} in the read mapper, "
        f"{dp_launches} in the data-parallel queries")
    k1 = record("mono2_probe", "mono2_probe.cu", "mazu_tpu/ops/pallas_query.py:46",
                launches + reads_launches + serve_launches + map_launches + dp_launches, max_err,
                k1_ms,
                plain_ms, k1_bound, sector_floor_ms=k1_floor, block_floor_ms=k1_block_floor)
    # the card's copy of the index goes now; phase 18 builds it again
    profile_mono2 = mono2_profile(host, fw, M2, times, serve, stream)
    del gpu_index, d, table, r
    torch.cuda.empty_cache()

    mark("7-8")
    # 7-8. the pufferfish dense and sparse paths over this genome
    profile_pf1 = [pf1_path(kind, genome, n_bases, truth, dev, smi) for kind in ("dense", "sparse")]
    torch.cuda.empty_cache()
    mark("8a-8e")
    # 8a-8e. the SSHash speed tier over this genome
    profile_speed = speed(genome, n_bases, truth, dev, smi)
    del genome, index
    torch.cuda.empty_cache()

    mark("9")
    # 9. K2 build report
    log(f"[k2 build] {lib2.name}")
    for line in ptxas_lines(ptxas2):
        log(f"[k2 build] {line}")

    k2, profile_cap = capacity(args, dev, smi, lib3.name, ptxas3, sector_rate)
    torch.cuda.empty_cache()
    k3, profile_mphf = mphf(args, dev, smi, sector_rate)
    torch.cuda.empty_cache()
    mark("19")
    # 19. the CLI
    profile_cli = cli_phase(args, dev, smi, k1)
    torch.cuda.empty_cache()
    mark("22a-22b")
    # 22a-22b. the cuckoo KCDict through the CLI, wide slots
    kcdict_rest(args, dev, smi)
    mark("20")
    # 20. synth3000-mphf: the MPHF tier past 2^31 bases, built on the card
    gbp(args, dev, smi, sector_rate, lib5, k3)

    mark("18")
    # 18. profiled passes
    for i, profile in enumerate((profile_mono2, *profile_pf1, profile_speed, profile_cap,
                                 profile_mphf, profile_cli)):
        mark(f"18.{i}")
        profile()
    mark("end")
    log(json.dumps({"kernels": [k1, p2, k2, k3, *labs]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


def run_cli(tag: str, argv: list) -> tuple[str, float]:
    """``mazu_tpu_torch.cli.main(argv)`` in this process: (its standard
    output, echoed to the log, and its seconds). Raises unless it returns 0."""
    import contextlib
    import io

    from mazu_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"[{tag}] | {line}")
    if rc != 0:
        raise AssertionError(f"[{tag}] the CLI returned {rc} on {argv}")
    return out.getvalue(), dt


def same_arrays(got, want, path: str = "") -> None:
    """Two ``device_arrays`` trees hold the same keys, records and bytes."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys differ: {sorted(set(got) ^ set(want))}")
        for key in want:
            same_arrays(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, np.ndarray):
        if got.dtype != want.dtype or got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"{path}: arrays differ")
    elif got != want:
        raise AssertionError(f"{path}: {got} != {want}")


def cli_maps(tag: str, index, reads: list, hits: int, dev) -> None:
    """The mapper on the card gives the CLI's hit count over ``reads``, and
    for the first 1,024 reads the hits of ``ReadMapper`` on CPU tensors,
    read by read."""
    card = ReadMapper(index, device=dev).map_reads(reads)
    if sum(r.n_hit for r in card) != hits:
        raise AssertionError(f"[{tag}] the card's mapper hits {sum(r.n_hit for r in card)} "
                             f"k-mers, the CLI {hits}")
    host = ReadMapper(index, device="cpu").map_reads(reads[:1024])
    for i, (a, b) in enumerate(zip(card, host)):
        if a.n_hit != b.n_hit or any(not np.array_equal(x, y) for x, y in zip(a.csr(), b.csr())):
            raise AssertionError(f"[{tag}] read {i}: the card's hits differ from the CPU's")
    log(f"[{tag}] the card's mapper: {hits} hits, as the CLI; the first 1024 reads' hits equal "
        f"ReadMapper's on CPU tensors read by read")


def cli_phase(args, dev, smi, k1: dict):
    """Phase 19: the CLI with the reference's defaults over synth50's genome
    from cuttlefish files (synth50-piscem-parity), then its mono2 leg.
    Adds the leg's K1 launches to ``k1``. Returns a function that runs the
    profiled passes of the parity index's uniform queries."""
    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.io import checkpoint

    phase_t0 = time.perf_counter()
    n_bases = int(args.mbp * 1e6)
    with tempfile.TemporaryDirectory() as tmp:
        prefix, fa, fq, npz = (os.path.join(tmp, n) for n in ("g", "g.fa", "r.fq.gz", "g.npz"))
        t0 = time.perf_counter()
        genome = synth.synthetic_spt(n_bases, seed=0)
        synth.write_cf(prefix, n_bases, fasta=fa, genome=genome)
        reads = synth.serve_reads(genome[1], synth.SERVE_READS * synth.SERVE_CHUNKS, seed=1)
        synth.write_fastq(fq, reads)
        del genome
        log(f"[cli] synth50's genome as cuttlefish files, a FASTA and a FASTQ of {len(reads)} "
            f"reads in {time.perf_counter() - t0:.1f} s ({os.path.getsize(prefix + '.cf_seg')} "
            f"bytes of .cf_seg)")

        # the build, keeping the index it saves
        built = {}
        real_save = checkpoint.save_index

        def keep(index, path, compress=True):
            t = time.perf_counter()
            real_save(index, path, compress)
            built.update(index=index, save_s=time.perf_counter() - t)

        checkpoint.save_index = keep
        try:
            _, build_s = run_cli("cli build", ["index", "build", "piscem", "-p", prefix, "-o", npz])
        finally:
            checkpoint.save_index = real_save
        index = built["index"]
        ss = index.k2u
        n_bytes = os.path.getsize(npz)
        log(f"[cli build] index build piscem (engine parity, w {ss.w}, skew {ss.skew_param}, "
            f"k {ss.k}, ordering {ss.ordering}) from cuttlefish files {build_s:.2f} s, of it the "
            f"save {built['save_s']:.2f} s; checkpoint {n_bytes} bytes; {ss.n_kmers} k-mers, "
            f"{ss.n_minimizers} minimizers, {ss.n_minimizer_occs} minimizer occurrences, "
            f"max bucket {ss.max_bucket()}, {ss.n_kmers_in_skew_index} skew k-mers ({smi})")
        t0 = time.perf_counter()
        loaded = checkpoint.load_index(npz)
        load_s = time.perf_counter() - t0
        same_arrays(loaded.device_arrays(), index.device_arrays())
        log(f"[cli build] load_index {load_s:.2f} s: every array byte-identical to the built "
            f"index's")
        del built, index

        stats, _ = run_cli("cli stats", ["index", "stats", "-i", npz])
        res = subprocess.run([sys.executable, "-m", "mazu_tpu_torch.cli", "index", "stats", "-i",
                              npz], capture_output=True, text=True, timeout=300)
        if res.returncode != 0 or res.stdout != stats:
            raise AssertionError(f"[cli stats] python -m mazu_tpu_torch.cli: rc {res.returncode}, "
                                 f"{res.stdout!r} {res.stderr[-2000:]}")
        log("[cli stats] python -m mazu_tpu_torch.cli index stats in a process of its own: the "
            "same lines")

        _, val_s = run_cli("cli validate", ["index", "validate-fasta", "-i", npz, "-f", fa])
        out, map_s = run_cli("cli map", ["index", "map", "-i", npz, "-f", fq])
        n_reads, n_kmers, hits = (int(x) for x in re.match(
            r"(\d+) reads, (\d+) k-mers, (\d+) hits", out).groups())
        log(f"[cli] validate-fasta {val_s:.2f} s; map {map_s:.2f} s: {n_reads / map_s:.1f} reads/s, "
            f"{n_kmers / map_s:.1f} k-mers/s ({smi})")
        cli_maps("cli map", loaded, reads, hits, dev)
        del reads

        loaded.refs = RefSeqCollection.from_fasta(fa)
        t0 = time.perf_counter()
        validate_self(loaded, device=dev, chunk=VALIDATE_CHUNK)
        log(f"[cli] validate_self on the card over all {loaded.refs.prefix_sum[-1]} reference "
            f"bases of the loaded index in {time.perf_counter() - t0:.1f} s")

        # the mono2 leg: K1 on the CLI's main path
        m_bases = int(args.cli_mono2_mbp * 1e6)
        p2, fa2, fq2, npz2 = (os.path.join(tmp, n) for n in ("m", "m.fa", "m.fq.gz", "m.npz"))
        genome = synth.synthetic_spt(m_bases, seed=0)
        synth.write_cf(p2, m_bases, fasta=fa2, genome=genome)
        reads2 = synth.serve_reads(genome[1], synth.SERVE_READS * synth.SERVE_CHUNKS, seed=1)
        synth.write_fastq(fq2, reads2)
        del genome
        reset_launches()
        _, b2_s = run_cli("cli mono2", ["index", "build", "piscem", "-p", p2, "-o", npz2,
                                        "--engine", "mono2"])
        _, v2_s = run_cli("cli mono2", ["index", "validate-fasta", "-i", npz2, "-f", fa2])
        out2, m2_s = run_cli("cli mono2", ["index", "map", "-i", npz2, "-f", fq2])
        launches = mono2_probe.LAUNCHES
        if launches == 0:
            raise AssertionError("[cli mono2] the CLI's map never launched the mono2_probe kernel")
        k1["launches"] += launches
        m2 = checkpoint.load_index(npz2)
        kc = m2.k2u.device_arrays()["meta"]
        if not (kc.scheme == "mono2" and kc.occ32):
            raise AssertionError(f"[cli mono2] the CLI built {kc.scheme} occ32={kc.occ32}")
        hits2 = int(re.match(r"\d+ reads, \d+ k-mers, (\d+) hits", out2).group(1))
        cli_maps("cli mono2", m2, reads2, hits2, dev)
        log(f"[cli mono2] {m_bases} bases: build {b2_s:.2f} s, validate-fasta {v2_s:.2f} s, map "
            f"{m2_s:.2f} s ({len(reads2) / m2_s:.1f} reads/s); mono2_probe launches {launches} "
            f"({smi})")
        del m2, reads2

    # uniform queries on the layout of the tier rule
    tier = query_tier(loaded, device=dev)
    host = loaded.device_arrays() if tier == "speed" else loaded.device_arrays(**synth.MPHF_LAYOUT)
    m = host["k2u"]["meta"]
    cpu_qi = QueryIndex(arrays_from_numpy(host, "cpu"))
    gpu_qi = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    del host
    if tier == "speed" and gpu_qi.nbytes() != speed_bytes(loaded):
        raise AssertionError(f"[cli uniform] speed_bytes {speed_bytes(loaded)} != the layout's "
                             f"{gpu_qi.nbytes()}")
    log(f"[cli uniform] tier {tier} by the rule: {m.pos_kind} positions, {m.prefix_kind} bounds, "
        f"probe bound {m.probe_bound}; {gpu_qi.nbytes()} bytes on the card (speed_bytes "
        f"{speed_bytes(loaded)})")
    t0 = time.perf_counter()
    work, uid, off, foreign = synth.sample_queries_truth(loaded.k2u.unitigs, BATCH, seed=1)
    work_cpu = torch.from_numpy(work.view(np.int64))
    fw = work_cpu.to(dev)
    out0 = get_ref_pos_compact(cpu_qi.arrays(), work_cpu, cpu_qi.max_occs, merge=False,
                               probe_limit=PLIM, m2=BATCH // 4)
    if bool(out0["over_budget"]):
        raise AssertionError("[cli uniform] CPU oracle over budget")
    host_chk = int(OneGraphIndexQuery.checksum(out0))
    merged = merge_compact_k2u(out0)
    hit = merged["mt"].numpy() > 0
    if not (hit[~foreign].all() and not hit[foreign].any()
            and np.array_equal(merged["unitig_id"].numpy()[~foreign], uid[~foreign])
            and np.array_equal(merged["pos"].numpy()[~foreign], off[~foreign])):
        raise AssertionError("[cli uniform] CPU oracle disagrees with the sampled lanes")
    n_ovf = int(out0["n_ovf"])
    M2 = max(1024, -(-(n_ovf + 128) // 256) * 256)
    log(f"[cli uniform] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}; "
        f"every sampled lane at its unitig and offset, no foreign lane hit; overflow "
        f"{n_ovf}/{BATCH} -> M2={M2}")
    del out0, merged, cpu_qi
    og = OneGraphIndexQuery(gpu_qi, BATCH, n_chunks=CH, m2=M2, probe_limit=PLIM)
    og_e = OneGraphIndexQuery(gpu_qi, BATCH, n_chunks=CH, m2=M2, probe_limit=PLIM, graph=False)
    _, worst, times = graph_and_eager("cli uniform", gpu_qi, og.checksum_pass_rolled,
                                      og_e.checksum_pass_rolled, fw, CH * host_chk, BATCH * CH,
                                      3, None, smi)
    log(f"[cli] phase 19 in {time.perf_counter() - phase_t0:.1f} s")

    def profile():
        profile_both("cli uniform", lambda: og.checksum_pass_rolled(fw),
                     lambda: og_e.checksum_pass_rolled(fw), times)
    return profile


def serve_phase(index, host: dict, gpu_index, dev, smi, tmp: str):
    """Phase 6a: ``bench.py::run_serve``'s device pass on the mono2 index
    over the synth50-serve traffic. Returns the mono2_probe launches of its
    first replayed pass and what phase 18 needs to profile it."""
    k, n_reads, n_ch = synth.K, synth.SERVE_READS, synth.SERVE_CHUNKS
    t0 = time.perf_counter()
    cc = index.color_classes()
    cb_host = color_bitsets(cc)
    cc_s = time.perf_counter() - t0
    cb, cb_cpu = arrays_from_numpy(cb_host, dev), arrays_from_numpy(cb_host, "cpu")
    log(f"[serve] color classes and bitsets in {cc_s:.2f} s on the host: {cc.n_classes} classes "
        f"over {cc.n_unitigs} unitigs and {cc.n_refs} references, W={cb_host['meta'].W}; "
        f"{tree_bytes(cb)} bytes on the card")

    t0 = time.perf_counter()
    reads = synth.serve_reads(index.refs, n_reads * n_ch, seed=1)
    fq = os.path.join(tmp, "reads.fastq.gz")
    synth.write_fastq(fq, reads)
    packed = pack_fastq(fq, k)
    m = packed["meta"]
    nq = sum(max(len(r) - k + 1, 0) for r in reads)
    log(f"[serve] {len(reads)} reads of {synth.READ_LEN} bases ({sum('N' in r for r in reads)} "
        f"with an N) written to a gzipped FASTQ and packed in {time.perf_counter() - t0:.2f} s: "
        f"{nq} read k-mers, has_bad={m.has_bad}, {serve_buffer(packed).nbytes} bytes to upload")

    # the oracle: the port's plain pass on CPU tensors, every chunk; chunk 0
    # sizes M2 as run_serve does (bench.py:209-211)
    t0 = time.perf_counter()
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    oracle = RunServePass(cpu_index, cb_cpu, n_reads, n_ch, max(8192, n_reads * m.L // 4),
                          synth.READ_LEN, probe_limit=PLIM, graph=False)(packed)
    M2 = max(2048, -(-int(oracle[2][0] * 1.4 + 1024) // 1024) * 1024)
    log(f"[serve] CPU oracle {time.perf_counter() - t0:.1f} s: chunk 0 map {oracle[0][0]}, pa "
        f"{oracle[1][0]}, overflow {oracle[2][0]} -> M2={M2}; worst overflow {max(oracle[2])}")

    sp = RunServePass(gpu_index, cb, n_reads, n_ch, M2, synth.READ_LEN, probe_limit=PLIM)
    sp_eager = RunServePass(gpu_index, cb, n_reads, n_ch, M2, synth.READ_LEN, probe_limit=PLIM,
                            graph=False)
    reset_launches()
    t0 = time.perf_counter()
    got = sp(packed)
    first_s = time.perf_counter() - t0
    launches = mono2_probe.LAUNCHES
    if launches == 0:
        raise AssertionError("[serve] the replayed pass never launched the mono2_probe kernel")
    cap = list(gpu_index.graphs.values())[-1]
    eager = sp_eager(packed)
    if not got == eager == oracle:
        raise AssertionError(f"[serve] replayed {got}, eager {eager}, CPU oracle {oracle}")
    log(f"[serve] first replayed pass {first_s:.3f} s (capture {cap.capture_s:.3f} s of it; graph "
        f"pool {cap.pool_bytes} bytes): {n_ch} chunks (map, pa, overflow) == eager == CPU oracle, "
        f"chunk for chunk; worst overflow {max(got[2])} <= M2 {M2}; mono2_probe launches "
        f"{launches} (the eager warm-up's and the captured)")
    # the graph reads its input buffer: chunks 0 and 1 swapped
    swapped = pack_reads(reads[n_reads : 2 * n_reads] + reads[:n_reads] + reads[2 * n_reads :], k)
    got2 = sp(swapped)
    if got2 != sp_eager(swapped) or [c[:2] for c in got2] != [[c[1], c[0]] for c in got]:
        raise AssertionError(f"[serve] with chunks 0 and 1 swapped the replayed pass gives {got2}")
    log("[serve] with chunks 0 and 1 swapped, replayed == eager, their results swapped")

    flat = torch.from_numpy(serve_buffer(packed)).to(dev)
    t = {kind: {"e2e": [], "device": []} for kind in ("graph", "eager")}
    for _ in range(SERVE_PASSES):
        for kind, run in (("graph", sp), ("eager", sp_eager)):
            t0 = time.perf_counter()
            res = run(pack_fastq(fq, k))
            t[kind]["e2e"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            dev_res = run.device_pass(flat, m)
            torch.cuda.synchronize()
            t[kind]["device"].append(time.perf_counter() - t0)
            if res != oracle or dev_res.T.tolist() != list(oracle):
                raise AssertionError(f"[serve] a timed {kind} pass differs from the oracle")
    for kind in ("graph", "eager"):
        for what, label in (("e2e", "end to end (FASTQ parse + pack + upload + pass)"),
                            ("device", "device pass alone")):
            rates = sorted(nq / x for x in t[kind][what])
            log(f"[serve] {kind} {label}, {SERVE_PASSES} in turns: median "
                f"{statistics.median(rates):.1f} read-kmers/s (min {rates[0]:.1f}, max "
                f"{rates[-1]:.1f}) ({smi})")
        host_s = statistics.median(t[kind]["e2e"]) - statistics.median(t[kind]["device"])
        log(f"[serve] {kind}: median end to end {statistics.median(t[kind]['e2e']) * 1e3:.2f} ms "
            f"a pass, device pass {statistics.median(t[kind]['device']) * 1e3:.2f} ms, the rest "
            f"(host pack, upload, read-back) {host_s * 1e3:.2f} ms ({smi})")
    host_split(fq, packed, dev, smi)

    # other policies on chunk 0, card against CPU
    t0 = time.perf_counter()
    d, d_cpu = gpu_index.arrays(), cpu_index.arrays()
    km, v = kmerize_device(arrays_from_numpy(packed, dev), 0, n_reads)
    km_c, v_c = kmerize_device(arrays_from_numpy(packed, "cpu"), 0, n_reads)
    num = tau_q32(TAU)
    for name, fn in (
        ("union", lambda a, c, x, y: pseudoalign_batch(a, c, x, y, "union")),
        (f"threshold {TAU} (device count)",
         lambda a, c, x, y: pseudoalign_threshold_batch(a, c, x, y, num)),
        ("classify", classify_kmers),
    ):
        g_out, c_out = fn(d, cb, km, v), fn(d_cpu, cb_cpu, km_c, v_c)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(g_out, c_out)):
            raise AssertionError(f"[serve] {name} on chunk 0: the card differs from the CPU")
        if name == "classify":
            cid, hit = (x.cpu().numpy() for x in g_out)
        elif name.startswith("threshold"):
            bits = g_out[0].cpu().numpy().view(np.uint8)
    host_count = count_threshold_host(cc, cid, hit, v_c.numpy(), num)
    unpacked = np.unpackbits(bits, bitorder="little", axis=1)[:, : cc.n_refs]
    if any(not np.array_equal(refs, np.flatnonzero(unpacked[i]))
           for i, (refs, _, _) in enumerate(host_count)):
        raise AssertionError(f"[serve] threshold {TAU}: the host count differs from the device's")
    log(f"[serve] chunk 0 through union, threshold {TAU} (device count) and classify: card == "
        f"CPU; the host count of threshold {TAU} == the device count "
        f"({time.perf_counter() - t0:.1f} s)")
    del cpu_index, sp, sp_eager, run
    if any(key[0][0] == "serve" for key in gpu_index.graphs):
        raise AssertionError("[serve] the pass's graphs outlived it")
    log("[serve] the pass's graphs left the index with it")
    return launches, {"cb": cb, "flat": flat, "meta": m, "m2": M2,
                      "times": {kind: statistics.median(t[kind]["device"]) for kind in t}}


def same_packed(a: dict, b: dict) -> bool:
    """Two ``pack_reads`` dicts hold the same Meta and bytes."""
    return a["meta"] == b["meta"] and all(
        (kk in a) == (kk in b) and (kk not in a or np.array_equal(a[kk], b[kk]))
        for kk in ("words", "lengths", "bad"))


def host_split(fq: str, packed: dict, dev, smi):
    """Phase 6a's host share of a serve pass, split into its parts, each
    timed SERVE_PASSES times (medians): decompression of the gzipped FASTQ,
    the fused parse and pack (``io.native.fastq_pack``), and the upload of
    the padded batch as one buffer; then ``pack_fastq`` (decompression and
    the fused pass) beside the Python reader (``read_fastq`` and
    ``pack_reads``) on the same file, both equal to the batch."""
    k = packed["meta"].k
    t = {kk: [] for kk in ("decompress", "parse and pack", "upload", "pack_fastq",
                           "python reader")}
    for _ in range(SERVE_PASSES):
        t0 = time.perf_counter()
        with open_binary(fq) as f:
            buf = f.read()
        t1 = time.perf_counter()
        p = fastq_pack(buf, k)
        t2 = time.perf_counter()
        up = torch.from_numpy(serve_buffer(pad_reads(p, synth.READ_LEN))).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fused = pack_fastq(fq, k)
        t4 = time.perf_counter()
        py = pack_reads([sq for _, sq in read_fastq(fq)], k)
        t5 = time.perf_counter()
        for kk, v in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            t[kk].append(v)
        if not (same_packed(p, packed) and same_packed(fused, packed) and same_packed(py, packed)):
            raise AssertionError("[serve host] a packing differs from the batch")
    med = {kk: statistics.median(v) for kk, v in t.items()}
    log(f"[serve host] {len(buf)} bytes of FASTQ text ({os.path.getsize(fq)} gzipped), "
        f"{up.numel() * 8} bytes uploaded; medians of {SERVE_PASSES}: decompress "
        f"{med['decompress'] * 1e3:.2f} ms, parse and pack (fused) "
        f"{med['parse and pack'] * 1e3:.2f} ms, upload {med['upload'] * 1e3:.2f} ms ({smi})")
    log(f"[serve host] pack_fastq {med['pack_fastq'] * 1e3:.2f} ms, the Python reader and "
        f"pack_reads {med['python reader'] * 1e3:.2f} ms on the same file: "
        f"{med['python reader'] / med['pack_fastq']:.2f}x; all equal to the batch ({smi})")


def read_truth(refs, start, rc, foreign, with_n, read_len: int, k: int):
    """(ok, ref, first k-mer's position, orient) a read of
    ``synth.serve_reads_truth``: ``ok`` for a read drawn from the genome
    (not foreign, no N) inside one reference, whose k-mer at read position p
    then lies on ``ref`` at ``pos0 + p`` (forward) or ``pos0 - p`` (reverse-
    complemented), on the reference's own unitig, which occurs there
    forward."""
    prefix = np.asarray(refs.prefix_sum, dtype=np.int64)
    ref = np.searchsorted(prefix, start, side="right") - 1
    ok = ~foreign & ~with_n & (ref == np.searchsorted(prefix, start + read_len - 1,
                                                      side="right") - 1)
    pos0 = np.where(rc, start + read_len - k, start) - prefix[ref]
    return ok, ref, pos0, np.where(rc, 0, 1)


def streaming_phase(index, host: dict, gpu_index, dev, smi, tmp: str) -> dict:
    """Phase 6c: the streaming index on the mono2 index over phase 6a's
    8 x 2,048 reads. Returns what phase 18 needs to profile a flat pass."""
    k, n = synth.K, synth.SERVE_READS * synth.SERVE_CHUNKS
    phase_t0 = t0 = time.perf_counter()
    reads, start, rc, foreign, with_n = synth.serve_reads_truth(index.refs, n, seed=1)
    kms, valid, positions = kmerize_reads(reads, k)
    packed = pack_reads(reads, k)
    nv = int(valid.sum())
    log(f"[stream] {n} reads k-merized on the host in {time.perf_counter() - t0:.2f} s: "
        f"[{kms.shape[0]}, {kms.shape[1]}] k-mer matrix, {nv} valid k-mers")
    fields = ("unitig_id", "unitig_len", "pos", "mt")

    def same(a, b, rows=None):
        return all(np.array_equal(a[kk][:rows], b[kk][:rows]) for kk in fields)

    def graph_of(si):
        return [g for key, g in gpu_index.graphs.items() if key[0][:2] == ("stream", si._key)]

    flat = StreamingIndex(gpu_index, mode="flat")
    flat_eager = StreamingIndex(gpu_index, mode="flat", graph=False)
    t0 = time.perf_counter()
    want = flat.k2u_reads(kms, valid)
    first_s = time.perf_counter() - t0
    cold = flat.last_cold_fraction
    t0 = time.perf_counter()
    got = flat.k2u_reads_packed(packed)
    first_packed_s = time.perf_counter() - t0
    if not (same(got, want) and flat.last_cold_fraction == cold):
        raise AssertionError("[stream] k2u_reads_packed differs from k2u_reads")
    for run in (lambda: flat_eager.k2u_reads(kms, valid),
                lambda: flat_eager.k2u_reads_packed(packed)):
        if not (same(run(), want) and flat_eager.last_cold_fraction == cold):
            raise AssertionError("[stream] an eager flat pass differs from the replayed one")
    caps = graph_of(flat)
    log(f"[stream] flat: first replayed k2u_reads {first_s:.3f} s, k2u_reads_packed "
        f"{first_packed_s:.3f} s; captures {[round(g.capture_s, 3) for g in caps]} s, graph "
        f"pools {[g.pool_bytes for g in caps]} bytes; replayed == eager, matrix == packed; "
        f"cold fraction {cold:.6f}; {int((want['mt'] > 0).sum())} hits")
    t = {kk: [] for kk in ("matrix graph", "matrix eager", "packed graph", "packed eager",
                           "device graph", "device eager")}
    kmat = torch.from_numpy(kms.view(np.int64)).to(dev)
    vt = torch.from_numpy(valid).to(dev)
    runs = (("matrix graph", lambda: flat.k2u_reads(kms, valid)),
            ("matrix eager", lambda: flat_eager.k2u_reads(kms, valid)),
            ("packed graph", lambda: flat.k2u_reads_packed(packed)),
            ("packed eager", lambda: flat_eager.k2u_reads_packed(packed)),
            ("device graph", lambda: (flat.k2u_device(kmat, vt), torch.cuda.synchronize())),
            ("device eager", lambda: (flat_eager.k2u_device(kmat, vt),
                                      torch.cuda.synchronize())))
    for _ in range(STREAM_PASSES):
        for kind, run in runs:
            t0 = time.perf_counter()
            out = run()
            t[kind].append(time.perf_counter() - t0)
            if isinstance(out, dict) and not same(out, want):
                raise AssertionError(f"[stream] a timed {kind} pass differs")
    for kind, v in t.items():
        rates = sorted(nv / x for x in v)
        log(f"[stream] flat {kind}, {STREAM_PASSES} in turns: median "
            f"{statistics.median(rates):.1f} k-mers/s (min {rates[0]:.1f}, max {rates[-1]:.1f}); "
            f"{statistics.median(v) * 1e3:.2f} ms a pass ({smi})")

    scan = StreamingIndex(gpu_index, mode="scan")
    t0 = time.perf_counter()
    out = scan.k2u_reads(kms, valid)
    scan_first = time.perf_counter() - t0
    if not (same(out, want) and scan.last_cold_fraction == cold):
        raise AssertionError("[stream] the scan pass differs from the flat one")
    t0 = time.perf_counter()
    scan.k2u_reads(kms, valid)
    scan_s = time.perf_counter() - t0
    cap = graph_of(scan)[0]
    log(f"[stream] scan over {kms.shape[1]} columns: first replayed pass {scan_first:.2f} s "
        f"(capture {cap.capture_s:.2f} s, graph pool {cap.pool_bytes} bytes), then {scan_s:.3f} s "
        f"= {nv / scan_s:.1f} k-mers/s ({smi}); == flat, same cold fraction")
    del scan, cap

    h = HOST_READS
    host_si = StreamingIndex(gpu_index, mode="host")
    t0 = time.perf_counter()
    out = host_si.k2u_reads(kms[:h], valid[:h])
    host_s = time.perf_counter() - t0
    flat_eager.k2u_reads(kms[:h], valid[:h])
    if not (same(out, want, h) and host_si.last_cold_fraction == flat_eager.last_cold_fraction):
        raise AssertionError(f"[stream] the host loop on the first {h} reads differs")
    log(f"[stream] host loop on the first {h} reads: {host_s:.2f} s = "
        f"{int(valid[:h].sum()) / host_s:.1f} k-mers/s ({smi}); == flat, cold fraction "
        f"{host_si.last_cold_fraction:.6f} == flat's on those reads")

    o = ORACLE_READS
    cpu_si = StreamingIndex(QueryIndex(arrays_from_numpy(host, "cpu")), mode="flat")
    out = cpu_si.k2u_reads(kms[:o], valid[:o])
    flat_eager.k2u_reads(kms[:o], valid[:o])
    if not (same(out, want, o) and cpu_si.last_cold_fraction == flat_eager.last_cold_fraction):
        raise AssertionError(f"[stream] the first {o} reads differ from the plain path on the CPU")
    log(f"[stream] the first {o} reads == the plain path on CPU tensors, cold fraction too")

    t0 = time.perf_counter()
    g = flat.get_ref_pos_reads(kms, valid)
    grp_s = time.perf_counter() - t0
    ok, ref, pos0, orient = read_truth(index.refs, start, rc, foreign, with_n, synth.READ_LEN, k)
    exp_pos = pos0[:, None] + np.where(rc, -1, 1)[:, None] * positions
    hit = (g["valid"] & (g["ref_id"] == ref[:, None, None]) & (g["ref_pos"] == exp_pos[..., None])
           & (g["orient"] == orient[:, None, None])).any(axis=2)
    need = valid & ok[:, None]
    if not (hit | ~need).all():
        raise AssertionError(f"[stream] {int((need & ~hit).sum())} k-mers of genome reads lack "
                             f"their true (ref, pos)")
    log(f"[stream] get_ref_pos_reads (flat) {grp_s:.3f} s: every one of the {int(need.sum())} "
        f"valid k-mers of the {int(ok.sum())} genome reads inside one reference hits its true "
        f"(ref, pos, orient)")

    refs = index.refs
    fa = os.path.join(tmp, "genome.fa")
    with open(fa, "w") as f:
        for i in range(refs.n_refs):
            s0, s1 = int(refs.prefix_sum[i]), int(refs.prefix_sum[i + 1])
            f.write(f">{refs.names[i]}\n{refs.seq.to_str(s0, s1)}\n")
    t0 = time.perf_counter()
    validate_fasta_streaming(gpu_index, fa, lanes=STREAM_LANES)
    log(f"[stream] validate_fasta_streaming over all {refs.n_refs} references "
        f"({int(refs.prefix_sum[-1])} bases), {STREAM_LANES} lanes of 2048 bases a batch, flat: "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    del flat, flat_eager, host_si, cpu_si, runs, run
    if any(key[0][0] == "stream" for key in gpu_index.graphs):
        raise AssertionError("[stream] the streaming graphs outlived their objects")
    log(f"[stream] phase 6c in {time.perf_counter() - phase_t0:.1f} s; its graphs left the index "
        f"with their objects")
    return {"kms": kms, "valid": valid,
            "times": {"graph": statistics.median(t["device graph"]),
                      "eager": statistics.median(t["device eager"])}}


def mapping_phase(tag: str, index, qi, cpu_qi, probe, smi, tmp: str, seed: int = 1,
                  driver: str = "TwoPhaseIndexQuery", rival: dict | None = None) -> int:
    """Phase 6d on one index: ``ReadMapper.map_file`` over a gzipped FASTQ
    of 8 x 2,048 reads drawn from the index's genome (``serve_reads``),
    querying ``qi`` (the index's arrays on the card in the mapper's layout)
    through ``driver`` (the mapper's choice must be it), with ``probe``'s
    kernel in its main phase (None: no kernel; the speed tier's probe is
    plain torch), the tier rule's tier on an SSHash. ``rival``: an SSHash's
    other tier, asked of a second mapper (``qi``, ``driver``, ``tier`` and
    ``probe`` as above), whose hits must equal the first's and which is
    timed in turns with it. The CSR hits of the first
    and the last ORACLE_READS reads (the first batch and the ragged last
    one) and of every read that is not a genome read inside one reference
    (foreign, with an N, across two references) must equal the plain padded
    query on ``cpu_qi`` (CPU tensors), and every valid k-mer of every
    genome read inside one reference must hit its true (ref, pos, orient).
    Returns the kernel's launches in the first run."""
    k, n = index.k, synth.SERVE_READS * synth.SERVE_CHUNKS
    phase_t0 = time.perf_counter()
    reads, start, rc, foreign, with_n = synth.serve_reads_truth(index.refs, n, seed=seed)
    fq = os.path.join(tmp, f"{tag.replace(' ', '_')}.fastq.gz")
    synth.write_fastq(fq, reads)
    runs = [dict(qi=qi, driver=driver, tier=None, probe=probe)] + ([rival] if rival else [])
    for r in runs:
        r["mapper"] = ReadMapper(index, query_index=r["qi"], tier=r["tier"])
        if type(r["mapper"].tp).__name__ != r["driver"]:
            raise AssertionError(f"[{tag}] the mapper took {type(r['mapper'].tp).__name__}, not "
                                 f"{r['driver']}")
        took = {"TwoPhaseIndexQuery": "speed", "CompactQuery": "capacity"}.get(r["driver"], "-")
        if type(index.k2u).__name__ != "SSHash":
            took = "-"
        elif r["tier"] is None and took != query_tier(index, device=next(qi.buffers()).device):
            raise AssertionError(f"[{tag}] the mapper's tier is not the rule's")
        r["took"] = f"{took} ({'the rule' if r['tier'] is None else 'asked for'})"
        log(f"[{tag}] tier {r['took']}: driver {r['driver']}")
        reset_launches()
        t0 = time.perf_counter()
        r["hits"] = r["mapper"].map_file(fq)
        r["first_s"] = time.perf_counter() - t0
        r["launches"] = r["probe"].LAUNCHES if r["probe"] else 0
        if r["probe"] and r["launches"] == 0:
            raise AssertionError(f"[{tag}] the mapper never launched the "
                                 f"{r['probe'].SOURCE.stem} kernel")
        r["times"] = []
    mapper, hits, first_s, launches = (runs[0][kk] for kk in ("mapper", "hits", "first_s",
                                                              "launches"))
    n_kmers = sum(h.n_kmers for h in hits)
    for _ in range(MAP_PASSES):
        for r in runs:
            t0 = time.perf_counter()
            r["again"] = r["mapper"].map_file(fq)
            r["times"].append(time.perf_counter() - t0)
    bh = runs[0]["again"][0]._batch
    for r in runs:
        for other in (r["again"][0]._batch, r["hits"][0]._batch):
            if not all(np.array_equal(getattr(bh, kk), getattr(other, kk))
                       for kk in ("mt", "offsets", "ref_id", "ref_pos", "orient")):
                raise AssertionError(f"[{tag}] two runs of the mappers differ")
    times = runs[0]["times"]

    o = ORACLE_READS
    ok, ref, pos0, orient = read_truth(index.refs, start, rc, foreign, with_n, synth.READ_LEN, k)
    held = np.unique(np.concatenate([np.arange(o), np.arange(n - o, n), np.flatnonzero(~ok)]))
    _, _, words = kmerize_batch([reads[i] for i in held], k)
    out = get_ref_pos_padded(cpu_qi.arrays(), torch.from_numpy(words.view(np.int64)),
                             cpu_qi.max_occs)
    want = BatchHits.from_padded({kk: v.numpy() for kk, v in out.items()})
    bounds = np.concatenate([[0], np.cumsum([h.n_kmers for h in hits])])
    lanes = np.concatenate([np.arange(bounds[i], bounds[i + 1]) for i in held])
    got = lane_hits(bh, lanes)
    if not all(np.array_equal(a, b) for a, b in zip(got, lane_hits(want, np.arange(len(lanes))))):
        raise AssertionError(f"[{tag}] {len(held)} held reads differ from the padded CPU query")
    from_foreign = foreign[np.repeat(held, np.diff(bounds)[held])]
    held_log = (f"the first and last {o} reads (batches 0 and {(bounds[-1] - 1) // mapper.batch}) "
                f"and all {int((~ok).sum())} others ({int(foreign.sum())} foreign, "
                f"{int(with_n.sum())} with an N), {len(lanes)} lanes, == the padded query on CPU "
                f"tensors ({int((got[0][from_foreign] > 0).sum())} of the foreign reads' "
                f"{int(from_foreign.sum())} lanes hit)")

    lane_read = np.repeat(np.arange(n), [h.n_kmers for h in hits])
    read_pos = np.concatenate([h.read_pos for h in hits])
    exp_pos = pos0[lane_read] + np.where(rc[lane_read], -1, 1) * read_pos
    hit_lane = np.repeat(np.arange(len(bh.mt)), np.diff(bh.offsets))
    match = ((bh.ref_id == ref[lane_read][hit_lane]) & (bh.ref_pos == exp_pos[hit_lane])
             & (bh.orient == orient[lane_read][hit_lane]))
    found = np.bincount(hit_lane[match], minlength=len(bh.mt)) > 0
    need = ok[lane_read]
    if not (found | ~need).all():
        raise AssertionError(f"[{tag}] {int((need & ~found).sum())} k-mers of genome reads lack "
                             f"their true (ref, pos)")
    med = statistics.median(times)
    log(f"[{tag}] ReadMapper.map_file, {n} reads, {n_kmers} k-mers, driver "
        f"{type(mapper.tp).__name__}: first run {first_s:.2f} s "
        f"({f'{probe.SOURCE.stem} launches {launches}' if probe else 'no kernel'}); {held_log}; all "
        f"{int(need.sum())} k-mers of the {int(ok.sum())} genome reads inside one reference hit "
        f"their true (ref, pos, orient)")
    log(f"[{tag}] {MAP_PASSES} runs: median {med:.3f} s = {n / med:.1f} reads/s, "
        f"{n_kmers / med:.1f} k-mers/s (min {min(times):.3f} s, max {max(times):.3f} s) ({smi}); "
        f"phase 6d on this index in {time.perf_counter() - phase_t0:.1f} s")
    if rival:
        t, rp = rival["times"], rival["probe"]
        rmed = statistics.median(t)
        kernel = f"{rp.SOURCE.stem} launches {rival['launches']}" if rp else "no kernel"
        log(f"[{tag}] in turns with it, the same hits from tier {rival['took']}, driver "
            f"{rival['driver']}: first run {rival['first_s']:.2f} s ({kernel}); {MAP_PASSES} "
            f"runs: median {rmed:.3f} s = {n / rmed:.1f} reads/s (min {min(t):.3f} s, max "
            f"{max(t):.3f} s); the rule's tier {rmed / med:.3f}x as fast ({smi})")
    return launches


def lane_hits(bh, lanes: np.ndarray) -> tuple:
    """(mt, hit counts, ref_id, ref_pos, orient) of the lanes ``lanes`` of
    the CSR hits ``bh``, their hits in lane order."""
    start = bh.offsets[lanes]
    cnt = bh.offsets[lanes + 1] - start
    idx = np.repeat(start - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt) + np.arange(cnt.sum())
    return (bh.mt[lanes], cnt, bh.ref_id[idx], bh.ref_pos[idx], bh.orient[idx])


def validation_phase(index, gpu_index, dev, tmp: str):
    """Phase 6b: the validation oracles on the card over the whole index."""
    d, mo = gpu_index.arrays(), gpu_index.max_occs

    def query(w):
        # every k-mer of a unitig with 3 occurrences overflows the main
        # phase: a FASTA record of one such reference overflows whole
        return get_ref_pos_compact(d, w, mo, merge=True, m2=w.shape[0])

    refs = index.refs
    n_kmers = int(np.maximum(np.diff(refs.prefix_sum) - index.k + 1, 0).sum())
    reset_launches()
    t0 = time.perf_counter()
    validate_self(index, query_fn=query, chunk=VALIDATE_CHUNK, device=dev)
    self_s = time.perf_counter() - t0
    if mono2_probe.LAUNCHES == 0:
        raise AssertionError("[validate] validate_self never launched the mono2_probe kernel")
    log(f"[validate] validate_self: {n_kmers} k-mers of {refs.n_refs} references through "
        f"get_ref_pos_compact(merge=True) in chunks of {VALIDATE_CHUNK}, every one at its "
        f"(ref, pos), in {self_s:.1f} s (mono2_probe launches {mono2_probe.LAUNCHES})")
    fa = os.path.join(tmp, "refs64.fa")
    with open(fa, "w") as f:
        for i in range(64):
            s0, s1 = int(refs.prefix_sum[i]), int(refs.prefix_sum[i + 1])
            f.write(f">{refs.names[i]}\n{refs.seq.to_str(s0, s1)}\n")
    t0 = time.perf_counter()
    validate_fasta(index, fa, query_fn=query, device=dev)
    log(f"[validate] validate_fasta on the first 64 references: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    validate_k2u_self(index.k2u, k2u_fn=lambda w: k2u_batch(d, w), chunk=VALIDATE_CHUNK,
                      device=dev)
    log(f"[validate] validate_k2u_self: {index.k2u.unitigs.n_kmers} unitig k-mers, forward and "
        f"reverse, through k2u_batch: {time.perf_counter() - t0:.1f} s")


def same_query(tag: str, got, want):
    """Two ``TwoPhaseIndexQuery.query`` results (main rows, overflow lanes,
    overflow rows) hold the same arrays."""
    (r_g, l_g, s_g), (r_w, l_w, s_w) = got, want
    if not np.array_equal(l_g, l_w) or (s_g is None) != (s_w is None):
        raise AssertionError(f"[{tag}] query: the overflow lanes differ")
    for part, g, w in (("main", r_g, r_w), ("overflow", s_g or {}, s_w or {})):
        if set(g) != set(w) or not all(np.array_equal(g[kk], w[kk]) for kk in w):
            raise AssertionError(f"[{tag}] query: the {part} rows differ")


def twophase_on_card(tag: str, gpu_index, cpu_index, work: np.ndarray, probe, **kw):
    """``TwoPhaseIndexQuery.checksum_query`` and ``.query`` on the card
    (its main phase launching ``probe``'s kernel) against the same on the
    CPU copy of the index."""
    fw = torch.from_numpy(work.view(np.int64))
    tp, tp_cpu = TwoPhaseIndexQuery(gpu_index, **kw), TwoPhaseIndexQuery(cpu_index, **kw)
    tp.checksum_query(fw.to(tp.device))  # warm
    reset_launches()
    t0 = time.perf_counter()
    got = tp.checksum_query(fw.to(tp.device))
    card_s = time.perf_counter() - t0
    if probe.LAUNCHES == 0:
        raise AssertionError(f"[{tag}] checksum_query never launched the {probe.SOURCE.stem} kernel")
    want = tp_cpu.checksum_query(fw)
    if got != want:
        raise AssertionError(f"[{tag}] checksum_query on the card {got}, on the CPU {want}")
    same_query(tag, tp.query(work), tp_cpu.query(work))
    log(f"[{tag}] TwoPhaseIndexQuery on {len(work)} queries: checksum_query (checksum, overflow "
        f"lanes) {got} on the card == CPU, {card_s * 1e3:.1f} ms on the card with "
        f"{probe.SOURCE.stem} launches {probe.LAUNCHES}; query's main and overflow rows == CPU")


def mono2_drivers(cpu_index, gpu_index, work: np.ndarray, fw: torch.Tensor):
    """Phase 6's drivers beside the pass: ``TwoPhaseIndexQuery`` (K1 in its
    main phase) and ``get_ref_pos_csr`` on the whole batch, each against
    the port's path on CPU tensors."""
    twophase_on_card("main twophase", gpu_index, cpu_index, work, mono2_probe)
    work_cpu = torch.from_numpy(work.view(np.int64))
    t0 = time.perf_counter()
    want = get_ref_pos_csr(cpu_index.arrays(), work_cpu, 1)
    total = int(want["total"])
    want = get_ref_pos_csr(cpu_index.arrays(), work_cpu, total)
    cpu_s = time.perf_counter() - t0
    got = get_ref_pos_csr(gpu_index.arrays(), fw, total)
    bad = [kk for kk in want if not torch.equal(got[kk].cpu(), want[kk])]
    if bad or int(got["valid"].sum()) != total:
        raise AssertionError(f"[main csr] get_ref_pos_csr on the card differs from the CPU in {bad}")
    log(f"[main csr] get_ref_pos_csr of {fw.shape[0]} queries, budget = total = {total} "
        f"occurrences: every field on the card == CPU ({cpu_s:.1f} s on the CPU)")


def capacity_drivers(cpu_index, gpu_index, work: np.ndarray, fw: torch.Tensor):
    """Phase 12's drivers beside the pass: ``TwoPhaseIndexQuery`` (K2 in its
    main phase), and ``get_ref_pos_compact`` on the capacity index without
    bpos rows and window records (K3 on the direct layout, the main phase
    projected through the offsets table), each against the port's path on
    CPU tensors."""
    twophase_on_card("cap twophase", gpu_index, cpu_index, work, bpos_probe, probe_limit=PLIM)

    def bare(d):
        k2u = {kk: v for kk, v in d["k2u"].items() if kk != "bpos"}
        k2u["us"] = {kk: v for kk, v in k2u["us"].items() if kk != "useqrec"}
        return {**d, "k2u": k2u}

    kw = dict(merge=False, m2=BATCH // 4, probe_limit=PLIM, m2b=BATCH // 4, defer_valid=True,
              probe_limit2=PLIM2, m2c=BATCH // 16)
    mo = gpu_index.max_occs
    want = get_ref_pos_compact(bare(cpu_index.arrays()), torch.from_numpy(work.view(np.int64)), mo,
                               **kw)
    reset_launches()
    got = get_ref_pos_compact(bare(gpu_index.arrays()), fw, mo, **kw)
    chk, want_chk = int(OneGraphIndexQuery.checksum(got)), int(OneGraphIndexQuery.checksum(want))
    if capacity_probe.LAUNCHES == 0:
        raise AssertionError("[cap offsets] the main phase never launched the capacity_probe kernel")
    if bool(want["over_budget"]) or bool(got["over_budget"]) or chk != want_chk:
        raise AssertionError(f"[cap offsets] checksum on the card {chk}, on the CPU {want_chk}")
    k2u_g, k2u_w = merge_compact_k2u(got), merge_compact_k2u(want)
    for kk in k2u_w:
        if not torch.equal(k2u_g[kk].cpu(), k2u_w[kk]):
            raise AssertionError(f"[cap offsets] merged {kk} on the card differs from the CPU")
    for kk in ("n_occs", "valid", "ref_id", "ref_pos"):
        if not torch.equal(got["main"][kk].cpu(), want["main"][kk]):
            raise AssertionError(f"[cap offsets] main-phase {kk} on the card differs from the CPU")
    log(f"[cap offsets] get_ref_pos_compact without bpos, useqrec or uproj (main phase through "
        f"_project_offsets): checksum {chk} and merged fields on the card == CPU; type-A "
        f"{int(got['n_ovf'])}, type-B {int(got['n_ovf_b'])}; capacity_probe launches "
        f"{capacity_probe.LAUNCHES}")


def n_occs_of(k2u: dict, fw: torch.Tensor) -> torch.Tensor:
    """Occurrence count of each query's minimizer bucket (its bpos row)."""
    m = k2u["meta"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    return mask32(k2u["bpos"][fold_hash32(mm) & (m.direct_t - 1), 3])


def probed_rows(run, n_occs: torch.Tensor, skew: torch.Tensor, plim: int) -> torch.Tensor:
    """Rows a first-hit probe reads per lane at probe limit ``plim``: j for
    a lane first found at limit j, else min(plim, n_occs); none for a skew
    lane. ``run(j)`` is the plain main probe at limit j (found: mt 1 or 2)."""
    rows = torch.clamp(n_occs, max=plim)
    done = torch.zeros_like(skew)
    for j in range(1, plim + 1):
        mt = run(j)["mt"]
        found = ((mt == 1) | (mt == 2)) & ~done
        rows = torch.where(found, j, rows)
        done = done | found
    return torch.where(skew, 0, rows)


def k3_lane_cost(k2u: dict, fw: torch.Tensor, plim: int,
                 mlim: int) -> tuple[int, int, int, int, int]:
    """(bytes, L2 sectors, DRAM sectors, DRAM 64-byte blocks, the MPHF's
    sectors among the L2 ones) that K3 must move on this batch on the MPHF
    layout with a truncated chain.

    Bytes, each read once and only what a lane reads: its key; one u32 MPHF
    word per level tested up to the first hit (at most ``mlim``); for a
    placed lane its block's u32 rank and the words before the hit word in
    the block; for a placed lane that is not skew, two u16 bucket deltas,
    one or two i64 group bases, and the position bits and three useq words
    of each probed row; for a winner two wb2 words and a count and its
    40-byte uproj row; and 59 bytes of outputs. A deferred winner that
    fails validation counts as a miss.

    Sectors: the distinct 32-byte sectors of those random reads (the key
    and output streams are left out), split into the tables that stay in
    the 50 MB L2 at 300 Mbp (the MPHF words and ranks, gbase, uproj: ~32
    MB) and those that do not (gdelta, the packed positions, words2,
    wb2); the DRAM reads also in distinct 64-byte blocks. Every placed
    lane reads its bucket bounds, skew or not. Both next-row words (q2, the
    next wb2 word) are counted: the kernel skips them where its masks
    discard them, so it touches a little less."""
    m, mp = k2u["meta"], k2u["mphf"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    mmeta = mp["meta"]
    n_test = min(mlim, len(mmeta.n_bits))
    s0, s1 = key_fold32(mm)
    hit = torch.full_like(fw, -1)
    hit_pos = torch.zeros_like(fw)
    for li in range(n_test):
        h, s0, s1 = chain_next(s0, s1)
        pos = h & (mmeta.n_bits[li] - 1)
        bit = ((mask32(mp["words"][mmeta.word_offsets[li] + (pos >> 5)]) >> (pos & 31)) & 1) != 0
        newly = bit & (hit < 0)
        hit = torch.where(newly, li, hit)
        hit_pos = torch.where(newly, pos, hit_pos)
    placed = hit >= 0
    levels = torch.where(placed, hit + 1, n_test)
    rank = torch.where(placed, 4 + 4 * ((hit_pos >> 5) & 7), 0)
    hc = torch.clamp(mphf_lookup(mp, mm, level_limit=mlim)[0].to(torch.int64), min=0)
    ps, pe = _prefix_pair(k2u, hc)
    n_occs = torch.where(placed, pe - ps, 0)

    def run(j):
        return sshash_k2u(k2u, fw, mode="main", probe_limit=j, defer_valid=True,
                          mphf_level_limit=mlim)

    last = run(plim)
    rows = probed_rows(run, n_occs, last["use_skew"], plim)
    groups = 1 + ((hc >> 10) != ((hc + 1) >> 10)).to(torch.int64)
    width = k2u["pos"]["meta"].width
    bucket = torch.where(placed & ~last["use_skew"],
                         4 + 8 * groups + (rows * width + 7) // 8 + 24 * rows, 0)
    hits = last["mt"] > 0
    tail = torch.where(hits, 24 + 40, 0)
    n_bytes = int((8 + 4 * levels + rank + bucket + tail + 59).sum())

    # L2: a sector per tested level (the hit word's 32-byte block is its
    # sector), the rank, the group bases, the uproj row
    us = k2u["us"]
    uid = last["unitig_id"]
    l2 = (levels + placed.to(torch.int64)
          + distinct(torch.stack(sector_ids(8 * (hc >> 10), 8, placed)
                                 + sector_ids(8 * ((hc + 1) >> 10), 8, placed), 1))
          + distinct(torch.stack(sector_ids(40 * uid, 40, hits), 1)))
    # DRAM: the two deltas, the position words, each probed row's two
    # words2 rows, the winner's two wb2 rows; in 32-byte sectors and in
    # 64-byte blocks
    lo_w = 8 * ((ps * width) >> 6)
    hi_w = 8 * (((ps + rows) * width - 1) >> 6)
    n_w2, n_wb = us["useq"]["words2"].shape[0], us["bv"]["wb2"].shape[0]
    n_pos = int(k2u["pos"]["meta"].length)
    w2_rows = []
    for j in range(plim):
        mm_pos = _pos_get(k2u, torch.clamp(ps + j, 0, n_pos - 1))
        wi = (torch.clamp(mm_pos - (m.k - m.w), min=0) * 2) >> 6
        w2_rows += [(torch.clamp(wi, max=n_w2 - 1), j < rows),
                    (torch.clamp(wi + 1, max=n_w2 - 1), j < rows)]
    bwi = (last["pos"] + us["uproj"][torch.clamp(uid, max=us["uproj"].shape[0] - 1), 0]) >> 6

    def dram(size):
        w2 = [i for r, on in w2_rows for i in sector_ids(16 * r, 16, on, size)]
        return int((distinct(torch.stack(sector_ids(2 * hc, 4, placed, size), 1))
                    + torch.where(rows > 0, hi_w // size - lo_w // size + 1, 0)
                    + distinct(torch.stack(w2, 1))
                    + distinct(torch.stack(
                        sector_ids(16 * bwi, 16, hits, size)
                        + sector_ids(16 * torch.clamp(bwi + 1, max=n_wb - 1), 16, hits, size), 1))
                    ).sum())

    return n_bytes, int(l2.sum()), dram(32), dram(64), int((levels + placed.to(torch.int64)).sum())


def k2_dram_sectors(k2u: dict, fw: torch.Tensor, rows: torch.Tensor) -> tuple[int, int]:
    """The distinct 32-byte sectors and 64-byte blocks of K2's random reads
    on this batch, all from tables past the L2 (2.1 GB of bpos rows, 0.6
    GB of padded records at 300 Mbp): each lane's 16-byte bpos row and the
    56 bytes of each of its ``rows`` probed rows' records, which the
    kernel reads from 64-byte rows (``bpos_probe.padded_records``; the key
    and output streams are left out)."""
    m = k2u["meta"]
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    brow = mask32(k2u["bpos"][fold_hash32(mm) & (m.direct_t - 1)])
    n_rec = k2u["us"]["useqrec"].shape[0]
    lo = [(8 * bpos_probe.REC_WORDS
           * torch.clamp((torch.clamp(brow[:, j] - (m.k - m.w), min=0) * 2) >> 6, max=n_rec - 1),
           j < rows)
          for j in range(int(rows.max()) if rows.numel() else 0)]

    def count(size):
        ids = [i for r, on in lo for i in sector_ids(r, 56, on, size)]
        return fw.shape[0] + (int(distinct(torch.stack(ids, 1)).sum()) if ids else 0)

    return count(32), count(64)


def tree_bytes(d) -> int:
    """Bytes of the tensors of an array dict."""
    if isinstance(d, dict):
        return sum(tree_bytes(v) for v in d.values())
    return d.numel() * d.element_size() if isinstance(d, torch.Tensor) else 0


# (kernel, the TPU kernel body it replaces)
LAB = (
    ("gather_u32", "labs/pallas_probe.py:31"),
    ("hash_mix32x8", "labs/pallas_probe.py:35"),
    ("xor_rows", "labs/tpu_dma_lab.py:44"),
    ("xor_rows_ring", "labs/tpu_dma_lab.py:68"),
    ("gather_rows", "labs/tpu_dma_lab.py:115"),
)


def lab_kernels(dev, smi, lib: str, report: str) -> list:
    """Phase 3; returns the five lab kernels' records for the kernels line."""
    g = gather_lab
    log(f"[lab build] {lib}")
    for line in ptxas_lines(report):
        log(f"[lab build] {line}")
    N, M, T, NR = gather_probe.N, gather_probe.M, dma_lab.T, dma_lab.N
    rng = np.random.default_rng(7)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64).astype(np.int32)).to(dev)

    def u32(shape):
        return i32(rng.integers(-(1 << 31), 1 << 31, shape))

    err = dict.fromkeys((*g.NAMES, "sector_reads"), 0)

    def same(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"[lab] {name}: {got.dtype}{tuple(got.shape)}, plain gives "
                                 f"{want.dtype}{tuple(want.shape)}")
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        err[name] = max(err[name], diff)
        if not torch.equal(got, want):
            raise AssertionError(f"[lab] {name}: kernel and plain version differ")

    tbl, rows = u32(M), u32((T, 128))
    for n in (N, 1, (1 << 18) + 37):
        idx = i32(rng.integers(0, M, n))
        for ii in (idx, torch.full_like(idx, M - 1)):
            same("gather_u32", g.gather_u32(tbl, ii), g.gather_u32_plain(tbl, ii))
        same("sector_reads", g.sector_reads(tbl, idx), g.gather_u32_plain(tbl, idx))
        x = u32(n + 1)
        for xx in (x[:n], x[1:]):  # 16-byte aligned, and not
            same("hash_mix32x8", g.hash_mix32x8(xx), g.hash_mix32x8_plain(xx))
    for n in (NR, 1, (1 << 18) + 37):
        idx = i32(rng.integers(0, T, n))
        for ii in (idx, torch.full_like(idx, T - 1)):
            want = g.xor_rows_plain(ii, rows)
            same("xor_rows", g.xor_rows(ii, rows), want)
            same("xor_rows_ring", g.xor_rows_ring(ii, rows), want)
            same("gather_rows", g.gather_rows(ii, rows), g.gather_rows_plain(ii, rows))
    torch.cuda.synchronize()
    log("[lab] L1-L5 at the labs' shapes, N=1, N=2^18+37 and all-same indices (and L2 on an "
        "unaligned view), and sector_reads: bit-identical")
    gather_cases(tbl, M, N, rng, same)
    xor_cases(rows, T, NR, rng, same)

    # the main path: the two lab entry points
    reset_launches()
    gather_probe.run(dev, log=lambda *a: log("[lab gather_probe]", *a))
    dma_lab.run(dev, log=lambda *a: log("[lab dma_lab]", *a))
    launches = dict(g.LAUNCHES)
    log(f"[lab] launches by the lab entry points: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a lab entry point never launched its kernel: {launches}")

    tblL, idxL, xL = gather_probe.inputs(N, M, dev)
    rowsL, idxR = dma_lab.inputs(T, NR, dev)
    row_b = 4 * g.ROW
    spec = {  # kernel, plain version, one torch call for the same, bound
        "gather_u32": (lambda: g.gather_u32(tblL, idxL), lambda: g.gather_u32_plain(tblL, idxL),
                       lambda: tblL[idxL], bound(4 * (2 * N + M))),
        "hash_mix32x8": (lambda: g.hash_mix32x8(xL), lambda: g.hash_mix32x8_plain(xL), None,
                         bound(8 * N, 24 * N)),
        "xor_rows": (lambda: g.xor_rows(idxR, rowsL), lambda: g.xor_rows_plain(idxR, rowsL),
                     None, bound(4 * NR + row_b * (T + 1))),
        "xor_rows_ring": (lambda: g.xor_rows_ring(idxR, rowsL),
                          lambda: g.xor_rows_plain(idxR, rowsL), None,
                          bound(4 * NR + row_b * (T + 1))),
        "gather_rows": (lambda: g.gather_rows(idxR, rowsL), lambda: g.gather_rows_plain(idxR, rowsL),
                        lambda: torch.index_select(rowsL, 0, idxR),
                        bound(4 * NR + row_b * (T + NR))),
    }
    # the kernels' own rates from L2 on batches where the launch costs
    # little: random 4-byte reads of the 1 MB table, random 512-byte rows of
    # the 8 MB one (what their own code costs stays in these rates)
    idx_w = i32(rng.integers(0, M, L2_WORDS))
    same("gather_u32", g.gather_u32(tblL, idx_w), g.gather_u32_plain(tblL, idx_w))
    words_s = L2_WORDS / cuda_ms(lambda: g.gather_u32(tblL, idx_w), 20) * 1e3
    idx_r = i32(rng.integers(0, T, L2_ROWS))
    rows_s = {}
    for name in ("xor_rows", "xor_rows_ring"):
        kern = getattr(g, name)
        same(name, kern(idx_r, rowsL), g.xor_rows_plain(idx_r, rowsL))
        rows_s[name] = L2_ROWS / cuda_ms(lambda: kern(idx_r, rowsL), 20) * 1e3
    del idx_w, idx_r
    log(f"[lab l2] L1 gather_u32, {L2_WORDS} random 4-byte reads of the {4 * M >> 10} KB table: "
        f"{words_s / 1e9:.3f} G words/s; {L2_ROWS} random 512-byte rows of the "
        f"{row_b * T >> 20} MB table: " + ", ".join(
            f"{name} {r / 1e6:.1f} M rows/s = {row_b * r / 1e12:.3f} TB/s"
            for name, r in rows_s.items()) + f" ({smi})")
    large_batch = {"gather_u32": N / words_s * 1e3,
                   **{name: NR / r * 1e3 for name, r in rows_s.items()}}
    # the L2 floor: the bytes each kernel moves through the L2 (a 32-byte
    # sector per random 4-byte read, 512 bytes per row, the index and
    # output streams) at the L2 read rate of l2_stream; torch's reductions
    # are printed beside it as a cross-check
    l2_rate = l2_stream_rate(dev, smi)
    torch_l2_rate(dev, smi)
    l2_bytes = {"gather_u32": N * (32 + 4 + 4), "xor_rows": NR * (row_b + 4) + row_b,
                "xor_rows_ring": NR * (row_b + 4) + row_b}
    l2_floor = {name: b / l2_rate * 1e3 for name, b in l2_bytes.items()}
    # L1's sector floor: its N random reads at the L2's random-sector rate,
    # its index and output streams at the L2 read rate
    sector_floor = (N / l2_sectors_rate(dev, smi) + 8 * N / l2_rate) * 1e3
    # L1 in turns with its frozen first design on the same inputs
    turns = [(name, cuda_ms(lambda: getattr(g, name)(tblL, idxL), 50))
             for name in ("sector_reads", "gather_u32", "gather_u32", "sector_reads")]
    l1_ms, before_ms = (statistics.mean(t for name, t in turns if name == k)
                        for k in ("gather_u32", "sector_reads"))
    log("[lab] L1 in turns with its frozen first design: "
        + ", ".join(f"{name} {t:.4f}" for name, t in turns)
        + f" ms; {l1_ms:.4f} against {before_ms:.4f} ms ({before_ms / l1_ms:.3f}x) ({smi})")
    out = []
    for name, replaces in LAB:
        kern, plain, library, bnd = spec[name]
        ms = l1_ms if name == "gather_u32" else cuda_ms(kern, 50)
        plain_ms = cuda_ms(plain, 10)
        lib_ms = cuda_ms(library, 50) if library else None
        if name in ("gather_u32", "hash_mix32x8"):
            rate = f"{N / ms / 1e6:.3f} G words/s"
        else:
            rate = f"{NR / ms / 1e3:.1f} M rows/s, {NR * row_b / ms / 1e6:.1f} GB/s of 512B rows"
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        extra = ({"large_batch_ms": large_batch[name], "l2_floor_ms": l2_floor[name]}
                 if name in large_batch else {})
        l2_txt = (f", at its large-batch L2 rate {large_batch[name]:.4f} ms, L2 floor "
                  f"{l2_floor[name]:.4f} ms ({l2_floor[name] / ms:.1%} of the kernel's time: "
                  f"{'under' if l2_floor[name] / ms < 0.5 else 'at or over'} half)" if extra else "")
        if name == "gather_u32":
            extra.update(sector_floor_ms=sector_floor, before_ms=before_ms)
            l2_txt += (f", sector floor {sector_floor:.4f} ms ({sector_floor / ms:.1%}), first "
                       f"design in turns {before_ms:.4f} ms")
        log(f"[lab] {name}: kernel {ms:.4f} ms ({rate}), plain {plain_ms:.4f} ms, torch call "
            f"{lib_txt}, bound {bnd[0]:.4f} ms ({bnd[1]}){l2_txt} ({smi})")
        out.append(record(name, "gather_lab.cu", replaces, launches[name], err[name], ms, plain_ms,
                          bnd, lib_ms, **extra))
        if name in rows_s:
            rows_s[f"{name} at N={NR}"] = NR / ms * 1e3
    fastest = max(rows_s, key=rows_s.get)
    top = row_b * rows_s[fastest]
    log(f"[lab l2 floor] the L2 read rate {l2_rate / 1e12:.3f} TB/s is "
        f"{'at or over' if l2_rate >= top else 'UNDER'} the fastest L3/L4 rate of this run, "
        f"{fastest}'s {top / 1e12:.3f} TB/s of rows"
        + ("" if l2_rate >= top else ": the reader is not the ceiling") + f" ({smi})")
    return out, dram_rates(dev, smi, same)


def gather_cases(tbl: torch.Tensor, m: int, n_lab: int, rng, same):
    """L1 against its plain version, bit for bit, on what its launch and
    its one thread a word could get wrong: an index view 4 bytes off 16-byte
    alignment, all-0 and all-(M-1) indices each called twice, ragged tables
    (37, 2^18 - 1, 2^18 + 1 words) and a table and indices written by the
    kernels launched just before each call (the launch may begin before
    they end, and must not read before they do)."""
    g = gather_lab

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32)).to(tbl.device)

    def check(t, ii, calls=1):
        for _ in range(calls):
            same("gather_u32", g.gather_u32(t, ii), g.gather_u32_plain(t, ii))

    ii = i32(rng.integers(0, m, n_lab + 1))
    check(tbl, ii[1:])
    for fill in (0, m - 1):
        check(tbl, torch.full_like(ii[:n_lab], fill), calls=2)
    for words in (37, m - 1, m + 1):
        t = i32(rng.integers(-(1 << 31), 1 << 31, words))
        check(t, i32(rng.integers(0, words, n_lab + 37)))
        check(t, torch.full_like(ii[:n_lab], words - 1), calls=2)
    gen = torch.Generator(device=tbl.device)
    gen.manual_seed(17)
    for k in range(8):
        t = tbl * (k + 3)
        check(t, torch.randint(0, m, (n_lab + k,), dtype=torch.int32, device=tbl.device,
                               generator=gen))
    torch.cuda.synchronize()
    log(f"[lab] L1 on idx[1:], all-0 and all-{m - 1} indices (twice each), tables of 37, "
        f"{m - 1} and {m + 1} words, and inputs written just before each of 8 calls: "
        f"bit-identical")


def xor_cases(rows: torch.Tensor, t: int, n_lab: int, rng, same):
    """L3 and L4 against their plain version, bit for bit, on batches made
    to break a grid of contiguous 32-index runs and a ticket fold: ragged
    sizes around a group (2, 31, 32, 33) and the lab's size - 1, fewer rows
    than the grid has warps and 3 x its warps + 5, indices only 0 or only
    T - 1, and pairs that cancel to zero; each called twice in a row, so a
    ticket left non-zero by the first call shows in the second."""
    g = gather_lab

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(rows.device)

    cases = {f"N={n}": i32(rng.integers(0, t, n)) for n in (2, 31, 32, 33, n_lab - 1)}
    for name in ("xor_rows", "xor_rows_ring"):
        warps = g.wave_blocks(name, rows.device) * g.FOLD_WARPS
        for n in (warps - 3, 3 * warps + 5):
            cases[f"N={n} ({name}: {warps} warps)"] = i32(rng.integers(0, t, n))
    cases["only row 0"] = i32(np.zeros(n_lab))
    cases[f"only row {t - 1}"] = i32(np.full(n_lab, t - 1))
    half = rng.integers(0, t, n_lab // 2)
    cases["pairs that cancel"] = i32(np.concatenate([half, half[::-1]]))
    if bool(g.xor_rows_plain(cases["pairs that cancel"], rows).any()):
        raise AssertionError("[lab] the cancelling batch does not fold to zero")
    for ii in cases.values():
        want = g.xor_rows_plain(ii, rows)
        for name in ("xor_rows", "xor_rows_ring"):
            kern = getattr(g, name)
            first, second = kern(ii, rows), kern(ii, rows)
            same(name, first, want)
            same(name, second, want)
    torch.cuda.synchronize()
    log(f"[lab] L3 and L4 on {'; '.join(cases)}, each called twice in a row: bit-identical")


L2_WORDS, L2_ROWS = 1 << 24, 1 << 21  # random reads of the labs' tables for their L2 rates
L2_READ = 512 << 20  # bytes a timed torch reduction reads from its L2-resident table
L2_STREAM = ((8, 257), (32, 65))  # l2_stream's tables (MB) and passes: ~2 GB a launch
DRAM_WORDS, DRAM_IDX = 1 << 28, 1 << 22  # L1: 2^22 random words of a 1 GB table
DRAM_ROWS, DRAM_NR = 1 << 21, 1 << 18  # L5: 2^18 random rows of a 1 GB table of 512-byte rows


def l2_stream_rate(dev, smi) -> float:
    """The card's L2 read rate (bytes/s) that the L2 floors use:
    ``gather_lab.l2_stream`` over an 8 MB table (the labs' size) and a 32
    MB one, each read R times in one launch (R odd: the blocks' rows fold
    to the table's XOR, checked), in order and in a fresh random order each
    pass. Its 16-byte ``ld.global.cg`` loads are cached in L2 only and no
    warp repeats another's read, so no SM's L1 serves any of it. Returns
    the fastest of the four."""
    g = gather_lab
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    best = 0.0
    for mb, reps in L2_STREAM:
        tbl = torch.randint(-(1 << 31), 1 << 31, ((mb << 20) // (4 * g.ROW), g.ROW),
                            dtype=torch.int32, device=dev, generator=gen)
        want = g.l2_stream_plain(tbl, reps)
        for random in (False, True):
            if not torch.equal(g.xor_fold(g.l2_stream(tbl, reps, random)), want):
                raise AssertionError(f"[lab l2 floor] l2_stream over {mb} MB (random={random}): "
                                     f"its rows do not fold to the table's XOR")
            ms = cuda_ms(lambda: g.l2_stream(tbl, reps, random), 10)
            rate = reps * (mb << 20) / ms * 1e3
            best = max(best, rate)
            log(f"[lab l2 floor] l2_stream: a {mb} MB table read {reps} times in one launch, "
                f"{'a fresh random order' if random else 'in order'} each pass: {ms:.4f} ms = "
                f"{rate / 1e12:.3f} TB/s ({smi})")
        del tbl
    log(f"[lab l2 floor] the card's L2 read rate: {best / 1e12:.3f} TB/s (l2_stream, the fastest "
        f"of the four)")
    return best


L2_SECTORS = ((18, 257), (21, 33))  # l2_sectors' tables (2^k words: 1, 8 MB), passes: ~2^26 reads


def l2_sectors_rate(dev, smi) -> float:
    """The L2's random-sector rate (reads/s) that L1's sector floor uses:
    ``gather_lab.l2_sectors`` over a 1 MB table (the lab's) and an 8 MB
    one, each word read R times in one launch (R odd: the blocks' words
    fold to the table's XOR, checked), a fresh random order each pass. Its
    4-byte ``ld.global.cg`` loads each cost one 32-byte L2 sector and no
    L1 serves a repeat. Returns the faster of the two."""
    g = gather_lab
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    best = 0.0
    for bits, reps in L2_SECTORS:
        tbl = torch.randint(-(1 << 31), 1 << 31, (1 << bits,), dtype=torch.int32, device=dev,
                            generator=gen)
        got = g.xor_fold(g.l2_sectors(tbl, reps).reshape(-1, 1)).reshape(1)
        if not torch.equal(got, g.l2_sectors_plain(tbl, reps)):
            raise AssertionError(f"[lab l2 sectors] l2_sectors over 2^{bits} words: its words do "
                                 f"not fold to the table's XOR")
        ms = cuda_ms(lambda: g.l2_sectors(tbl, reps), 10)
        rate = (reps << bits) / ms * 1e3
        best = max(best, rate)
        log(f"[lab l2 sectors] l2_sectors: a {4 << bits >> 20} MB table's words read {reps} times "
            f"in one launch, a fresh random order each pass: {ms:.4f} ms = {rate / 1e9:.2f} G "
            f"sectors/s = {32 * rate / 1e12:.3f} TB/s of 32-byte sectors ({smi})")
        del tbl
    log(f"[lab l2 sectors] the L2's random-sector rate: {best / 1e9:.2f} G sectors/s (the faster "
        f"of the two)")
    return best


def torch_l2_rate(dev, smi) -> float:
    """A cross-check of ``l2_stream_rate``, no floor: torch's reductions
    over an 8 MB and a 1 MB table, each seen through a stride-0 view that
    repeats it to 512 MB (``t.expand(R, n)``), so that one call reads the
    same table R times; int32, float32 and float64 tables, summed whole
    and row by row. Every row of such a view reads the same addresses, so
    an SM's L1 may serve part of it. Returns the fastest."""
    best = 0.0
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    for mb in (8, 1):
        base = torch.randint(0, 1 << 20, ((mb << 20) // 8,), dtype=torch.int32, device=dev,
                             generator=gen)
        for table in (torch.cat([base, base]), torch.cat([base, base]).to(torch.float32),
                      base.to(torch.float64)):
            n = table.shape[0]
            reps = L2_READ // (table.element_size() * n)
            view = table.expand(reps, n)
            if table.dtype == torch.int32 and int(view.sum()) != reps * int(table.sum()):
                raise AssertionError("the repeated sum differs from reps x the sum")
            for how, fn in (("whole", view.sum), ("row by row", lambda: view.sum(dim=1))):
                ms = cuda_ms(fn, 20)
                rate = L2_READ / ms * 1e3
                best = max(best, rate)
                log(f"[lab l2 floor] {table.dtype} .sum() {how} of a {mb} MB table read "
                    f"{reps} times through a stride-0 view: {ms:.4f} ms = {rate / 1e12:.3f} TB/s "
                    f"({smi})")
    log(f"[lab l2 floor] torch's reductions: {best / 1e12:.3f} TB/s at best (a cross-check, not "
        f"the floor: L1 may serve part of a stride-0 view)")
    return best


def dram_rates(dev, smi, same) -> float:
    """The card's random-read rates from device memory (phase 3): the
    frozen first design of L1 (``sector_reads``) over a 1 GB table of u32 (each
    4-byte read costs one 32-byte sector), L1 itself on the same as a
    cross-check, and L5 over a 1 GB table of 512-byte rows, all far past
    the 50 MB L2 and bit-identical to their plain versions. Returns
    ``sector_reads``' random-sector rate (sectors/s), which the K2 and K3
    sector floors use."""
    g = gather_lab
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def rand(hi, shape):
        return torch.randint(0, hi, shape, dtype=torch.int32, device=dev, generator=gen)

    tbl, idx = rand(1 << 30, (DRAM_WORDS,)), rand(DRAM_WORDS, (DRAM_IDX,))
    want = g.gather_u32_plain(tbl, idx)
    same("sector_reads", g.sector_reads(tbl, idx), want)
    same("gather_u32", g.gather_u32(tbl, idx), want)
    ms = cuda_ms(lambda: g.sector_reads(tbl, idx), 20)
    sec_s = DRAM_IDX / ms * 1e3
    log(f"[lab dram] sector_reads (L1's first design), {DRAM_IDX} random 4-byte reads of a "
        f"{4 * DRAM_WORDS >> 20} MB table: {ms:.4f} ms = {sec_s / 1e9:.3f} G sectors/s = "
        f"{32 * sec_s / 1e9:.1f} GB/s of 32-byte sectors ({4 * sec_s / 1e9:.1f} GB/s of words) "
        f"({smi})")
    ms = cuda_ms(lambda: g.gather_u32(tbl, idx), 20)
    log(f"[lab dram] L1 gather_u32 on the same (a cross-check, not the floors' rate): {ms:.4f} ms "
        f"= {DRAM_IDX / ms / 1e6:.3f} G sectors/s ({smi})")
    del tbl, idx, want
    rows, idx = rand(1 << 30, (DRAM_ROWS, g.ROW)), rand(DRAM_ROWS, (DRAM_NR,))
    same("gather_rows", g.gather_rows(idx, rows), g.gather_rows_plain(idx, rows))
    ms = cuda_ms(lambda: g.gather_rows(idx, rows), 20)
    row_s = DRAM_NR / ms * 1e3
    log(f"[lab dram] L5 gather_rows, {DRAM_NR} random 512-byte rows of a "
        f"{4 * g.ROW * DRAM_ROWS >> 20} MB table: {ms:.4f} ms = {row_s / 1e6:.1f} M rows/s = "
        f"{16 * row_s / 1e9:.3f} G sectors/s = {512 * row_s / 1e9:.1f} GB/s read ({smi})")
    del rows, idx
    torch.cuda.empty_cache()
    return sec_s


def pf1_path(kind: str, genome, n_bases: int, truth, dev, smi):
    """Phases 7 (dense) and 8 (sparse); returns a function that runs one
    profiled pass of the path."""
    tag = f"pf1 {kind}"
    build = synth.build_pf1_dense_index if kind == "dense" else synth.build_pf1_sparse_index
    t0 = time.perf_counter()
    index = build(n_bases, seed=0, device=dev, genome=genome)
    t_build = time.perf_counter() - t0
    host = index.device_arrays()
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    del host
    mp = index.k2u.mphf
    d, cpu = gpu_index.arrays(), cpu_index.arrays()
    k2u = d["k2u"]
    log(f"[{tag}] {index.k2u.n_kmers} k-mers; MPHF levels {len(mp.levels)} "
        f"{[n for n, _, _ in mp.levels]}, {len(mp.fh_keys)} final-hash keys; host build "
        f"{t_build:.1f} s (MPHF lookup on the card); {gpu_index.nbytes()} bytes on the card "
        f"(MPHF {tree_bytes(k2u['mphf'])}, unitig set {tree_bytes(k2u['us'])}, other K2U "
        f"{tree_bytes(k2u) - tree_bytes(k2u['mphf']) - tree_bytes(k2u['us'])}, occurrences "
        f"{tree_bytes(d['u2pos'])})")
    work, uid, off, foreign = truth
    work_cpu = torch.from_numpy(work.view(np.int64))
    fw = work_cpu.to(dev)
    if kind == "dense":
        keys = umin(work_cpu, revcomp(work_cpu, index.k))
        keys_d = keys.to(dev)
        want = boophf_lookup(cpu["k2u"]["mphf"], keys)
        if not torch.equal(boophf_lookup(k2u["mphf"], keys_d).cpu(), want):
            raise AssertionError("64-bit boophf_lookup differs between the card and the CPU")
        ms = cuda_ms(lambda: boophf_lookup(k2u["mphf"], keys_d), 5)
        log(f"[{tag}] 64-bit boophf_lookup of {BATCH} canonical words: the card equals the CPU "
            f"({int((want >= 0).sum())} values >= 0); {ms:.3f} ms on the card ({smi})")
    t0 = time.perf_counter()
    out0 = get_ref_pos_padded(cpu, work_cpu, cpu_index.max_occs)
    host_chk = int(padded_checksum(out0))
    hit = out0["mt"].numpy() > 0
    if not hit[~foreign].all() or hit[foreign].any():
        raise AssertionError(f"[{tag}] CPU oracle: {int((~hit[~foreign]).sum())} sampled lanes "
                             f"missed, {int(hit[foreign].sum())} foreign lanes hit")
    if not (np.array_equal(out0["unitig_id"].numpy()[~foreign], uid[~foreign])
            and np.array_equal(out0["pos"].numpy()[~foreign], off[~foreign])):
        raise AssertionError(f"[{tag}] CPU oracle disagrees with the sampled unitigs and offsets")
    log(f"[{tag}] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}; "
        f"{int((~foreign).sum())} sampled lanes hit at their unitig and offset, "
        f"{int(foreign.sum())} foreign lanes missed")
    del cpu_index, cpu, out0
    _, _, times = graph_and_eager(
        tag, gpu_index, lambda x: checksum_padded_rolled(gpu_index, x, CH),
        lambda x: checksum_padded_rolled(gpu_index, x, CH, graph=False), fw, CH * host_chk,
        BATCH * CH, 3, None, smi)
    return lambda: profile_both(
        tag, lambda: checksum_padded_rolled(gpu_index, fw, CH),
        lambda: checksum_padded_rolled(gpu_index, fw, CH, graph=False), times)


def read_kmers(refs, n_reads: int, k: int, seed: int) -> np.ndarray:
    """Every k-mer of ``n_reads`` reads of ``READ_LEN`` bases, in read order:
    their starts uniform over the whole concatenated genome (``bench.py``
    draws them over its first 8 references; here those would be 80 kb,
    whose rows the L2 would hold)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, int(refs.prefix_sum[-1]) - synth.READ_LEN + 1, n_reads)
    codes = refs.seq.get_base(starts[:, None] + np.arange(synth.READ_LEN)).reshape(-1)
    per = synth.READ_LEN - k + 1
    kpos = (np.arange(per)[None, :] + (np.arange(n_reads) * synth.READ_LEN)[:, None]).reshape(-1)
    return SeqVector.from_codes(codes.astype(np.uint8)).get_kmer_u64(kpos, k)


def reads1graph_stack(refs, k: int) -> torch.Tensor:
    """``bench.py``'s reads1graph input: ``SPEED_CH`` distinct chunks of
    ``READ_BATCH`` read k-mers (``read_kmers``, seed 1) as an int64
    [SPEED_CH, READ_BATCH] stack on the CPU."""
    n = SPEED_CH * READ_BATCH
    words = read_kmers(refs, -(-n // (synth.READ_LEN - k + 1)), k, seed=1)[:n]
    return torch.from_numpy(words.view(np.int64)).reshape(SPEED_CH, READ_BATCH)


def reads1graph_oracle(tag: str, cpu_index, stack: torch.Tensor, **kw) -> tuple[int, int]:
    """(pass checksum, M2) of a reads1graph stack: the sum of each chunk's
    checksum by the port's plain path on CPU tensors, M2 sized from the
    worst chunk's overflow as ``bench.py:991-1000`` sizes it from chunk 0's."""
    t0 = time.perf_counter()
    total, worst, chunk0 = 0, 0, None
    for i, chunk in enumerate(stack):
        out = get_ref_pos_compact(cpu_index.arrays(), chunk, cpu_index.max_occs, merge=False,
                                  m2=max(8192, READ_BATCH // 4), **kw)
        if bool(out["over_budget"]):
            raise AssertionError(f"[{tag}] CPU oracle over budget on chunk {i}")
        n_hit = int((merge_compact_k2u(out)["mt"] > 0).sum())
        if n_hit < READ_BATCH * 0.9:
            raise AssertionError(f"[{tag}] only {n_hit} of {READ_BATCH} read k-mers of chunk "
                                 f"{i} hit")
        chk = int(OneGraphIndexQuery.checksum(out))
        total += chk
        worst = max(worst, int(out["n_ovf"]))
        chunk0 = chunk0 or (chk, n_hit, int(out["n_ovf"]))
    M2 = max(2048, -(-int(worst * 1.4 + 1024) // 1024) * 1024)
    log(f"[{tag}] {READ_BATCH} read k-mers a chunk, {SPEED_CH} distinct chunks; CPU oracle "
        f"{time.perf_counter() - t0:.1f} s: pass checksum {total}; chunk 0 checksum "
        f"{chunk0[0]}, {chunk0[1]} hits, overflow {chunk0[2]} = {chunk0[2] / READ_BATCH:.4f}; "
        f"worst overflow {worst} -> M2={M2}")
    return total, M2


def mono2_reads(index, host: dict, gpu_index, smi) -> int:
    """Phase 6e: the reads1graph pass of phase 8b (the same read k-mers) on
    the mono2 index, so SSHash's read rate stands beside mono2's on the same
    traffic. Returns K1's launches in the first replayed pass."""
    stack_cpu = reads1graph_stack(index.refs, index.k)
    stack = stack_cpu.to(next(gpu_index.buffers()).device)
    want, M2 = reads1graph_oracle("mono2 reads1graph",
                                  QueryIndex(arrays_from_numpy(host, "cpu")), stack_cpu)
    og = OneGraphIndexQuery(gpu_index, READ_BATCH, n_chunks=SPEED_CH, m2=M2)
    og_e = OneGraphIndexQuery(gpu_index, READ_BATCH, n_chunks=SPEED_CH, m2=M2, graph=False)
    launches, _, _ = graph_and_eager(
        "mono2 reads1graph", gpu_index, og.checksum_pass, og_e.checksum_pass, stack, want,
        READ_BATCH * SPEED_CH, 3, mono2_probe, smi)
    del og, og_e
    return launches


def speed(genome, n_bases: int, truth, dev, smi):
    """Phases 8a-8e: the SSHash speed tier over phase 4's genome. Returns a
    function that runs the profiled passes of 8b and 8d."""
    mark("8a")
    # 8a. the speed index, in its two fused layouts
    t0 = time.perf_counter()
    index = synth.build_speed_index(n_bases, seed=0, device=dev, chunk=1 << 22, genome=genome)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host2 = index.device_arrays(**synth.SPEED_LAYOUT)
    t_arr2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    host1 = index.device_arrays(fused=True)
    t_arr1 = time.perf_counter() - t0
    cpu2, cpu1 = (QueryIndex(arrays_from_numpy(h, "cpu")) for h in (host2, host1))
    gpu2, gpu1 = (QueryIndex(arrays_from_numpy(h, "cpu")).to(dev) for h in (host2, host1))
    torch.cuda.synchronize()
    del host2, host1
    k = index.k
    ss, us = index.k2u, index.k2u.unitigs
    k2u = gpu2.arrays()["k2u"]
    m = k2u["meta"]
    log(f"[speed index] {us.total_len} bases, {us.n_kmers} k-mers; direct engine w={ss.w}, skew "
        f"{ss.skew_param}, load {synth.SPEED_LOAD}: T={m.direct_t} buckets, {len(ss.pos)} "
        f"minimizer occurrences (rows), probe_bound={m.probe_bound}, max bucket "
        f"{ss.max_bucket()}, {ss.n_kmers_in_skew_index} skew k-mers "
        f"({getattr(m, 'skew_kind', 'no skew table')}); "
        f"max_occs={gpu2.max_occs}")
    log(f"[speed index] host build {t_build:.1f} s (minimizer scan on the card); inline2 fused "
        f"arrays {t_arr2:.1f} s: {gpu2.nbytes()} bytes on the card (rows "
        f"{k2u['pos']['inline'].numel() * 4}, flat2 {k2u['prefix']['flat2'].numel() * 4}, skew "
        f"rows {tree_bytes({'s': k2u.get('skew_inline')})}, unitig set {tree_bytes(k2u['us'])}, "
        f"occurrences {tree_bytes(gpu2.arrays()['u2pos'])}, references "
        f"{tree_bytes(gpu2.arrays()['refs'])}); inline fused arrays {t_arr1:.1f} s: "
        f"{gpu1.nbytes()} bytes ({smi})")
    if gpu2.nbytes() != speed_bytes(index):
        raise AssertionError(f"speed_bytes {speed_bytes(index)} != the layout's {gpu2.nbytes()}")

    mark("8b")
    # 8b. bench.py's reads1graph pass: the k-mers of reads of READ_LEN bases
    stack_cpu = reads1graph_stack(index.refs, k)
    fw_r = stack_cpu.to(dev)
    want_r, M2 = reads1graph_oracle("reads1graph", cpu2, stack_cpu, probe_limit=PLIM)
    og_r = OneGraphIndexQuery(gpu2, READ_BATCH, n_chunks=SPEED_CH, m2=M2, probe_limit=PLIM)
    og_re = OneGraphIndexQuery(gpu2, READ_BATCH, n_chunks=SPEED_CH, m2=M2, probe_limit=PLIM,
                               graph=False)
    _, worst, times_r = graph_and_eager(
        "reads1graph", gpu2, og_r.checksum_pass, og_re.checksum_pass, fw_r, want_r,
        READ_BATCH * SPEED_CH, 3, None, smi)
    log(f"[reads1graph] worst overflow {worst} within M2; the rates above are read k-mers/s")

    mark("8c")
    # 8c. bench.py's reads path (BASELINE config 3)
    reads_phase(index, cpu1, gpu1, dev, smi)

    mark("8d")
    # 8d. uniform queries: phase 5's batch through the speed layout
    t0 = time.perf_counter()
    work, uid, off, foreign = truth
    work_cpu = torch.from_numpy(work.view(np.int64))
    fw_u = work_cpu.to(dev)
    out0 = get_ref_pos_compact(cpu2.arrays(), work_cpu, cpu2.max_occs, merge=False,
                               probe_limit=PLIM, m2=BATCH // 4)
    if bool(out0["over_budget"]):
        raise AssertionError("[speed uniform] CPU oracle over budget")
    host_chk_u = int(OneGraphIndexQuery.checksum(out0))
    merged = merge_compact_k2u(out0)
    hit = merged["mt"].numpy() > 0
    if not (hit[~foreign].all() and not hit[foreign].any()
            and np.array_equal(merged["unitig_id"].numpy()[~foreign], uid[~foreign])
            and np.array_equal(merged["pos"].numpy()[~foreign], off[~foreign])):
        raise AssertionError("[speed uniform] CPU oracle disagrees with the sampled lanes")
    n_ovf = int(out0["n_ovf"])
    M2u = max(1024, -(-(n_ovf + 128) // 256) * 256)
    log(f"[speed uniform] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum "
        f"{host_chk_u}; every sampled lane at its unitig and offset, no foreign lane hit; "
        f"overflow {n_ovf}/{BATCH} = {n_ovf / BATCH:.4f} -> M2={M2u}")
    del out0, merged
    og_u = OneGraphIndexQuery(gpu2, BATCH, n_chunks=CH, m2=M2u, probe_limit=PLIM)
    og_ue = OneGraphIndexQuery(gpu2, BATCH, n_chunks=CH, m2=M2u, probe_limit=PLIM, graph=False)
    _, worst, times_u = graph_and_eager(
        "speed uniform", gpu2, og_u.checksum_pass_rolled, og_ue.checksum_pass_rolled, fw_u,
        CH * host_chk_u, BATCH * CH, PASSES, None, smi)

    mark("8e")
    # 8e. the read mapper, in the speed tier by the rule, then in the
    # capacity tier asked for (its K2 launches not counted: a comparison)
    qc = QueryIndex(arrays_from_numpy(index.device_arrays(**synth.CAPACITY_LAYOUT), "cpu")).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        mapping_phase("map speed", index, gpu1, cpu1, None, smi, tmp, driver="TwoPhaseIndexQuery",
                      rival=dict(qi=qc, driver="CompactQuery", tier="capacity", probe=bpos_probe))
    del cpu1, cpu2, qc

    mark("21")
    # 21. the rest of the SSHash layouts and the wavelet-matrix table
    profile_layouts = layouts(index, truth, fw_u, times_u, dev, smi)
    mark("23b")
    # 23b. the fused sharded query and a sharded checkpoint of these rows
    speed_shards(index, fw_u, dev, smi)

    def profile():
        profile_both("reads1graph", lambda: og_r.checksum_pass(fw_r),
                     lambda: og_re.checksum_pass(fw_r), times_r)
        profile_both("speed uniform", lambda: og_u.checksum_pass_rolled(fw_u),
                     lambda: og_ue.checksum_pass_rolled(fw_u), times_u)
        profile_layouts()
    return profile


# the layouts of phase 21b: (tag, SSHash layout), the speed tier's default
# first, whose time the others stand beside
OTHER_LAYOUTS = (("inline, flat32 bounds", {}), ("records", dict(pos_kind="records")),
                 ("flat32 positions", dict(pos_kind="flat32")),
                 ("packed, grouped32", dict(pos_kind="packed", prefix_kind="grouped32")),
                 ("packed, flat", dict(pos_kind="packed", prefix_kind="flat")),
                 ("packed, flat32", dict(pos_kind="packed", prefix_kind="flat32")))
TWOPHASE_ITERS = 10  # bench.py's 2phase mode (MAZU_BENCH_ITERS)
SHARDS = 4
WM_N = 1 << 20


def same_out(tag: str, got: dict, want: dict) -> None:
    """Every field of two query results equal on every lane (padded
    occurrence columns where valid)."""
    if set(got) != set(want):
        raise AssertionError(f"[{tag}] keys {sorted(set(got) ^ set(want))}")
    valid = want.get("valid")
    for key, w in want.items():
        g, w = got[key].cpu(), w.cpu()
        if g.dim() == 2 and valid is not None and key != "valid":
            g, w = torch.where(valid.cpu(), g, 0), torch.where(valid.cpu(), w, 0)
        if not torch.equal(g, w):
            raise AssertionError(f"[{tag}] {key} differs")


def fixedcap_rows(index, kind: str, dev, smi):
    """Phase 21a's arrays: the fused ``kind`` rows on the host (their
    seconds and the host's peak memory) and on the card. Returns (the host
    arrays, the card's ``QueryIndex``)."""
    with RssPeak() as rss:
        t0 = time.perf_counter()
        host = index.device_arrays(fused=True, pos_kind=kind)
        t_rows = time.perf_counter() - t0
        t0 = time.perf_counter()
        gpu_qi = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
    m, rows = host["k2u"]["meta"], host["k2u"]["pos"]["inline"]
    n_full = int((rows[:, 1] < 0xFFFFFFFE).sum())
    log(f"[{kind}] synth50-fixedcap: T={m.direct_t} buckets x B={m.cap} = {rows.shape[0]} rows "
        f"of {rows.shape[1]} u32, {n_full} holding an occurrence; rows and fusion pass "
        f"{t_rows:.1f} s on the host (peak RSS {rss.peak:.2f} GB), to the card {t_up:.1f} s; "
        f"{gpu_qi.nbytes()} bytes on the card (rows {rows.nbytes}) ({smi})")
    return host, gpu_qi


def layouts(index, truth, fw_u, times_u: dict, dev, smi):
    """Phase 21 on the speed index of phase 8a: the rest of the SSHash's
    layouts, ``TwoPhaseSSHash``, ``bucket_range`` and the wavelet-matrix
    occurrence table, each against its CPU oracle. Returns the function
    that runs the profiled passes of 21a's fixedcap2 path (phase 18), its
    rows built again."""
    t_phase = time.perf_counter()
    work, uid, off, foreign = truth
    work_cpu = torch.from_numpy(work.view(np.int64))
    mo = index.max_occs()
    inline_rate = BATCH * CH / times_u["graph"]
    found = {}

    mark("21a")
    # 21a. fused fixedcap2 and fixedcap rows through OneGraphIndexQuery
    for kind in ("fixedcap2", "fixedcap"):
        host, gpu_qi = fixedcap_rows(index, kind, dev, smi)
        cpu_qi = QueryIndex(arrays_from_numpy(host, "cpu"))
        t0 = time.perf_counter()
        out0 = get_ref_pos_compact(cpu_qi.arrays(), work_cpu, mo, merge=False, probe_limit=PLIM,
                                   m2=BATCH // 2)
        if bool(out0["over_budget"]):
            raise AssertionError(f"[{kind}] CPU oracle over budget")
        merged = merge_compact_k2u(out0)
        hit = merged["mt"].numpy() > 0
        if not (hit[~foreign].all() and not hit[foreign].any()
                and np.array_equal(merged["unitig_id"].numpy()[~foreign], uid[~foreign])
                and np.array_equal(merged["pos"].numpy()[~foreign], off[~foreign])):
            raise AssertionError(f"[{kind}] CPU oracle disagrees with the sampled lanes")
        host_chk, n_ovf = int(OneGraphIndexQuery.checksum(out0)), int(out0["n_ovf"])
        M2 = fit(n_ovf * 1.1)
        log(f"[{kind}] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}; "
            f"every sampled lane at its unitig and offset, no foreign lane hit; overflow "
            f"{n_ovf}/{BATCH} = {n_ovf / BATCH:.4f} -> M2={M2} ({smi})")
        del out0, merged
        og = OneGraphIndexQuery(gpu_qi, BATCH, n_chunks=CH, m2=M2, probe_limit=PLIM)
        og_e = OneGraphIndexQuery(gpu_qi, BATCH, n_chunks=CH, m2=M2, probe_limit=PLIM,
                                  graph=False)
        _, worst, times = graph_and_eager(f"{kind} 1graph", gpu_qi, og.checksum_pass_rolled,
                                          og_e.checksum_pass_rolled, fw_u, CH * host_chk,
                                          BATCH * CH, 3, None, smi)
        found[kind] = (M2, CH * host_chk, times)
        log(f"[{kind} 1graph] worst overflow {worst} within M2; replayed "
            f"{BATCH * CH / times['graph']:.1f} queries/s beside phase 8d's inline2 rows' "
            f"{inline_rate:.1f} ({smi})")
        del og, og_e
        if kind == "fixedcap":
            mark("21d")
            # 21d. run sharing on the fixedcap rows
            fixedcap_reads(index, cpu_qi, gpu_qi, dev, smi)
        del host, cpu_qi, gpu_qi
        torch.cuda.empty_cache()

    mark("21b")
    # 21b. the other layouts through the padded query
    for tag, kw in OTHER_LAYOUTS:
        host = index.device_arrays(**kw)
        cpu_qi = QueryIndex(arrays_from_numpy(host, "cpu"))
        gpu_qi = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
        del host
        t0 = time.perf_counter()
        want = get_ref_pos_padded(cpu_qi.arrays(), work_cpu[:LAYOUT_ORACLE], mo)
        cpu_s = time.perf_counter() - t0
        got = get_ref_pos_padded(gpu_qi.arrays(), fw_u, mo)
        same_out(tag, {kk: v[:LAYOUT_ORACLE] for kk, v in got.items()}, want)
        ms = cuda_ms(lambda: get_ref_pos_padded(gpu_qi.arrays(), fw_u, mo), 3)
        m = gpu_qi.arrays()["k2u"]["meta"]
        log(f"[layout {tag}] pos_kind {m.pos_kind}, prefix_kind {m.prefix_kind}: "
            f"get_ref_pos_padded on {BATCH} queries, the first {LAYOUT_ORACLE} == CPU on every "
            f"lane ({cpu_s:.1f} s); "
            f"{ms:.2f} ms on the card = {BATCH / ms * 1e3:.1f} queries/s; {gpu_qi.nbytes()} "
            f"bytes on the card ({smi})")
        del cpu_qi, gpu_qi, want, got
        torch.cuda.empty_cache()

    mark("21c")
    # 21c. TwoPhaseSSHash, bench.py's 2phase mode
    tp = TwoPhaseSSHash(index.k2u, device=dev)
    got = tp.k2u(work)
    full = sshash_k2u(tp.d, fw_u)
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        if not np.array_equal(got[key], full[key].cpu().numpy()):
            raise AssertionError(f"[2phase] {key} differs from one full-mode call")
    t0 = time.perf_counter()
    want = TwoPhaseSSHash(index.k2u, device="cpu").k2u(work)
    cpu_s = time.perf_counter() - t0
    if set(got) != set(want) or not all(np.array_equal(got[key], want[key]) for key in want):
        raise AssertionError("[2phase] the card differs from the CPU")
    n_skew = int(tp.main(fw_u)["use_skew"].sum())
    t0 = time.perf_counter()
    for _ in range(TWOPHASE_ITERS):
        tp.k2u(work)
    dt = time.perf_counter() - t0
    log(f"[2phase] TwoPhaseSSHash (inline rows, flat32 bounds) on {BATCH} queries: equal to one "
        f"full-mode call on the card and to the CPU ({cpu_s:.1f} s) on every lane; {n_skew} "
        f"skew lanes re-run in full mode; {TWOPHASE_ITERS} iterations in {dt:.3f} s = "
        f"{BATCH * TWOPHASE_ITERS / dt:.1f} queries/s, host words in and out ({smi})")
    del tp, full

    mark("21e")
    # 21e. bucket_range: the one-hot sum of four shards
    host = index.k2u.device_arrays()
    whole_d = arrays_from_numpy(host, dev)
    whole = sshash_k2u(whole_d, fw_u)
    whole_ms = cuda_ms(lambda: sshash_k2u(whole_d, fw_u), 3)
    acc, shard_ms = None, []
    for local, lo, hi in shard_arrays(host, index.k2u.occs_prefix_sum, SHARDS):
        d = arrays_from_numpy(local, dev)
        r = sshash_k2u(d, fw_u, bucket_range=(lo, hi))
        mine = r.pop("mine")
        for key, v in r.items():
            if bool(torch.where(mine, 0, v.to(torch.int64)).any()):
                raise AssertionError(f"[bucket_range] shard [{lo}, {hi}): a lane it does not "
                                     f"own has {key}")
        acc = r if acc is None else {key: (acc[key].to(torch.int64) + v.to(torch.int64)).to(
            v.dtype) for key, v in r.items()}
        shard_ms.append(cuda_ms(lambda: sshash_k2u(d, fw_u, bucket_range=(lo, hi)), 3))
        del d
    same_out("bucket_range", acc, whole)
    log(f"[bucket_range] {SHARDS} bucket shards of T={host['meta'].direct_t} (inline rows, flat2 "
        f"bounds, laid out as the reference's shard_fused_arrays): their one-hot sum == the "
        f"unsharded full-mode answer on {BATCH} lanes; full mode {whole_ms:.2f} ms unsharded, "
        f"{', '.join(f'{x:.2f}' for x in shard_ms)} ms a shard ({smi})")
    del host, whole_d, whole, acc
    torch.cuda.empty_cache()

    mark("21f")
    # 21f. the wavelet-matrix occurrence table
    t0 = time.perf_counter()
    wt = WMUnitigTable.from_piscem(index.u2pos)
    t_wm = time.perf_counter() - t0
    qa = QueryIndex(arrays_from_numpy(
        ModIndex(index.k2u, wt, index.refs, index_type=index.index_type).device_arrays(),
        "cpu")).to(dev)
    qb = QueryIndex(arrays_from_numpy(index.device_arrays(), "cpu")).to(dev)
    same_out("wm table", get_ref_pos_padded(qa.arrays(), fw_u, mo),
             get_ref_pos_padded(qb.arrays(), fw_u, mo))
    wm_ms = cuda_ms(lambda: get_ref_pos_padded(qa.arrays(), fw_u, mo), 3)
    ps_ms = cuda_ms(lambda: get_ref_pos_padded(qb.arrays(), fw_u, mo), 3)
    log(f"[wm table] WMUnitigTable over the piscem table ({len(wt.planes)} byte planes, "
        f"{wt.n_total_occs} occurrences) in {t_wm:.2f} s on the host: num_bits {wt.num_bits()} "
        f"against the piscem table's {index.u2pos.num_bits()}; get_ref_pos_padded on {BATCH} "
        f"queries on the card == the piscem table's, lane for lane; {wm_ms:.2f} ms against "
        f"{ps_ms:.2f} ms ({smi})")
    del qa, qb
    rng = np.random.default_rng(21)
    seq = rng.integers(0, 200, WM_N).astype(np.uint8)  # symbols 200-255 absent
    for tag, wm in (("random bytes", WaveletMatrix.build(seq, 256)),
                    ("the table's plane 0", wt.planes[0])):
        n = len(wm)
        i = torch.from_numpy(rng.integers(0, n, WM_N))
        a = torch.from_numpy(rng.integers(0, wm.alpha_size, WM_N))
        r = torch.from_numpy(rng.integers(0, max(1, n // 64), WM_N))
        d_cpu = arrays_from_numpy(wm.device_arrays(), "cpu")
        d = arrays_from_numpy(wm.device_arrays(), dev)
        calls = {"access": (wm_access, (i,)), "rank": (wm_rank, (a, i)),
                 "select": (wm_select, (a, r))}
        times = {}
        for name, (fn, args) in calls.items():
            want = fn(d_cpu, *args)
            got = fn(d, *(x.to(dev) for x in args))
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"[wm {tag}] {name} differs from the CPU")
            times[name] = cuda_ms(lambda: fn(d, *(x.to(dev) for x in args)), 3)
        absent = int((~torch.from_numpy(wm.has_symbol(a.numpy()))).sum())
        log(f"[wm {tag}] {n} symbols, alphabet {wm.alpha_size}, {wm.n_levels} levels: "
            f"wm_access, wm_rank and wm_select on {WM_N} random arguments ({absent} of absent "
            f"symbols) == the CPU; "
            f"{', '.join(f'{k_} {v:.3f} ms' for k_, v in times.items())} ({smi})")
    log(f"[layouts] phase 21 in {time.perf_counter() - t_phase:.1f} s ({smi})")

    # phase 18 builds the fixedcap2 rows again rather than hold their
    # 15 GB on the host through the phases between
    M2, want2, times2 = found["fixedcap2"]

    def profile():
        host, gpu_qi = fixedcap_rows(index, "fixedcap2", dev, smi)
        del host
        og = OneGraphIndexQuery(gpu_qi, BATCH, n_chunks=CH, m2=M2, probe_limit=PLIM)
        og_e = OneGraphIndexQuery(gpu_qi, BATCH, n_chunks=CH, m2=M2, probe_limit=PLIM,
                                  graph=False)
        if og.checksum_pass_rolled(fw_u)[0] != want2:
            raise AssertionError("[fixedcap2 1graph] the profiled index's checksum differs")
        profile_both("fixedcap2 1graph", lambda: og.checksum_pass_rolled(fw_u),
                     lambda: og_e.checksum_pass_rolled(fw_u), times2)
        del og, og_e, gpu_qi
        torch.cuda.empty_cache()
    return profile


def fixedcap_reads(index, cpu_qi, gpu_qi, dev, smi):
    """Phase 21d: ``ReadBatchQuery`` (run sharing) on the fused fixedcap
    rows over phase 8c's read k-mers, its checksum equal to
    ``TwoPhaseIndexQuery``'s on the same rows and to the CPU's; 3 of each
    timed in turns."""
    k = index.k
    per = synth.READ_LEN - k + 1
    words = read_kmers(index.refs, READS, k, seed=1)
    n_real = len(words)
    n = 1 << (n_real - 1).bit_length()
    words = np.concatenate([words, np.zeros(n - n_real, dtype=np.uint64)])
    new_read = np.zeros(n, dtype=bool)
    new_read[:n_real:per] = True
    new_read[n_real:] = True
    fw = torch.from_numpy(words.view(np.int64)).to(dev)
    nr = torch.from_numpy(new_read).to(dev)
    t0 = time.perf_counter()
    want = TwoPhaseIndexQuery(cpu_qi).checksum_query(torch.from_numpy(words.view(np.int64)))
    cpu_s = time.perf_counter() - t0
    tp, rb = TwoPhaseIndexQuery(gpu_qi), ReadBatchQuery(gpu_qi)
    runs = {"twophase": lambda: tp.checksum_query(fw),
            "runshare": lambda: rb.checksum_query(fw, words, nr)}
    got = {kind: run() for kind, run in runs.items()}
    if not got["twophase"] == got["runshare"] == want:
        raise AssertionError(f"[fixedcap reads] checksums: {got}, CPU {want}")
    t = {kind: [] for kind in runs}
    for _ in range(3):
        for kind, run in runs.items():
            t0 = time.perf_counter()
            if run() != want:
                raise AssertionError(f"[fixedcap reads] timed {kind} checksum differs")
            t[kind].append(time.perf_counter() - t0)
    rates = {kind: sorted(n_real / x for x in v) for kind, v in t.items()}
    log(f"[fixedcap reads] {n_real} read k-mers of {READS} reads padded to {n}: (checksum, "
        f"overflow lanes) {want} from ReadBatchQuery and TwoPhaseIndexQuery on the fused "
        f"fixedcap rows == TwoPhaseIndexQuery on CPU tensors ({cpu_s:.1f} s); 3 of each in "
        f"turns: " + ", ".join(f"{kind} median {statistics.median(v):.1f} read k-mers/s (min "
                               f"{v[0]:.1f}, max {v[-1]:.1f})" for kind, v in rates.items())
        + f" ({smi})")


def reads_phase(index, cpu_qi, gpu_qi, dev, smi):
    """Phase 8c: ``bench.py``'s reads path on the speed index's fused
    inline rows: ``READS`` reads k-merized on the host and padded to a power
    of two (pad lanes each a read), through ``TwoPhaseIndexQuery`` and
    ``ReadBatchQuery`` (run sharing), both equal to the two-phase checksum
    on CPU tensors, then 3 of each timed in turns."""
    k = index.k
    per = synth.READ_LEN - k + 1
    words = read_kmers(index.refs, READS, k, seed=1)
    n_real = len(words)
    n = 1 << (n_real - 1).bit_length()
    words = np.concatenate([words, np.zeros(n - n_real, dtype=np.uint64)])
    new_read = np.zeros(n, dtype=bool)
    new_read[:n_real:per] = True
    new_read[n_real:] = True
    fw = torch.from_numpy(words.view(np.int64)).to(dev)
    nr = torch.from_numpy(new_read).to(dev)
    t0 = time.perf_counter()
    want = TwoPhaseIndexQuery(cpu_qi).checksum_query(torch.from_numpy(words.view(np.int64)))
    cpu_s = time.perf_counter() - t0
    n_runs = int(run_starts(gpu_qi.arrays()["k2u"], fw, nr)[0].sum())
    tp, rb = TwoPhaseIndexQuery(gpu_qi), ReadBatchQuery(gpu_qi)
    runs = {"twophase": lambda: tp.checksum_query(fw),
            "runshare": lambda: rb.checksum_query(fw, words, nr)}
    got = {kind: run() for kind, run in runs.items()}
    if not got["twophase"] == got["runshare"] == want:
        raise AssertionError(f"[reads] checksums: {got}, CPU {want}")
    log(f"[reads] {READS} reads of {synth.READ_LEN} bases k-merized on the host: {n_real} read "
        f"k-mers padded to {n}; (checksum, overflow lanes) {want} from TwoPhaseIndexQuery and "
        f"ReadBatchQuery on the card == TwoPhaseIndexQuery on CPU tensors ({cpu_s:.1f} s); "
        f"{n_runs} runs ({n_runs / n_real:.3f} a read k-mer with the {n - n_real} pad lanes) "
        f"in {n} run slots, the reference's budget {n // 2} "
        f"({'exceeded' if n_runs > n // 2 else 'not exceeded'}: C11)")
    t = {kind: [] for kind in runs}
    for _ in range(3):
        for kind, run in runs.items():
            t0 = time.perf_counter()
            if run() != want:
                raise AssertionError(f"[reads] timed {kind} checksum differs")
            t[kind].append(time.perf_counter() - t0)
    for kind, v in t.items():
        rates = sorted(n_real / x for x in v)
        log(f"[reads] {kind}, 3 in turns (eager: the overflow count comes back mid-pass): median "
            f"{statistics.median(rates):.1f} read k-mers/s (min {rates[0]:.1f}, max "
            f"{rates[-1]:.1f}) ({smi})")


def capacity_speed(index, work: np.ndarray, uid, upos, fw: torch.Tensor, smi):
    """Phase 12a: the 300 Mbp capacity build laid out as the reference's
    tier rule lays it out on this card (fused inline2 rows), its 8 x 2^20
    queries through ``OneGraphIndexQuery`` at probe limit 2, checked
    against a CPU oracle for chunk 0, replayed and eager."""
    tag = "cap speed"
    t0 = time.perf_counter()
    host = index.device_arrays(pos_kind="inline2")
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.fuse(host["k2u"])
    t_fuse = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(fw.device)
    torch.cuda.synchronize()
    del host
    log(f"[{tag}] the port's tier rule gives {query_tier(index, device=fw.device)} (probe "
        f"bound {index.k2u.probe_bound()}), the reference's speed; inline2 rows and "
        f"flat32 bounds {t_rows:.1f} s, fusion pass {t_fuse:.1f} s on the host; "
        f"{gpu_index.nbytes()} bytes on the card (speed_bytes {speed_bytes(index)})")
    t0 = time.perf_counter()
    work_cpu = torch.from_numpy(work.view(np.int64))
    out0 = get_ref_pos_compact(cpu_index.arrays(), work_cpu, cpu_index.max_occs, merge=False,
                               probe_limit=PLIM, m2=BATCH // 4)
    if bool(out0["over_budget"]):
        raise AssertionError(f"[{tag}] CPU oracle over budget")
    merged = merge_compact_k2u(out0)
    if not (bool((merged["mt"] > 0).all()) and np.array_equal(merged["unitig_id"].numpy(), uid)
            and np.array_equal(merged["pos"].numpy(), upos)):
        raise AssertionError(f"[{tag}] CPU oracle disagrees with the sampled unitigs and offsets")
    host_chk, n_ovf = int(OneGraphIndexQuery.checksum(out0)), int(out0["n_ovf"])
    M2 = fit(n_ovf * 1.3)
    log(f"[{tag}] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}, every "
        f"lane at its sampled unitig and offset; overflow {n_ovf} -> M2={M2}")
    del cpu_index, out0, merged
    og = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CAP_CH, m2=M2, probe_limit=PLIM)
    og_e = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CAP_CH, m2=M2, probe_limit=PLIM,
                              graph=False)
    _, _, times = graph_and_eager(tag, gpu_index, og.checksum_pass_rolled,
                                  og_e.checksum_pass_rolled, fw, CAP_CH * host_chk,
                                  BATCH * CAP_CH, 3, None, smi)
    m = gpu_index.arrays()["k2u"]["meta"]
    p2_ms = cuda_ms(lambda: get_ref_pos_padded(gpu_index.arrays(), fw[:M2], gpu_index.max_occs), 3)
    log(f"[{tag}] phase 2 alone (full mode, static loop to probe_bound={m.probe_bound}) on {M2} "
        f"lanes: {p2_ms:.3f} ms, x {CAP_CH} chunks = {CAP_CH * p2_ms:.1f} ms of the replayed "
        f"pass's {times['graph'] * 1e3:.1f} ms ({smi})")
    del og, og_e, gpu_index
    torch.cuda.empty_cache()


def c10_on_card(index, cap_index, work: np.ndarray, fw: torch.Tensor) -> QueryIndex:
    """Phase 17a: reference fault C10 on the card. The fast32 index at its
    default fused inline layout through ``TwoPhaseIndexQuery``'s default
    must equal, lane for lane, the padded query on the capacity layout
    ``cap_index``, skew lanes included. Returns that layout on the card."""
    qi = QueryIndex(arrays_from_numpy(index.device_arrays(fused=True), "cpu")).to(fw.device)
    tp = TwoPhaseIndexQuery(qi)
    skew = sshash_k2u(qi.arrays()["k2u"], fw, mode="main")["use_skew"]
    n_skew = int(skew.sum())
    got = tp.get_ref_pos_batch(work)
    out = get_ref_pos_padded(cap_index.arrays(), fw, cap_index.max_occs)
    want = BatchHits.from_padded(_host(out))
    skew_hit = int((skew & (out["mt"] > 0)).sum())
    for key in ("mt", "offsets", "ref_id", "ref_pos", "orient"):
        if not np.array_equal(getattr(got, key), getattr(want, key)):
            raise AssertionError(f"[c10] TwoPhaseIndexQuery on fused fast32 rows differs from the "
                                 f"padded query in {key}")
    if skew_hit == 0:
        raise AssertionError("[c10] the batch has no skew lane that hits")
    log(f"[c10] fast32 index, fused inline rows, TwoPhaseIndexQuery's default on {len(work)} "
        f"queries == the padded query on the capacity layout, lane for lane: {n_skew} skew "
        f"lanes, {skew_hit} of them hits with their occurrences ({qi.nbytes()} bytes on the card)")
    del tp, skew, out
    return qi


def speed_rows(tag: str, index, dev) -> QueryIndex:
    """A 300 Mbp SSHash's speed-tier arrays, ``index.device_arrays(fused=True)``
    (fused inline rows), on the card, their host seconds printed: the
    rival of phase 12's mapper (12b)."""
    t0 = time.perf_counter()
    qi = QueryIndex(arrays_from_numpy(index.device_arrays(fused=True), "cpu")).to(dev)
    log(f"[{tag}] fused inline rows for the speed tier {time.perf_counter() - t0:.1f} s on the "
        f"host: {qi.nbytes()} bytes on the card")
    return qi


def capacity(args, dev, smi, lib3: str, ptxas3: str, sector_rate: float):
    """Phases 10-14; returns K2's record for the kernels line and the
    capacity path's profiled pass. ``sector_rate``: phase 3's random-sector
    rate (sectors/s), for K2's sector floor."""
    mark("10")
    # 10. the capacity index
    t0 = time.perf_counter()
    index = synth.build_capacity_index(int(args.cap_mbp * 1e6), seed=0, device=dev, chunk=1 << 24)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = index.device_arrays(**synth.CAPACITY_LAYOUT)
    t_arrays = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    us = index.k2u.unitigs
    d = gpu_index.arrays()
    k2u = d["k2u"]
    m = k2u["meta"]
    log(f"[cap index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"T={m.direct_t} buckets, probe_bound={m.probe_bound}, max bucket {index.k2u.max_bucket()}, "
        f"{index.k2u.n_kmers_in_skew_index} skew k-mers ({m.skew_kind}, skew_t={m.skew_t}); "
        f"max_occs={gpu_index.max_occs}")
    log(f"[cap index] host build {t_build:.1f} s (minimizer scan on the card), arrays "
        f"{t_arrays:.1f} s, to card {t_card:.1f} s; {gpu_index.nbytes()} bytes on the card "
        f"(bpos {k2u['bpos'].numel() * 4}, useqrec {k2u['us']['useqrec'].numel() * 8})")

    mark("11")
    # 11. K2 against its plain version
    work, uid, upos = synth.sample_capacity_queries(us, BATCH, seed=1)
    fw = torch.from_numpy(work.view(np.int64)).to(dev)

    def k2(plim):
        return (lambda d_, f_: bpos_probe.bpos_usrec_k2u(d_, f_, plim),
                lambda d_, f_: sshash_k2u(d_, f_, mode="main", probe_limit=plim))

    want = sshash_k2u(k2u, fw, mode="main", probe_limit=PLIM)
    skew_lane = int(torch.nonzero(want["use_skew"])[0])
    small = work[:257].copy()
    small[0] = work[skew_lane]
    small[1] = np.random.default_rng(5).integers(1 << 63, 1 << 64, dtype=np.uint64)
    small[2] = mask2k(index.k)
    for plim in (1, 2, 3):
        for words in (small[:1], small):
            compare_k2u(k2u, torch.from_numpy(words.view(np.int64)).to(dev),
                        f"plim={plim} N={len(words)}", *k2(plim))
        max_err = compare_k2u(k2u, fw, f"plim={plim} N={BATCH}", *k2(plim))
    log("[k2] N=1, N=257 (a skew lane, a foreign word, all-T) and 2^20 at probe limits 1-3: "
        "bit-identical on all nine fields")
    cases = tile_cases(work, want["use_skew"], us, index.k, bpos_probe.TILE)
    max_err = max(max_err, compare_cases(
        "k2 tiles", k2u, cases, [(f"plim={p}", *k2(p), FIELDS) for p in (1, 2, 3)], dev))
    n_skew = int(want["use_skew"].sum())
    n_unres = int(want["unresolved"].sum())
    # unresolved lanes whose bucket has no row past the probed depth are
    # there only for the mt == 3 sentinel (a lower bound of its count)
    n_mt3 = int((want["unresolved"] & (n_occs_of(k2u, fw) <= PLIM)).sum())
    log(f"[k2] N={BATCH} at probe limit {PLIM}: {n_skew} skew lanes, {n_unres} unresolved, "
        f">= {n_mt3} by the mt==3 sentinel, {int((want['mt'] > 0).sum())} hits")
    if min(n_skew, n_unres, n_mt3) == 0:
        raise AssertionError("the capacity batch lacks skew, unresolved or sentinel lanes")
    kern, plain = k2(PLIM)
    k2_ms = cuda_ms(lambda: kern(k2u, fw), 20)
    k2_plain_ms = cuda_ms(lambda: plain(k2u, fw), 5)
    rows = probed_rows(lambda plim: sshash_k2u(k2u, fw, mode="main", probe_limit=plim),
                       n_occs_of(k2u, fw), want["use_skew"], PLIM)
    # the key, the 16-byte bpos row, a 56-byte record per probed row, the outputs
    k2_bound = bound(BATCH * (8 + 16 + K2U_OUT) + 56 * int(rows.sum()))
    k2_dram, k2_blocks = k2_dram_sectors(k2u, fw, rows)
    k2_floor = k2_dram / sector_rate * 1e3
    log(f"[k2] N={BATCH}: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms; {int(rows.sum())} "
        f"records read; bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); {k2_dram} DRAM sectors "
        f"({k2_dram / BATCH:.3f} a lane): sector floor {k2_floor:.4f} ms; {k2_blocks} 64-byte "
        f"blocks ({k2_blocks / BATCH:.3f} a lane): {k2_blocks / sector_rate * 1e3:.4f} ms at "
        f"the same rate ({smi})")
    del want

    mark("12")
    # 12. the capacity main path
    launches, m2c, profile = sshash_path(
        "cap main", cpu_index, gpu_index, work, uid, upos, fw,
        dict(probe_limit=PLIM, defer_valid=True, probe_limit2=PLIM2), bpos_probe, smi)
    res_ms = cuda_ms(lambda: get_ref_pos_padded(d, fw[:m2c], gpu_index.max_occs), 5)
    log(f"[cap main] residue phase alone (full mode, static loop to probe_bound={m.probe_bound}) "
        f"on {m2c} lanes: {res_ms:.3f} ms ({smi})")
    capacity_drivers(cpu_index, gpu_index, work, fw)
    # 6d on the capacity index: the read mapper in the capacity tier by the
    # rule, K2 in its main phase; 12b. in turns with it, the speed tier
    qs = speed_rows("map capacity", index, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches += mapping_phase(
            "map capacity", index, gpu_index, cpu_index, bpos_probe, smi, tmp,
            driver="CompactQuery",
            rival=dict(qi=qs, driver="TwoPhaseIndexQuery", tier="speed", probe=None))
    del qs
    torch.cuda.empty_cache()

    mark("12a")
    # 12a. the speed layout of this build
    capacity_speed(index, work, uid, upos, fw, smi)

    mark("13")
    # 13. K3 build report
    log(f"[k3 build] {lib3}")
    for line in ptxas_lines(ptxas3):
        log(f"[k3 build] {line}")

    mark("14")
    # 14. K3 on the direct layout: these arrays without bpos and useqrec,
    # with uproj records
    uproj = torch.from_numpy(build_uproj(index.u2pos, us).view(np.int64)).to(dev)
    k3d = {**{kk: v for kk, v in k2u.items() if kk != "bpos"},
           "us": {**{kk: v for kk, v in k2u["us"].items() if kk != "useqrec"}, "uproj": uproj}}
    for plim in (1, 2, 3):
        for words in (small[:1], small):
            compare_k2u(k3d, torch.from_numpy(words.view(np.int64)).to(dev),
                        f"direct plim={plim} N={len(words)}", *k3(plim), fields=FIELDS3)
        compare_k2u(k3d, fw, f"direct plim={plim} N={BATCH}", *k3(plim), fields=FIELDS3)
    compare_cases("k3 direct tiles", k3d, cases,
                  [(f"plim={p}", *k3(p), FIELDS3) for p in (1, 2, 3)], dev)
    kern, plain = k3(PLIM)
    k3_ms = cuda_ms(lambda: kern(k3d, fw), 20)
    k3_plain_ms = cuda_ms(lambda: plain(k3d, fw), 5)
    log(f"[k3 direct] N=1, N=257 and 2^20 at probe limits 1-3: bit-identical on all ten fields; "
        f"N={BATCH} at probe limit {PLIM}: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms "
        f"({smi})")
    mark("23c")
    # 23c. the bucket-sharded, all-to-all and compact sharded queries
    capacity_shards(index, gpu_index, cpu_index.arrays()["k2u"], fw, dev, smi)
    return record("bpos_probe", "bpos_probe.cu", "mazu_tpu/ops/pallas_capacity.py:266",
                  launches, max_err, k2_ms, k2_plain_ms, k2_bound,
                  sector_floor_ms=k2_floor), profile


def sshash_path(tag: str, cpu_index, gpu_index, work, uid, upos, fw, query: dict, probe,
                smi) -> tuple[int, int, object]:
    """Phases 12 and 17: an SSHash main path with the type-split heavy phase
    and its middle phase (``query``: the main and middle probe settings).
    The port's plain path on CPU tensors gives chunk 0's oracle, which must
    hit every sampled lane at its sampled unitig and offset and sizes the
    capacities; the merged query on 4,096 lanes on the card must equal the
    padded CPU query; then ``checksum_pass_rolled`` over CAP_CH chunks must
    equal CAP_CH x the oracle and launch ``probe``'s kernel; 3 timed passes.
    Returns (the kernel's launches in the first pass, m2c, a function that
    runs one profiled pass)."""
    t0 = time.perf_counter()
    cpu = cpu_index.arrays()
    work_cpu = torch.from_numpy(work.view(np.int64))
    rM = sshash_k2u(cpu["k2u"], work_cpu, mode="main", probe_limit=query["probe_limit2"])
    m2c = fit(int((rM["use_skew"] | rM["unresolved"]).sum()) * 1.3)
    kw = dict(query, m2b=max(8192, BATCH // 8), m2c=m2c)
    out0 = get_ref_pos_compact(cpu, work_cpu, cpu_index.max_occs, merge=False,
                               m2=max(8192, BATCH // 8), **kw)
    if bool(out0["over_budget"]):
        raise AssertionError("CPU oracle over budget")
    host_chk = int(OneGraphIndexQuery.checksum(out0))
    merged = merge_compact_k2u(out0)
    if not bool((merged["mt"] > 0).all()):
        raise AssertionError(f"CPU oracle missed {int((merged['mt'] == 0).sum())} sampled lanes")
    if not (np.array_equal(merged["unitig_id"].numpy(), uid)
            and np.array_equal(merged["pos"].numpy(), upos)):
        raise AssertionError("CPU oracle disagrees with the sampled unitigs and offsets")
    n_a, n_b = int(out0["n_ovf"]), int(out0["n_ovf_b"])
    real_b = out0["lanes_b"][out0["slot_real_b"]]
    rB = sshash_k2u(cpu["k2u"], work_cpu[real_b], mode="main", probe_limit=query["probe_limit2"])
    n_c = int((rB["use_skew"] | rB["unresolved"]).sum())
    M2, M2B = fit(n_a * 1.3), fit(n_b * 1.15)
    log(f"[{tag}] CPU oracle {time.perf_counter() - t0:.1f} s: chunk checksum {host_chk}; "
        f"every lane hit at its sampled unitig and offset; type-A {n_a}, type-B {n_b}, residue "
        f"{n_c} of {BATCH} -> m2={M2}, m2b={M2B}, m2c={m2c}")

    d = gpu_index.arrays()
    got = get_ref_pos_compact(d, fw[:4096], gpu_index.max_occs, merge=True, m2=4096,
                              **dict(kw, m2b=4096, m2c=4096))
    want = get_ref_pos_padded(cpu, work_cpu[:4096], cpu_index.max_occs)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid",
                "ref_id", "ref_pos", "orient"):
        g, w = got[key].cpu(), want[key]
        if g.dim() == 2:
            g, w = torch.where(want["valid"], g, 0), torch.where(want["valid"], w, 0)
        if not torch.equal(g, w):
            raise AssertionError(f"[{tag}] merged query on the card differs from padded CPU in {key}")
    log(f"[{tag}] merged query on 4096 lanes equals the padded CPU query")

    og = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CAP_CH, m2=M2, m2b=M2B, **dict(query, m2c=m2c))
    og_eager = OneGraphIndexQuery(gpu_index, BATCH, n_chunks=CAP_CH, m2=M2, m2b=M2B, graph=False,
                                  **dict(query, m2c=m2c))
    launches, worst, times = graph_and_eager(
        tag, gpu_index, og.checksum_pass_rolled, og_eager.checksum_pass_rolled, fw,
        CAP_CH * host_chk, BATCH * CAP_CH, 3, probe, smi)
    log(f"[{tag}] worst (type-A, type-B) {worst} within (m2, m2b)")
    return launches, m2c, lambda: profile_both(
        tag, lambda: og.checksum_pass_rolled(fw), lambda: og_eager.checksum_pass_rolled(fw), times)


def k3(plim, mlim=None):
    """(K3, its plain version) at probe limit ``plim`` and MPHF level limit
    ``mlim``."""
    return (lambda d_, f_: capacity_probe.capacity_k2u(d_, f_, plim, mphf_level_limit=mlim),
            lambda d_, f_: sshash_k2u(d_, f_, mode="main", probe_limit=plim, defer_valid=True,
                                      mphf_level_limit=mlim))


def lane_counts(k2u: dict, fw: torch.Tensor, plim: int, mlim) -> dict:
    """The plain main probe's lane classes: skew, unplaced by the truncated
    MPHF chain, deferred winners that failed validation, hits."""
    m = k2u["meta"]
    on = sshash_k2u(k2u, fw, mode="main", probe_limit=plim, defer_valid=True,
                    mphf_level_limit=mlim)
    off = sshash_k2u(k2u, fw, mode="main", probe_limit=plim, mphf_level_limit=mlim)
    mm = canonical_minimizer_batch(fw, m.k, m.w, m.seed)[0]
    unplaced = mphf_lookup(k2u["mphf"], mm, level_limit=mlim)[1] if mlim else torch.zeros_like(fw)
    return {
        "skew": int(on["use_skew"].sum()),
        "mphf_unresolved": int(unplaced.sum()),
        "deferred_fail": int((on["unresolved"] & ~off["unresolved"]).sum()),
        "unresolved": int(on["unresolved"].sum()),
        "hits": int((on["mt"] > 0).sum()),
    }


def mphf(args, dev, smi, sector_rate: float):
    """Phases 15-17; returns K3's record for the kernels line and the MPHF
    path's profiled pass (``sector_rate`` as for ``capacity``)."""
    mark("15")
    # 15. the MPHF index
    t0 = time.perf_counter()
    index = synth.build_mphf_index(int(args.mphf_mbp * 1e6), seed=0, device=dev, chunk=1 << 24)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = index.device_arrays(**synth.MPHF_LAYOUT)
    t_arrays = time.perf_counter() - t0
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    us = index.k2u.unitigs
    d = gpu_index.arrays()
    k2u = d["k2u"]
    m = k2u["meta"]
    n_min = k2u["prefix"]["gdelta"].shape[0] - 1
    mp = index.k2u.mphf
    log(f"[mphf index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"{n_min} minimizers (T), MPHF levels {len(mp.levels)} {[n for n, _, _ in mp.levels]}, "
        f"{len(mp.fh_keys)} final-hash keys; {index.k2u.n_kmers_in_skew_index} skew k-mers; "
        f"probe_bound={m.probe_bound}, max bucket {index.k2u.max_bucket()}, "
        f"max_occs={gpu_index.max_occs}")
    stages = ", ".join(f"{kk} {v:.2f} s" for kk, v in index.k2u.build_seconds.items())
    log(f"[mphf index] build {t_build:.1f} s (the genome on the host, the SSHash on the card: "
        f"{stages}), arrays {t_arrays:.1f} s, to card {t_card:.1f} s; {gpu_index.nbytes()} bytes "
        f"on the card "
        f"(gdelta {k2u['prefix']['gdelta'].numel() * 2}, packed positions "
        f"{k2u['pos']['words'].numel() * 8}, MPHF words {k2u['mphf']['words'].numel() * 4}, "
        f"uproj {k2u['us']['uproj'].numel() * 8})")

    mark("16")
    # 16. K3 against its plain version
    work, uid, upos = synth.sample_capacity_queries(us, BATCH, seed=1)
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    want = sshash_k2u(k2u, fw, mode="main", probe_limit=PLIM, defer_valid=True,
                      mphf_level_limit=MLIM)
    skew_lane = int(torch.nonzero(want["use_skew"])[0])
    cases = tile_cases(work, want["use_skew"], us, index.k, capacity_probe.TILE)
    del want
    # a tile the one-level chain cannot place; lanes that reach the final
    # table (the batch's, and foreign k-mers that do)
    n_levels = len(k2u["mphf"]["meta"].n_bits)
    foreign = torch.from_numpy(np.random.default_rng(9).integers(
        0, 1 << (2 * index.k), 1 << 16, dtype=np.uint64).view(np.int64)).to(dev)

    def unplaced(words, limit):
        mm = canonical_minimizer_batch(words, m.k, m.w, m.seed)[0]
        return words[mphf_lookup(k2u["mphf"], mm, level_limit=limit)[1]].cpu().numpy()

    cases["unplaced at level limit 1"] = np.resize(unplaced(fw, 1).view(np.uint64),
                                                   capacity_probe.TILE)
    final_batch, final_foreign = unplaced(fw, n_levels), unplaced(foreign, n_levels)
    cases["final-table lanes"] = np.concatenate([final_batch, final_foreign]).view(np.uint64)
    log(f"[k3 mphf] lanes that reach the final-hash table at level limit None: "
        f"{len(final_batch)} of the {BATCH} batch, {len(final_foreign)} of {foreign.shape[0]} "
        f"foreign k-mers")
    small = work[:257].copy()
    small[0] = work[skew_lane]
    small[1] = np.random.default_rng(5).integers(1 << 63, 1 << 64, dtype=np.uint64)
    small[2] = mask2k(index.k)
    small[3:203] = synth.sample_boundary_queries(us, 200, seed=6)
    small_t = torch.from_numpy(small.view(np.int64)).to(dev)
    max_err = 0
    for mlim in (None, MLIM):
        for plim in (1, 2, 3):
            for words in (small_t[:1], small_t, fw):
                max_err = max(max_err, compare_k2u(
                    k2u, words, f"mphf mlim={mlim} plim={plim} N={len(words)}", *k3(plim, mlim),
                    fields=FIELDS3))
    log("[k3 mphf] N=1, N=257 (a skew lane, a foreign word, all-T, 200 boundary k-mers) and 2^20 "
        "at level limits None and 4, probe limits 1-3: bit-identical on all ten fields")
    max_err = max(max_err, compare_cases(
        "k3 mphf tiles", k2u, cases,
        [(f"mlim={ml} plim={p}", *k3(p, ml), FIELDS3) for ml in (None, MLIM, 2, 1)
         for p in (1, 2, 3)],
        dev))
    c_small = lane_counts(k2u, small_t, PLIM, MLIM)
    c_big = lane_counts(k2u, fw, PLIM, MLIM)
    log(f"[k3 mphf] probe limit {PLIM}, level limit {MLIM}: N=257 {c_small}; N={BATCH} {c_big}")
    if min(c_big["mphf_unresolved"], c_big["skew"], c_big["hits"]) == 0:
        raise AssertionError("the 2^20 batch lacks MPHF-unresolved, skew or hit lanes")
    if c_small["deferred_fail"] == 0:
        raise AssertionError("the N=257 batch has no deferred winner that failed validation")
    kern, plain = k3(PLIM, MLIM)
    k3_ms = cuda_ms(lambda: kern(k2u, fw), 20)
    k3_plain_ms = cuda_ms(lambda: plain(k2u, fw), 5)
    k3_bytes, k3_l2, k3_dram, k3_blocks, _ = k3_lane_cost(k2u, fw, PLIM, MLIM)
    k3_bound = bound(k3_bytes)
    k3_floor = k3_dram / sector_rate * 1e3
    log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {MLIM}: kernel {k3_ms:.4f} ms, "
        f"plain {k3_plain_ms:.4f} ms; {k3_bytes} bytes read and written; bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]}); sectors a lane {k3_l2 / BATCH:.3f} in L2, "
        f"{k3_dram / BATCH:.3f} in DRAM: sector floor {k3_floor:.4f} ms; 64-byte DRAM blocks a "
        f"lane {k3_blocks / BATCH:.3f}: {k3_blocks / sector_rate * 1e3:.4f} ms at the same rate "
        f"({smi})")
    for mlim in (1, 2, None):
        kern_l = k3(PLIM, mlim)[0]
        log(f"[k3 mphf] N={BATCH} at probe limit {PLIM}, level limit {mlim}: kernel "
            f"{cuda_ms(lambda: kern_l(k2u, fw), 20):.4f} ms ({smi})")

    mark("17")
    # 17. the MPHF main path
    launches, _, profile = sshash_path("mphf main", cpu_index, gpu_index, work, uid, upos, fw,
                                       synth.MPHF_QUERY, capacity_probe, smi)
    mark("17a")
    # 17a. C10 on the card
    qs = c10_on_card(index, gpu_index, work, fw)
    # 6d on the MPHF index: the read mapper in the capacity tier by the
    # rule, K3 in its main phase; 17b. in turns with it, the speed tier on
    # the fused inline rows of 17a
    with tempfile.TemporaryDirectory() as tmp:
        launches += mapping_phase(
            "map mphf", index, gpu_index, cpu_index, capacity_probe, smi, tmp,
            driver="CompactQuery",
            rival=dict(qi=qs, driver="TwoPhaseIndexQuery", tier="speed", probe=None))
    del qs
    torch.cuda.empty_cache()
    return record("capacity_probe", "capacity_probe.cu", "mazu_tpu/ops/pallas_capacity.py:56",
                  launches, max_err, k3_ms, k3_plain_ms, k3_bound,
                  sector_floor_ms=k3_floor), profile


def rss_now() -> float:
    """This process's resident memory, GB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


class RssPeak:
    """The peak resident memory (GB) of this process while a block runs,
    sampled every 10 ms by a thread: the card's machine reports no
    ``VmHWM`` and cannot reset one. A peak inside one call that holds the
    interpreter lock is missed."""

    def __enter__(self):
        import threading

        self.peak = rss_now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_now())


def array_bytes(d, path: str = "") -> list:
    """(path, bytes) of each tensor of an array dict, largest first."""
    if isinstance(d, dict):
        return sorted((x for kk, v in d.items() for x in array_bytes(v, f"{path}/{kk}")),
                      key=lambda x: -x[1])
    return [(path, d.numel() * d.element_size())] if isinstance(d, torch.Tensor) else []


def k3_plain_reads_source():
    """K3's source with the MPHF layout's far reads plain (the direct
    layout's instance for both layouts), written into the build directory:
    phase 20 times it in turns with K3, to see whether evict-first still
    pays when the MPHF's levels no longer fit the L2."""
    from mazu_tpu_torch.ops.cuda_build import BUILD_DIR

    src = capacity_probe.SOURCE.read_text()
    hot = "capacity_probe_kernel<true><<<"
    if src.count(hot) != 1:
        raise AssertionError("K3's source no longer launches its evict-first instance once")
    BUILD_DIR.mkdir(exist_ok=True)
    out = BUILD_DIR / "capacity_probe_plain_reads.cu"
    out.write_text(src.replace(hot, "capacity_probe_kernel<false><<<"))
    return out


def plain_reads_k3(lib):
    """K3 (``capacity_probe.capacity_k2u``) launching the plain-read build
    ``lib`` of ``k3_plain_reads_source`` instead, at probe limit ``PLIM``
    and level limit ``MLIM``."""
    import ctypes

    fn = ctypes.CDLL(str(lib)).capacity_probe
    fn.argtypes = [ctypes.POINTER(capacity_probe._Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(d, f):
        own, capacity_probe._FN = capacity_probe._kernel(), fn
        try:
            return capacity_probe.capacity_k2u(d, f, PLIM, mphf_level_limit=MLIM)
        finally:
            capacity_probe._FN = own
    return run


def same_builds(got, want) -> None:
    """Two fast32 SSHash builds hold the same bucket prefix, packed
    positions, MPHF levels and final table, and skew structures."""
    if not np.array_equal(got.occs_prefix_sum, want.occs_prefix_sum):
        raise AssertionError("builds differ in their bucket prefix")
    for (n_a, w_a, r_a), (n_b, w_b, r_b) in zip(got.mphf.levels, want.mphf.levels):
        if n_a != n_b or not (np.array_equal(w_a, w_b) and np.array_equal(r_a, r_b)):
            raise AssertionError("builds differ in an MPHF level")
    if len(got.mphf.levels) != len(want.mphf.levels):
        raise AssertionError("builds differ in their MPHF levels")
    same_arrays(got.device_arrays(prefix_kind="grouped16", pos_kind="packed"),
                want.device_arrays(prefix_kind="grouped16", pos_kind="packed"), "k2u")


def gbp(args, dev, smi, sector_rate: float, lib_plain_reads, k3_record: dict) -> None:
    """Phase 20 (synth3000-mphf): the MPHF tier at 2^31 bases or more,
    built on the card. Adds its K3 launches (main path and mapper) to K3's
    record ``k3_record`` and its K3 numbers under ``gbp_*`` keys."""
    import gc

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[gbp] before the phase: {torch.cuda.memory_allocated()} bytes allocated on the card by "
        f"earlier phases (phase 18's passes), host RSS {rss_now():.2f} GB")
    n_bases = int(args.gbp_mbp * 1e6)
    t0 = time.perf_counter()
    with RssPeak() as rss:
        genome = synth.mphf_genome(n_bases, seed=0)
    synth_s = time.perf_counter() - t0
    log(f"[gbp synth] synth.mphf_genome({n_bases}): {synth_s:.2f} s, host peak RSS "
        f"{rss.peak:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        index = synth.build_mphf_index(n_bases, seed=0, device=dev, chunk=1 << 24, genome=genome)
    build_s = time.perf_counter() - t0
    del genome
    sh = index.k2u
    us = sh.unitigs
    stages = ", ".join(f"{kk} {v:.2f} s" for kk, v in sh.build_seconds.items())
    log(f"[gbp build] SSHash fast32 on the card: {build_s:.2f} s ({stages}); peak "
        f"{torch.cuda.max_memory_allocated()} bytes allocated on the card, host peak RSS "
        f"{rss.peak:.2f} GB ({smi})")
    log(f"[gbp index] {us.total_len} bases, {us.n_unitigs} unitigs, {us.n_kmers} k-mers; "
        f"{sh.n_minimizer_occs} minimizer occurrences ({sh.n_minimizer_occs / us.n_kmers:.4f} a "
        f"k-mer), {sh.n_minimizers} minimizers, positions {sh.pos.width} bits wide; MPHF levels "
        f"{[n for n, _, _ in sh.mphf.levels]}, {len(sh.mphf.fh_keys)} final-hash keys; "
        f"{sh.n_kmers_in_skew_index} skew k-mers; max bucket {sh.max_bucket()}")
    t0 = time.perf_counter()
    with RssPeak() as rss:
        host = index.device_arrays(**synth.MPHF_LAYOUT)
    arrays_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    us.device_arrays(paired=True)
    paired_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_uproj(index.u2pos, us)
    uproj_s = time.perf_counter() - t0
    log(f"[gbp arrays] index.device_arrays(**MPHF_LAYOUT) on the host {arrays_s:.2f} s (the "
        f"paired unitig arrays alone {paired_s:.2f} s, uproj {uproj_s:.2f} s, the rest: grouped16 "
        f"bounds and the MPHF's, position and table arrays {arrays_s - paired_s - uproj_s:.2f} s); "
        f"host peak RSS {rss.peak:.2f} GB; the process's peak so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB")
    cpu_index = QueryIndex(arrays_from_numpy(host, "cpu"))
    t0 = time.perf_counter()
    gpu_index = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    d = gpu_index.arrays()
    k2u = d["k2u"]
    top = ", ".join(f"{p} {b}" for p, b in array_bytes(d)[:12])
    log(f"[gbp arrays] to the card {card_s:.2f} s: {gpu_index.nbytes()} bytes ({top}, ...)")
    if query_tier(index, device=dev) != "capacity":
        raise AssertionError("the tier rule does not keep synth3000-mphf in the capacity tier")

    # the card's build against the same build on CPU tensors
    n_chk = int(args.mphf_check_mbp * 1e6)
    small = synth.mphf_genome(n_chk, seed=0)
    t0 = time.perf_counter()
    on_card = synth.build_mphf_index(n_chk, device=dev, chunk=1 << 24, genome=small).k2u
    t1 = time.perf_counter()
    on_cpu = synth.build_mphf_index(n_chk, device="cpu", chunk=1 << 22, genome=small).k2u
    t2 = time.perf_counter()
    same_builds(on_card, on_cpu)
    log(f"[gbp check] at {n_chk} bases the card's build ({t1 - t0:.2f} s) equals the build on "
        f"CPU tensors ({t2 - t1:.2f} s) byte for byte: bucket prefix, packed positions, "
        f"{len(on_cpu.mphf.levels)} MPHF levels and {len(on_cpu.mphf.fh_keys)} final-table keys, "
        f"skew MPHF and positions")
    del small, on_card, on_cpu

    # K3 against its plain version, lanes past base 2^31 among them
    work, uid, upos = synth.sample_capacity_queries(us, BATCH, seed=1)
    fw = torch.from_numpy(work.view(np.int64)).to(dev)
    at = us.accum[uid] + upos
    far = int((at >= 1 << 31).sum())
    center = 1 << 31 if us.total_len > (1 << 31) + synth.PIECE else us.total_len // 2
    if n_bases >= (1 << 31) + synth.PIECE and far == 0:
        raise AssertionError("no sampled lane lies past base 2^31")
    c_uid = int(us.pos_to_id(center))
    edge = np.concatenate([np.arange(max(0, c_uid - 2), min(us.n_unitigs, c_uid + 3)),
                           [us.n_unitigs - 1]])
    kp = np.concatenate([us.accum[u] + np.arange(us.unitig_len(u) - us.k + 1) for u in edge])
    edge_words = us.get_kmer_u64(kp)
    want = sshash_k2u(k2u, fw, mode="main", probe_limit=PLIM, defer_valid=True,
                      mphf_level_limit=MLIM)
    cases = tile_cases(work, want["use_skew"], us, index.k, capacity_probe.TILE)
    cases[f"unitigs {edge[0]}-{edge[-2]} and {edge[-1]}"] = edge_words
    del want
    max_err = 0
    for mlim in (None, MLIM):
        for plim in (1, 2, 3):
            max_err = max(max_err, compare_k2u(k2u, fw, f"gbp mlim={mlim} plim={plim} N={BATCH}",
                                               *k3(plim, mlim), fields=FIELDS3))
    max_err = max(max_err, compare_cases(
        "k3 gbp tiles", k2u, cases,
        [(f"mlim={ml} plim={p}", *k3(p, ml), FIELDS3) for ml in (None, MLIM) for p in (1, 2, 3)],
        dev))
    c_big = lane_counts(k2u, fw, PLIM, MLIM)
    log(f"[k3 gbp] {BATCH} uniform queries ({far} lanes past base 2^31, {far / BATCH:.1%}), level "
        f"limits None and {MLIM}, probe limits 1-3, and the tiles with the k-mers of unitigs "
        f"{edge[0]}-{edge[-2]} (bases {int(us.accum[edge[0]])}-{int(us.accum[edge[-2] + 1])}) and "
        f"of the last unitig: bit-identical on all ten fields; probe limit {PLIM}, level limit "
        f"{MLIM}: {c_big}")
    kern, plain = k3(PLIM, MLIM)
    variant = plain_reads_k3(lib_plain_reads)
    got, ref = variant(k2u, fw), kern(k2u, fw)
    if any(not torch.equal(got[kk], ref[kk]) for kk in FIELDS3):
        raise AssertionError("K3 with plain far reads differs from K3")
    turns = {"evict-first": [], "plain reads": []}
    for name in ("evict-first", "plain reads", "plain reads", "evict-first"):
        fn = kern if name == "evict-first" else variant
        turns[name].append(cuda_ms(lambda: fn(k2u, fw), 20))
    k3_ms = statistics.mean(turns["evict-first"])
    plain_reads_ms = statistics.mean(turns["plain reads"])
    k3_plain_ms = cuda_ms(lambda: plain(k2u, fw), 5)
    n_bytes, l2, dram, blocks, mphf_sectors = k3_lane_cost(k2u, fw, PLIM, MLIM)
    k3_bound = bound(n_bytes)
    # the MPHF's levels no longer fit the L2: their sectors are DRAM reads
    floor = (dram + mphf_sectors) / sector_rate * 1e3
    log(f"[k3 gbp] N={BATCH} at probe limit {PLIM}, level limit {MLIM}: kernel {k3_ms:.4f} ms "
        f"(in turns: evict-first {turns['evict-first']}, plain far reads "
        f"{turns['plain reads']} -> {plain_reads_ms:.4f} ms, evict-first "
        f"{plain_reads_ms / k3_ms:.3f}x as fast), plain {k3_plain_ms:.4f} ms; {n_bytes} bytes: bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]}); sectors a lane: {mphf_sectors / BATCH:.3f} MPHF, "
        f"{(l2 - mphf_sectors) / BATCH:.3f} gbase and uproj, {dram / BATCH:.3f} DRAM: "
        f"sector floor with the MPHF in DRAM {floor:.4f} ms ({smi})")
    k3_record.update(gbp_ms=k3_ms, gbp_plain_reads_ms=plain_reads_ms, gbp_plain_ms=k3_plain_ms,
              gbp_bound_ms=k3_bound[0], gbp_sector_floor_ms=floor)

    # the mrows layout: its lookup equals the lean layout's; K3 refuses it
    mm = canonical_minimizer_batch(fw, index.k, sh.w, sh.seed)[0]
    rows = arrays_from_numpy(sh.mphf.device_arrays(mrows=True), dev)
    for limit in (None, MLIM):
        a, b = mphf_lookup(rows, mm, level_limit=limit), mphf_lookup(k2u["mphf"], mm,
                                                                     level_limit=limit)
        if not all(torch.equal(x, y) for x, y in zip(a if limit else (a,), b if limit else (b,))):
            raise AssertionError(f"the mrows lookup differs from the lean one at level limit {limit}")
    with_rows = {**d, "k2u": {**k2u, "mphf": rows}}
    try:
        capacity_probe.check_layout(with_rows["k2u"], fw, PLIM)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("K3's layout check takes an mrows MPHF")
    kw4 = dict(synth.MPHF_QUERY, m2b=4096, m2c=4096)
    reset_launches()
    a = get_ref_pos_compact(with_rows, fw[:4096], gpu_index.max_occs, merge=True, m2=4096, **kw4)
    if capacity_probe.LAUNCHES:
        raise AssertionError("the compact query on an mrows MPHF launched K3")
    b = get_ref_pos_compact(d, fw[:4096], gpu_index.max_occs, merge=True, m2=4096, **kw4)
    if not capacity_probe.LAUNCHES or any(not torch.equal(a[kk], b[kk]) for kk in b):
        raise AssertionError("the compact query on an mrows MPHF differs from the lean one's")
    log(f"[gbp mrows] the mrows lookup of the batch's {BATCH} minimizers equals the lean "
        f"layout's at level limits None and {MLIM} ({tree_bytes(rows)} bytes against "
        f"{tree_bytes(k2u['mphf'])}); K3's layout check refuses it ({refused}), and the compact "
        f"query on it takes the plain probe, equal on 4096 lanes")
    del rows, mm, with_rows, a, b

    # every k-mer of the unitigs around base 2^31, at its own unitig and offset
    lo, hi = max(0, center - (1 << 25)), min(us.total_len, center + (1 << 25))
    u_lo, u_hi = int(us.pos_to_id(lo)), int(us.pos_to_id(hi - 1))
    accum = torch.from_numpy(us.accum).to(dev)
    t0 = time.perf_counter()
    n_checked = 0
    per = max(1, VALIDATE_CHUNK // synth.PIECE)  # unitigs a query
    for u0 in range(u_lo, u_hi + 1, per):
        u = torch.arange(u0, min(u0 + per, u_hi + 1), device=dev)
        ln = accum[u + 1] - accum[u] - index.k + 1
        off = torch.arange(int(ln.max()), device=dev)[None, :].expand(u.shape[0], -1)
        ok = off < ln[:, None]
        tu, toff = u[:, None].expand_as(off)[ok], off[ok]
        words = us_get_kmer(k2u["us"], accum[tu] + toff)
        flip = (toff & 1) == 1
        words = torch.where(flip, revcomp(words, index.k), words)
        n = words.shape[0]
        out = get_ref_pos_compact(d, words, gpu_index.max_occs, merge=True, m2=n,
                                  **dict(synth.MPHF_QUERY, m2b=n, m2c=n))
        if not bool(((out["mt"] > 0) & (out["unitig_id"] == tu) & (out["pos"] == toff)).all()):
            raise AssertionError(f"[gbp] a k-mer of unitigs {u0}-{int(u[-1])} is not found at its "
                                 f"unitig and offset")
        n_checked += words.shape[0]
    log(f"[gbp around 2^31] all {n_checked} k-mers of unitigs {u_lo}-{u_hi} (bases "
        f"{int(us.accum[u_lo])}-{int(us.accum[u_hi + 1])}), every other one reverse-complemented, "
        f"found at their unitig and offset through get_ref_pos_compact on the card in "
        f"{time.perf_counter() - t0:.2f} s")

    # index/validate.py on the references of the unitigs around base 2^31
    # (reference i is unitig i) and of the last unitig
    def query(w):
        n = w.shape[0]
        return get_ref_pos_compact(d, w, gpu_index.max_occs, merge=True, m2=n,
                                   **dict(synth.MPHF_QUERY, m2b=n, m2c=n))

    ps = index.refs.prefix_sum
    t0 = time.perf_counter()
    for ri in edge:
        validate_ckmers(index, int(ri), index.refs.seq.to_str(int(ps[ri]), int(ps[ri + 1])),
                        query_fn=query, chunk=VALIDATE_CHUNK, device=dev)
    log(f"[gbp validate] validate_ckmers on references {list(map(int, edge))}: every k-mer at "
        f"its (ref, pos), {time.perf_counter() - t0:.2f} s")

    # the MPHF path; the mapper by the tier rule
    launches, _, profile = sshash_path("gbp main", cpu_index, gpu_index, work, uid, upos, fw,
                                       synth.MPHF_QUERY, capacity_probe, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches += mapping_phase("map gbp", index, gpu_index, cpu_index, capacity_probe, smi,
                                  tmp, driver="CompactQuery")
    reads = synth.serve_reads(index.refs, 1024, seed=1)
    card_hits = ReadMapper(index, query_index=gpu_index).map_reads(reads)
    cpu_hits = ReadMapper(index, query_index=cpu_index).map_reads(reads)
    for i, (a, b) in enumerate(zip(card_hits, cpu_hits)):
        if a.n_hit != b.n_hit or any(not np.array_equal(x, y) for x, y in zip(a.csr(), b.csr())):
            raise AssertionError(f"[map gbp] read {i}: the card's hits differ from the CPU's")
    log(f"[map gbp] the first 1024 reads' hits ({sum(r.n_hit for r in card_hits)}) equal "
        f"ReadMapper's on CPU tensors read by read")
    k3_record["launches"] += launches
    profile()
    del profile, cpu_index, gpu_index, d, k2u, host, index, fw
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[gbp] phase 20 in {time.perf_counter() - phase_t0:.1f} s; its K3 launches {launches} "
        f"(main path and mapper)")


def mono2_profile(host: dict, fw: torch.Tensor, m2: int, times: dict, serve: dict,
                  stream: dict):
    """Phase 18's mono2 passes: the index moved to the card again from its
    host arrays, a replayed and an eager pass of the main path, of the
    serve pass (``serve``: its bitsets, batch buffer, Meta, capacity and
    pass times) and of the flat streaming pass (``stream``: its k-mer
    matrix, validity and pass times) to warm it (the first of each captures
    its graph again), each profiled, and the index freed."""
    def run():
        index = QueryIndex(arrays_from_numpy(host, "cpu")).to(fw.device)
        og = OneGraphIndexQuery(index, BATCH, n_chunks=CH, m2=m2)
        og_eager = OneGraphIndexQuery(index, BATCH, n_chunks=CH, m2=m2, graph=False)
        og.checksum_pass_rolled(fw)
        og_eager.checksum_pass_rolled(fw)
        profile_both("mono2 main", lambda: og.checksum_pass_rolled(fw),
                     lambda: og_eager.checksum_pass_rolled(fw), times)
        sp, sp_eager = (RunServePass(index, serve["cb"], synth.SERVE_READS, synth.SERVE_CHUNKS,
                                     serve["m2"], synth.READ_LEN, probe_limit=PLIM, graph=g)
                        for g in (True, False))

        def device_pass(p):
            return lambda: (p.device_pass(serve["flat"], serve["meta"]),
                            torch.cuda.synchronize())

        for p in (sp, sp_eager):
            device_pass(p)()
        profile_both("serve", device_pass(sp), device_pass(sp_eager), serve["times"])
        kmat = torch.from_numpy(stream["kms"].view(np.int64)).to(fw.device)
        vt = torch.from_numpy(stream["valid"]).to(fw.device)
        flat, flat_eager = (StreamingIndex(index, mode="flat", graph=g) for g in (True, False))

        def flat_pass(si):
            return lambda: (si.k2u_device(kmat, vt), torch.cuda.synchronize())

        for si in (flat, flat_eager):
            flat_pass(si)()
        profile_both("stream flat", flat_pass(flat), flat_pass(flat_eager), stream["times"])
        del og, og_eager, sp, sp_eager, flat, flat_eager, index
        torch.cuda.empty_cache()
    return run


def graph_and_eager(tag: str, index, graph_pass, eager_pass, x: torch.Tensor, want: int,
                    n_queries: int, passes: int, probe, smi):
    """A path's pass over ``x`` as one CUDA graph and eagerly (phases 6, 7,
    8, 12, 17; ``graph_pass`` and ``eager_pass`` take the input and return
    the checksum, or (checksum, worst overflow)). The launch counts are set
    to 0 just before the first replayed pass (the eager warm-up, the
    capture and a replay), which must launch ``probe``'s kernel (the K2U
    kernel of the path; None for the pf1 paths, which have none); the
    graph's capture time and memory pool are read from ``index.graphs``.
    The replayed pass and the eager one must give the same checksum,
    ``want`` (the chunk count times the CPU oracle's), and agree again on
    an input whose lane 0 holds lane 1's word, which the graph must read
    from its input buffer; then ``passes`` passes of each, timed in turns.
    Returns (the kernel's launches, the worst overflow the pass returned,
    the median seconds of a pass of each kind)."""
    def chk_of(res):
        return res[0] if isinstance(res, tuple) else res

    reset_launches()
    t0 = time.perf_counter()
    res = graph_pass(x)
    first_s = time.perf_counter() - t0
    launches = probe.LAUNCHES if probe else None
    if probe and launches == 0:
        raise AssertionError(f"[{tag}] the replayed pass never launched the "
                             f"{probe.SOURCE.stem} kernel")
    chk, worst = res if isinstance(res, tuple) else (res, None)
    cap = list(index.graphs.values())[-1]
    eager_chk = chk_of(eager_pass(x))
    if not chk == eager_chk == want:
        raise AssertionError(f"[{tag}] replayed checksum {chk}, eager {eager_chk}, oracle x chunks "
                             f"{want}")
    other = x.clone()
    other[0] = x[1]
    other_chk = chk_of(graph_pass(other))
    if other_chk != chk_of(eager_pass(other)) or other_chk == want:
        raise AssertionError(f"[{tag}] on a changed input the replayed pass gives {other_chk}, "
                             f"the eager pass {chk_of(eager_pass(other))}")
    name = f", {probe.SOURCE.stem} launches {launches} (the eager warm-up's and the captured)" \
        if probe else ""
    log(f"[{tag}] first replayed pass {first_s:.3f} s (capture {cap.capture_s:.3f} s of it; "
        f"graph pool {cap.pool_bytes} bytes): checksum {chk} == eager == oracle x chunks{name}; "
        f"with lane 0 changed, replayed == eager {other_chk} ({smi})")
    t = {"graph": [], "eager": []}
    for _ in range(passes):
        for kind, run in (("graph", graph_pass), ("eager", eager_pass)):
            t0 = time.perf_counter()
            out = run(x)
            t[kind].append(time.perf_counter() - t0)
            if chk_of(out) != want:
                raise AssertionError(f"[{tag}] timed {kind} pass checksum differs")
    for kind in ("graph", "eager"):
        rates = sorted(n_queries / s for s in t[kind])
        log(f"[{tag}] {kind} pass, {passes} in turns: median {statistics.median(rates):.1f} "
            f"queries/s (min {rates[0]:.1f}, max {rates[-1]:.1f}) ({smi})")
    return launches, worst, {kind: statistics.median(v) for kind, v in t.items()}


def profile_both(tag: str, run_graph, run_eager, times: dict):
    """Phase 18: one profiled replayed pass and one profiled eager pass
    (the eager one only before ``EAGER_PROFILE_UNTIL_S``)."""
    profile_pass(f"{tag} graph", run_graph, times["graph"])
    now = time.perf_counter() - T0
    if now > EAGER_PROFILE_UNTIL_S:
        log(f"[profile {tag} eager] not profiled: the run is at {now:.1f} s, past "
            f"{EAGER_PROFILE_UNTIL_S:.0f} s")
        return
    profile_pass(f"{tag} eager", run_eager, times["eager"])


def derived_capture_raises(dev):
    """A tensor that a wrapper derives from an index, first asked for
    inside a CUDA graph capture, raises rather than come from the graph's
    pool."""
    src = torch.zeros(4, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            derived(src, "a check", lambda: src + 1)
    except RuntimeError as e:
        if "CUDA graph capture" not in str(e):
            raise
        log(f"[graph] a derived tensor first asked for during capture raises: {e}")
    else:
        raise AssertionError("a derived tensor was made inside a CUDA graph capture")
    del graph
    torch.cuda.synchronize()


def kcdict_rest(args, dev, smi: str) -> None:
    """Phases 22a-22b: the cuckoo KCDict through the CLI (``index build
    piscem --engine cuckoo`` over ``--cuckoo-mbp`` of synth's genome as
    cuttlefish files, its padded query on the card against the CPU and the
    sampled truth, ``validate-fasta``; ``kphf build cuckoo --validate`` over
    ``--cuckoo-kphf-mbp``, since it places the same keys again on the host),
    then a wide-slot mono2 dictionary (a unitig of 2^24 bases) and the mono
    layout of the same keys, queried on the card against the CPU; K1 never
    sees the wide dictionary."""
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.io import checkpoint
    from mazu_tpu_torch.kphf.kcdict import KCDict

    phase_t0 = time.perf_counter()
    c_bases, kc_bases = int(args.cuckoo_mbp * 1e6), int(args.cuckoo_kphf_mbp * 1e6)
    with tempfile.TemporaryDirectory() as tmp:
        prefix, kprefix, fa, npz, knpz = (os.path.join(tmp, x)
                                          for x in ("c", "kc", "c.fa", "c.npz", "k.npz"))
        synth.write_cf(prefix, c_bases, fasta=fa)
        synth.write_cf(kprefix, kc_bases)
        _, build_s = run_cli("cli cuckoo", ["index", "build", "piscem", "-p", prefix, "-o", npz,
                                            "--engine", "cuckoo"])
        ci = checkpoint.load_index(npz)
        kc = ci.k2u
        if kc.scheme != "cuckoo" or kc.side is not None:
            raise AssertionError(f"[cli cuckoo] built {kc.scheme}")
        _, val_s = run_cli("cli cuckoo", ["index", "validate-fasta", "-i", npz, "-f", fa])
        _, kb_s = run_cli("cli cuckoo", ["kphf", "build", "cuckoo", "-p", kprefix, "-o", knpz,
                                         "--validate"])
    host = ci.device_arrays()
    work, uid, off, foreign = synth.sample_queries_truth(kc.unitigs, BATCH, seed=3)
    work_cpu = torch.from_numpy(work.view(np.int64))
    fw = work_cpu.to(dev)
    gq = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    mo = gq.max_occs
    want = get_ref_pos_padded(arrays_from_numpy(host, "cpu"), work_cpu, mo)
    reset_launches()
    got = get_ref_pos_padded(gq.arrays(), fw, mo)
    for key, w in want.items():
        g = got[key].cpu()
        if w.dim() == 2:
            g, w = torch.where(want["valid"], g, 0), torch.where(want["valid"], w, 0)
        if not torch.equal(g, w):
            raise AssertionError(f"[cuckoo] the padded query on the card differs from the CPU in "
                                 f"{key}")
    hit = want["mt"].numpy() > 0
    if not (hit[~foreign].all() and not hit[foreign].any()
            and np.array_equal(want["unitig_id"].numpy()[~foreign], uid[~foreign])
            and np.array_equal(want["pos"].numpy()[~foreign], off[~foreign])):
        raise AssertionError("[cuckoo] the query disagrees with the sampled lanes")
    pad_ms = cuda_ms(lambda: get_ref_pos_padded(gq.arrays(), fw, mo), 5)
    k2u_ms = cuda_ms(lambda: kcdict_k2u(gq.arrays()["k2u"], fw), 10)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    log(f"[cuckoo] {c_bases} bases ({kc.n_kmers} k-mers), T={kc.T} buckets of "
        f"{kc.table.nbytes} table bytes (the card's L2: {l2}), salt {kc.salt}: "
        f"build through the CLI {build_s:.2f} s, validate-fasta {val_s:.2f} s, kphf build "
        f"--validate over {kc_bases} bases {kb_s:.2f} s; padded query of {BATCH} on the card "
        f"equals the CPU and the sampled truth: {pad_ms:.3f} ms, its two-row K2U "
        f"{k2u_ms:.3f} ms; "
        f"{gq.nbytes()} bytes on the card ({smi})")
    del gq, got, want, ci, host

    mark("22b")
    # 22b. wide slots: a unitig of 2^24 bases
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    L = 1 << 24
    codes = rng.integers(0, 4, L + 6 * 200).astype(np.uint8)
    accum = np.concatenate([[0, L], L + 200 * np.arange(1, 7)]).astype(np.int64)
    us = UnitigSet(31, SeqVector.from_codes(codes), accum)
    occ = (np.array([0, 0, 1, 2, 3, 4, 5, 6]), np.array([0, 7, 1, 2, 3, 4, 5, 6]),
           np.array([0, 9, 0, 0, 0, 0, 0, 0]), np.array([1, 0, 1, 1, 1, 1, 1, 1]))
    lens = np.array([L] + [200] * 6 + [L + 9])
    names = [f"r{i}" for i in range(8)]
    u2 = SPT(us, names, *occ, lens).piscem_table()
    wide = KCDict.from_unitig_set(us, 0.5, u2, "mono2")
    wide_s = time.perf_counter() - t0
    if wide.slot_words != 10 or wide.occ32:
        raise AssertionError(f"[wide] {wide.slot_words}-word slots, occ32={wide.occ32}")
    wmo = max(1, u2.max_occs())
    wi = ModIndex(wide, u2, synth.RefSeqCollection.from_lens(lens, names), index_type="t")
    host2 = wi.device_arrays(fused=True)
    t2, s2 = wide.table.reshape(wide.T, 2, 10), wide.side.reshape(-1, 2, 10)
    mono = {**host2["k2u"], "table": t2[:, :, :8].reshape(wide.T, 16),
            "side": s2[:, :, :8].reshape(-1, 16),
            "meta": host2["k2u"]["meta"].replace(scheme="mono", sw=8, split=False)}
    pos = rng.permutation(np.concatenate([rng.integers(0, L - 31, BATCH - 4096),
                                          accum[1] + rng.integers(0, 1169, 4096)]))
    words = us.get_kmer_u64(pos)
    flip = rng.random(BATCH) < 0.5
    words[flip] = revcomp_np(words[flip], 31)
    words_cpu = torch.from_numpy(words.view(np.int64))
    wfw = words_cpu.to(dev)
    head = min(LAYOUT_ORACLE, BATCH)
    for name, kd in (("mono2", host2["k2u"]), ("mono", mono)):
        cpu_d, gpu_d = arrays_from_numpy(kd, "cpu"), arrays_from_numpy(kd, dev)
        for mode in ("main", "full"):
            want = kcdict_k2u(cpu_d, words_cpu[:head], mode=mode)
            got = kcdict_k2u(gpu_d, wfw, mode=mode)
            for key, w in want.items():
                if not torch.equal(got[key][:head].cpu(), w):
                    raise AssertionError(f"[wide] {name} {mode}: the card differs from the CPU "
                                         f"in {key}")
        if int((want["unitig_len"] == L).sum()) == 0:
            raise AssertionError("[wide] no lane in the 2^24-base unitig")
        wms = cuda_ms(lambda: kcdict_k2u(gpu_d, wfw), 5)
        log(f"[wide] {name} {kd['meta'].sw}-word slots: main and full K2U of {BATCH} on the "
            f"card, the first {head} equal to the CPU ({int((want['mt'] > 0).sum())} hits, "
            f"{int((want['unitig_len'] == L).sum())} in the 2^24-base unitig); full {wms:.3f} ms "
            f"({smi})")
        del cpu_d, gpu_d
    wq = QueryIndex(arrays_from_numpy(host2, "cpu")).to(dev)
    reset_launches()
    get_ref_pos_compact(wq.arrays(), wfw, wmo, m2=BATCH // 4)
    got = get_ref_pos_compact(wq.arrays(), wfw[:head], wmo, m2=head // 4)
    if mono2_probe.LAUNCHES:
        raise AssertionError("[wide] K1 ran on a wide mono2 dictionary")
    want = get_ref_pos_compact(arrays_from_numpy(host2, "cpu"), words_cpu[:head], wmo,
                               m2=head // 4)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid", "over_budget"):
        if not torch.equal(got[key].cpu(), want[key]):
            raise AssertionError(f"[wide] the compact query differs from the CPU in {key}")
    log(f"[wide] mono2 build on the host {wide_s:.1f} s ({wide.n_kmers} k-mers, T={wide.T}, "
        f"side T={wide.side_T}); get_ref_pos_compact of {BATCH} on the card with no K1 "
        f"launch, the first {head} equal to the CPU's; {wq.nbytes()} bytes on the card; phase 22 in "
        f"{time.perf_counter() - phase_t0:.1f} s")
    del wq, got, want, wide, wi, host2, mono
    torch.cuda.empty_cache()


def speed_shards(index, fw: torch.Tensor, dev, smi: str) -> None:
    """Phase 23b on synth50-speed's fused inline2 rows: the fused sharded
    query through ``SerialMesh`` at 1x4 and 2x4 against the unsharded query
    on the card (held to the CPU on 2^16 lanes); then a sharded checkpoint
    of four shards saved, loaded shard by shard onto the card and queried,
    and ``validate_k2u_self_sharded`` through the loaded query."""
    from mazu_tpu_torch.index.validate import validate_k2u_self_sharded
    from mazu_tpu_torch.io import sharded_ckpt
    from mazu_tpu_torch.parallel import sharding
    from mazu_tpu_torch.parallel.mesh import SerialMesh

    phase_t0 = time.perf_counter()
    host = index.device_arrays(**synth.SPEED_LAYOUT)
    gq = QueryIndex(arrays_from_numpy(host, "cpu")).to(dev)
    d, mo, m2 = gq.arrays(), gq.max_occs, SHARD_M2

    def single(f):
        return get_ref_pos_compact(d, f, mo, merge=False, m2=m2, probe_limit=2)

    head = 1 << 16
    want = get_ref_pos_compact(arrays_from_numpy(host, "cpu"), fw[:head].cpu(), mo, m2=head,
                               probe_limit=2)
    got = get_ref_pos_compact(d, fw[:head], mo, m2=head, probe_limit=2)
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        if not torch.equal(got[kk].cpu(), want[kk]):
            raise AssertionError(f"[shard fused] the unsharded card query differs from the CPU "
                                 f"in {kk}")
    del host, got, want
    single_s = wall_s(lambda: single(fw))
    t0 = time.perf_counter()
    shared, stacked = sharding.shard_fused_arrays(index, 4)
    part_s = time.perf_counter() - t0
    shared_dev, stacked_dev = sharding.place_sharded(shared, stacked, SerialMesh(1, 4, dev))
    del stacked
    for nd in (1, 2):
        mesh = SerialMesh(nd, 4, dev)
        q = sharding.build_fused_sharded_query(shared, shared_dev, stacked_dev, mesh, m2=m2,
                                               max_occs=mo)
        check_sharded(f"fused {nd}x4", q(fw), single, fw, nd, m2)
        mesh.reset_seconds()
        shard_log("shard fused", mesh, shared_dev, stacked_dev, wall_s(lambda: q(fw)), single_s,
                  smi)
    del shared_dev, stacked_dev, q
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "fused")
        t0 = time.perf_counter()
        sharded_ckpt.save_fused_sharded(ck, index, 4)
        save_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(ck, f)) for f in sorted(os.listdir(ck))}
        t0 = time.perf_counter()
        mesh = SerialMesh(2, 4, dev)
        q = sharded_ckpt.make_fused_sharded_query_from_ckpt(ck, mesh, m2=m2)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check_sharded("fused ckpt 2x4", q(fw), single, fw, 2, m2)
    log(f"[shard ckpt] four fused shards of synth50-speed: partition {part_s:.1f} s, save "
        f"(the partition again, savez_compressed) {save_s:.1f} s, load shard by shard onto the card {load_s:.1f} s; "
        f"files {files}; the loaded query (2x4) equals the unsharded query on {BATCH} lanes")
    # validate_k2u_self_sharded: every k-mer if a batch's rate allows 60 s;
    # a data shard's phase 2 holds all its lanes (sequential k-mers cluster
    # in the 3-occurrence unitigs)
    n_all = index.k2u.unitigs.n_kmers
    batch = 2 * m2
    t0 = time.perf_counter()
    validate_k2u_self_sharded(q, index.k2u, batch=batch, n_kmers=batch)
    per = time.perf_counter() - t0
    n_val = n_all if per * n_all / batch <= 60 else max(1, int(15 / per)) * batch
    t0 = time.perf_counter()
    validate_k2u_self_sharded(q, index.k2u, batch=batch, n_kmers=n_val)
    log(f"[shard ckpt] validate_k2u_self_sharded through the loaded query: "
        f"{'every k-mer' if n_val >= n_all else f'the first {n_val} of {n_all} k-mers'}, both "
        f"strands, in {time.perf_counter() - t0:.1f} s (a batch of {batch}: {per:.2f} s); "
        f"phase 23b in {time.perf_counter() - phase_t0:.1f} s ({smi})")
    del q, gq
    torch.cuda.empty_cache()


def bucket_alltoall(ss, k2u: dict, cpu_k2u: dict, fw: torch.Tensor, dev, smi: str) -> None:
    """The bucket-sharded and all-to-all K2U of SSHash ``ss`` (one
    partition, four shards) through ``SerialMesh`` at 1x4 and 2x4, against
    the unsharded full-mode K2U on the card's arrays ``k2u`` (held to
    ``cpu_k2u``, the same arrays on the CPU, on 2^16 lanes); the all-to-all
    query's ``routed_ok`` share."""
    from mazu_tpu_torch.parallel import sharding
    from mazu_tpu_torch.parallel.mesh import SerialMesh

    want = sshash_k2u(k2u, fw)
    head = 1 << 16
    cpu = sshash_k2u(cpu_k2u, fw[:head].cpu())
    for kk in ("unitig_id", "unitig_len", "pos", "mt"):
        if not torch.equal(want[kk][:head].cpu(), cpu[kk]):
            raise AssertionError(f"[shard bucket] the unsharded K2U differs from the CPU in {kk}")
    single_s = wall_s(lambda: sshash_k2u(k2u, fw))
    t0 = time.perf_counter()
    shared, stacked = sharding.shard_sshash_buckets(ss, 4)
    part_s = time.perf_counter() - t0
    shared_dev, stacked_dev = sharding.place_sharded(shared, stacked, SerialMesh(1, 4, dev))
    del shared, stacked
    n_buckets = len(ss.occs_prefix_sum) - 1
    for nd in (1, 2):
        mesh = SerialMesh(nd, 4, dev)
        for name, build in (
                ("bucket", sharding.build_bucket_sharded_query),
                ("alltoall", lambda *a: sharding.build_alltoall_sharded_query(*a, n_buckets))):
            q = build(shared_dev, stacked_dev, mesh)
            got = q(fw)
            ok = got.get("routed_ok", torch.ones_like(fw, dtype=torch.bool))
            for kk in ("unitig_id", "unitig_len", "pos", "mt"):
                if not torch.equal(torch.where(ok, got[kk], 0), torch.where(ok, want[kk], 0)):
                    raise AssertionError(f"[shard {name}] {nd}x4 differs from the unsharded K2U "
                                         f"in {kk}")
            mesh.reset_seconds()
            qs = wall_s(lambda: q(fw))
            share = f", routed_ok {float(ok.float().mean()):.6f}" if name == "alltoall" else ""
            shard_log(f"shard {name} (equals the unsharded K2U on the routed lanes{share})", mesh,
                      shared_dev, stacked_dev, qs, single_s, smi)
            del q, got
    log(f"[shard bucket] bucket and all-to-all queries in {time.perf_counter() - t0:.1f} s "
        f"(partition {part_s:.1f} s)")
    del shared_dev, stacked_dev
    torch.cuda.empty_cache()


def capacity_shards(index, gpu_index, cpu_k2u: dict, fw: torch.Tensor, dev, smi: str) -> None:
    """Phase 23c on synth300-capacity's direct SSHash: the bucket-sharded
    and all-to-all K2U (``bucket_alltoall``; ``cpu_k2u``: the index's K2U
    arrays on the CPU), then the compact sharded query with and without the
    ``bpos`` rows and ``useqrec`` records, through ``SerialMesh`` at 1x4
    and 2x4, its merged answers against the unsharded padded query on the
    card."""
    from mazu_tpu_torch.index.validate import merge_sharded_out
    from mazu_tpu_torch.parallel import sharding
    from mazu_tpu_torch.parallel.mesh import SerialMesh

    phase_t0 = time.perf_counter()
    d = gpu_index.arrays()
    bucket_alltoall(index.k2u, d["k2u"], cpu_k2u, fw, dev, smi)
    mo, m2 = gpu_index.max_occs, SHARD_M2
    padded = get_ref_pos_padded(d, fw, mo)
    padded_s = wall_s(lambda: get_ref_pos_padded(d, fw, mo))
    for bi_uq in (False, True):
        t0 = time.perf_counter()
        shared, stacked = sharding.shard_compact_arrays(index, 4, bucket_inline=bi_uq,
                                                        useqrec=bi_uq)
        part_s = time.perf_counter() - t0
        shared_dev, stacked_dev = sharding.place_sharded(shared, stacked, SerialMesh(1, 4, dev))
        del stacked
        for nd in (1, 2):
            mesh = SerialMesh(nd, 4, dev)
            q = sharding.build_compact_sharded_query(shared, shared_dev, stacked_dev, mesh, m2=m2,
                                                     max_occs=mo, probe_limit=3)
            out = q(fw)
            if bool(out["over_budget"].any()):
                raise AssertionError("[shard compact] over budget")
            merged = merge_sharded_out(cpu_tree(
                {kk: out[kk] for kk in ("main", "lanes", "slot_real", "n_ovf", "phase2")}))
            for kk in ("unitig_id", "unitig_len", "pos", "mt"):
                if not np.array_equal(merged[kk], padded[kk].cpu().numpy()):
                    raise AssertionError(f"[shard compact] {nd}x4 bpos/useqrec={bi_uq}: merged "
                                         f"{kk} differs from the unsharded padded query")
            mesh.reset_seconds()
            shard_log(f"shard compact bpos+useqrec={bi_uq} (partition {part_s:.1f} s; the "
                      f"unsharded: the padded query)", mesh, shared_dev, stacked_dev,
                      wall_s(lambda: q(fw)), padded_s, smi)
            del q, out
        del shared_dev, stacked_dev, shared
        torch.cuda.empty_cache()
    log(f"[shard cap] phase 23c in {time.perf_counter() - phase_t0:.1f} s")


# ---------------------------------------------------------------- 22-23
def cpu_tree(t):
    if isinstance(t, dict):
        return {kk: cpu_tree(v) for kk, v in t.items()}
    return t.cpu()


def wall_s(fn) -> float:
    """Seconds of one call, the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_pieces(tag: str, got: dict, want: dict) -> None:
    """A sharded query's ``merge=False`` pieces of one data shard equal the
    unsharded query's: every field, but phase-2 slots past the flagged
    count and projections of invalid occurrences."""
    def eq(a, b, what, mask=None):
        a, b = a.cpu(), b.cpu()
        if mask is not None:
            m = mask if mask.dim() == a.dim() else mask[:, None]
            a, b = torch.where(m, a, 0), torch.where(m, b, 0)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"[{tag}] {what} differs from the unsharded query")

    for key in ("overflow", "slot_real", "n_ovf", "over_budget"):
        eq(got[key].reshape(want[key].shape), want[key], key)
    sr = want["slot_real"].cpu()
    eq(got["lanes"], want["lanes"], "lanes", sr)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        eq(got["main"][key], want["main"][key], f"main {key}")
    for key in ("ref_id", "ref_pos", "orient"):
        eq(got["main"][key], want["main"][key], f"main {key}", want["main"]["valid"].cpu())
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        eq(got["phase2"][key], want["phase2"][key], f"phase2 {key}", sr)
    v2 = want["phase2"]["valid"].cpu() & sr[:, None]
    eq(got["phase2"]["valid"].cpu() & sr[:, None], v2, "phase2 valid")
    for key in ("ref_id", "ref_pos", "orient"):
        eq(got["phase2"][key], want["phase2"][key], f"phase2 {key}", v2)


def data_shard(out: dict, d: int, n_data: int, n: int, m2: int) -> dict:
    """Data shard ``d``'s pieces of a sharded ``merge=False`` result."""
    lane, slot = slice(d * (n // n_data), (d + 1) * (n // n_data)), slice(d * m2, (d + 1) * m2)
    return {"main": {kk: v[lane] for kk, v in out["main"].items()},
            "overflow": out["overflow"][lane], "lanes": out["lanes"][slot],
            "slot_real": out["slot_real"][slot],
            "phase2": {kk: v[slot] for kk, v in out["phase2"].items()},
            "n_ovf": out["n_ovf"][d], "over_budget": out["over_budget"][d]}


def check_sharded(tag: str, out: dict, single, fw: torch.Tensor, n_data: int, m2: int) -> None:
    """Each data shard of ``out`` against ``single(fw slice)``, the
    unsharded query on one card."""
    n = fw.shape[0]
    for d in range(n_data):
        same_pieces(f"{tag} data shard {d}", data_shard(out, d, n_data, n, m2),
                    single(fw[d * (n // n_data): (d + 1) * (n // n_data)]))


def shard_log(tag: str, mesh, shared_dev: dict, stacked_dev: dict, query_s: float,
              single_s: float, smi: str) -> None:
    """Per-shard seconds (``SerialMesh.seconds``), bytes a shard and the
    whole, and the query's time over the unsharded query's."""
    per = ", ".join(f"({d},{b}) {t * 1e3:.1f}" for (d, b), t in mesh.seconds.items())
    shard_b = [tree_bytes({k: v for k, v in stk.items() if isinstance(v, torch.Tensor)})
               for stk in stacked_dev.values()]
    log(f"[{tag}] {mesh.n_data}x{mesh.n_bucket}: query {query_s * 1e3:.1f} ms, unsharded "
        f"{single_s * 1e3:.1f} ms ({query_s / single_s:.2f}x); per shard (data, bucket) ms: "
        f"{per}; bytes a shard {shard_b}, shared {tree_bytes(shared_dev)}, whole "
        f"{sum(shard_b) + tree_bytes(shared_dev)} ({smi})")


def mono2_shards(index, host: dict, gpu_index, work: np.ndarray, fw: torch.Tensor, dev,
                 smi: str) -> int:
    """Phases 22c and 23a on the synth50 mono2 index: ``bucket_range`` on
    four shards of its table, then the data-parallel query (K1 on every
    data rank) and the mono sharded query through ``DistMesh`` over NCCL at
    world size 1 and through ``SerialMesh`` at 1x4 and 2x4, each held to
    the unsharded query on the card, which is held to the CPU. Returns the
    data-parallel queries' K1 launches."""
    import functools

    import torch.distributed as dist

    from mazu_tpu_torch.index.validate import merge_sharded_out
    from mazu_tpu_torch.parallel import sharding
    from mazu_tpu_torch.parallel.mesh import DistMesh, SerialMesh

    phase_t0 = time.perf_counter()
    d = gpu_index.arrays()
    mo = gpu_index.max_occs
    n = BATCH
    m2 = SHARD_M2
    shared, stacked = sharding.shard_mono_arrays(index, 4)
    mesh4 = SerialMesh(1, 4, dev)
    t0 = time.perf_counter()
    shared_dev, stacked_dev = sharding.place_sharded(shared, stacked, mesh4)
    torch.cuda.synchronize()
    log(f"[shard mono] four shards of the table ({stacked['table'].shape}) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    del stacked

    mark("22c")
    # 22c. bucket_range: the shards' one-hot sum is the whole table's answer
    for mode in ("main", "full"):
        whole = kcdict_k2u(d["k2u"], fw, mode=mode)
        total = {kk: torch.zeros_like(v, dtype=torch.int64) for kk, v in whole.items()}
        owners = torch.zeros(n, dtype=torch.int64, device=dev)
        for b, stk in stacked_dev.items():
            r = kcdict_k2u({**shared_dev["k2u"], "table": stk["table"]}, fw, mode=mode,
                           bucket_range=(stk["blo"], stk["bhi"]))
            hit = r["mt"] > 0
            owners += (hit | r["unresolved"] if mode == "main" else hit).to(torch.int64)
            for kk, v in r.items():
                total[kk] += v.to(torch.int64)
        for kk, v in whole.items():
            if not torch.equal(total[kk], v.to(torch.int64)):
                raise AssertionError(f"[bucket_range] {mode}: the shards' sum differs in {kk}")
        if mode == "main":
            if not bool((owners == 1).all()):
                raise AssertionError("[bucket_range] main: a lane without exactly one owner")
            unres = whole["unresolved"]
        else:
            side = unres & (whole["mt"] > 0)
            if int(side.sum()) == 0 or int(owners[side].max()) != 1 or int(owners.max()) > 1:
                raise AssertionError("[bucket_range] full: side-table hits not from one owner")
            log(f"[bucket_range] four shards of synth50 mono2, main and full mode on {n} lanes: "
                f"the one-hot sum equals the whole table's answer; every lane has one owner in "
                f"main mode; {int(side.sum())} side-table hits, each from its owner alone")
    del whole, total, owners, r

    # the unsharded query on the card, held to the CPU on the first 2^16 lanes
    def single(f):
        return get_ref_pos_compact(d, f, mo, merge=False, m2=m2)

    cpu = arrays_from_numpy(host, "cpu")
    head = 1 << 16
    want = get_ref_pos_compact(cpu, torch.from_numpy(work[:head].view(np.int64)), mo, m2=head)
    got = get_ref_pos_compact(d, fw[:head], mo, m2=head)
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        if not torch.equal(got[kk].cpu(), want[kk]):
            raise AssertionError(f"[shard mono] the unsharded card query differs from the CPU "
                                 f"in {kk}")
    del got, want, cpu
    single_s = wall_s(lambda: single(fw))

    dp_pipe = functools.partial(get_ref_pos_compact, max_occs=mo, merge=False, m2=m2)
    launches = 0
    mark("23a")
    # 23a. DistMesh over NCCL, world size 1 (NCCL takes one rank a card)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            dmesh = DistMesh(1, 1, device=dev)
            reset_launches()
            _, dpq = sharding.make_data_parallel_query(gpu_index, dp_pipe, dmesh)
            out = dpq(fw)
            launches += mono2_probe.LAUNCHES
            check_sharded("dp nccl", out, single, fw, 1, m2)
            mq = sharding.make_mono_sharded_query(index, dmesh, m2=m2, max_occs=mo)
            out = mq(fw)
            check_sharded("mono nccl", out, single, fw, 1, m2)
            log(f"[shard nccl] DistMesh over NCCL at world size 1: the data-parallel query "
                f"(K1 launched) and the mono sharded query equal the unsharded query on {n} "
                f"lanes; query {wall_s(lambda: mq(fw)) * 1e3:.1f} ms")
            del mq, out
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    for nd in (1, 2):
        mesh = SerialMesh(nd, 4, dev)
        reset_launches()
        _, dpq = sharding.make_data_parallel_query(gpu_index, dp_pipe, mesh)
        out = dpq(fw)
        launches += mono2_probe.LAUNCHES
        if mono2_probe.LAUNCHES != nd * 4:
            raise AssertionError(f"[shard dp] {mono2_probe.LAUNCHES} K1 launches on {nd}x4")
        check_sharded(f"dp {nd}x4", out, single, fw, nd, m2)
        mesh.reset_seconds()
        dp_s = wall_s(lambda: dpq(fw))
        log(f"[shard dp] {nd}x4: equals the unsharded query; K1 launched on every rank; "
            f"{dp_s * 1e3:.1f} ms, per rank ms "
            f"{[round(t * 1e3, 1) for t in mesh.seconds.values()]} ({smi})")
        mq = sharding.build_mono_sharded_query(shared, shared_dev, stacked_dev, mesh, m2=m2,
                                               max_occs=mo)
        out = mq(fw)
        check_sharded(f"mono {nd}x4", out, single, fw, nd, m2)
        merged = merge_sharded_out(cpu_tree(
            {kk: out[kk] for kk in ("main", "lanes", "slot_real", "n_ovf", "phase2")}))
        if not (merged["mt"] > 0).sum() > 0.9 * n:
            raise AssertionError("[shard mono] fewer hits than the batch's share")
        mesh.reset_seconds()
        shard_log("shard mono", mesh, shared_dev, stacked_dev, wall_s(lambda: mq(fw)),
                  single_s, smi)
        del out, mq
    log(f"[shard mono] phases 22c and 23a in {time.perf_counter() - phase_t0:.1f} s")
    return launches


def profile_pass(tag: str, run, pass_s: float) -> float:
    """One profiled pass (``run()``): device busy share, kernel launches,
    the kernels that take the most device time and the probe kernels.
    Returns the device busy microseconds."""
    from torch.profiler import ProfilerActivity, profile

    # device activity alone first: the host ops' records cost seconds a
    # pass to sum and no line reads them
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if events:
            break
    if not events:
        log(f"[profile {tag}] the profiler gave no per-kernel device records for this pass")
    busy_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    log(f"[profile {tag}] profiled pass {wall * 1e3:.1f} ms (unprofiled {pass_s * 1e3:.1f} ms); device "
        f"busy {busy_us / 1e3:.2f} ms = {100 * busy_us / (pass_s * 1e6):.1f}% of an unprofiled "
        f"pass; {n_kernels} device kernels")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the twelve that take the most time, and every probe kernel of the repo
    for e in ranked[:12] + [e for e in ranked[12:] if "_probe_kernel" in e.key]:
        log(f"[profile {tag}] {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")
    return busy_us


if __name__ == "__main__":
    main()
