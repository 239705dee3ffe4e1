"""Load pufferfish (C++) serialized indexes into a ModIndex (counterpart of
``mazu_tpu.io.pf1_index``; host): the dense index (``PFHash``) and the
sparse one (``SampledPFHash``), each over the pf1 ``DenseUnitigTable``."""

from __future__ import annotations

import os

import numpy as np

from ..bits.bitvector import BitVector
from ..containers.refseq import RefSeqCollection
from ..containers.unitig_set import UnitigSet
from ..index.modindex import ModIndex
from ..index.unitig_table import DenseUnitigTable
from ..kphf.boophf import BooPHF
from ..kphf.pfhash import PFHash
from ..kphf.sampled import SampledPFHash
from .pf1 import (
    PF1FilePaths, load_info_json, read_compact_bit_vector, read_compact_int_vector,
    read_compact_seq_vector, read_ctable, read_ref_accum_lens,
)


def _load_unitig_set(files: PF1FilePaths, k: int) -> UnitigSet:
    """The useq and the boundary bitvector; unitig extents from the
    positions of its ones (each unitig's last base)."""
    useq = read_compact_seq_vector(files.seq)
    bv = read_compact_bit_vector(files.rank)
    ends = bv.select(np.arange(bv.count_ones()))
    accum = np.concatenate([[0], ends + 1]).astype(np.int64)
    return UnitigSet(k, useq, accum, bv=BitVector.from_set_positions(ends, len(useq)))


def _load_u2pos_refs(files: PF1FilePaths):
    ref_names, ref_exts, ctable = read_ctable(files.ctable)
    offsets = read_compact_int_vector(files.ctg_offsets).to_array().astype(np.int64)
    u2pos = DenseUnitigTable(ctable, offsets, ref_names, ref_exts)
    prefix_sum = read_ref_accum_lens(files.ref_accum_lens)
    seq = read_compact_seq_vector(files.ref_seq) if os.path.exists(files.ref_seq) else None
    return u2pos, RefSeqCollection(seq, prefix_sum, ref_names)


def load_sparse_index(dirname: str) -> ModIndex:
    """A pufferfish sparse (sampled) index directory."""
    files = PF1FilePaths(dirname)
    info = load_info_json(files.info_json)
    if info["sampling_type"] not in ("sparse", "Sparse"):
        raise ValueError(f"{dirname}: sampling_type {info['sampling_type']!r}, not sparse")
    unitigs = _load_unitig_set(files, info["k"])
    k2u = SampledPFHash(
        unitigs,
        BooPHF.from_pf1(files.mphf),
        sampled_pos=read_compact_int_vector(files.sample_pos),
        sampled_vec=read_compact_bit_vector(files.presence),
        canonical_vec=read_compact_bit_vector(files.canonical),
        direction_vec=read_compact_bit_vector(files.direction),
        ext_sizes=read_compact_int_vector(files.extension_lengths),
        ext_bases=read_compact_int_vector(files.extension_bases),
        sample_size=info["sample_size"],
        extension_size=info["extension_size"],
    )
    u2pos, refs = _load_u2pos_refs(files)
    return ModIndex(k2u, u2pos, refs, index_type="PF1Sparse", metadata=info)


def load_dense_index(dirname: str) -> ModIndex:
    """A pufferfish dense index directory."""
    files = PF1FilePaths(dirname)
    info = load_info_json(files.info_json)
    if info["sampling_type"] not in ("dense", "Dense"):
        raise ValueError(f"{dirname}: sampling_type {info['sampling_type']!r}, not dense")
    unitigs = _load_unitig_set(files, info["k"])
    pos = read_compact_int_vector(files.pos)
    if len(pos) != unitigs.n_kmers:
        raise ValueError(f"{dirname}: {len(pos)} positions for {unitigs.n_kmers} k-mers")
    k2u = PFHash(unitigs, BooPHF.from_pf1(files.mphf), pos)
    u2pos, refs = _load_u2pos_refs(files)
    return ModIndex(k2u, u2pos, refs, index_type="PF1Dense", metadata=info)
