"""The benchmark's sequence set handed to the port: its unitig set,
references and occurrence table as the port's own host containers."""

from __future__ import annotations

from mazu_tpu_torch.bits.seqvector import SeqVector
from mazu_tpu_torch.containers.refseq import RefSeqCollection
from mazu_tpu_torch.containers.unitig_set import UnitigSet
from mazu_tpu_torch.index.spt import SPT


def port_genome(genome):
    """(UnitigSet, RefSeqCollection, SPT) of a ``portbench.genome.Genome``."""
    unitigs = UnitigSet(genome.k, SeqVector(genome.host_words, genome.n_bases), genome.accum)
    names = genome.names
    refs = RefSeqCollection(SeqVector(genome.ref_host_words, int(genome.ref_accum[-1])),
                            genome.ref_accum, names)
    spt = SPT(unitigs, names, genome.occ_uid, genome.occ_ref, genome.occ_pos, genome.occ_o,
              genome.ref_lens)
    return unitigs, refs, spt
