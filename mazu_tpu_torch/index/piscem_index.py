"""Index assembly from cuttlefish output (counterpart of
``mazu_tpu.index.piscem_index``): a K2U dictionary over the unitigs, the
occurrence table of the tiling, and the references' lengths.

``piscem_index_from_spt`` builds the piscem index: an SSHash (engine
``parity``, the reference's default, or ``fast32``/``direct``) or a KCDict
(``cuckoo`` at load 0.65, ``mono``/``mono2`` at load 0.25) over the packed
piscem table.
``pufferfish_dense_index_from_cf_prefix`` builds pufferfish's dense index:
a PFHash over the pf1 table. The dictionary builds run on ``device``, the
card by default.
"""

from __future__ import annotations

from ..io.cuttlefish import CfFiles
from ..kphf.pfhash import PFHash
from ..kphf.sshash import SSHash
from .modindex import ModIndex, index_metadata
from .spt import SPT

ENGINES = ("parity", "fast32", "direct", "cuckoo", "mono", "mono2")


def piscem_index_from_spt(spt: SPT, w: int, skew_param: int | None, seed: int = 0,
                          engine: str = "parity", device=None) -> ModIndex:
    table = spt.piscem_table()
    if engine in ("cuckoo", "mono", "mono2"):
        from ..kphf.kcdict import KCDict

        k2u = KCDict.from_unitig_set(spt.unitigs, load=0.65 if engine == "cuckoo" else 0.25,
                                     occ_table=table, scheme=engine)
    elif engine in ("parity", "fast32", "direct"):
        k2u = SSHash.from_unitig_set(spt.unitigs, w, skew_param=skew_param, seed=seed,
                                     engine=engine, device=device)
    else:
        raise ValueError(f"no {engine!r} engine: one of {', '.join(ENGINES)}")
    refs = spt.ref_seq_collection()
    return ModIndex(k2u, table, refs, index_type="Piscem", metadata=index_metadata(refs))


def piscem_index_from_cf_prefix(prefix: str, w: int, skew_param: int | None = 64, seed: int = 0,
                                engine: str = "parity", device=None) -> ModIndex:
    return piscem_index_from_spt(SPT.from_cf(CfFiles(prefix)), w, skew_param, seed, engine,
                                 device)


def pufferfish_dense_index_from_cf_prefix(prefix: str, device=None) -> ModIndex:
    """Pufferfish's dense index: a PFHash (64-bit BooPHF over every
    canonical k-mer) with the pf1 occurrence table."""
    spt = SPT.from_cf(CfFiles(prefix))
    k2u = PFHash.from_unitig_set(spt.unitigs, device=device)
    refs = spt.ref_seq_collection()
    return ModIndex(k2u, spt.dense_table(), refs, index_type="PufferfishDense",
                    metadata=index_metadata(refs))
