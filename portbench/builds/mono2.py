"""The mono2-occ32 KCDict index: every canonical k-mer in a one-hash
bucket table at ``load`` keys a slot with its unitig's first two
occurrence words, the keys that do not fit in a side table (the port's
host build, ``KCDict.from_unitig_set``), moved to the card as the K1
kernel reads it."""

from __future__ import annotations

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import ModIndex, QueryIndex
from mazu_tpu_torch.kphf.kcdict import KCDict

from .common import port_genome


def build(genome, cfg: dict, device):
    """(ModIndex, QueryIndex on ``device``)."""
    unitigs, refs, spt = port_genome(genome)
    u2pos = spt.piscem_table()
    k2u = KCDict.from_unitig_set(unitigs, load=float(cfg["load"]), occ_table=u2pos,
                                 scheme="mono2")
    index = ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")
    host = index.device_arrays()
    m = host["k2u"]["meta"]
    if not (m.scheme == "mono2" and m.occ32):
        raise RuntimeError(f"the index is {m.scheme} occ32={m.occ32}, not mono2-occ32")
    return index, QueryIndex(arrays_from_numpy(host, "cpu")).to(device)
