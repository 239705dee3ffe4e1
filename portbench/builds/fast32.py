"""The SSHash fast32 index of the MPHF capacity tier: a BooPHF32 MPHF over
the unitigs' w-mer minimizers numbers their buckets, the heavy buckets'
k-mers go to a second BooPHF32 (the port's build, ``SSHash.from_unitig_set(
engine="fast32")``, on the card), laid out as ``synth.MPHF_LAYOUT`` (grouped16
bounds, packed positions, the paired unitig arrays and ``uproj`` records)
and moved to the card, where kernel K3 probes it."""

from __future__ import annotations

from mazu_tpu_torch import synth
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import ModIndex, QueryIndex
from mazu_tpu_torch.index.tuning import query_tier
from mazu_tpu_torch.kphf.sshash import SSHash

from .common import port_genome


def build(genome, cfg: dict, device):
    """(ModIndex, QueryIndex on ``device``)."""
    unitigs, refs, spt = port_genome(genome)
    u2pos = spt.piscem_table(device=device)
    k2u = SSHash.from_unitig_set(unitigs, w=int(cfg["w"]), skew_param=int(cfg["skew"]),
                                 gamma=float(cfg["gamma"]), engine="fast32", chunk=1 << 24,
                                 device=device)
    index = ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")
    if query_tier(index, device=device) != "capacity":
        raise RuntimeError("the tier rule does not keep the index in the capacity tier")
    host = index.device_arrays(**synth.MPHF_LAYOUT)
    m = host["k2u"]["meta"]
    if not (m.kind == "sshash" and m.hash32 and not m.direct_t and m.pos_kind == "packed"
            and m.prefix_kind == "grouped16" and "uproj" in host["k2u"]["us"]):
        raise RuntimeError("the index is not fast32 in the MPHF layout (grouped16, packed, uproj)")
    return index, QueryIndex(arrays_from_numpy(host, "cpu")).to(device)
