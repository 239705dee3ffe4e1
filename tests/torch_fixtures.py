"""Shared inputs for the ``test_torch_*`` files: the same index built by
``mazu_tpu`` (the reference) and by ``mazu_tpu_torch`` (the port), and
helpers to compare their outputs exactly."""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch


def mono2_recipe():
    """The recipe of ``tests/test_pallas_query.py::mono2_dict``: 24 random
    120-base unitigs, k=21, each its own reference (one occurrence)."""
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGT"), 120)) for _ in range(24)]
    n = len(seqs)
    occ = (
        np.arange(n, dtype=np.int64),
        np.arange(n, dtype=np.int64),
        np.zeros(n, dtype=np.int64),
        np.ones(n, dtype=np.int64),
    )
    return seqs, 21, occ, np.full(n, 120, dtype=np.int64)


def toy_recipe(idx=None):
    """The unitigs and occurrences of ``__graft_entry__._toy_index`` (six
    unitigs with 3 mixed-orientation occurrences), read back from it."""
    if idx is None:
        import __graft_entry__ as g

        idx = g._toy_index()
    us = idx.k2u.unitigs
    n = us.n_unitigs
    seqs = [us.unitig_seq_str(i) for i in range(n)]
    uid, ref, pos, o = [], [], [], []
    for u in range(n):
        r, p, oo = idx.u2pos.occs(u)
        uid += [u] * len(r)
        ref += list(r)
        pos += list(p)
        o += list(oo)
    occ = tuple(np.array(a, dtype=np.int64) for a in (uid, ref, pos, o))
    return seqs, us.k, occ, us.unitig_len(np.arange(n)).astype(np.int64)


def build_pair(recipe):
    """(mazu_tpu ModIndex, mazu_tpu_torch ModIndex) of one recipe, both
    with a mono2 KCDict at load 0.25 over a piscem occurrence table."""
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.modindex import ModIndex as MModIndex
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.kcdict import KCDict as MKCDict

    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.modindex import ModIndex
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.kcdict import KCDict

    seqs, k, occ, ref_lens = recipe
    names = [f"r{i}" for i in range(len(ref_lens))]

    mus = MUnitigs.from_seqs(seqs, k)
    mu2 = MSPT(mus, names, *occ, ref_lens).piscem_table()
    mkc = MKCDict.from_unitig_set(mus, occ_table=mu2, scheme="mono2", load=0.25)
    ref = MModIndex(mkc, mu2, MRefs.from_lens(ref_lens, names), index_type="t")

    pus = UnitigSet.from_seqs(seqs, k)
    pu2 = SPT(pus, names, *occ, ref_lens).piscem_table()
    pkc = KCDict.from_unitig_set(pus, occ_table=pu2, scheme="mono2", load=0.25)
    port = ModIndex(pkc, pu2, RefSeqCollection.from_lens(ref_lens, names), index_type="t")
    return ref, port


def build_capacity_pair(recipe, w: int = 15, skew: int = 8):
    """(mazu_tpu ModIndex, mazu_tpu_torch ModIndex) of one recipe, both
    with a direct-engine SSHash (load 0.5, skew threshold ``skew``) over a
    piscem occurrence table: the capacity tier's dictionary."""
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.modindex import ModIndex as MModIndex
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.sshash import SSHash as MSSHash

    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.modindex import ModIndex
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.sshash import SSHash

    seqs, k, occ, ref_lens = recipe
    names = [f"r{i}" for i in range(len(ref_lens))]

    mus = MUnitigs.from_seqs(seqs, k)
    mu2 = MSPT(mus, names, *occ, ref_lens).piscem_table()
    mss = MSSHash.from_unitig_set(mus, w, skew_param=skew, engine="direct", bucket_load=0.5)
    ref = MModIndex(mss, mu2, MRefs.from_lens(ref_lens, names), index_type="t")

    pus = UnitigSet.from_seqs(seqs, k)
    pu2 = SPT(pus, names, *occ, ref_lens).piscem_table()
    pss = SSHash.from_unitig_set(pus, w, skew_param=skew, engine="direct", bucket_load=0.5,
                                 device="cpu")
    port = ModIndex(pss, pu2, RefSeqCollection.from_lens(ref_lens, names), index_type="t")
    return ref, port


def build_mphf_pair(recipe, w: int = 15, skew: int | None = 8):
    """(mazu_tpu ModIndex, mazu_tpu_torch ModIndex) of one recipe, both
    with a fast32 SSHash (BooPHF32 minimizer MPHF, gamma 1.7, skew
    threshold ``skew``) over a piscem occurrence table: the MPHF capacity
    tier's dictionary."""
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.modindex import ModIndex as MModIndex
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.sshash import SSHash as MSSHash

    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.modindex import ModIndex
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.sshash import SSHash

    seqs, k, occ, ref_lens = recipe
    names = [f"r{i}" for i in range(len(ref_lens))]

    mus = MUnitigs.from_seqs(seqs, k)
    mu2 = MSPT(mus, names, *occ, ref_lens).piscem_table()
    mss = MSSHash.from_unitig_set(mus, w, skew_param=skew, engine="fast32", gamma=1.7)
    ref = MModIndex(mss, mu2, MRefs.from_lens(ref_lens, names), index_type="t")

    pus = UnitigSet.from_seqs(seqs, k)
    pu2 = SPT(pus, names, *occ, ref_lens).piscem_table()
    pss = SSHash.from_unitig_set(pus, w, skew_param=skew, engine="fast32", gamma=1.7,
                                 device="cpu")
    port = ModIndex(pss, pu2, RefSeqCollection.from_lens(ref_lens, names), index_type="t")
    return ref, port


def build_parity_pair(recipe, w: int = 15, skew: int | None = 8,
                      minimizer_hash: str | None = None):
    """(mazu_tpu ModIndex, mazu_tpu_torch ModIndex) of one recipe, both
    with a parity SSHash (the reference's default engine: 64-bit BooPHF
    minimizer MPHF, gamma 1.7, mix64 ordering or ``minimizer_hash``, skew
    threshold ``skew``) over a piscem occurrence table."""
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.modindex import ModIndex as MModIndex
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.sshash import SSHash as MSSHash

    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.modindex import ModIndex
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.sshash import SSHash

    seqs, k, occ, ref_lens = recipe
    names = [f"r{i}" for i in range(len(ref_lens))]

    mus = MUnitigs.from_seqs(seqs, k)
    mu2 = MSPT(mus, names, *occ, ref_lens).piscem_table()
    mss = MSSHash.from_unitig_set(mus, w, skew_param=skew, minimizer_hash=minimizer_hash)
    ref = MModIndex(mss, mu2, MRefs.from_lens(ref_lens, names), index_type="t")

    pus = UnitigSet.from_seqs(seqs, k)
    pu2 = SPT(pus, names, *occ, ref_lens).piscem_table()
    pss = SSHash.from_unitig_set(pus, w, skew_param=skew, minimizer_hash=minimizer_hash,
                                 device="cpu")
    port = ModIndex(pss, pu2, RefSeqCollection.from_lens(ref_lens, names), index_type="t")
    return ref, port


def build_pf1_pair(recipe):
    """((mazu_tpu dense, port dense), (mazu_tpu sparse, port sparse))
    ModIndexes of one recipe: pufferfish's PFHash and SampledPFHash
    (sample 9, extension 4; both over a 64-bit BooPHF, gamma 1.7) over the
    pf1-encoded ``DenseUnitigTable``."""
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs
    from mazu_tpu.containers.unitig_set import UnitigSet as MUnitigs
    from mazu_tpu.index.modindex import ModIndex as MModIndex
    from mazu_tpu.index.spt import SPT as MSPT
    from mazu_tpu.kphf.pfhash import PFHash as MPFHash
    from mazu_tpu.kphf.sampled import SampledPFHash as MSampled

    from mazu_tpu_torch.containers.refseq import RefSeqCollection
    from mazu_tpu_torch.containers.unitig_set import UnitigSet
    from mazu_tpu_torch.index.modindex import ModIndex
    from mazu_tpu_torch.index.spt import SPT
    from mazu_tpu_torch.kphf.pfhash import PFHash
    from mazu_tpu_torch.kphf.sampled import SampledPFHash

    seqs, k, occ, ref_lens = recipe
    names = [f"r{i}" for i in range(len(ref_lens))]

    mus = MUnitigs.from_seqs(seqs, k)
    mu2 = MSPT(mus, names, *occ, ref_lens).dense_table()
    mrefs = MRefs.from_lens(ref_lens, names)
    pus = UnitigSet.from_seqs(seqs, k)
    pu2 = SPT(pus, names, *occ, ref_lens).dense_table()
    prefs = RefSeqCollection.from_lens(ref_lens, names)
    dense = (
        MModIndex(MPFHash.from_unitig_set(mus), mu2, mrefs, index_type="t"),
        ModIndex(PFHash.from_unitig_set(pus, device="cpu"), pu2, prefs, index_type="t"),
    )
    sparse = (
        MModIndex(MSampled.from_unitig_set(mus), mu2, mrefs, index_type="t"),
        ModIndex(SampledPFHash.from_unitig_set(pus, device="cpu"), pu2, prefs, index_type="t"),
    )
    return dense, sparse


def capacity_queries(unitigs, n: int, seed: int, miss: float = 0.1) -> np.ndarray:
    """``queries`` with foreign words drawn from all 64 bits, so some have
    bit 63 set."""
    rng = np.random.default_rng(seed + 1)
    work = queries(unitigs, n, seed, miss=0.0)
    m = rng.random(n) < miss
    work[m] = rng.integers(0, 1 << 64, int(m.sum()), dtype=np.uint64)
    return work


def same_tree(got, want, path: str = ""):
    """A port array dict (NumPy, or tensors) equals the reference's: the
    same keys, Meta records and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys differ: {set(got) ^ set(want)}"
        for key in want:
            same_tree(got[key], want[key], f"{path}/{key}")
    elif hasattr(want, "kv"):
        assert got.kv == want.kv, f"{path}: meta {got.kv} != {want.kv}"
    elif dataclasses.is_dataclass(want):
        # a dataclass meta record (the reference's BooPHF32Meta): field by field
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), f"{path}: meta {f.name}"
    else:
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        if g.dtype != w.dtype and g.dtype.itemsize == w.dtype.itemsize:
            g = g.view(w.dtype)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}: {g.dtype}{g.shape} != {w.dtype}{w.shape}"
        assert g.tobytes() == w.tobytes(), f"{path}: bytes differ"


def queries(unitigs, n: int, seed: int, miss: float = 0.1) -> np.ndarray:
    """uint64 words: uniform draws from the index's k-mers, half reverse-
    complemented, a ``miss`` share replaced by random 62-bit words."""
    from mazu_tpu.kmer import revcomp

    rng = np.random.default_rng(seed)
    kms = unitigs.get_kmer_u64(unitigs.kmer_start_positions())
    work = kms[rng.integers(0, len(kms), n)]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], unitigs.k)
    m = rng.random(n) < miss
    work[m] = rng.integers(0, 1 << 62, int(m.sum()), dtype=np.uint64)
    return work


def tensor(words: np.ndarray) -> torch.Tensor:
    """uint64 NumPy words -> int64 bit-pattern tensor on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64))


def assert_same(got: torch.Tensor, want, what: str = ""):
    """Exact equality of a port tensor with a reference array: same shape,
    same dtype (u64/u32 read back from their bit patterns), same values."""
    want = np.asarray(want)
    g = got.detach().cpu().numpy()
    if want.dtype.kind == "u" and want.itemsize == g.itemsize and g.dtype.kind == "i":
        g = g.view(want.dtype)
    assert g.dtype == want.dtype, f"{what}: dtype {g.dtype} != {want.dtype}"
    np.testing.assert_array_equal(g, want, err_msg=what)


# ---------------------------------------------------------------- pf1 files


def write_boophf(path, ref, extra_word: bool = True):
    """A BooPHF (either package's) in pufferfish's BooPHF.hpp layout; C++
    stores n_bits/64 + 1 words a level, so a spare zero word follows each
    level's words."""
    with open(path, "wb") as f:
        f.write(struct.pack("<d", ref.gamma))
        f.write(struct.pack("<i", len(ref.levels)))
        f.write(struct.pack("<QQ", ref.last_bitset_rank, ref.n_elem))
        for n_bits, words, ranks in ref.levels:
            w = np.concatenate([words, np.zeros(int(extra_word), np.uint64)]).astype("<u8")
            f.write(struct.pack("<QQ", n_bits, len(w)) + w.tobytes())
            f.write(struct.pack("<Q", len(ranks)) + np.asarray(ranks, "<u8").tobytes())
        f.write(struct.pack("<Q", len(ref.fh_keys)))
        for key, v in zip(ref.fh_keys, ref.fh_vals):
            f.write(struct.pack("<QQ", int(key), int(v) - ref.last_bitset_rank))


def write_compact(path, words, length: int, width: int):
    """An sdsl compact int vector: static flag, width, length, capacity (in
    bits), then the packed words."""
    nw = (length * width + 63) // 64
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQQ", 0, width, length, nw * 64))
        f.write(np.asarray(words[:nw], dtype="<u8").tobytes())


def write_pf1_index(dirname, index, ref_lens):
    """The files a pufferfish dense (PFHash) or sparse (SampledPFHash)
    index directory holds, from a port-built ModIndex over a
    ``DenseUnitigTable``."""
    from mazu_tpu_torch.bits.intvector import IntVector

    k2u, u2 = index.k2u, index.u2pos
    us = k2u.unitigs
    p = lambda name: os.path.join(dirname, name)  # noqa: E731
    sparse = hasattr(k2u, "sampled_vec")
    info = {"k": us.k, "sampling_type": "sparse" if sparse else "dense"}
    if sparse:
        info.update(sample_size=k2u.sample_size, extension_size=k2u.extension_size)
    with open(p("info.json"), "w") as f:
        json.dump(info, f)
    write_compact(p("seq.bin"), us.useq.words, us.useq.length, 2)
    write_compact(p("rank.bin"), us.bv.words, us.bv.n_bits, 1)
    write_boophf(p("mphf.bin"), k2u.mphf)
    ivs = {"ctg_offsets.bin": IntVector.from_array(u2.offsets.astype(np.uint64))}
    if sparse:
        ivs.update({"sample_pos.bin": k2u.sampled_pos, "extensionSize.bin": k2u.ext_sizes,
                    "extension.bin": k2u.ext_bases})
        for name, bv in (("presence.bin", k2u.sampled_vec), ("canonical.bin", k2u.canonical_vec),
                         ("direction.bin", k2u.direction_vec)):
            write_compact(p(name), bv.words, bv.n_bits, 1)
    else:
        ivs["pos.bin"] = k2u.pos
    for name, iv in ivs.items():
        write_compact(p(name), iv.words, iv.length, iv.width)
    names = [f"r{i}" for i in range(len(ref_lens))]
    with open(p("ctable.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for nm in names:
            f.write(struct.pack("<Q", len(nm)) + nm.encode())
        f.write(struct.pack("<Q", len(names)) + np.zeros(len(names), "<u4").tobytes())
        f.write(struct.pack("<Q", len(u2.ctable)) + u2.ctable.astype("<u8").tobytes())
    with open(p("refAccumLengths.bin"), "wb") as f:
        acc = np.cumsum(np.asarray(ref_lens, dtype=np.uint64))
        f.write(struct.pack("<Q", len(acc)) + acc.astype("<u8").tobytes())


# ------------------------------------------------------- reads and references


def seq_recipe(n_refs: int = 24, length: int = 400, k: int = 31, seed: int = 11, every: int = 4):
    """Random references, each one unitig at position 0 forward; every
    ``every``-th unitig also occurs on the next two references (one forward,
    one reverse, at random positions), so its color set holds three
    references. Returns (recipe for ``build_pair``, reference sequences)."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), length)) for _ in range(n_refs)]
    multi = np.repeat(np.arange(0, n_refs, every, dtype=np.int64), 2)
    j = np.arange(len(multi), dtype=np.int64) % 2
    occ = (
        np.concatenate([np.arange(n_refs), multi]),
        np.concatenate([np.arange(n_refs), (multi + 1 + j) % n_refs]),
        np.concatenate([np.zeros(n_refs, dtype=np.int64), rng.integers(0, length, len(multi))]),
        np.concatenate([np.ones(n_refs, dtype=np.int64), j]),
    )
    return (seqs, k, occ, np.full(n_refs, length, dtype=np.int64)), seqs


def write_fasta(path, seqs, width: int = 60, names=None):
    """A FASTA file of ``seqs`` (records r0, r1, ...) wrapped at ``width``."""
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{names[i] if names else f'r{i}'}\n")
            for a in range(0, len(s), width):
                f.write(s[a : a + width] + "\n")


def with_refs(pair, fasta_path):
    """Both ModIndexes of ``pair`` with their references read from a FASTA
    file by each package's ``RefSeqCollection.from_fasta``."""
    from mazu_tpu.containers.refseq import RefSeqCollection as MRefs

    from mazu_tpu_torch.containers.refseq import RefSeqCollection

    ref, port = pair
    ref.refs = MRefs.from_fasta(str(fasta_path))
    port.refs = RefSeqCollection.from_fasta(str(fasta_path))
    return ref, port


# ------------------------------------------------------------------ sharding
SHARD_N = 512  # k-mers a sharded query
SHARD_M2 = 256  # phase-2 lanes a data shard


def sharding_pairs() -> dict:
    """The toy recipe as a direct SSHash pair (``cap``) and a mono2 KCDict
    pair (``mono``), a batch of hits, reverse complements and misses, and
    the toy's max_occs."""
    ref, port = build_capacity_pair(toy_recipe())
    ref2, port2 = build_pair(toy_recipe())
    return {"cap": (ref, port), "mono": (ref2, port2), "mo": max(1, ref2.max_occs()),
            "work": capacity_queries(ref.k2u.unitigs, SHARD_N, seed=21)}


SHARD_JOBS = ("dp", "bucket", "a2a", "fused", "mono", "compact", "compact_bpos_useqrec",
              "compact_bpos")
_COMPACT = {"compact": (False, False), "compact_bpos_useqrec": (True, True),
            "compact_bpos": (True, False)}


def port_job(name: str, pairs: dict):
    """(builder name in ``mazu_tpu_torch.parallel.sharding.BUILDERS``,
    positional args, keyword args) of one sharded query."""
    import functools

    from mazu_tpu_torch.index.modindex import get_ref_pos_compact

    port, port2 = pairs["cap"][1], pairs["mono"][1]
    if name == "dp":
        return ("make_data_parallel_query",
                (port2.device_arrays(fused=True),
                 functools.partial(get_ref_pos_compact, max_occs=pairs["mo"], m2=SHARD_M2)), {})
    if name in ("bucket", "a2a"):
        b = "make_bucket_sharded_query" if name == "bucket" else "make_alltoall_sharded_query"
        return b, (port.k2u,), {}
    if name == "fused":
        return "make_fused_sharded_query", (port,), {"m2": SHARD_M2, "probe_limit": 2}
    if name == "mono":
        return "make_mono_sharded_query", (port2,), {"m2": SHARD_M2}
    bi, uq = _COMPACT[name]
    return ("make_compact_sharded_query", (port,),
            {"m2": SHARD_M2, "max_occs": pairs["mo"], "bucket_inline": bi, "useqrec": uq})


def port_sharded(name: str, pairs: dict, shape) -> dict:
    """The port's sharded query ``name`` under ``SerialMesh(*shape)`` on
    the pairs' batch."""
    from mazu_tpu_torch.parallel import sharding
    from mazu_tpu_torch.parallel.mesh import SerialMesh

    builder, args, kw = port_job(name, pairs)
    q = sharding.BUILDERS[builder](*args, mesh=SerialMesh(*shape), **kw)
    q = q[1] if isinstance(q, tuple) else q
    return q(tensor(pairs["work"]))


def ref_sharded(name: str, pairs: dict, shape) -> dict:
    """The reference's sharded query ``name`` on a (data, bucket) mesh of
    the virtual CPU devices (the all-to-all query: its 1-D bucket mesh),
    run on the pairs' batch; NumPy outputs."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import mazu_tpu.index.modindex as mmi
    import mazu_tpu.parallel.sharding as ms

    nd, nb = shape
    devs = np.array(jax.devices()[: nd * nb])
    mesh = Mesh(devs.reshape(nd, nb), ("data", "bucket"))
    ref, ref2 = pairs["cap"][0], pairs["mono"][0]
    if name == "dp":
        q = ms.make_data_parallel_query(
            ref2.device_arrays(fused=True),
            functools.partial(mmi.get_ref_pos_compact, max_occs=pairs["mo"], m2=SHARD_M2),
            mesh)[1]
    elif name == "bucket":
        q = ms.make_bucket_sharded_query(ref.k2u, mesh)
    elif name == "a2a":
        q = ms.make_alltoall_sharded_query(ref.k2u, Mesh(devs[:nb], ("bucket",)))
    elif name == "fused":
        q = ms.make_fused_sharded_query(ref, mesh, m2=SHARD_M2, probe_limit=2)
    elif name == "mono":
        q = ms.make_mono_sharded_query(ref2, mesh, m2=SHARD_M2)
    else:
        bi, uq = _COMPACT[name]
        q = ms.make_compact_sharded_query(ref, mesh, m2=SHARD_M2, max_occs=pairs["mo"],
                                          bucket_inline=bi, useqrec=uq)
    return jax.tree_util.tree_map(np.asarray, q(jnp.asarray(pairs["work"])))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what, mask=None):
    g, w = _np(got), _np(want)
    if g.dtype != w.dtype and g.dtype.itemsize == w.dtype.itemsize and w.dtype.kind == "u":
        g = g.view(w.dtype)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    if mask is not None:
        m = np.broadcast_to(mask if mask.ndim == g.ndim else mask[:, None], g.shape)
        g, w = np.where(m, g, 0), np.where(m, w, 0)
    assert np.array_equal(g, w), f"{what}: values differ"


_PROJ = ("ref_id", "ref_pos", "orient")


def assert_sharded_same(name: str, got: dict, want: dict):
    """A port sharded output equals the reference's: every field exact,
    but where it has no meaning (phase-2 slots past the flagged count,
    projections of invalid occurrences)."""
    if name in ("bucket", "a2a"):
        assert set(got) == set(want), set(got) ^ set(want)
        for key in want:
            _eq(got[key], want[key], key)
        return
    if name == "dp":  # merged answers; over_budget comes a data shard each
        assert not _np(got["over_budget"]).any() and not _np(want["over_budget"]).any()
        for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
            _eq(got[key], want[key], key)
        for key in _PROJ:
            _eq(got[key], want[key], key, _np(want["valid"]))
        return
    assert set(got) == set(want), set(got) ^ set(want)
    for key in ("overflow", "slot_real", "n_ovf", "over_budget"):
        _eq(got[key], want[key], key)
    sr = _np(want["slot_real"])
    _eq(got["lanes"], want["lanes"], "lanes", sr)
    main, wmain = got["main"], want["main"]
    assert set(main) == set(wmain), set(main) ^ set(wmain)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid"):
        _eq(main[key], wmain[key], f"main {key}")
    for key in _PROJ:
        _eq(main[key], wmain[key], f"main {key}", _np(wmain["valid"]))
    p2, wp2 = got["phase2"], want["phase2"]
    assert set(p2) == set(wp2)
    for key in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        _eq(p2[key], wp2[key], f"phase2 {key}", sr)
    v2 = _np(wp2["valid"]) & sr[:, None]
    _eq(_np(p2["valid"]) & sr[:, None], v2, "phase2 valid")
    for key in _PROJ:
        _eq(p2[key], wp2[key], f"phase2 {key}", v2)
