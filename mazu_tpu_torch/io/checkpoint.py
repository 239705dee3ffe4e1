"""Whole-index save and load (counterpart of ``mazu_tpu.io.checkpoint``),
NumPy only.

An index is a tree of flat arrays and scalars, saved as one ``.npz`` with
``/``-separated keys: the same ``FORMAT_VERSION``, keys and dtypes as the
reference package's, so a file written by either loads in the other, on a
machine with or without JAX. Strings are 0-d unicode arrays and files load
with ``allow_pickle=False``.

Every K2U of the port has a state: a KCDict (cuckoo, mono, mono2; slim
or wide slots), an SSHash (parity, fast32, direct with either skew table
kind), a PFHash and a SampledPFHash. Loaded arrays are host NumPy arrays;
queries move them with ``device_arrays``.
"""

from __future__ import annotations

import json

import numpy as np

from ..bits.bitvector import BitVector
from ..bits.intvector import IntVector
from ..bits.seqvector import SeqVector
from ..containers.refseq import RefSeqCollection
from ..containers.unitig_set import UnitigSet
from ..err import IndexLoad
from ..index.modindex import ModIndex
from ..index.unitig_table import DenseUnitigTable, PiscemUnitigTable
from ..kphf.boophf import BooPHF
from ..kphf.boophf32 import BooPHF32
from ..kphf.kcdict import KCDict
from ..kphf.pfhash import PFHash
from ..kphf.sampled import SampledPFHash
from ..kphf.sshash import SSHash

FORMAT_VERSION = 1
_SCHEMES = {"cuckoo": 0, "mono": 1, "mono2": 2}
_ORDERINGS = {"mix64": 0, "mix32": 1, "wyhash": 2}


def _iv_state(iv: IntVector) -> dict:
    return {"words": iv.words, "length": np.int64(iv.length), "width": np.int64(iv.width)}


def _iv_from(d) -> IntVector:
    return IntVector(d["words"], int(d["length"]), int(d["width"]))


def _bv_state(bv: BitVector) -> dict:
    return {"words": bv.words, "n_bits": np.int64(bv.n_bits)}


def _bv_from(d) -> BitVector:
    return BitVector(d["words"], int(d["n_bits"]))


def _us_state(us: UnitigSet) -> dict:
    return {"k": np.int64(us.k), "useq_words": us.useq.words,
            "useq_len": np.int64(len(us.useq)), "accum": us.accum}


def _us_from(d) -> UnitigSet:
    return UnitigSet(int(d["k"]), SeqVector(d["useq_words"], int(d["useq_len"])), d["accum"])


def _mphf_state(m) -> dict:
    levels = m.levels
    return {
        "mkind": "b32" if isinstance(m, BooPHF32) else "b64",
        "n_elem": np.int64(m.n_elem),
        "last_bitset_rank": np.int64(m.last_bitset_rank),
        "gamma": np.float64(m.gamma),
        "level_n_bits": np.array([n for (n, _, _) in levels], dtype=np.int64),
        "level_n_words": np.array([len(w) for (_, w, _) in levels], dtype=np.int64),
        "level_n_ranks": np.array([len(r) for (_, _, r) in levels], dtype=np.int64),
        "level_words": np.concatenate([w for (_, w, _) in levels]) if levels
        else np.zeros(0, np.uint64),
        "level_ranks": np.concatenate([np.asarray(r, dtype=np.uint64) for (_, _, r) in levels])
        if levels else np.zeros(0, np.uint64),
        "fh_keys": m.fh_keys,
        "fh_vals": m.fh_vals,
    }


def _mphf_from(d):
    is32 = str(d.get("mkind", "b64")) == "b32"
    wdt = np.uint32 if is32 else np.uint64
    levels = []
    wo = ro = 0
    for n, nw, nr in zip(d["level_n_bits"], d["level_n_words"], d["level_n_ranks"]):
        nw, nr = int(nw), int(nr)
        levels.append((int(n), d["level_words"][wo : wo + nw].astype(wdt),
                       d["level_ranks"][ro : ro + nr].astype(wdt)))
        wo += nw
        ro += nr
    return (BooPHF32 if is32 else BooPHF)(
        n_elem=int(d["n_elem"]),
        last_bitset_rank=int(d["last_bitset_rank"]),
        levels=levels,
        fh_keys=d["fh_keys"],
        fh_vals=d["fh_vals"].astype(wdt) if is32 else d["fh_vals"],
        gamma=float(d["gamma"]),
    )


def _k2u_state(k2u) -> dict:
    if isinstance(k2u, KCDict):
        d = {
            "kind": "kcdict",
            "us": _us_state(k2u.unitigs),
            "table": k2u.table,
            "T": np.int64(k2u.T),
            "salt": np.int64(k2u.salt),
            "scheme": np.int64(_SCHEMES[k2u.scheme]),
            "occ32": np.int64(1 if k2u.occ32 else 0),
            "side_T": np.int64(k2u.side_T),
            "side_salt": np.int64(k2u.side_salt),
        }
        if k2u.side is not None:
            d["side"] = k2u.side
        return d
    if isinstance(k2u, SSHash):
        d = {
            "kind": "sshash",
            "us": _us_state(k2u.unitigs),
            "w": np.int64(k2u.w),
            "seed": np.int64(k2u.seed),
            "hash32": np.int64(1 if k2u.hash32 else 0),
            "ordering": np.int64(_ORDERINGS[k2u.ordering]),
            "direct_T": np.int64(k2u.direct_T),
            "skew_param": np.int64(-1 if k2u.skew_param is None else k2u.skew_param),
            "prefix": k2u.occs_prefix_sum,
            "pos": _iv_state(k2u.pos),
        }
        if k2u.mphf is not None:
            d["mphf"] = _mphf_state(k2u.mphf)
        if k2u.skew_mphf is not None:
            d["skew_mphf"] = _mphf_state(k2u.skew_mphf)
            d["skew_pos"] = _iv_state(k2u.skew_pos)
        if k2u.skew_direct is not None:
            sd = k2u.skew_direct
            out = {"T": np.int64(sd["T"]), "pos": sd["pos"], "skind": sd["kind"]}
            if sd["kind"] == "cuckoo":
                out.update(salt=np.int64(sd["salt"]), slot_key=sd["slot_key"])
            else:
                out.update(bound=np.int64(sd["bound"]), prefix=sd["prefix"])
            d["skew_direct"] = out
        return d
    if isinstance(k2u, PFHash):
        return {"kind": "pfhash", "us": _us_state(k2u.unitigs), "mphf": _mphf_state(k2u.mphf),
                "pos": _iv_state(k2u.pos)}
    if isinstance(k2u, SampledPFHash):
        return {
            "kind": "sampled",
            "us": _us_state(k2u.unitigs),
            "mphf": _mphf_state(k2u.mphf),
            "sampled_pos": _iv_state(k2u.sampled_pos),
            "sampled_vec": _bv_state(k2u.sampled_vec),
            "canonical_vec": _bv_state(k2u.canonical_vec),
            "direction_vec": _bv_state(k2u.direction_vec),
            "ext_sizes": _iv_state(k2u.ext_sizes),
            "ext_bases": _iv_state(k2u.ext_bases),
            "sample_size": np.int64(k2u.sample_size),
            "extension_size": np.int64(k2u.extension_size),
        }
    raise TypeError(type(k2u))


def _kcdict_from(d) -> KCDict:
    kc = KCDict(_us_from(d["us"]), d["table"], int(d["T"]), int(d["salt"]))
    if "scheme" in d and int(d["scheme"]) != 0:
        kc.scheme = {v: k for k, v in _SCHEMES.items()}[int(d["scheme"])]
        kc.occ32 = bool(int(d.get("occ32", 0)))
        kc.side_T = int(d["side_T"])
        kc.side_salt = int(d["side_salt"])
        kc.side = d.get("side")
    return kc


def _sshash_from(d) -> SSHash:
    sp = int(d["skew_param"])
    prefix = np.asarray(d["prefix"], dtype=np.int64)
    # the file keeps no probe-depth record: the deepest bucket, from the
    # prefix, as the reference derives it
    max_bucket = int((prefix[1:] - prefix[:-1]).max()) if len(prefix) > 1 else 0
    hash32 = int(d.get("hash32", 0))
    skew_direct = None
    if "skew_direct" in d:
        sd = d["skew_direct"]
        if str(sd.get("skind", "bucket")) == "cuckoo":
            # the file keeps one position array: it is both slot_pos and pos
            skew_direct = {"kind": "cuckoo", "T": int(sd["T"]), "salt": int(sd["salt"]),
                           "slot_key": sd["slot_key"], "slot_pos": sd["pos"], "pos": sd["pos"]}
        else:
            skew_direct = {"kind": "bucket", "T": int(sd["T"]), "bound": int(sd["bound"]),
                           "prefix": sd["prefix"], "pos": sd["pos"]}
    return SSHash(
        _us_from(d["us"]), int(d["w"]), _iv_from(d["pos"]), None if sp < 0 else sp,
        int(d["seed"]), max_bucket, direct_T=int(d.get("direct_T", 0)), skew_direct=skew_direct,
        mphf=_mphf_from(d["mphf"]) if "mphf" in d else None, prefix=prefix,
        skew_mphf=_mphf_from(d["skew_mphf"]) if "skew_mphf" in d else None,
        skew_pos=_iv_from(d["skew_pos"]) if "skew_pos" in d else None,
        ordering={v: k for k, v in _ORDERINGS.items()}[int(d.get("ordering", hash32))],
    )


def _k2u_from(d):
    kind = str(d["kind"])
    if kind == "kcdict":
        return _kcdict_from(d)
    if kind == "sshash":
        return _sshash_from(d)
    if kind == "pfhash":
        return PFHash(_us_from(d["us"]), _mphf_from(d["mphf"]), _iv_from(d["pos"]))
    if kind == "sampled":
        return SampledPFHash(
            _us_from(d["us"]), _mphf_from(d["mphf"]), _iv_from(d["sampled_pos"]),
            _bv_from(d["sampled_vec"]), _bv_from(d["canonical_vec"]),
            _bv_from(d["direction_vec"]), _iv_from(d["ext_sizes"]), _iv_from(d["ext_bases"]),
            int(d["sample_size"]), int(d["extension_size"]),
        )
    raise IndexLoad(f"unknown K2U kind {kind!r}")


def _names_state(names) -> np.ndarray:
    return np.array(names, dtype="U") if names else np.zeros(0, dtype="U1")


def _u2pos_state(t) -> dict:
    if isinstance(t, DenseUnitigTable):
        return {"kind": "dense", "ctable": t.ctable, "offsets": t.offsets,
                "ref_names": _names_state(t.ref_names)}
    if isinstance(t, PiscemUnitigTable):
        return {"kind": "piscem", "ctable": _iv_state(t.ctable), "offsets": t.offsets,
                "ref_shift": np.int64(t.ref_shift), "pos_mask": np.uint64(t.pos_mask),
                "ref_names": _names_state(t.ref_names)}
    raise TypeError(type(t))


def _u2pos_from(d):
    names = [str(x) for x in d["ref_names"]]
    if str(d["kind"]) == "dense":
        return DenseUnitigTable(d["ctable"], d["offsets"], names)
    return PiscemUnitigTable(_iv_from(d["ctable"]), d["offsets"], int(d["ref_shift"]),
                             int(d["pos_mask"]), names)


def _refs_state(r: RefSeqCollection) -> dict:
    d = {"prefix_sum": r.prefix_sum, "names": _names_state(r.names),
         "has_seq": np.int64(1 if r.has_seq else 0)}
    if r.has_seq:
        d["seq_words"] = r.seq.words
        d["seq_len"] = np.int64(len(r.seq))
    return d


def _refs_from(d) -> RefSeqCollection:
    seq = SeqVector(d["seq_words"], int(d["seq_len"])) if int(d["has_seq"]) else None
    names = [str(x) for x in d["names"]] if len(d["names"]) else None
    return RefSeqCollection(seq, d["prefix_sum"], names)


def _flatten(prefix: str, tree: dict, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _flatten(key, v, out)
        elif isinstance(v, str):
            out[key] = np.array(v)
        else:
            out[key] = v


def _unflatten(flat: dict) -> dict:
    """The tree of ``/``-separated keys; 0-d unicode arrays become str."""
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = str(v) if v.dtype.kind == "U" and v.ndim == 0 else v
    return root


def _save(tree: dict, path: str, compress: bool) -> None:
    flat: dict = {}
    _flatten("", tree, flat)
    (np.savez_compressed if compress else np.savez)(path, **flat)


def _load(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    if int(tree["format_version"]) != FORMAT_VERSION:
        raise IndexLoad(f"{path}: format version {int(tree['format_version'])}, "
                        f"not {FORMAT_VERSION}")
    return tree


def save_index(index: ModIndex, path: str, compress: bool = True) -> None:
    """``compress=False`` writes the members uncompressed (faster, larger)."""
    _save({
        "format_version": np.int64(FORMAT_VERSION),
        "index_type": index.index_type,
        "version": index.version,
        "metadata_json": json.dumps(index.metadata),
        "k2u": _k2u_state(index.k2u),
        "u2pos": _u2pos_state(index.u2pos),
        "refs": _refs_state(index.refs),
    }, path, compress)


def load_index(path: str) -> ModIndex:
    tree = _load(path)
    idx = ModIndex(_k2u_from(tree["k2u"]), _u2pos_from(tree["u2pos"]), _refs_from(tree["refs"]),
                   index_type=str(tree["index_type"]),
                   metadata=json.loads(str(tree.get("metadata_json", "{}"))))
    if "version" in tree:
        idx.version = str(tree["version"])
    return idx


def save_k2u(k2u, path: str, compress: bool = True) -> None:
    _save({"format_version": np.int64(FORMAT_VERSION), "k2u": _k2u_state(k2u)}, path, compress)


def load_k2u(path: str):
    return _k2u_from(_load(path)["k2u"])
