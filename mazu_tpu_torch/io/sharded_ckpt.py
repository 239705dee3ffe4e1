"""Sharded checkpoints: the bucket-sharded layouts of
``parallel.sharding`` on disk, one file a shard (counterpart of
``mazu_tpu.io.sharded_ckpt``, the same format, so either package loads the
other's).

Layout on disk::

    <dir>/manifest.json   format_version 1, n_shards, kind, max_occs, the
                          shard leaves' shapes and dtypes
    <dir>/shared.npz      the replicated arrays (unitig set, skew rows, ...)
    <dir>/meta.json       the Meta records of the replicated tree
    <dir>/shard_<s>.npz   shard s's rows, bounds and occurrence pair rows

``load_sharded`` reads the shared part and only the shard files of the
bucket ranks the mesh holds in this process, and puts each straight on the
mesh's device: the whole index is never on one device (under
``DistMesh``, nor in one process).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..pytree import Meta

FORMAT_VERSION = 1


def _enc(v):
    if isinstance(v, Meta) or hasattr(v, "kv"):
        return {"__meta__": [[k, _enc(x)] for k, x in v.kv]}
    if isinstance(v, tuple):
        return {"__tuple__": [_enc(x) for x in v]}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    raise TypeError(f"unserializable meta value: {type(v)}")


def _dec(v):
    if isinstance(v, dict) and "__meta__" in v:
        return Meta(tuple((k, _dec(x)) for k, x in v["__meta__"]))
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_dec(x) for x in v["__tuple__"])
    return v


def _split(tree, prefix, arrays, metas):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Meta) or hasattr(v, "kv"):
            metas[key] = _enc(v)
        elif isinstance(v, dict):
            _split(v, key, arrays, metas)
        else:
            arrays[key] = np.asarray(v)


def _join(arrays, metas):
    root: dict = {}

    def put(key, v):
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    for k, v in arrays.items():
        put(k, v)
    for k, v in metas.items():
        put(k, _dec(v))
    return root


def _save_sharded(dirpath: str, shared, stacked, n_shards: int, extra: dict):
    os.makedirs(dirpath, exist_ok=True)
    arrays: dict = {}
    metas: dict = {}
    _split(shared, "", arrays, metas)
    np.savez_compressed(os.path.join(dirpath, "shared.npz"), **arrays)
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(metas, f)
    from concurrent.futures import ThreadPoolExecutor

    def save(s):
        np.savez_compressed(os.path.join(dirpath, f"shard_{s}.npz"),
                            **{k: v[s] for k, v in stacked.items()})

    # zlib lets go of the GIL: the shard files compress side by side
    with ThreadPoolExecutor(max_workers=max(1, min(n_shards, os.cpu_count() or 1))) as pool:
        list(pool.map(save, range(n_shards)))
    manifest = {
        "format_version": FORMAT_VERSION,
        "n_shards": int(n_shards),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in stacked.items()},
        **extra,
    }
    with open(os.path.join(dirpath, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def save_fused_sharded(dirpath: str, index, n_shards: int, pos_kind: str = "inline2") -> None:
    """``index`` in ``n_shards`` fused bucket shards (manifest kind
    "fused")."""
    from ..parallel.sharding import shard_fused_arrays

    shared, stacked = shard_fused_arrays(index, n_shards, pos_kind=pos_kind)
    _save_sharded(dirpath, shared, stacked, n_shards,
                  {"kind": "fused", "pos_kind": pos_kind,
                   "max_occs": int(max(1, index.max_occs()))})


def save_compact_sharded(dirpath: str, index, n_shards: int, bucket_inline: bool = False,
                         useqrec: bool = False) -> None:
    """A capacity-tier index (direct engine, packed positions) in bucket
    shards (manifest kind "compact"); ``bucket_inline`` and ``useqrec``
    persist the ``bpos`` rows and window records, which the loader wires
    from their presence."""
    from ..parallel.sharding import shard_compact_arrays

    shared, stacked = shard_compact_arrays(index, n_shards, bucket_inline=bucket_inline,
                                           useqrec=useqrec)
    _save_sharded(dirpath, shared, stacked, n_shards,
                  {"kind": "compact", "max_occs": int(max(1, index.max_occs())),
                   "bucket_inline": bool(bucket_inline), "useqrec": bool(useqrec)})


def save_mono_sharded(dirpath: str, index, n_shards: int) -> None:
    """A mono or mono2 KCDict index in bucket shards (manifest kind
    "mono")."""
    from ..parallel.sharding import shard_mono_arrays

    shared, stacked = shard_mono_arrays(index, n_shards)
    _save_sharded(dirpath, shared, stacked, n_shards,
                  {"kind": "mono", "max_occs": int(max(1, index.max_occs()))})


def load_manifest(dirpath: str) -> dict:
    with open(os.path.join(dirpath, "manifest.json")) as f:
        m = json.load(f)
    if int(m.get("format_version", 0)) != FORMAT_VERSION:
        from ..err import IndexLoad

        raise IndexLoad(f"sharded checkpoint format version {m.get('format_version')}, "
                        f"this reader takes {FORMAT_VERSION}")
    return m


def load_shared(dirpath: str) -> dict:
    """The replicated part as a host tree, its Meta records restored."""
    with np.load(os.path.join(dirpath, "shared.npz"), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(dirpath, "meta.json")) as f:
        metas = json.load(f)
    return _join(arrays, metas)


def load_shard(dirpath: str, s: int) -> dict:
    with np.load(os.path.join(dirpath, f"shard_{s}.npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_sharded(dirpath: str, mesh):
    """(shared host tree, shared arrays on the mesh's device, {bucket rank:
    its shard on the device} for the ranks this process holds, manifest).
    Only those ranks' shard files are read."""
    from ..convert import arrays_from_numpy
    from ..parallel.sharding import _local_shard

    manifest = load_manifest(dirpath)
    S = int(manifest["n_shards"])
    if mesh.n_bucket != S:
        raise ValueError(f"a {S}-shard checkpoint on a mesh of {mesh.n_bucket} bucket shards")
    shared_host = load_shared(dirpath)
    shared_dev = arrays_from_numpy({k: v for k, v in shared_host.items() if k != "pos_meta"},
                                   mesh.device)
    stacked_dev = {}
    for b in mesh.local_buckets():
        local = load_shard(dirpath, b)
        stacked_dev[b] = _local_shard({k: v[None] for k, v in local.items()}, 0, mesh.device)
        del local
    return shared_host, shared_dev, stacked_dev, manifest


def _check_kind(manifest: dict, kind: str):
    if manifest.get("kind", "fused") != kind:
        raise ValueError(f"a {manifest.get('kind')!r} checkpoint, not {kind!r}")


def make_fused_sharded_query_from_ckpt(dirpath: str, mesh, m2: int,
                                       probe_limit: int | None = 2):
    """A fused sharded checkpoint's query (``make_fused_sharded_query``'s),
    each shard placed from its file."""
    from ..parallel.sharding import build_fused_sharded_query

    shared_host, shared_dev, stacked_dev, manifest = load_sharded(dirpath, mesh)
    _check_kind(manifest, "fused")
    return build_fused_sharded_query(shared_host, shared_dev, stacked_dev, mesh, m2=m2,
                                     max_occs=int(manifest["max_occs"]), probe_limit=probe_limit)


def make_mono_sharded_query_from_ckpt(dirpath: str, mesh, m2: int):
    """A mono sharded checkpoint's query (``make_mono_sharded_query``'s)."""
    from ..parallel.sharding import build_mono_sharded_query

    shared_host, shared_dev, stacked_dev, manifest = load_sharded(dirpath, mesh)
    _check_kind(manifest, "mono")
    return build_mono_sharded_query(shared_host, shared_dev, stacked_dev, mesh, m2=m2,
                                    max_occs=int(manifest["max_occs"]))


def make_compact_sharded_query_from_ckpt(dirpath: str, mesh, m2: int,
                                         probe_limit: int | None = 3, defer_valid: bool = True):
    """A compact sharded checkpoint's query
    (``make_compact_sharded_query``'s)."""
    from ..parallel.sharding import build_compact_sharded_query

    shared_host, shared_dev, stacked_dev, manifest = load_sharded(dirpath, mesh)
    _check_kind(manifest, "compact")
    return build_compact_sharded_query(shared_host, shared_dev, stacked_dev, mesh, m2=m2,
                                       max_occs=int(manifest["max_occs"]),
                                       probe_limit=probe_limit, defer_valid=defer_valid)
