"""Sharded checkpoints cross between the packages: the fused, mono and
compact layouts written by either package hold the same manifest, Meta
records and arrays, each package's ``make_*_sharded_query_from_ckpt``
reads the other's files, and the two queries agree field by field.
``load_sharded`` reads only the shard files of the ranks a process holds,
and ``validate_k2u_self_sharded`` passes through a loaded query (and
fails on a corrupted shard)."""

import json
import os

import numpy as np
import pytest

import mazu_tpu.io.sharded_ckpt as msc

import mazu_tpu_torch.io.sharded_ckpt as psc
from mazu_tpu_torch.index.validate import validate_k2u_self_sharded
from mazu_tpu_torch.parallel.mesh import SerialMesh

from torch_fixtures import (
    SHARD_M2, assert_sharded_same, port_sharded, same_tree, sharding_pairs, tensor,
)

LAYOUTS = {  # name: (save function name, pair, save kwargs, query kwargs, compare as)
    "fused": ("save_fused_sharded", "cap", {"pos_kind": "inline2"}, {"probe_limit": 2}, "fused"),
    "mono": ("save_mono_sharded", "mono", {}, {}, "mono"),
    "compact": ("save_compact_sharded", "cap", {"bucket_inline": True, "useqrec": True},
                {"probe_limit": 3}, "compact_bpos_useqrec"),
}
_FROM = {"fused": "make_fused_sharded_query_from_ckpt",
         "mono": "make_mono_sharded_query_from_ckpt",
         "compact": "make_compact_sharded_query_from_ckpt"}


@pytest.fixture(scope="module")
def pairs():
    return sharding_pairs()


@pytest.fixture(scope="module")
def saved(pairs, tmp_path_factory):
    """Each layout in 4 shards, written by each package."""
    d = tmp_path_factory.mktemp("shards")
    out = {}
    for name, (fn, which, kw, _, _) in LAYOUTS.items():
        ref, port = pairs[which]
        for who, mod, index in (("ref", msc, ref), ("port", psc, port)):
            path = str(d / f"{name}_{who}")
            getattr(mod, fn)(path, index, n_shards=4, **kw)
            out[(name, who)] = path
    return out


def _files(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "meta.json")) as f:
        metas = json.load(f)
    return manifest, metas


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_same_files(saved, name):
    a, b = saved[(name, "ref")], saved[(name, "port")]
    assert _files(a) == _files(b)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    same_tree(psc.load_shared(b), msc.load_shared(a))
    for s in range(4):
        sa, sb = msc.load_shard(a, s), psc.load_shard(b, s)
        assert set(sa) == set(sb)
        for key in sa:
            assert sa[key].dtype == sb[key].dtype and sa[key].tobytes() == sb[key].tobytes()


def _ref_query(name, path, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(*shape),
                ("data", "bucket"))
    q = getattr(msc, _FROM[name])(path, mesh, m2=SHARD_M2, **LAYOUTS[name][3])
    return lambda work: jax.tree_util.tree_map(np.asarray, q(jnp.asarray(work)))


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_cross_loaded_queries(pairs, saved, name, shape):
    """The port's query from the reference's files and the reference's
    from the port's agree with each other and with the port's query built
    from the index."""
    work = pairs["work"]
    port_q = getattr(psc, _FROM[name])(saved[(name, "ref")], SerialMesh(*shape), m2=SHARD_M2,
                                       **LAYOUTS[name][3])
    got = port_q(tensor(work))
    want = _ref_query(name, saved[(name, "port")], shape)(work)
    as_ = LAYOUTS[name][4]
    assert_sharded_same(as_, got, want)
    built = port_sharded(as_, pairs, shape)
    for key in ("overflow", "n_ovf"):
        assert np.array_equal(got[key].numpy(), built[key].numpy())


def test_rank_reads_only_its_shards(saved, monkeypatch):
    class OneShard(SerialMesh):
        def local_buckets(self):
            return [2]

    read = []
    real = psc.load_shard
    monkeypatch.setattr(psc, "load_shard", lambda path, s: read.append(s) or real(path, s))
    _, _, stacked, manifest = psc.load_sharded(saved[("mono", "ref")], OneShard(1, 4))
    assert read == [2] and list(stacked) == [2] and manifest["kind"] == "mono"
    with pytest.raises(ValueError, match="4-shard"):
        psc.load_sharded(saved[("mono", "ref")], SerialMesh(1, 8))
    with pytest.raises(ValueError, match="'mono' checkpoint"):
        psc.make_fused_sharded_query_from_ckpt(saved[("mono", "ref")], SerialMesh(1, 4), m2=8)


@pytest.mark.parametrize("name", ["fused", "mono"])
def test_validate_k2u_self_sharded(pairs, saved, name, tmp_path):
    """Every unitig k-mer, both strands, through the loaded query (2x4);
    a shard with its rows scrambled fails it."""
    which = LAYOUTS[name][1]
    k2u = pairs[which][1].k2u
    q = getattr(psc, _FROM[name])(saved[(name, "ref")], SerialMesh(2, 4), m2=512,
                                  **LAYOUTS[name][3])
    validate_k2u_self_sharded(q, k2u, batch=1024)
    import shutil

    bad = str(tmp_path / "bad")
    shutil.copytree(saved[(name, "ref")], bad)
    leaf = "inline" if name == "fused" else "table"
    for s in range(4):
        z = psc.load_shard(bad, s)
        z[leaf] = np.ascontiguousarray(z[leaf][::-1])
        np.savez_compressed(os.path.join(bad, f"shard_{s}.npz"), **z)
    q = getattr(psc, _FROM[name])(bad, SerialMesh(2, 4), m2=512, **LAYOUTS[name][3])
    with pytest.raises(AssertionError, match="sharded k2u self-validation failed"):
        validate_k2u_self_sharded(q, k2u, batch=1024)
