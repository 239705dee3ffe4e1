"""The sharded queries (``mazu_tpu_torch.parallel.sharding``) under
``SerialMesh`` at 1x4, 2x4 and 1x8 against the reference's sharded
queries on the virtual CPU mesh of ``tests/conftest.py``: the data-parallel
query, the bucket-sharded and all-to-all SSHash K2U, and the fused and mono
full queries (the compact query: ``test_torch_sharding_compact.py``; gloo
ranks: ``test_torch_sharding_dist.py``). Exact, field by field."""

import numpy as np
import pytest

from mazu_tpu.kphf.sshash import sshash_k2u as m_sshash_k2u

from mazu_tpu_torch.parallel import sharding
from mazu_tpu_torch.parallel.mesh import SerialMesh

from torch_fixtures import (
    assert_sharded_same, port_sharded, ref_sharded, sharding_pairs, tensor,
)

SHAPES = [(1, 4), (2, 4), (1, 8)]


@pytest.fixture(scope="module")
def pairs():
    return sharding_pairs()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["dp", "bucket", "fused", "mono"])
def test_sharded_query_matches_reference(pairs, name, shape):
    got = port_sharded(name, pairs, shape)
    assert_sharded_same(name, got, ref_sharded(name, pairs, shape))
    if name in ("fused", "mono"):  # the batch reaches phase 2
        assert int(got["n_ovf"].sum()) > 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_alltoall_matches_reference(pairs, shape):
    """Every lane routed at cap_factor 2; 1-row meshes equal the
    reference's 1-D bucket mesh; 2x4 (the batch split over all eight ranks)
    equals the unsharded K2U."""
    got = port_sharded("a2a", pairs, shape)
    assert bool(got["routed_ok"].all())
    if shape[0] == 1:
        assert_sharded_same("a2a", got, ref_sharded("a2a", pairs, shape))
    want = m_sshash_k2u(pairs["cap"][0].k2u.device_arrays(), pairs["work"], np)
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


def test_alltoall_overflow_reported_not_requeried(pairs):
    """At a tiny cap_factor some destinations overflow: those lanes report
    routed_ok False and zeros, the rest stay exact, as the reference's."""
    ref, port = pairs["cap"]
    work = np.repeat(pairs["work"][:8], 64)  # 8 distinct k-mers: few destinations
    q = sharding.make_alltoall_sharded_query(port.k2u, SerialMesh(1, 4), cap_factor=0.01)
    got = q(tensor(work))
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import mazu_tpu.parallel.sharding as ms

    rq = ms.make_alltoall_sharded_query(ref.k2u, Mesh(np.array(jax.devices()[:4]), ("bucket",)),
                                        cap_factor=0.01)
    want = jax.tree_util.tree_map(np.asarray, rq(jnp.asarray(work)))
    assert_sharded_same("a2a", got, want)
    assert not want["routed_ok"].all() and want["routed_ok"].any()
    assert (got["mt"].numpy()[~want["routed_ok"]] == 0).all()


def test_bucket_shards_hold_their_slice(pairs):
    """Each shard holds its own bucket range's positions; every bucket is
    on exactly one shard."""
    _, port = pairs["cap"]
    shared, stacked = sharding.shard_sshash_buckets(port.k2u, 4)
    lo, hi = stacked["lo"][:, 0], stacked["hi"][:, 0]
    assert lo[0] == 0 and (lo[1:] == hi[:-1]).all() and hi[-1] == len(port.k2u.occs_prefix_sum) - 1
    assert "prefix" not in shared and "pos" not in shared
    n_occ = [int(stacked["prefix"][s, hi[s] - lo[s]]) for s in range(4)]
    assert sum(n_occ) == port.k2u.n_minimizer_occs


def test_mesh_refuses_uneven_batches(pairs):
    with pytest.raises(ValueError, match="equal shards"):
        port_sharded("bucket", {**pairs, "work": pairs["work"][:511]}, (2, 4))


def test_dist_mesh_needs_a_process_group():
    from mazu_tpu_torch.parallel.mesh import DistMesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        DistMesh(1, 4)


def test_bucket_sharded_keeps_the_sshash_ordering():
    """A parity SSHash ordered by wyhash: the port's sharded query takes
    the minimizers in the SSHash's own ordering and equals the unsharded
    query; the reference's sharded query passes only ``hash32`` and so
    orders them by mix64, which misses lanes (not mirrored)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import mazu_tpu.parallel.sharding as ms
    from torch_fixtures import build_parity_pair, capacity_queries, toy_recipe

    ref, port = build_parity_pair(toy_recipe(), minimizer_hash="wyhash")
    work = capacity_queries(ref.k2u.unitigs, 512, seed=4)
    want = m_sshash_k2u(ref.k2u.device_arrays(), work, np)
    got = sharding.make_bucket_sharded_query(port.k2u, SerialMesh(1, 4))(tensor(work))
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "bucket"))
    theirs = ms.make_bucket_sharded_query(ref.k2u, mesh)(jnp.asarray(work))
    assert (np.asarray(theirs["mt"]) != np.asarray(want["mt"])).any()
