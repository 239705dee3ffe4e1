"""The six sharded builders over ``torch.distributed``: one
``parallel.launch`` spawn of four gloo ranks (a 2x2 ``DistMesh``, a
``file://`` rendezvous) runs them all and returns every rank's outputs.
Each equals ``SerialMesh(2, 2)``'s tensor for tensor, and the reference's
sharded query on a 2x2 virtual CPU mesh field by field (the all-to-all
query, routed over all four ranks: the unsharded K2U). No rank imports
JAX."""

import numpy as np
import pytest
import torch

from mazu_tpu.kphf.sshash import sshash_k2u as m_sshash_k2u

from mazu_tpu_torch.parallel.launch import launch, sharded_queries_rank
from mazu_tpu_torch.parallel.mesh import _flatten

from torch_fixtures import (
    assert_sharded_same, port_job, port_sharded, ref_sharded, sharding_pairs,
)

NAMES = ("dp", "bucket", "a2a", "fused", "mono", "compact_bpos_useqrec")


@pytest.fixture(scope="module")
def run():
    pairs = sharding_pairs()
    jobs = [(name, *port_job(name, pairs), pairs["work"]) for name in NAMES]
    return pairs, launch(sharded_queries_rank, 4, 2, 2, jobs)


def test_no_rank_imports_jax(run):
    _, outs = run
    assert len(outs) == 4 and not any(o["jax_loaded"] for o in outs)


@pytest.mark.parametrize("name", NAMES)
def test_gloo_ranks_match_serial_mesh_and_reference(run, name):
    pairs, outs = run
    want = dict(_flatten(port_sharded(name, pairs, (2, 2))))
    for r, out in enumerate(outs):
        got = dict(_flatten(out[name]))
        assert set(got) == set(want)
        for path, v in want.items():
            assert torch.equal(got[path], v), (r, path)
    got = outs[0][name]
    if name == "a2a":
        assert bool(got["routed_ok"].all())
        ref = m_sshash_k2u(pairs["cap"][0].k2u.device_arrays(), pairs["work"], np)
        for key in ("unitig_id", "unitig_len", "pos", "mt"):
            assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    else:
        assert_sharded_same(name, got, ref_sharded(name, pairs, (2, 2)))


def test_failed_rank_raises():
    """A rank that raises fails the launch, with its traceback."""
    with pytest.raises(RuntimeError, match="a rank failed"):
        launch(sharded_queries_rank, 2, 3, 1, [])
