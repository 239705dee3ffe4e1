"""The compact (capacity-tier) sharded query under ``SerialMesh`` against
the reference's on the virtual CPU mesh: packed positions and ``flat2``
bounds, with the ``bpos`` rows and the ``useqrec`` window records on and
off. Exact, field by field."""

import pytest

from torch_fixtures import assert_sharded_same, port_sharded, ref_sharded, sharding_pairs

CASES = [("compact", (1, 4)), ("compact", (2, 4)), ("compact", (1, 8)),
         ("compact_bpos_useqrec", (1, 8)), ("compact_bpos_useqrec", (2, 4)),
         ("compact_bpos", (1, 8))]


@pytest.fixture(scope="module")
def pairs():
    return sharding_pairs()


@pytest.mark.parametrize("name,shape", CASES, ids=[f"{n}-{s[0]}x{s[1]}" for n, s in CASES])
def test_compact_sharded_matches_reference(pairs, name, shape):
    got = port_sharded(name, pairs, shape)
    assert not got["over_budget"].any() and int(got["n_ovf"].sum()) > 0
    assert_sharded_same(name, got, ref_sharded(name, pairs, shape))
