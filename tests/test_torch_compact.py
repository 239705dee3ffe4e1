"""Lane compaction: the port's ``flagged_lanes`` keeps the reference's
contract (first m flagged lanes in order, exact count). Only real slots
are compared: the reference leaves in-bounds garbage past the count."""

import numpy as np
import pytest
import torch

from mazu_tpu.ops.compact import flagged_lanes as ref_flagged_lanes
from mazu_tpu_torch.ops.compact import flagged_lanes


@pytest.mark.parametrize(
    "n,m,density",
    [
        (1, 64, 1.0),
        (255, 64, 0.1),
        (256, 64, 0.3),
        (1000, 64, 0.5),  # over budget
        (4097, 512, 0.05),
        (4097, 100, 0.5),  # over budget, N not a multiple of 256
        (20000, 4096, 0.13),
        (333, 16, 0.0),  # nothing flagged
    ],
)
def test_flagged_lanes_matches_reference(n, m, density):
    rng = np.random.default_rng(n + m)
    flags = rng.random(n) < density
    want_lanes, want_n = ref_flagged_lanes(flags, m, np)
    lanes, n_set = flagged_lanes(torch.from_numpy(flags), m)
    assert lanes.shape == (m,) and lanes.dtype == torch.int64
    assert int(n_set) == int(want_n) == int(flags.sum())
    real = min(int(want_n), m)
    np.testing.assert_array_equal(lanes[:real].numpy(), np.asarray(want_lanes)[:real])
    np.testing.assert_array_equal(lanes[:real].numpy(), np.flatnonzero(flags)[:real])
    # slots past the count hold in-bounds lanes
    assert ((lanes >= 0) & (lanes < n)).all()


def test_flagged_lanes_all_set_over_budget():
    lanes, n_set = flagged_lanes(torch.ones(512, dtype=torch.bool), 64)
    assert int(n_set) == 512
    np.testing.assert_array_equal(lanes.numpy(), np.arange(64))


def test_flagged_lanes_empty():
    lanes, n_set = flagged_lanes(torch.zeros(0, dtype=torch.bool), 8)
    assert lanes.shape == (8,) and int(n_set) == 0
