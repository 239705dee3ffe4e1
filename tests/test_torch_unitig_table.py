"""Occurrence decode and ``fetch_occ_block``: port against mazu_tpu."""

import numpy as np
import pytest
import torch

from mazu_tpu.index import unitig_table as mut
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import unitig_table as ut
from torch_fixtures import assert_same, build_pair, tensor, toy_recipe


@pytest.fixture(scope="module")
def u2pos():
    ref, port = build_pair(toy_recipe())
    return ref.u2pos.device_arrays(), port.u2pos.device_arrays()


def test_decode_piscem():
    rng = np.random.default_rng(1)
    ref_shift, pos_mask = 15, (1 << 14) - 1
    w = mut.encode_piscem(
        rng.integers(0, 1 << 20, 2000), rng.integers(0, 1 << 14, 2000),
        rng.integers(0, 2, 2000), ref_shift,
    )
    np.testing.assert_array_equal(
        ut.encode_piscem(*mut.decode_piscem(w, ref_shift, pos_mask, np), ref_shift), w
    )
    for g, want, what in zip(
        ut.decode_piscem(tensor(w), ref_shift, pos_mask),
        mut.decode_piscem(w, ref_shift, pos_mask, np), ("ref_id", "pos", "o"),
    ):
        assert_same(g, want, what)


def test_decode_pf1():
    rng = np.random.default_rng(2)
    w = mut.encode_pf1(
        rng.integers(0, 1 << 32, 2000, dtype=np.uint64),
        rng.integers(0, 1 << 31, 2000, dtype=np.uint64),
        rng.integers(0, 2, 2000, dtype=np.uint64),
    )
    assert (w >= np.uint64(1 << 63)).any(), "no word with bit 63 set"
    for g, want, what in zip(ut.decode_pf1(tensor(w)), mut.decode_pf1(w, np), ("ref_id", "pos", "o")):
        assert_same(g, want, what)


def test_decode_words(u2pos):
    host_ref, host_port = u2pos
    words = host_port["ctable"]["words"][:8]
    d = arrays_from_numpy(host_port, "cpu")
    for g, want in zip(ut.decode_words(d, tensor(words)), mut.decode_words(host_ref, words, np)):
        assert_same(g, want)


@pytest.mark.parametrize("max_occs", [1, 2, 3, 4, 5])
def test_fetch_occ_block(u2pos, max_occs):
    host_ref, host_port = u2pos
    n_occs = host_ref["meta"].n_occs
    # every start, plus starts past the end (clipped to the last occurrence)
    start = np.concatenate([np.arange(n_occs), [n_occs - 1, n_occs, n_occs + 7]]).astype(np.int64)
    want = mut.fetch_occ_block(host_ref, start, max_occs, np)
    got = ut.fetch_occ_block(arrays_from_numpy(host_port, "cpu"), torch.from_numpy(start), max_occs)
    for g, w, what in zip(got, want, ("ref_id", "pos", "o")):
        assert_same(g, w, what)
