"""Color classes of the port against mazu_tpu's, with tolerance 0:
``ColorClasses.from_u2pos`` (piscem and pf1 occurrence tables, through
``ModIndex.color_classes``), its accessors, ``device_arrays`` and
``save``/``load``; ``color_bitsets``; ``colors_lookup``, ``colors_batch``
and ``colors_from_k2u`` on ``torch_fixtures.build_pair``'s index (the toy
index's mixed-orientation unitigs, and references whose unitigs lie on
three of them), with misses."""

import numpy as np
import pytest

from mazu_tpu.index import colors as mc
from mazu_tpu.index.modindex import k2u_batch as m_k2u_batch
from mazu_tpu.index.pseudoalign import color_bitsets as m_color_bitsets

from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import colors as pc
from mazu_tpu_torch.index.modindex import k2u_batch
from mazu_tpu_torch.index.pseudoalign import color_bitsets

from torch_fixtures import (
    assert_same, build_pair, build_pf1_pair, queries, same_tree, seq_recipe, tensor, toy_recipe,
)


def _recipe(name):
    if name == "toy":
        return toy_recipe()
    return seq_recipe(n_refs=70, length=200, every=3)[0]


@pytest.fixture(scope="module", params=["toy", "three refs"])
def pair(request):
    return build_pair(_recipe(request.param))


def _same_classes(got, want):
    for key in ("u2c", "offsets", "refs"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
        assert getattr(got, key).dtype == getattr(want, key).dtype, key
    assert got.n_refs == want.n_refs


def test_from_u2pos(pair):
    ref, port = pair
    want, got = ref.color_classes(), port.color_classes()
    _same_classes(got, want)
    assert (got.n_classes, got.n_unitigs, got.max_class_size(), got.num_bits()) == \
        (want.n_classes, want.n_unitigs, want.max_class_size(), want.num_bits())
    uids = np.arange(got.n_unitigs)
    np.testing.assert_array_equal(got.class_of(uids), want.class_of(uids))
    for c in range(got.n_classes):
        np.testing.assert_array_equal(got.refs_of_class(c), want.refs_of_class(c))
    same_tree(got.device_arrays(), want.device_arrays())
    same_tree(color_bitsets(got), m_color_bitsets(want))


def test_from_pf1_table():
    (mref, mport), _ = build_pf1_pair(_recipe("toy"))
    _same_classes(mport.color_classes(), mref.color_classes())


def test_save_load(pair, tmp_path):
    ref, port = pair
    cc = port.color_classes()
    cc.save(str(tmp_path / "cc.npz"))
    _same_classes(pc.ColorClasses.load(str(tmp_path / "cc.npz")), cc)
    # and the reference reads the port's file
    _same_classes(mc.ColorClasses.load(str(tmp_path / "cc.npz")), ref.color_classes())


def test_colors_queries(pair):
    ref, port = pair
    mcc = ref.color_classes()
    host_cc = mcc.device_arrays()
    cc = arrays_from_numpy(port.color_classes().device_arrays(), "cpu")
    host = ref.device_arrays()
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    work = queries(ref.k2u.unitigs, 1024, seed=3, miss=0.2)
    mr = max(1, mcc.max_class_size())
    want = mc.colors_batch(host, host_cc, work, np, mr)
    got = pc.colors_batch(d, cc, tensor(work), mr)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert (np.asarray(want["class_id"]) == -1).any() and (np.asarray(want["n_refs"]) > 1).any()
    # the lookup alone, one column short of the widest class
    uid = np.asarray(m_k2u_batch(host, work, np)["unitig_id"]) % port.n_unitigs
    want = mc.colors_lookup(host_cc, uid, np, max(1, mr - 1))
    got = pc.colors_lookup(cc, tensor(uid.astype(np.uint64)), max(1, mr - 1))
    for g, w in zip(got, want):
        assert_same(g, w)
    r = k2u_batch(d, tensor(work))
    got = pc.colors_from_k2u(cc, r, mr)
    want = mc.colors_from_k2u(host_cc, m_k2u_batch(host, work, np), np, mr)
    for key in want:
        assert_same(got[key], want[key], key)
