"""The port's wavelet matrix and wavelet-matrix occurrence table against
mazu_tpu's, with tolerance 0 (the reference run with ``xp=np``):
``WaveletMatrix`` built over random byte sequences with alphabet sizes 2
to 256 (symbols absent, lengths on word edges, the empty sequence) and the
reference's Figure 4 goldens (``tests/test_wm.py``): the same levels,
zeros and alpha offsets, and ``wm_access``, ``wm_rank``, ``wm_select``
(past the last occurrence too) and ``_bv_select_zero``; the slice forms at
the window edges, host and batched; then ``WMUnitigTable`` over a piscem
table (``tests/test_wm_table.py`` on synthetic data): its arrays, decode,
slices, a ``ModIndex`` padded query and color classes, equal to the
reference's and to the piscem table's; and the paths that read a ctable
raising by name on it."""

import numpy as np
import pytest
import torch

import mazu_tpu.bits.wm as mwm
import mazu_tpu.index.modindex as mmi
from mazu_tpu.index import colors as mc
from mazu_tpu.index.unitig_table import WMUnitigTable as MWMTable
from mazu_tpu.index.unitig_table import decode_occs as m_decode_occs

import mazu_tpu_torch.bits.wm as pwm
from mazu_tpu_torch.containers.unitig_set import us_pos_to_id
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import colors as pc
from mazu_tpu_torch.index import modindex as pmi
from mazu_tpu_torch.index.modindex import ModIndex, build_uproj, build_useqrec
from mazu_tpu_torch.index.unitig_table import WMUnitigTable, decode_occs

from torch_fixtures import (
    assert_same, build_capacity_pair, capacity_queries, same_tree, seq_recipe, tensor,
)

FIG4 = np.array([4, 7, 6, 5, 3, 2, 1, 0, 2, 1, 4, 1, 7], dtype=np.uint8)
# (alphabet size, length, symbols drawn below): absent symbols where the
# draw stops short of the alphabet
CASES = [(2, 1000, 2), (3, 64, 3), (7, 129, 5), (8, 13, 8), (9, 700, 9), (16, 500, 16),
         (100, 2000, 60), (255, 257, 255), (256, 1024, 256), (256, 128, 7), (5, 0, 5)]


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def pair(alpha, n, hi, seed=0):
    rng = np.random.default_rng(seed + alpha + n)
    seq = rng.integers(0, hi, n).astype(np.uint8)
    return seq, mwm.WaveletMatrix.build(seq, alpha), pwm.WaveletMatrix.build(seq, alpha)


def case_ids():
    return [f"a{a}-n{n}-s{h}" for a, n, h in CASES]


@pytest.mark.parametrize("alpha,n,hi", CASES, ids=case_ids())
def test_build(alpha, n, hi):
    seq, ref, port = pair(alpha, n, hi)
    assert (port.n_levels, len(port), port.alpha_size) == (ref.n_levels, len(ref), alpha)
    same_tree(port.device_arrays(), ref.device_arrays())
    assert port.num_bits() == ref.num_bits()
    np.testing.assert_array_equal(port.has_symbol(np.arange(alpha)),
                                  ref.has_symbol(np.arange(alpha)))
    if hi < alpha or n == 0:
        assert not port.has_symbol(np.arange(alpha)).all()


@pytest.mark.parametrize("alpha,n,hi", CASES, ids=case_ids())
def test_access_rank_select(alpha, n, hi):
    """The batched functions on every position, every symbol (absent ones
    and one past the alphabet too) and every occurrence rank up to two past
    a symbol's count, against the reference's and the sequence."""
    seq, ref, port = pair(alpha, n, hi)
    want_d = ref.device_arrays()
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    if n:
        i = np.arange(n)
        assert_same(pwm.wm_access(d, t(i)), mwm.wm_access(want_d, i, np))
        np.testing.assert_array_equal(port.access(i), seq)
    syms = np.arange(min(alpha + 1, 256))
    a = np.repeat(syms, n + 1)
    i = np.tile(np.arange(n + 1), len(syms))
    want = mwm.wm_rank(want_d, a, i, np)
    assert_same(pwm.wm_rank(d, t(a), t(i)), want)
    for s in syms[:alpha]:
        np.testing.assert_array_equal(port.rank(s, np.arange(n + 1)),
                                      np.concatenate([[0], np.cumsum(seq == s)]))
    counts = np.bincount(seq, minlength=256)[syms]
    a = np.concatenate([np.full(c + 2, s) for s, c in zip(syms, counts)])
    r = np.concatenate([np.arange(c + 2) for c in counts])
    want = mwm.wm_select(want_d, a, r, np)
    got = pwm.wm_select(d, t(a), t(r))
    assert_same(got, want)
    inside = r < counts[a] if len(a) else r.astype(bool)
    for s in syms[:alpha]:
        occ = np.flatnonzero(seq == s)
        np.testing.assert_array_equal(got.numpy()[inside & (a == s)], occ)
    # a symbol past the alphabet clips to its last one, as in the reference
    absent = np.isin(a, syms[:alpha][counts[:alpha] == 0])
    assert (got.numpy()[absent] == -1).all()
    for lev in range(port.n_levels):
        zeros = int(d["zeros"][lev])
        rz = np.arange(zeros)
        assert_same(pwm._bv_select_zero(d[f"level{lev}"], t(rz)),
                    mwm._bv_select_zero(want_d[f"level{lev}"], rz, np))


def test_fig4_goldens():
    """The reference's Figure 4 sequence (Claude-Navarro-Ordonez 2015)."""
    wm = pwm.WaveletMatrix.build(FIG4, 8)
    assert wm.n_levels == 3 and len(wm) == 13
    np.testing.assert_array_equal(wm.zeros, [7, 7, 6])
    np.testing.assert_array_equal(wm.alpha_offsets, [0, 6, 3, 10, 1, 9, 5, 11])
    ll = ([1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 1], [1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1],
          [1, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1])
    for lev, want in enumerate(ll):
        bits = (wm.levels[lev].words[0] >> np.arange(13, dtype=np.uint64)) & np.uint64(1)
        np.testing.assert_array_equal(bits, want)
    np.testing.assert_array_equal(wm.access(np.arange(13)), FIG4)
    for alpha, h in [(8, 3), (7, 3), (9, 4), (256, 8)]:
        assert pwm.WaveletMatrix.build(np.array([1, 2, 3], np.uint8), alpha).n_levels == h


@pytest.mark.parametrize("start,end", [(0, 13), (3, 11), (5, 5), (2, 9), (0, 0), (13, 13),
                                       (12, 13), (0, 1)])
def test_slice(start, end):
    """``WaveletMatrixSlice`` and the batched slice forms at the window's
    edges, against the reference's and the window; select past the window
    returns the reference's rebased position, -1 only past the sequence."""
    ref, port = mwm.WaveletMatrix.build(FIG4, 8), pwm.WaveletMatrix.build(FIG4, 8)
    ms, ps = mwm.WaveletMatrixSlice(ref, start, end), pwm.WaveletMatrixSlice(port, start, end)
    win = FIG4[start:end]
    assert len(ps) == len(win) and ps.is_empty() == (len(win) == 0)
    n = len(win)
    if n:
        np.testing.assert_array_equal(ps.access(np.arange(n)), win)
    want_d, d = ref.device_arrays(), arrays_from_numpy(port.device_arrays(), "cpu")
    for a in range(9):
        np.testing.assert_array_equal(ps.rank(a, np.arange(n + 1)), ms.rank(a, np.arange(n + 1)))
        np.testing.assert_array_equal(ps.select(a, np.arange(4)), ms.select(a, np.arange(4)))
        if a < 8:
            np.testing.assert_array_equal(ps.rank(a, np.arange(n + 1)),
                                          np.concatenate([[0], np.cumsum(win == a)]))
        st = np.full(n + 1, start)
        aa = np.full(n + 1, a)
        assert_same(pwm.wm_slice_rank(d, t(aa), t(st), t(np.arange(n + 1))),
                    mwm.wm_slice_rank(want_d, aa, st, np.arange(n + 1), np))
        assert_same(pwm.wm_slice_select(d, t(np.full(4, a)), t(np.full(4, start)),
                                        t(np.arange(4))),
                    mwm.wm_slice_select(want_d, np.full(4, a), np.full(4, start), np.arange(4),
                                        np))
    if n:
        assert_same(pwm.wm_slice_access(d, t(np.full(n, start)), t(np.arange(n))),
                    mwm.wm_slice_access(want_d, np.full(n, start), np.arange(n), np))


def test_slice_select_past_the_window():
    """The reference's semantics (``tests/test_wm.py``): the window [4, 7]
    rebases select; the 2nd 7 lies at 12, past the window, and there is no
    3rd."""
    ps = pwm.WaveletMatrixSlice(pwm.WaveletMatrix.build(FIG4, 8), 0, 2)
    assert ps.select(7, np.array([1]))[0] == 12
    assert ps.select(7, np.array([2]))[0] == -1
    with pytest.raises(AssertionError):
        pwm.WaveletMatrixSlice(pwm.WaveletMatrix.build(FIG4, 8), 5, 14)


_TABLES = {}


def tables():
    """(reference ModIndex, port ModIndex, reference WM table, port WM
    table) over ``seq_recipe``'s piscem table (every 3rd unitig on three
    references), built once."""
    if not _TABLES:
        ref, port = build_capacity_pair(seq_recipe(n_refs=60, length=300, every=3)[0])
        _TABLES["t"] = (ref, port, MWMTable.from_piscem(ref.u2pos),
                        WMUnitigTable.from_piscem(port.u2pos))
    return _TABLES["t"]


def test_wm_table_arrays_and_decode():
    """Planes of ``ceil(width / 8)`` bytes, each over its largest byte + 1;
    the arrays, ``num_bits``, ``max_occs``, every word and every unitig's
    occurrences equal the reference's and the piscem table's; one
    ``decode_occs`` over every index, and the unitig slices' rank."""
    ref, port, mwt, pwt = tables()
    pt = port.u2pos
    assert len(pwt.planes) == -(-pt.ctable.width // 8) and pwt.n_unitigs == pt.n_unitigs
    same_tree(pwt.device_arrays(paired=True), mwt.device_arrays())
    assert pwt.num_bits() == mwt.num_bits() and pwt.max_occs() == mwt.max_occs() == 3
    n = pwt.n_total_occs
    assert n == pt.n_total_occs == mwt.n_total_occs
    np.testing.assert_array_equal(pwt._words(np.arange(n)), pt.ctable.to_array())
    for uid in range(pt.n_unitigs):
        for a, b, c in zip(pwt.occs(uid), mwt.occs(uid), pt.occs(uid)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    idx = np.arange(n).reshape(-1, 1) + np.arange(3)[None, :] % n
    idx = np.minimum(idx, n - 1)
    got = decode_occs(arrays_from_numpy(pwt.device_arrays(), "cpu"), t(idx))
    want = m_decode_occs(mwt.device_arrays(), idx, np)
    for g, w in zip(got, want):
        assert_same(g, w)
    uid = int(np.argmax(pt.offsets[1:] - pt.offsets[:-1]))
    for plane in range(len(pwt.planes)):
        ps, ms = pwt.unitig_slice(uid, plane), mwt.unitig_slice(uid, plane)
        for a in range(pwt.planes[plane].alpha_size):
            np.testing.assert_array_equal(ps.rank(a, np.arange(len(ps) + 1)),
                                          ms.rank(a, np.arange(len(ms) + 1)))


def test_wm_table_query_and_colors():
    """A ModIndex over the WM table: ``get_ref_pos_padded`` equals the
    reference's over its WM table and the port's over the piscem table,
    lane for lane; ``ColorClasses.from_u2pos`` accepts it and equals the
    piscem table's classes and the reference's."""
    ref, port, mwt, pwt = tables()
    work = capacity_queries(ref.k2u.unitigs, 2048, seed=8)
    mo = max(1, ref.max_occs())
    mref = mmi.ModIndex(ref.k2u, mwt, ref.refs, index_type="t")
    pwm_index = ModIndex(port.k2u, pwt, port.refs, index_type="t")
    want = mmi.get_ref_pos_padded(mref.device_arrays(), work, np, mo)
    d = arrays_from_numpy(pwm_index.device_arrays(), "cpu")
    got = pmi.get_ref_pos_padded(d, tensor(work), mo)
    plain = pmi.get_ref_pos_padded(arrays_from_numpy(port.device_arrays(), "cpu"), tensor(work),
                                   mo)
    assert set(got) == set(want)
    valid = got["valid"]
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)
        g, p = got[key], plain[key]
        if g.dim() == 2:  # the piscem table's pair rows pad past the table otherwise
            g, p = torch.where(valid, g, 0), torch.where(valid, p, 0)
        assert torch.equal(g, p), key
    assert bool((got["n_occs"] == 3).any())
    got_c, want_c = pc.ColorClasses.from_u2pos(pwt), mc.ColorClasses.from_u2pos(mwt)
    plain_c = pc.ColorClasses.from_u2pos(port.u2pos)
    for key in ("u2c", "offsets", "refs"):
        np.testing.assert_array_equal(getattr(got_c, key), getattr(want_c, key), err_msg=key)
        np.testing.assert_array_equal(getattr(got_c, key), getattr(plain_c, key), err_msg=key)


def test_wm_table_refusals_and_pos_to_id():
    """The paths that read a ctable raise by name on a WM table (the
    reference's fusion pass fails there with an ``AttributeError``);
    ``us_pos_to_id`` equals the host's on the plain and the paired rows."""
    ref, port, mwt, pwt = tables()
    pidx = ModIndex(port.k2u, pwt, port.refs, index_type="t")
    with pytest.raises(AttributeError):
        mmi.ModIndex(ref.k2u, mwt, ref.refs).device_arrays(fused=True)
    with pytest.raises(ValueError, match="the fusion pass.*WMUnitigTable"):
        pidx.device_arrays(fused=True)
    for build in (build_uproj, build_useqrec):
        with pytest.raises(ValueError, match="WMUnitigTable"):
            build(pwt, port.k2u.unitigs)
    us = port.k2u.unitigs
    pos = np.arange(us.total_len, dtype=np.int64)
    for paired in (False, True):
        d = arrays_from_numpy(us.device_arrays(paired=paired), "cpu")
        np.testing.assert_array_equal(us_pos_to_id(d, t(pos)).numpy(), us.pos_to_id(pos))
