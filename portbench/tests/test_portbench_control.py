"""What ``correct`` must refuse, on the host at small sizes: the control
(the reference with every k-mer's occurrences cut to two, the main
phase's width) and the timed path broken underneath a whole run (a pass
that returns its state unchanged, half the batch left out and the rest
counted twice, one answer's offset altered where the probe produces it,
and, for the k-mer cell, one answer's orientation flipped there, which
only the check after the window sees). A cell on one card has no exchange
between chips to leave out."""

import pytest
import torch

from mazu_tpu_torch.index import pipeline, twophase
from portbench import control
from portbench.harness import run_cell
from portbench.tests.small import CELLS, small_spec

SEED = 2**31 + 321


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_wrong(cell):
    wrong, n = control.control_wrong(small_spec(cell), SEED, torch.device("cpu"))
    assert n == 3 and wrong == n


def _stale(monkeypatch):
    """Every pass returns the first pass's result: a graph never replayed."""
    for cls, name in ((pipeline.OneGraphIndexQuery, "checksum_pass"),
                      (pipeline.RunServePass, "__call__")):
        orig, first = getattr(cls, name), []

        def stuck(self, x, _orig=orig, _first=first):
            out = _orig(self, x)
            if not _first:
                _first.append(out)
            return _first[0]

        monkeypatch.setattr(cls, name, stuck)


def _half(monkeypatch):
    """Half of the chunks left out, the first half's sums counted for the
    whole."""
    orig_q = pipeline.OneGraphIndexQuery._run

    def half_q(self, chunks):
        res = orig_q(self, chunks[: len(chunks) // 2]).clone()
        res[0] = res[0] * 2
        return res

    orig_s = pipeline.RunServePass._run

    def half_s(self, m, flat):
        res = orig_s(self, m, flat).clone()
        h = res.shape[0] // 2
        res[h:] = res[:h]
        return res

    monkeypatch.setattr(pipeline.OneGraphIndexQuery, "_run", half_q)
    monkeypatch.setattr(pipeline.RunServePass, "_run", half_s)


def _probe_fault(monkeypatch, change):
    """``change(r, lane)`` on the main probe's result at one lane that the
    main phase settles."""
    orig = twophase.mono2_k2u

    def probe(*args, **kw):
        r = dict(orig(*args, **kw))
        ok = (r["mt"] > 0) & (r["occ_cnt"] <= 2)
        for key in ("unresolved", "use_skew"):
            ok = ok & ~r[key]
        change(r, int(torch.nonzero(ok)[0]))
        return r

    monkeypatch.setattr(twophase, "mono2_k2u", probe)


def _altered(monkeypatch):
    """One lane's offset off by one where the main probe produces it."""
    def change(r, lane):
        r["pos"] = r["pos"].clone()
        r["pos"][lane] += 1

    _probe_fault(monkeypatch, change)


def _flipped(monkeypatch):
    """One lane's orientation flipped where the main probe produces it:
    the pass's sums do not hold it."""
    def change(r, lane):
        r["mt"] = r["mt"].clone()
        r["mt"][lane] = 3 - r["mt"][lane]

    _probe_fault(monkeypatch, change)


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_cell(small_spec(cell), SEED, 6.0, False, "cpu")
    assert out["attempted"] >= 2 and not out["correct"]
    assert out["checks"]["wrong_batches"]["value"] > 0


def test_a_flipped_orientation_is_not_correct(monkeypatch):
    _flipped(monkeypatch)
    out = run_cell(small_spec("tx50-mono2.kmers"), SEED, 6.0, False, "cpu")
    assert out["attempted"] >= 2 and not out["correct"]
    assert out["checks"]["wrong_batches"]["value"] == out["attempted"]
