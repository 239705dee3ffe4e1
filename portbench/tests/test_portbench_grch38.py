"""The GRCh38-shaped genome at small sizes: its layout against the
configuration's figures, and its unitigs against a brute-force
maximal-unitig compaction of the chromosomes' canonical k-mers."""

import json

import numpy as np
import pytest
import torch

from portbench import genome as G
from portbench.genomes import grch38 as GR
from portbench.harness import ROOT
from portbench.reference import kmers as K

CPU = torch.device("cpu")
CONFIG = json.loads((ROOT / "portbench/configs/hg-scale-fast32.json").read_text())


def tiny(**over) -> dict:
    """Three short chromosomes, dense with low-divergence repeat copies in
    both orientations, tandem arrays of period 1-3 and segmental
    duplications of stretches that hold repeat copies (so several copies
    share their substitutions)."""
    cfg = dict(CONFIG)
    cfg.update({
        "chromosomes": [["a", 4000], ["b", 2600], ["c", 1900]],
        "scale": 1.0,
        "families": [
            {"name": "young", "copies": 14, "share": 0.08, "consensus": 60,
             "anchor": "3prime", "divergence": 0.02},
            {"name": "old", "copies": 10, "share": 0.1, "consensus": 200, "anchor": "any",
             "divergence": 0.1},
        ],
        "ssr": {"share": 0.05, "period_max": 3, "len_min": 30, "len_mean": 45},
        "segdup": {"share": 0.2, "len_min": 150, "len_max": 500, "identity_min": 0.97,
                   "identity_max": 0.99},
    })
    cfg.update(over)
    return cfg


def _seq(words: np.ndarray, start: int, n: int) -> np.ndarray:
    return K.bases_at(torch.from_numpy(words.view(np.int64)),
                      torch.arange(start, start + n)).numpy().astype(np.uint8)


def _rc(s: np.ndarray) -> np.ndarray:
    return (3 - s[::-1]).copy()


def brute_unitigs(refs: list, k: int) -> set:
    """The maximal unitigs of the chromosomes' canonical k-mers, each as
    the smaller of its spelling and its reverse complement (bytes), by
    walking the bidirected graph of oriented k-mers in Python."""
    kmer = lambda a, i: a[i : i + k].tobytes()  # noqa: E731
    rc = lambda x: _rc(np.frombuffer(x, dtype=np.uint8)).tobytes()  # noqa: E731
    canon = lambda x: min(x, rc(x))  # noqa: E731
    succ, pred, ends, starts = {}, {}, set(), set()
    for seq in refs:
        for s in (seq, _rc(seq)):  # both strands
            starts.add(kmer(s, 0))
            ends.add(kmer(s, len(s) - k))
            for i in range(len(s) - k):
                succ.setdefault(kmer(s, i), set()).add(kmer(s, i + 1))
                pred.setdefault(kmer(s, i + 1), set()).add(kmer(s, i))

    def joined(x, y):
        return (succ.get(x) == {y} and pred.get(y) == {x} and x not in ends
                and y not in starts and canon(x) != canon(y))

    nodes = set(succ) | set(pred) | starts | ends
    seen, out = set(), set()
    for x in sorted(nodes):
        if canon(x) in seen:
            continue
        # back up to the unitig's first k-mer, then walk forward
        first, steps = x, 0
        while True:
            p = pred.get(first, set())
            if len(p) != 1 or not joined(next(iter(p)), first) or steps > len(nodes):
                break
            first = next(iter(p))
            steps += 1
        path, cur = [first], first
        while True:
            s = succ.get(cur, set())
            if len(s) != 1 or not joined(cur, next(iter(s))):
                break
            cur = next(iter(s))
            path.append(cur)
        assert not {canon(y) for y in path} & seen, "a k-mer in two unitigs"
        seen |= {canon(y) for y in path}
        spell = np.concatenate([np.frombuffer(path[0], dtype=np.uint8)]
                               + [np.frombuffer(y, dtype=np.uint8)[-1:] for y in path[1:]])
        out.add(min(spell.tobytes(), _rc(spell).tobytes()))
    return out


@pytest.mark.parametrize("seed,over", [
    (5, {}),
    (2**40 + 7, {}),
    (11, {"ssr": {"share": 0.15, "period_max": 2, "len_min": 40, "len_mean": 60}}),
    (3, {"annotation_seed": 9}),
])
def test_unitigs_are_the_brute_force_compaction(seed, over):
    cfg = tiny(**over)
    g = G.make(cfg, seed, CPU)
    k = g.k
    refs = [_seq(g.ref_host_words, int(g.ref_accum[r]), int(g.ref_lens[r]))
            for r in range(len(g.ref_lens))]
    uni = [_seq(g.host_words, int(g.accum[u]), int(g.accum[u + 1] - g.accum[u]))
           for u in range(g.n_unitigs)]
    assert (g.occ_o == 0).any() and (np.diff(g.offsets) > 2).any()
    # every chromosome is the concatenation of its unitig occurrences,
    # overlapping by k - 1, each its unitig forward or reverse-complemented
    uid = np.repeat(np.arange(g.n_unitigs), np.diff(g.offsets))
    assert np.array_equal(uid, g.occ_uid)
    for r, seq in enumerate(refs):
        on = np.flatnonzero(g.occ_ref == r)
        on = on[np.argsort(g.occ_pos[on], kind="stable")]
        at = 0
        for i in on:
            u, p = int(g.occ_uid[i]), int(g.occ_pos[i])
            want = uni[u] if g.occ_o[i] == 1 else _rc(uni[u])
            assert p == at and np.array_equal(seq[p : p + len(want)], want)
            at = p + len(want) - k + 1
        assert at == len(seq) - k + 1
    # every distinct canonical k-mer lies in exactly one unitig, once
    canon = lambda x: min(x.tobytes(), _rc(x).tobytes())  # noqa: E731
    held = [canon(u[i : i + k]) for u in uni for i in range(len(u) - k + 1)]
    every = {canon(s[i : i + k]) for s in refs for i in range(len(s) - k + 1)}
    assert len(held) == len(set(held)) and set(held) == every
    # the unitigs are the brute-force maximal ones
    assert {min(u.tobytes(), _rc(u).tobytes()) for u in uni} == brute_unitigs(refs, k)


def test_layout_follows_the_configuration():
    cfg = dict(CONFIG, scale=0.002)
    ann = GR.annotation(cfg)
    el, G_ = ann["elements"], int(ann["lens"].sum())
    assert np.array_equal(ann["lens"], np.round(np.array([c[1] for c in CONFIG["chromosomes"]])
                                                * 0.002).astype(np.int64))
    assert (np.diff(el["start"]) >= el["len"][:-1]).all() and el["start"][-1] + el["len"][-1] <= G_
    for f, fam in enumerate(CONFIG["families"]):
        s = (el["kind"] == GR.FAMILY) & (el["fam"] == f)
        assert s.sum() == round(fam["copies"] * 0.002)
        assert abs(el["len"][s].sum() / G_ - fam["share"]) < 0.2 * fam["share"]
        assert (el["len"][s] <= fam["consensus"]).all()
        assert abs(el["rate"][s].mean() - fam["divergence"]) < 0.15 * fam["divergence"]
        if fam["anchor"] == "3prime":
            assert (el["lo"][s] + el["len"][s] == fam["consensus"]).all()
        assert 0.4 < el["rev"][s].mean() < 0.6
    for kind, share in ((GR.SSR, CONFIG["ssr"]["share"]), (GR.SEGDUP,
                                                         CONFIG["segdup"]["share"] / 2)):
        s = el["kind"] == kind
        assert abs(el["len"][s].sum() / G_ - share) < 0.35 * share
    # the same annotation for every run: only the bases follow the seed, so
    # the multiplicities differ only where a random base happens to extend
    # a repeat
    a, b = G.make(cfg, 1, CPU), G.make(cfg, 2**33 + 5, CPU)
    assert not np.array_equal(a.ref_host_words, b.ref_host_words)
    for x, y in ((a.n_unitigs, b.n_unitigs), (len(a.occ_uid), len(b.occ_uid)),
                 (np.diff(a.offsets).max(), np.diff(b.offsets).max())):
        assert abs(x - y) <= 0.005 * x


def test_primitive_motifs():
    codes, periods = GR.primitive_motifs(6)
    assert len(codes) == 5356 and np.bincount(periods).tolist() == [0, 4, 12, 60, 240, 1020, 4020]
    assert 0b0100 in codes[periods == 2] and 0b0101 not in codes[periods == 2]
