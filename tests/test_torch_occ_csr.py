"""The ragged (CSR) phase 2 (``ops/occ_csr``) on the host: its plain
version against ``get_ref_pos_padded`` lane for lane and against
``mazu_tpu``'s ``get_ref_pos_csr`` with tolerance 0, at the budget's edges;
its dispatch; ``get_ref_pos_compact``, ``OneGraphIndexQuery`` and
``RunServePass`` on it; a whole run of the GRCh38-shaped cell on the host
against the benchmark's closed-form reference; the fast32 build's cut
heavy buckets; and the vectorised colour classes against the loop they
replace."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mazu_tpu.index.modindex as mmi

from mazu_tpu_torch import synth
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import colors as pc
from mazu_tpu_torch.index.modindex import (
    ModIndex, get_ref_pos_compact, get_ref_pos_padded, k2u_batch,
)
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery, RunServePass
from mazu_tpu_torch.index.pseudoalign import color_bitsets
from mazu_tpu_torch.io.reads import pack_reads
from mazu_tpu_torch.kphf import sshash as ps
from mazu_tpu_torch.ops import occ_csr

from torch_fixtures import build_mphf_pair, build_pair, seq_recipe, tensor, toy_recipe

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/hg-scale-fast32.json").read_text())
QUERY = {"probe_limit": 2, "defer_valid": True, "mphf_level_limit": 4}
CSR_KEYS = ("occ_start", "occ_count", "total", "qid", "ref_id", "ref_pos", "orient", "valid")


SCALE = 0.0006  # 1.85 Mbp of chromosomes: the largest unitig occurs 92 times


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run whole builds in torch's CPU ops: one thread each, so
    that six test workers do not oversubscribe the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def grch38(scale: float = SCALE, seed: int = 2**33 + 1):
    """A GRCh38-shaped genome at ``scale`` of the configuration's lengths and
    copy counts (the same repeat model), its fast32 index and query arrays
    on the host."""
    from portbench import genome as G
    from portbench.builds import fast32

    cfg = dict(CONFIG, scale=scale)
    g = G.make(cfg, seed, "cpu")
    index, qi = fast32.build(g, cfg, "cpu")
    return g, index, qi


@pytest.fixture(scope="module")
def genome():
    return grch38()


def read_lanes(g, n_reads: int, seed: int) -> torch.Tensor:
    """The k-mer words of ``n_reads`` reads of the genome (traffic's shares)."""
    from portbench.reference.checksums import read_lanes as lanes
    from portbench.traffic.reads import sample_codes

    mix = {"read_len": 150, "rc_share": 0.5, "foreign_share": 0.05, "n_share": 0.01}
    codes = sample_codes(g, n_reads, mix, np.random.default_rng(seed))
    return lanes(torch.from_numpy(codes), g.k)[0].reshape(-1).contiguous()


def phase2(qi, fw):
    """(lanes, n_ovf, the slots' exact K2U) of a chunk's phase 2."""
    d = qi.arrays()
    out = get_ref_pos_compact(d, fw, qi.max_occs, merge=False, m2=fw.shape[0], **QUERY)
    lanes = out["lanes"]
    return out, lanes, out["n_ovf"], k2u_batch(d, fw[lanes])


def test_the_genome_passes_the_padded_width(genome):
    _, _, qi = genome
    assert qi.max_occs > occ_csr.COLUMNS and occ_csr.engages(qi.arrays(), qi.max_occs)


def test_plain_equals_padded_lane_for_lane(genome):
    g, _, qi = genome
    d = qi.arrays()
    fw = read_lanes(g, 96, seed=3)
    _, lanes, n_ovf, r2 = phase2(qi, fw)
    n = int(n_ovf)
    assert 0 < n < fw.shape[0]
    got = occ_csr.occ_csr_plain(d, r2, n_ovf, 1 << 20)
    want = get_ref_pos_padded(d, fw[lanes[:n]], qi.max_occs)
    assert torch.equal(got["occ_count"][:n], torch.where(want["mt"] > 0, want["n_occs"], 0))
    assert not got["occ_count"][n:].any() and int(got["total"]) == int(got["occ_count"].sum())
    assert int(got["total"]) < (1 << 20) and (got["occ_count"][:n] > 2).any()
    start = got["occ_start"].tolist()
    for s in range(n):
        c = int(got["occ_count"][s])
        sl = slice(start[s], start[s] + c)
        assert (got["qid"][sl] == s).all()
        for key in ("ref_id", "ref_pos", "orient"):
            assert torch.equal(got[key][sl].to(torch.int64), want[key][s, :c].to(torch.int64)), key


@pytest.fixture(scope="module")
def pair():
    """Both packages' fast32 indexes over a small GRCh38-shaped genome whose
    repeat copies lie in both orientations."""
    from portbench import genome as G
    from portbench.reference.kmers import bases_at

    cfg = dict(CONFIG, chromosomes=[["a", 6000], ["b", 4000]], scale=1.0,
               families=[{"name": "young", "copies": 40, "share": 0.2, "consensus": 80,
                          "anchor": "3prime", "divergence": 0.02}],
               segdup={"share": 0.1, "len_min": 200, "len_max": 800, "identity_min": 0.97,
                       "identity_max": 0.99})
    g = G.make(cfg, 5, "cpu")
    words = torch.from_numpy(g.host_words.view(np.int64))
    seqs = ["".join("ACGT"[c] for c in bases_at(words, torch.arange(int(g.accum[u]),
                                                                     int(g.accum[u + 1]))))
            for u in range(g.n_unitigs)]
    recipe = (seqs, g.k, (g.occ_uid, g.occ_ref, g.occ_pos, g.occ_o), g.ref_lens)
    ref, port = build_mphf_pair(recipe, w=19, skew=64)
    return g, ref, port


@pytest.mark.parametrize("extra", [5, 0, -1, -200], ids=["above", "full", "one over", "below"])
def test_plain_equals_the_references_csr(pair, extra):
    g, ref, port = pair
    host = ref.device_arrays()
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    rng = np.random.default_rng(4)
    fw_np = g.host_words.view(np.uint64)  # any words: k-mers of the unitigs and misses
    from portbench.reference.kmers import kmer_at

    u = rng.integers(0, g.n_unitigs, 300)
    span = np.diff(g.accum)[u] - g.k + 1
    pos = g.accum[u] + (rng.random(300) * span).astype(np.int64)
    fw = kmer_at(torch.from_numpy(fw_np.view(np.int64)), torch.from_numpy(pos), g.k)
    fw = torch.cat([fw, torch.tensor([7, 99, 12345])])
    r = k2u_batch(d, fw)
    total = int(torch.where(r["mt"] > 0, d["u2pos"]["offsets"][r["unitig_id"] + 1]
                            - d["u2pos"]["offsets"][r["unitig_id"]], 0).sum())
    assert total > fw.shape[0] * 3 // 2
    budget = total + extra
    want = mmi.get_ref_pos_csr(host, fw.numpy().view(np.uint64), np, budget)
    got = occ_csr.occ_csr_plain(d, r, torch.tensor(fw.shape[0]), budget)
    for key in CSR_KEYS:
        np.testing.assert_array_equal(got[key].numpy().astype(np.int64),
                                      np.asarray(want[key]).astype(np.int64), err_msg=key)
    assert int(got["valid"].sum()) == min(total, budget) and int(got["total"]) == total


def test_fake_slots_and_the_budget_edge(genome):
    g, _, qi = genome
    d = qi.arrays()
    fw = read_lanes(g, 48, seed=5)
    out, lanes, n_ovf, r2 = phase2(qi, fw)
    total = int(out["phase2"]["total"])
    # the slots past n_ovf count nothing, whatever their lanes hold
    half = occ_csr.occ_csr_plain(d, r2, n_ovf // 2, total)
    assert not half["occ_count"][int(n_ovf) // 2:].any() and int(half["total"]) < total
    for budget, over in ((total, False), (total - 1, True)):
        res = get_ref_pos_compact(d, fw, qi.max_occs, merge=False, m2=fw.shape[0],
                                  occ_budget=budget, **QUERY)
        p2 = res["phase2"]
        assert bool(res["over_budget"]) == over and int(p2["total"]) == total
        assert int(p2["valid"].sum()) == min(total, budget) and p2["ref_pos"].shape[0] == budget
        live = slice(0, min(total, budget))
        word = fw[res["lanes"]][p2["qid"][live].to(torch.int64)]
        want = (p2["ref_pos"][live] + p2["ref_id"][live] + p2["orient"][live] + 2 * word).sum()
        assert int(occ_csr.occurrence_sum(p2, fw[res["lanes"]])) == int(want)


def test_dispatch_never_engages_on_mono2_occ32():
    _, port = build_pair(toy_recipe())
    d = arrays_from_numpy(port.device_arrays(), "cpu")
    m = d["k2u"]["meta"]
    assert m.kind == "kcdict" and m.scheme == "mono2" and m.occ32
    for mo in (1, occ_csr.COLUMNS + 1, 1 << 20):
        assert not occ_csr.engages(d, mo)


def test_dispatch_by_padded_width(genome):
    _, _, qi = genome
    d = qi.arrays()
    assert not occ_csr.engages(d, occ_csr.COLUMNS) and occ_csr.engages(d, occ_csr.COLUMNS + 1)
    fw = tensor(np.arange(1, 300, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15 >> 2))
    narrow = get_ref_pos_compact(d, fw, occ_csr.COLUMNS, merge=False, m2=300, **QUERY)
    assert "total" not in narrow["phase2"] and narrow["phase2"]["ref_id"].dim() == 2
    # merge=True keeps the padded result
    merged = get_ref_pos_compact(d, fw, qi.max_occs, merge=True, m2=300, **QUERY)
    assert merged["ref_id"].shape == (fw.shape[0], qi.max_occs)


def test_one_graph_query_checksum(genome):
    g, _, qi = genome
    d = qi.arrays()
    stack = torch.stack([read_lanes(g, 16, seed=s) for s in (6, 7)])
    q = OneGraphIndexQuery(qi, stack.shape[1], n_chunks=2, m2=stack.shape[1], graph=False,
                           **QUERY)
    assert q.OCC == stack.shape[1] * occ_csr.COLUMNS
    tot, worst = q.checksum_pass(stack)
    want = 0
    for chunk in stack:
        p = get_ref_pos_padded(d, chunk, qi.max_occs)
        hit = p["mt"] > 0
        # a ragged phase 2 also sums each occurrence's orientation and twice its k-mer
        want += int(torch.where(p["valid"], p["ref_pos"] + p["ref_id"] + p["orient"]
                                + 2 * chunk[:, None], 0).sum()
                    + torch.where(hit, p["unitig_id"] + p["pos"], 0).sum())
    assert tot == want and 0 < worst <= stack.shape[1]
    small = OneGraphIndexQuery(qi, stack.shape[1], n_chunks=2, m2=stack.shape[1], graph=False,
                               m2c=1, **QUERY)
    with pytest.raises(RuntimeError, match="residue capacity"):
        small.checksum_pass(stack)


@pytest.mark.parametrize("short", [0, 1], ids=["enough", "one short"])
def test_ragged_k2u_equals_the_full_k2u(genome, short):
    """The ragged phase's K2U (the main probe again at full depth, the full
    K2U for its residue only) equals the full K2U on every real slot, and
    tells a residue past its capacity."""
    from mazu_tpu_torch.index.modindex import _ragged_k2u

    g, _, qi = genome
    d = qi.arrays()
    fw = read_lanes(g, 64, seed=10)
    out, lanes, n_ovf, want = phase2(qi, fw)
    real = out["slot_real"]
    _, n_rest = _ragged_k2u(d, fw[lanes], real, fw.shape[0])
    n_rest = int(n_rest)
    assert 0 < n_rest < int(n_ovf)
    got, n_c = _ragged_k2u(d, fw[lanes], real, n_rest - short)
    assert int(n_c) == n_rest
    wrong = torch.zeros_like(real)
    for key in got:
        wrong |= real & (got[key] != want[key])
    assert int(wrong.sum()) == 0 if not short else 0 < int(wrong.sum()) <= 1


def test_serve_pass_reads_back_totals_and_raises_past_the_budget(genome):
    g, index, qi = genome
    from portbench.traffic.reads import sample_codes

    mix = {"read_len": 150, "rc_share": 0.5, "foreign_share": 0.05, "n_share": 0.01}
    codes = sample_codes(g, 64, mix, np.random.default_rng(8))
    reads = ["".join("ACGTN"[c] for c in row) for row in codes]
    packed = pack_reads(reads, 31)
    cb = arrays_from_numpy(color_bitsets(index.color_classes()), "cpu")
    sp = RunServePass(qi, cb, 32, 2, 32 * 120, 150, graph=False, **QUERY)
    assert sp.ragged and sp.occ_budget == 32 * 120 * occ_csr.COLUMNS
    maps, pas, n_ovf = sp(packed)
    assert len(sp.occ_totals) == 2 and min(sp.occ_totals) > 0
    tight = RunServePass(qi, cb, 32, 2, 32 * 120, 150, graph=False,
                         occ_budget=max(sp.occ_totals), **QUERY)
    assert tight(packed) == (maps, pas, n_ovf)
    over = RunServePass(qi, cb, 32, 2, 32 * 120, 150, graph=False,
                        occ_budget=max(sp.occ_totals) - 1, **QUERY)
    with pytest.raises(RuntimeError, match="occurrence budget"):
        over(packed)


def test_the_cell_is_correct_on_the_host():
    from portbench.harness import cell_spec, run_cell

    R = 96
    spec = cell_spec("hg-scale-fast32.reads", {
        "config": {"scale": SCALE}, "mix": {"chunks": 2, "reads_per_chunk": R, "pool": 2,
                                            "trace_batches": 2, "n_share": 0.2},
        "capacity": {"m2": R * 120, "occ_budget": 200000}})
    out = run_cell(spec, 2**31 + 77, 0.3, False, "cpu")
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["wrong_batches"]["value"] == 0


def test_capped_buckets_answer_as_the_whole_ones():
    """A heavy bucket cut to skew + 1 positions (the grouped bounds' layout
    where whole buckets would overflow a group) gives every query the same
    answer as the whole bucket, in main and full mode."""
    unitigs, refs, u2pos = synth.build_synthetic(400_000, 0, heavy_sites=synth.HEAVY_SITES,
                                                 w=synth.MPHF_W, tag_sites=True)
    ss = ps.SSHash.from_unitig_set(unitigs, w=synth.MPHF_W, skew_param=synth.CAP_SKEW,
                                   gamma=synth.MPHF_GAMMA, engine="fast32", device="cpu")
    assert ss.capped is None and ss.max_bucket() > synth.CAP_SKEW
    index = ModIndex(ss, u2pos, refs)
    whole = arrays_from_numpy(index.device_arrays(**synth.MPHF_LAYOUT), "cpu")
    pos = torch.from_numpy(ss.pos.to_array().view(np.int64))
    prefix = torch.from_numpy(ss.occs_prefix_sum)
    ss.capped = ps._capped_buckets(pos, prefix, synth.CAP_SKEW + 1, ss.pos.width)
    cut = arrays_from_numpy(index.device_arrays(**synth.MPHF_LAYOUT), "cpu")
    assert cut["k2u"]["pos"]["meta"].length < whole["k2u"]["pos"]["meta"].length
    work, _, _ = synth.sample_capacity_queries(unitigs, 4096, seed=2)
    fw = tensor(work)
    for kw in ({"mode": "main", "probe_limit": 2, "defer_valid": True, "mphf_level_limit": 4},
               {"mode": "full"}):
        a, b = ps.sshash_k2u(whole["k2u"], fw, **kw), ps.sshash_k2u(cut["k2u"], fw, **kw)
        assert set(a) == set(b) and all(torch.equal(a[key], b[key]) for key in a), kw
        if kw["mode"] == "main":
            assert bool(a["use_skew"].any())


def colour_loop(table):
    """``ColorClasses.from_u2pos`` as it was built before: a Python loop over
    the unitigs, each row of references looked up by its bytes."""
    from mazu_tpu_torch.index.unitig_table import decode_occs

    n = table.n_unitigs
    offsets = np.asarray(table.offsets, dtype=np.int64)
    total = int(offsets[-1])
    d = arrays_from_numpy(table.device_arrays(), "cpu")
    ref_id = decode_occs(d, torch.arange(total, dtype=torch.int64))[0].numpy()
    uid = np.searchsorted(offsets, np.arange(total, dtype=np.int64), side="right") - 1
    n_refs = int(ref_id.max()) + 1 if total else 0
    key = np.unique(uid * np.int64(max(n_refs, 1)) + ref_id)
    p_uid = key // max(n_refs, 1)
    p_ref = (key % max(n_refs, 1)).astype(np.int32)
    bounds = np.searchsorted(p_uid, np.arange(n + 1, dtype=np.int64))
    classes, rows = {}, []
    u2c = np.zeros(n, dtype=np.int32)
    for u in range(n):
        row = p_ref[bounds[u] : bounds[u + 1]]
        cid = classes.setdefault(row.tobytes(), len(rows))
        if cid == len(rows):
            rows.append(row)
        u2c[u] = cid
    coff = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int64)
    return u2c, coff, np.concatenate(rows).astype(np.int32), n_refs


@pytest.mark.parametrize("which", ["grch38", "seventy refs", "toy"])
def test_vectorised_colour_classes_equal_the_loop(which, genome):
    if which == "grch38":
        table = genome[1].u2pos
    else:
        recipe = toy_recipe() if which == "toy" else seq_recipe(n_refs=70, length=200,
                                                                every=3)[0]
        table = build_pair(recipe)[1].u2pos
    u2c, coff, refs, n_refs = colour_loop(table)
    cc = pc.ColorClasses.from_u2pos(table)
    for got, want in ((cc.u2c, u2c), (cc.offsets, coff), (cc.refs, refs)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert cc.n_refs == n_refs


@pytest.mark.parametrize("seed", [0, 1])
def test_row_grouping_equals_the_byte_keyed_loop(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4, 500)
    bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    vals = rng.integers(0, 3, int(bounds[-1])).astype(np.int32)
    got, want = pc._group_rows(vals, bounds), pc._group_rows_by_bytes(vals, bounds)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_marked_passes_count_the_ragged_phase_and_builds_are_spanned(genome):
    """A marked serve pass puts the ragged phase's lanes and occurrences in
    ``phase2.lanes`` and ``phase2.occurrences`` and its budget in
    ``phase2.slots``; the colour classes and the fast32 build run inside
    their spans ``colors.build`` and ``sshash.build``."""
    from mazu_tpu_torch import trace

    g, index, qi = genome
    from portbench.traffic.reads import sample_codes

    mix = {"read_len": 150, "rc_share": 0.5, "foreign_share": 0.05, "n_share": 0.01}
    codes = sample_codes(g, 32, mix, np.random.default_rng(9))
    packed = pack_reads(["".join("ACGTN"[c] for c in row) for row in codes], 31)
    trace.reset()
    trace.enable(stages=True)
    try:
        cb = arrays_from_numpy(color_bitsets(index.color_classes()), "cpu")
        sp = RunServePass(qi, cb, 16, 2, 16 * 120, 150, graph=False, **QUERY)
        _, _, n_ovf = sp(packed)
        ps.SSHash.from_unitig_set(index.k2u.unitigs, w=19, skew_param=64, gamma=1.7,
                                  engine="fast32", device="cpu")
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    c = snap["counters"]
    assert c["phase2.lanes"] == sum(n_ovf) > 0
    assert c["phase2.occurrences"] == sum(sp.occ_totals) > 0
    assert c["phase2.slots"] == 2 * sp.occ_budget
    names = {s["name"] for s in snap["spans"]}
    assert {"colors.build", "sshash.build"} <= names
    build = next(s for s in snap["spans"] if s["name"] == "sshash.build")
    assert build["attrs"]["engine"] == "fast32" and "skew" in build["attrs"]
