"""The plain reference against the port's plain path on the host: answer
by answer, and whole runs of each cell."""

import numpy as np
import pytest
import torch

from mazu_tpu_torch.index.modindex import get_ref_pos_padded
from portbench import genome as G
from portbench.builds import mono2
from portbench.harness import run_cell
from portbench.reference.checksums import kmer_sums, wrap
from portbench.reference.lookup import Layout, answer, locate, orientations
from portbench.traffic import kmers as TK
from portbench.tests.small import CELLS, small_spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [31, 2**33 + 1])
def test_answers_lane_by_lane(seed):
    spec = small_spec("tx50-mono2.kmers")
    g = G.make(spec["config"], seed, CPU)
    index, qi = mono2.build(g, spec["config"], CPU)
    q = TK.sample(g, 1 << 13, spec["mix"], G.torch_generator(np.random.default_rng(3), CPU))
    port = get_ref_pos_padded(qi.arrays(), q, qi.max_occs)
    layout = Layout(g, CPU)
    a = answer(layout, q, locate(layout, q).first)
    for key in ("unitig_id", "pos", "unitig_len"):
        assert torch.equal(a[key], torch.where(a["hit"], port[key], 0)), key
    assert torch.equal(a["mt"], port["mt"].to(torch.int64))
    mine = orientations(layout, a)
    for i in range(q.shape[0]):
        n = int(port["n_occs"][i])
        theirs = {(int(port["ref_id"][i, j]), int(port["ref_pos"][i, j]),
                   int(port["orient"][i, j])) for j in range(n)}
        assert set(mine[i]) == theirs, i


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_host(cell):
    out = run_cell(small_spec(cell), 2**31 + 99, 0.5, False, "cpu")
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and out["checks"]["wrong_batches"]["value"] == 0


def test_a_repeated_kmer_has_two_right_sums():
    spec = small_spec("tx50-mono2.kmers")
    g = G.make(spec["config"], 4, CPU)
    # copy the k-mer at offset 3 of one unitig over offset 2 of another
    long = np.flatnonzero(np.diff(g.accum) >= 40)
    src, dst = int(g.accum[long[0]]) + 3, int(g.accum[long[1]]) + 2
    for j in range(31):
        s, d = src + j, dst + j
        base = (int(g.host_words[s >> 5]) >> (2 * (s & 31))) & 3
        sh = np.uint64(2 * (d & 31))
        g.host_words[d >> 5] = (g.host_words[d >> 5] & ~(np.uint64(3) << sh)) | (np.uint64(base) << sh)
    layout = Layout(g, CPU)
    from portbench.reference.kmers import kmer_at

    word = kmer_at(layout.words, torch.tensor([src]), 31)
    pool = torch.zeros(1, 1, 8, dtype=torch.int64) + word
    loc = locate(layout, pool)
    assert loc.count.tolist() == [2] * 8 and loc.more[0] == [src, dst]
    sums = kmer_sums(layout, pool, loc)[0]
    assert len(sums) > 8  # eight lanes, each with either answer
    one = kmer_sums(layout, pool, type(loc)(loc.count, loc.first, {}))[0]
    assert one <= sums and all(wrap(a) == a and wrap(b) == b for a, b in sums)
