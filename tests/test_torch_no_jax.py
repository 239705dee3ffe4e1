"""The port runs where there is no JAX: every module imports, and tiny
indexes (the mono2 KCDict, the SSHash capacity tier, the MPHF capacity
tier, built on the device's code path and also with its MPHF in the
``mrows`` layout, the SSHash speed tier and the pufferfish dense and sparse
indexes; the speed tier's fixedcap rows, ``TwoPhaseSSHash`` and a
wavelet-matrix occurrence table) answer queries, the device pack and BooPHF32 build run, a lab
kernel's plain version runs, and a tiny serve pass (FASTQ, packing in the
host library, device k-merization, map, pseudoalignment), ``validate_self``,
a flat streaming pass, a read mapper and the CLI's parity build, its
checkpoint loaded and validated, a mono sharded query (``SerialMesh``,
from a sharded checkpoint with ``validate_k2u_self_sharded``, and on two
spawned gloo ranks, which load no JAX either) run, with ``jax`` blocked
from importing."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import mazu_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
mods = sys.argv[1:]
for name in mods:
    importlib.import_module(name)

import numpy as np, torch
from mazu_tpu_torch import synth
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index.modindex import QueryIndex, get_ref_pos_compact
from mazu_tpu_torch.index.pipeline import OneGraphIndexQuery

index = synth.build_index(5 * synth.PIECE)
qi = QueryIndex(arrays_from_numpy(index.device_arrays(), "cpu"))
q = torch.from_numpy(synth.sample_queries(index.k2u.unitigs, 512, seed=1).view(np.int64))
out = get_ref_pos_compact(qi.arrays(), q, qi.max_occs, merge=True, m2=512)
assert not bool(out["over_budget"]) and (out["mt"] > 0).any()
chk, worst = OneGraphIndexQuery(qi, 512, n_chunks=2, m2=512).checksum_pass_rolled(q)
assert chk > 0

cap = synth.build_capacity_index(8 * synth.PIECE, heavy_sites=128, device="cpu")
cq = QueryIndex(arrays_from_numpy(cap.device_arrays(**synth.CAPACITY_LAYOUT), "cpu"))
words, uid, upos = synth.sample_capacity_queries(cap.k2u.unitigs, 512, seed=1)
out = get_ref_pos_compact(cq.arrays(), torch.from_numpy(words.view(np.int64)), cq.max_occs,
                          merge=True, m2=512, probe_limit=2, m2b=512, defer_valid=True,
                          probe_limit2=4, m2c=512)
assert not bool(out["over_budget"]) and bool((out["mt"] > 0).all())
assert (out["unitig_id"].numpy() == uid).all() and (out["pos"].numpy() == upos).all()

mp = synth.build_mphf_index(8 * synth.PIECE, heavy_sites=128, device="cpu")
mq = QueryIndex(arrays_from_numpy(mp.device_arrays(**synth.MPHF_LAYOUT), "cpu"))
words, uid, upos = synth.sample_capacity_queries(mp.k2u.unitigs, 512, seed=2)
out = get_ref_pos_compact(mq.arrays(), torch.from_numpy(words.view(np.int64)), mq.max_occs,
                          merge=True, m2=512, m2b=512, m2c=512, **synth.MPHF_QUERY)
assert not bool(out["over_budget"]) and bool((out["mt"] > 0).all())
assert (out["unitig_id"].numpy() == uid).all() and (out["pos"].numpy() == upos).all()
assert {"scan", "sort and runs", "mphf build", "pack"} <= set(mp.k2u.build_seconds)
rq = QueryIndex(arrays_from_numpy(mp.device_arrays(mphf_rows=True, **synth.MPHF_LAYOUT), "cpu"))
out2 = get_ref_pos_compact(rq.arrays(), torch.from_numpy(words.view(np.int64)), rq.max_occs,
                           merge=True, m2=512, m2b=512, m2c=512, **synth.MPHF_QUERY)
assert all(torch.equal(out[k], out2[k]) for k in out)
from mazu_tpu_torch.bits.intvector import IntVector
from mazu_tpu_torch.kphf.boophf32 import BooPHF32
v = np.arange(1000, dtype=np.uint64) * np.uint64(4294967311)
assert (IntVector.from_tensor(torch.from_numpy(v.view(np.int64))).words
        == IntVector.from_array(v).words).all()
assert BooPHF32.build(v, device="cpu").n_elem == 1000

from mazu_tpu_torch.index.twophase import ReadBatchQuery, TwoPhaseIndexQuery
sp = synth.build_speed_index(8 * synth.PIECE, device="cpu")
sq = QueryIndex(arrays_from_numpy(sp.device_arrays(**synth.SPEED_LAYOUT), "cpu"))
words, uid, upos = synth.sample_capacity_queries(sp.k2u.unitigs, 512, seed=4)
out = get_ref_pos_compact(sq.arrays(), torch.from_numpy(words.view(np.int64)), sq.max_occs,
                          merge=True, m2=512, probe_limit=2)
assert not bool(out["over_budget"]) and bool((out["mt"] > 0).all())
assert (out["unitig_id"].numpy() == uid).all() and (out["pos"].numpy() == upos).all()
fw = torch.from_numpy(words.view(np.int64))
chk = TwoPhaseIndexQuery(sp, device="cpu").checksum_query(fw)
nr = torch.ones(512, dtype=torch.bool)
assert ReadBatchQuery(sp, device="cpu").checksum_query(fw, words, nr) == chk
fq = QueryIndex(arrays_from_numpy(sp.device_arrays(fused=True, pos_kind="fixedcap"), "cpu"))
assert ReadBatchQuery(fq).checksum_query(fw, words, nr)[0] == chk[0]
from mazu_tpu_torch.kphf.sshash import TwoPhaseSSHash, sshash_k2u
assert (TwoPhaseSSHash(sp.k2u, device="cpu").k2u(words)["unitig_id"] == uid).all()
f2 = arrays_from_numpy(sp.k2u.device_arrays(pos_kind="fixedcap2"), "cpu")
assert (sshash_k2u(f2, fw)["unitig_id"].numpy() == uid).all()
from mazu_tpu_torch.bits.wm import WaveletMatrix
from mazu_tpu_torch.index.modindex import ModIndex, get_ref_pos_padded
from mazu_tpu_torch.index.unitig_table import WMUnitigTable
sym = np.arange(300, dtype=np.uint8) % 7
assert (WaveletMatrix.build(sym, 7).access(np.arange(300)) == sym).all()
wq = QueryIndex(arrays_from_numpy(
    ModIndex(sp.k2u, WMUnitigTable.from_piscem(sp.u2pos), sp.refs).device_arrays(), "cpu"))
out = get_ref_pos_padded(wq.arrays(), fw, wq.max_occs)
assert bool((out["mt"] > 0).all()) and (out["unitig_id"].numpy() == uid).all()

from mazu_tpu_torch.index.modindex import get_ref_pos_padded
from mazu_tpu_torch.ops import gather_lab
genome = synth.synthetic_spt(4 * synth.PIECE)
words, uid, off, foreign = synth.sample_queries_truth(genome[0], 512, seed=3)
for build in (synth.build_pf1_dense_index, synth.build_pf1_sparse_index):
    pq = QueryIndex(arrays_from_numpy(build(0, device="cpu", genome=genome).device_arrays(), "cpu"))
    out = get_ref_pos_padded(pq.arrays(), torch.from_numpy(words.view(np.int64)), pq.max_occs)
    assert ((out["mt"] > 0).numpy() == ~foreign).all()
    assert (out["unitig_id"].numpy()[~foreign] == uid[~foreign]).all()
idx = torch.arange(64, dtype=torch.int32) % 16
assert gather_lab.xor_rows(idx, torch.ones(16, 128, dtype=torch.int32)).eq(0).all()
import os, tempfile
from mazu_tpu_torch.index.pipeline import RunServePass
from mazu_tpu_torch.index.pseudoalign import color_bitsets
from mazu_tpu_torch.index.validate import validate_self
from mazu_tpu_torch.io.reads import pack_fastq
from mazu_tpu_torch.kmer import codes_to_seq
validate_self(index, device="cpu")
cb = arrays_from_numpy(color_bitsets(index.color_classes()), "cpu")
codes = index.refs.seq.get_base(np.arange(index.refs.prefix_sum[-1]))
starts = np.random.default_rng(1).integers(0, len(codes) - 150, 64)
with tempfile.TemporaryDirectory() as tmp:
    fq = os.path.join(tmp, "reads.fastq")
    with open(fq, "w") as f:
        for i, s in enumerate(starts):
            sq = codes_to_seq(codes[s : s + 150])
            f.write(f"@r{i}\\n{sq[:70]}N{sq[71:]}\\n+\\n{'I' * 150}\\n")
    maps, pas, novf = RunServePass(qi, cb, 32, 2, 4096, 150, graph=False)(pack_fastq(fq, 31))
assert all(c > 0 for c in maps) and all(p != 0 for p in pas)
from mazu_tpu_torch.index.mapping import ReadMapper
from mazu_tpu_torch.index.streaming import StreamingIndex, kmerize_reads
from mazu_tpu_torch.io.native import library
library()
reads = [codes_to_seq(codes[s : s + 150]) for s in starts[:16]]
kms, valid, _ = kmerize_reads(reads, 31)
flat = StreamingIndex(index, mode="flat", device="cpu").k2u_reads(kms, valid)
assert (flat["mt"][valid] > 0).all()
hits = ReadMapper(index, device="cpu").map_reads(reads)
assert all(h.n_hit == h.n_kmers == 120 for h in hits)
from mazu_tpu_torch.cli import main as cli_main
from mazu_tpu_torch.io.checkpoint import load_index
from mazu_tpu_torch.index.validate import validate_fasta
with tempfile.TemporaryDirectory() as tmp:
    prefix, fa, npz = (os.path.join(tmp, n) for n in ("g", "g.fa", "g.npz"))
    synth.write_cf(prefix, 4 * synth.PIECE, fasta=fa)
    import contextlib, io
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        assert cli_main(["--torch-device", "cpu", "index", "build", "piscem", "-p", prefix,
                         "-o", npz]) == 0
        loaded = load_index(npz)
        assert loaded.k2u.ordering == "mix64" and loaded.k2u.mphf is not None
        validate_fasta(loaded, fa, device="cpu")
        assert cli_main(["--torch-device", "cpu", "index", "validate-fasta", "-i", npz,
                         "-f", fa]) == 0
    assert said.getvalue().splitlines() == [f"wrote {npz}", "valid"]
from mazu_tpu_torch.index.validate import validate_k2u_self_sharded
from mazu_tpu_torch.io import sharded_ckpt
from mazu_tpu_torch.parallel import sharding
from mazu_tpu_torch.parallel.launch import launch, sharded_queries_rank
from mazu_tpu_torch.parallel.mesh import SerialMesh
words = synth.sample_queries(index.k2u.unitigs, 512, seed=5)
mono = sharding.make_mono_sharded_query(index, SerialMesh(1, 2), m2=512)(
    torch.from_numpy(words.view(np.int64)))
with tempfile.TemporaryDirectory() as tmp:
    sharded_ckpt.save_mono_sharded(tmp, index, 2)
    q2 = sharded_ckpt.make_mono_sharded_query_from_ckpt(tmp, SerialMesh(2, 2), m2=1024)
    validate_k2u_self_sharded(q2, index.k2u, batch=2048, n_kmers=4096)
outs = launch(sharded_queries_rank, 2, 1, 2, [("mono", "make_mono_sharded_query", (index,),
                                                {"m2": 512}, words)])
assert not any(o["jax_loaded"] for o in outs)
assert all(torch.equal(o["mono"]["main"]["unitig_id"], mono["main"]["unitig_id"]) for o in outs)
leaked = sorted(m for m in sys.modules if m == "mazu_tpu" or m.startswith("mazu_tpu."))
assert not leaked, leaked
print("OK", len(mods))
"""


def _modules():
    names = [mazu_tpu_torch.__name__]
    for info in pkgutil.walk_packages(mazu_tpu_torch.__path__, mazu_tpu_torch.__name__ + "."):
        names.append(info.name)
    return names


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_and_queries_without_jax():
    mods = _modules()
    assert "mazu_tpu_torch.ops.mono2_probe" in mods and "mazu_tpu_torch.synth" in mods
    assert "mazu_tpu_torch.ops.bpos_probe" in mods and "mazu_tpu_torch.kphf.sshash" in mods
    assert "mazu_tpu_torch.ops.capacity_probe" in mods and "mazu_tpu_torch.kphf.boophf32" in mods
    for name in ("hashes", "kphf.boophf", "kphf.pfhash", "kphf.sampled", "io.pf1",
                 "io.pf1_index", "ops.gather_lab", "labs.gather_probe", "labs.dma_lab",
                 "io.fasta", "io.fastq", "io.cuttlefish", "io.reads", "index.streaming",
                 "index.validate", "index.colors", "index.pseudoalign", "io.native",
                 "index.mapping", "index.tuning", "kphf.runshare", "cli", "io.checkpoint",
                 "bits.elias_fano", "index.piscem_index", "bits.wm", "parallel.mesh",
                 "parallel.sharding", "parallel.launch", "io.sharded_ckpt"):
        assert f"mazu_tpu_torch.{name}" in mods, name
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, *mods], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=_env(),
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"OK {len(mods)}"


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke script fails before any result, and not
    for want of JAX."""
    code = (
        "import runpy, sys; sys.modules['jax'] = None; sys.argv = ['chip_smoke.py']; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=_env(),
    )
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert '"ok"' not in res.stdout
