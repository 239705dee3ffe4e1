"""``python -m mazu_tpu_torch.cli`` against ``python -m mazu_tpu.cli``: every
subcommand run through both CLIs (in-process, the port's with
``--torch-device cpu``) on the same cuttlefish files, FASTA and FASTQ. Their
exit codes are equal and their standard output is equal line for line once
the time values are masked and each CLI's own output directory is named
alike. Also ``SPT.from_cf``'s tiling cursor (N runs, reverse tiles)
against the reference's, ``piscem_index_from_cf_prefix`` byte for byte,
the error of a port CLI asked for the card where there is none, and the
module and script entry points."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mazu_tpu.cli import main as m_main
from mazu_tpu.index.piscem_index import piscem_index_from_cf_prefix as m_piscem
from mazu_tpu.index.spt import SPT as MSPT
from mazu_tpu.io.cuttlefish import CfFiles as MCfFiles

from mazu_tpu_torch import synth
from mazu_tpu_torch.cli import main as p_main
from mazu_tpu_torch.index.piscem_index import piscem_index_from_cf_prefix
from mazu_tpu_torch.index.spt import SPT
from mazu_tpu_torch.io.cuttlefish import CfFiles

from torch_fixtures import build_pf1_pair, same_tree, toy_recipe, write_pf1_index

ROOT = Path(__file__).resolve().parents[1]
PIECES = 12
_TIME = re.compile(r"\d+\.\d+s\b|\d+\.\d+ ns/kmer")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Inputs, and one output directory for each CLI."""
    d = tmp_path_factory.mktemp("cli")
    prefix, fasta, fastq = str(d / "g"), str(d / "g.fa"), str(d / "r.fq")
    synth.write_cf(prefix, PIECES * synth.PIECE, seed=0, fasta=fasta)
    _, refs, _ = synth.synthetic_spt(PIECES * synth.PIECE, seed=0)
    synth.write_fastq(fastq, synth.serve_reads(refs, 48, seed=1))
    _, port = build_pf1_pair(toy_recipe())[1]
    pf1 = d / "pf1_sparse"
    pf1.mkdir()
    write_pf1_index(str(pf1), port, toy_recipe()[3])
    out = {"ref": d / "ref", "port": d / "port"}
    for p in out.values():
        p.mkdir()
    return {"prefix": prefix, "fasta": fasta, "fastq": fastq, "pf1": str(pf1), "out": out}


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(data, argv):
    """(exit code, masked stdout) of both CLIs on ``argv``, where ``{o}``
    stands for the CLI's own output directory."""
    res = []
    for who, fn, pre in (("ref", m_main, []), ("port", p_main, ["--torch-device", "cpu"])):
        o = str(data["out"][who])
        rc, out, err = _run(fn, pre + [a.replace("{o}", o) for a in argv])
        res.append((rc, _TIME.sub("T", out.replace(o, "{o}")), err))
    (rc_w, out_w, err_w), (rc_g, out_g, err_g) = res
    assert rc_g == rc_w, (argv, err_w, err_g)
    assert out_g.splitlines() == out_w.splitlines(), argv
    return rc_w, out_w, err_g


BUILDS = {  # output name: build argv
    "parity.npz": ["index", "build", "piscem", "-p", "{prefix}", "-o", "{o}/parity.npz"],
    "mono2.npz": ["index", "build", "piscem", "-p", "{prefix}", "-o", "{o}/mono2.npz",
                  "--engine", "mono2"],
    "mono.npz": ["index", "build", "piscem", "-p", "{prefix}", "-o", "{o}/mono.npz",
                 "--engine", "mono"],
    "fast32.npz": ["index", "build", "piscem", "-p", "{prefix}", "-o", "{o}/fast32.npz",
                   "--engine", "fast32", "-m", "19"],
    "direct.npz": ["index", "build", "piscem", "-p", "{prefix}", "-o", "{o}/direct.npz",
                   "--engine", "direct", "-s", "0"],
    "pf.npz": ["index", "build", "pufferfish", "-p", "{prefix}", "-o", "{o}/pf.npz"],
    "k_sshash.npz": ["kphf", "build", "sshash", "-p", "{prefix}", "-o", "{o}/k_sshash.npz",
                     "--validate"],
    "k_pfhash.npz": ["kphf", "build", "pfhash", "-p", "{prefix}", "-o", "{o}/k_pfhash.npz"],
    "k_sampled.npz": ["kphf", "build", "sampled", "-p", "{prefix}", "-o", "{o}/k_sampled.npz",
                      "--sample-size", "7", "--extension-size", "3"],
    "k_mono.npz": ["kphf", "build", "mono", "-p", "{prefix}", "-o", "{o}/k_mono.npz"],
    "k_mono2.npz": ["kphf", "build", "mono2", "-p", "{prefix}", "-o", "{o}/k_mono2.npz",
                    "--validate"],
    "k_direct.npz": ["kphf", "build", "sshash", "-p", "{prefix}", "-o", "{o}/k_direct.npz",
                     "--engine", "direct"],
    "cuckoo.npz": ["index", "build", "piscem", "-p", "{prefix}", "-o", "{o}/cuckoo.npz",
                   "--engine", "cuckoo"],
    "k_cuckoo.npz": ["kphf", "build", "cuckoo", "-p", "{prefix}", "-o", "{o}/k_cuckoo.npz",
                     "--validate"],
    "k_sshash_cuckoo.npz": ["kphf", "build", "sshash", "-p", "{prefix}", "-o",
                            "{o}/k_sshash_cuckoo.npz", "--engine", "cuckoo"],
}


def _fill(data, argv):
    return [a.replace("{prefix}", data["prefix"]).replace("{fasta}", data["fasta"])
            .replace("{fastq}", data["fastq"]).replace("{pf1}", data["pf1"]) for a in argv]


@pytest.fixture(scope="module")
def built(data):
    """Every build through both CLIs; their output files compared."""
    for name, argv in BUILDS.items():
        rc, out, _ = _both(data, _fill(data, argv))
        assert rc == 0 and out.splitlines()[-1] == f"wrote {{o}}/{name}"
    return data


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_files_equal(built, name):
    """Both CLIs write the same arrays (the package version aside)."""
    with np.load(built["out"]["ref"] / name) as a, np.load(built["out"]["port"] / name) as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            if key != "version":
                assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key


COMMANDS = {
    "stats parity": ["index", "stats", "-i", "{o}/parity.npz"],
    "stats mono2": ["index", "stats", "-i", "{o}/mono2.npz"],
    "stats mono": ["index", "stats", "-i", "{o}/mono.npz"],
    "stats fast32": ["index", "stats", "-i", "{o}/fast32.npz"],
    "stats direct": ["index", "stats", "-i", "{o}/direct.npz"],
    "stats pufferfish": ["index", "stats", "-i", "{o}/pf.npz"],
    "stats pf1 directory": ["index", "stats", "-i", "{pf1}"],
    "stats missing": ["index", "stats", "-i", "{o}/missing.npz"],
    "validate parity": ["index", "validate-fasta", "-i", "{o}/parity.npz", "-f", "{fasta}"],
    "validate mono2": ["index", "validate-fasta", "-i", "{o}/mono2.npz", "-f", "{fasta}"],
    "validate pufferfish": ["index", "validate-fasta", "-i", "{o}/pf.npz", "-f", "{fasta}"],
    "validate streaming": ["index", "validate-fasta", "-i", "{o}/parity.npz", "-f", "{fasta}",
                           "--streaming"],
    "validate missing": ["index", "validate-fasta", "-i", "{o}/missing.npz", "-f", "{fasta}"],
    "map parity": ["index", "map", "-i", "{o}/parity.npz", "-f", "{fastq}"],
    "map mono2": ["index", "map", "-i", "{o}/mono2.npz", "-f", "{fastq}"],
    "colors": ["index", "colors", "-i", "{o}/parity.npz", "-o", "{o}/colors.npz"],
    "pseudomap": ["index", "pseudomap", "-i", "{o}/parity.npz", "-f", "{fastq}", "--list"],
    "pseudomap threshold": ["index", "pseudomap", "-i", "{o}/parity.npz", "-f", "{fastq}",
                            "--policy", "threshold", "--tau", "0.5"],
    "kphf stats sshash": ["kphf", "stats", "-i", "{o}/k_sshash.npz"],
    "kphf stats sampled": ["kphf", "stats", "-i", "{o}/k_sampled.npz"],
    "kphf stats pfhash": ["kphf", "stats", "-i", "{o}/k_pfhash.npz"],
    "kphf stats mono": ["kphf", "stats", "-i", "{o}/k_mono.npz"],
    "kphf stats mono2": ["kphf", "stats", "-i", "{o}/k_mono2.npz"],
    "stats cuckoo": ["index", "stats", "-i", "{o}/cuckoo.npz"],
    "validate cuckoo": ["index", "validate-fasta", "-i", "{o}/cuckoo.npz", "-f", "{fasta}"],
    "map cuckoo": ["index", "map", "-i", "{o}/cuckoo.npz", "-f", "{fastq}"],
    "kphf stats cuckoo": ["kphf", "stats", "-i", "{o}/k_cuckoo.npz"],
    "kphf validate cuckoo": ["kphf", "validate", "-i", "{o}/k_cuckoo.npz"],
    "kphf validate sshash": ["kphf", "validate", "-i", "{o}/k_sshash.npz"],
    "kphf validate direct": ["kphf", "validate", "-i", "{o}/k_direct.npz"],
    "kphf validate sampled": ["kphf", "validate", "-i", "{o}/k_sampled.npz"],
    "kphf validate missing": ["kphf", "validate", "-i", "{o}/missing.npz"],
    "kphf bench": ["kphf", "bench", "-i", "{o}/k_sshash.npz", "-f", "{fasta}"],
    "kphf bench device": ["kphf", "bench", "-i", "{o}/k_sshash.npz", "-f", "{fasta}",
                          "--device"],
    "kphf bench streaming": ["kphf", "bench", "-i", "{o}/k_mono2.npz", "-f", "{fasta}",
                             "--streaming"],
    "kphf bench pfhash": ["kphf", "bench", "-i", "{o}/k_pfhash.npz", "-f", "{fasta}"],
}
FAILING = ("stats missing", "validate missing", "kphf validate missing")


@pytest.mark.parametrize("name", list(COMMANDS))
def test_command(built, name):
    rc, out, err = _both(built, _fill(built, COMMANDS[name]))
    assert rc == (1 if name in FAILING else 0), err
    if name in FAILING:
        assert err.startswith("error: ")
    else:
        assert out.strip()


def test_cuckoo_is_not_ported(built):
    """The cuckoo KCDict, once missing from the port, now builds through
    both CLIs: the same files, and each CLI validates the other's. (The
    name is kept from when the port refused the engine.)"""
    for argv in (["kphf", "validate", "-i", "{o}/k_cuckoo.npz"],
                 ["index", "validate-fasta", "-i", "{o}/cuckoo.npz", "-f", "{fasta}"]):
        for who, fn, pre in (("ref", p_main, ["--torch-device", "cpu"]), ("port", m_main, [])):
            o = str(built["out"][who])
            rc, out, err = _run(fn, pre + [a.replace("{o}", o) for a in _fill(built, argv)])
            assert rc == 0 and out.strip() == "valid", err
    with np.load(built["out"]["port"] / "cuckoo.npz") as z:
        assert int(z["k2u/scheme"]) == 0 and z["k2u/table"].shape[1] == 14


def test_trace_option_dumps_the_build_spans(data, tmp_path):
    """``--trace FILE`` writes the program's spans as Chrome trace JSON at
    exit: a mono2 build shows ``kcdict.build`` and, inside it,
    ``kcdict.place``."""
    path = tmp_path / "trace.json"
    rc, out, err = _run(p_main, ["--torch-device", "cpu", "--trace", str(path), "kphf", "build",
                                 "mono2", "-p", data["prefix"], "-o", str(tmp_path / "k.npz")])
    assert rc == 0, err
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    names = [e["name"] for e in spans]
    build = names.index("kcdict.build")
    place = spans[names.index("kcdict.place")]
    assert place["args"]["parent"] == build
    assert spans[build]["ts"] <= place["ts"]
    assert place["ts"] + place["dur"] <= spans[build]["ts"] + spans[build]["dur"]


def test_no_card_no_cpu_fallback(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(p_main, ["index", "stats", "-i", "x.npz"])
    assert rc == 1 and not out and err == "error: no CUDA device: pass device='cpu' to run on " \
                                          "the host\n"


def test_spt_from_cf_tiling(tmp_path):
    """N runs after a unitig advance the cursor by n + k - 1, at the start
    of a reference by n; reverse tiles; the piscem table and references."""
    from test_torch_reads import _write_cf

    rng = np.random.default_rng(4)
    k = 31
    segs = [(7, "".join(rng.choice(list("ACGT"), 60))),
            (2, "".join(rng.choice(list("ACGT"), 31))),
            (40, "".join(rng.choice(list("ACGT"), 95)))]
    tiling = [("chrA", ["7+", "N12", "2-", "40+"]), ("chrB", ["N5", "40-", "7-", "N3"]),
              ("chrC", ["2+"])]
    prefix = str(tmp_path / "t")
    _write_cf(prefix, segs, tiling, k)
    want, got = MSPT.from_cf(MCfFiles(prefix)), SPT.from_cf(CfFiles(prefix))
    for key in ("occ_uid", "occ_ref", "occ_pos", "occ_o", "ref_lens", "offsets"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), key)
    assert got.ref_names == want.ref_names == ["chrA", "chrB", "chrC"]
    wt, gt = want.piscem_table(), got.piscem_table()
    np.testing.assert_array_equal(gt.ctable.words, wt.ctable.words)
    assert (gt.ref_shift, gt.pos_mask) == (wt.ref_shift, wt.pos_mask)
    wr, gr = want.ref_seq_collection(), got.ref_seq_collection()
    np.testing.assert_array_equal(gr.prefix_sum, wr.prefix_sum)
    assert gr.names == wr.names and not gr.has_seq


@pytest.mark.parametrize("engine", ["parity", "mono2", "mono", "direct"])
def test_piscem_index_from_cf_prefix(data, engine):
    want = m_piscem(data["prefix"], w=15, skew_param=64, engine=engine)
    got = piscem_index_from_cf_prefix(data["prefix"], w=15, skew_param=64, engine=engine,
                                      device="cpu")
    same_tree(got.device_arrays(), want.device_arrays())
    assert got.metadata == want.metadata and got.index_type == want.index_type == "Piscem"


def test_piscem_from_dense_table(data):
    """``PiscemUnitigTable.from_dense``: the pf1 table re-encoded at the
    piscem widths, as the reference re-encodes it."""
    from mazu_tpu.index.unitig_table import PiscemUnitigTable as MPiscem
    from mazu_tpu_torch.index.unitig_table import PiscemUnitigTable

    want_spt, got_spt = MSPT.from_cf(MCfFiles(data["prefix"])), SPT.from_cf(CfFiles(data["prefix"]))
    for lens in (None, want_spt.ref_lens):
        want = MPiscem.from_dense(want_spt.dense_table(), ref_lens=lens)
        got = PiscemUnitigTable.from_dense(got_spt.dense_table(), ref_lens=lens)
        np.testing.assert_array_equal(got.ctable.words, want.ctable.words)
        assert (got.ref_shift, got.pos_mask, got.ctable.width) == (
            want.ref_shift, want.pos_mask, want.ctable.width)
        assert got.num_bits() == want.num_bits()
    assert got_spt.dense_table().num_bits() == want_spt.dense_table().num_bits()


def test_module_and_script_entry_points(built):
    """``python -m mazu_tpu_torch.cli`` runs the CLI in a process of its
    own, and ``pyproject.toml`` names it as the ``mazu-tpu-torch`` script."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "mazu_tpu_torch.cli", "--torch-device", "cpu",
                          "index", "stats", "-i", str(built["out"]["port"] / "parity.npz")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("index_type: Piscem   k: 31\n")
    text = (ROOT / "pyproject.toml").read_text()
    assert 'mazu-tpu-torch = "mazu_tpu_torch.cli:main"' in text
