"""The port's host library (``csrc/host_reads.cpp`` through
``io/native.py``) against mazu_tpu's: ``fastq_pack``/``pack_fastq`` byte
for byte on the record mix of ``tests/test_streaming.py``'s parity test
(multi-line records, lowercase, N, gzip, an odd count, no trailing
newline) and on framing edges; malformed files raising the reference's
``InvalidData`` texts through the Python reader; ``kmerize_batch`` against
the reference's and the per-read loop; every ``extern "C"`` entry held to
its ctypes types; and the build: concurrent first builds leave one
loadable library, a failed build raises."""

from __future__ import annotations

import ctypes
import gzip
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mazu_tpu.err import InvalidData as MInvalidData
from mazu_tpu.index.validate import valid_kmer_windows as m_windows
from mazu_tpu.io import native as mnative
from mazu_tpu.io.reads import pack_fastq as m_pack_fastq

from mazu_tpu_torch.err import InvalidData
from mazu_tpu_torch.io import native
from mazu_tpu_torch.io.fastq import read_fastq
from mazu_tpu_torch.io.reads import pack_fastq, pack_reads
from mazu_tpu_torch.ops.cuda_build import compile_host_library

from torch_fixtures import same_tree

ROOT = Path(__file__).resolve().parents[1]
K = 31


def record_mix() -> str:
    """The record mix of ``test_streaming.py::test_pack_fastq_native_parity``."""
    rng = np.random.default_rng(3)
    recs = []
    for i in range(33):
        ln = int(rng.integers(40, 180))
        s = "".join(rng.choice(list("ACGT"), ln))
        if i % 5 == 0:
            s = s[:7] + "N" + s[8:]
        if i % 7 == 0:
            s = s.lower()
        q = "I" * ln
        if i % 3 == 0:
            m = ln // 2
            recs.append(f"@r{i} x\n{s[:m]}\n{s[m:]}\n+\n{q[:m]}\n{q[m:]}\n")
        else:
            recs.append(f"@r{i}\n{s}\n+anything\n{q}\n")
    return "".join(recs).rstrip("\n")


def write(path: Path, text: str) -> str:
    data = text.encode()
    path.write_bytes(gzip.compress(data) if path.suffix == ".gz" else data)
    return str(path)


@pytest.mark.parametrize("suffix", [".fastq", ".fastq.gz"])
def test_pack_fastq_matches_reference(tmp_path, suffix):
    p = write(tmp_path / ("reads" + suffix), record_mix())
    got = pack_fastq(p, K)
    same_tree(got, m_pack_fastq(p, K))
    same_tree(got, pack_reads([s for _, s in read_fastq(p)], K))
    assert got["meta"].has_bad and got["meta"].R == 33


EDGES = {
    "empty file": "",
    "blank lines between records": "\n@a\nACGTACGT\n+\nIIIIIIII\n\n\n@b\nGGA\n+\nIII\n\n",
    "quality starting with @ and +": "@a\nACGTA\n+\n@+III\n@b\nTT\n+b\n++\n",
    "one long read": "@a\n" + "ACGT" * 100 + "\n+\n" + "I" * 400,
    "all N": "@a\n" + "N" * 70 + "\n+\n" + "I" * 70 + "\n",
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_fastq_pack_edges(tmp_path, edge):
    """Text the C passes take: packed as the Python reader and
    ``pack_reads`` pack it, with no fallback."""
    p = write(tmp_path / "e.fastq", EDGES[edge])
    with open(p, "rb") as f:
        got = native.fastq_pack(f.read(), K)
    assert got is not None
    same_tree(got, pack_reads([s for _, s in read_fastq(p)], K))
    same_tree(pack_fastq(p, K), m_pack_fastq(p, K))


MALFORMED = {
    "short quality": "@r\nACGT\n+\nII\n",
    "long quality": "@r\nACGT\n+\nIIIIII\n",
    "no @": "r\nACGT\n+\nIIII\n",
    "no + line": "@r\nACGT\nACGT\n",
    "truncated quality": "@a\nACGT\n+\nIIII\n@b\nACGT\n+\nII",
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_raises_reference_text(tmp_path, case):
    """The C passes refuse the text; the Python reader raises the same
    ``InvalidData`` text as the reference's."""
    p = write(tmp_path / "bad.fastq", MALFORMED[case])
    with open(p, "rb") as f:
        assert native.fastq_pack(f.read(), K) is None
    with pytest.raises(MInvalidData) as want:
        m_pack_fastq(p, K)
    with pytest.raises(InvalidData) as got:
        pack_fastq(p, K)
    assert str(got.value) == str(want.value)


def test_empty_sequence_falls_back(tmp_path):
    """A record with an empty sequence is valid FASTQ that the C passes do
    not take: the Python reader packs it, as the reference does."""
    p = write(tmp_path / "e.fastq", "@a\nACGTACGT\n+\nIIIIIIII\n@b\n+\n\n@c\nGG\n+\nII\n")
    with open(p, "rb") as f:
        assert native.fastq_pack(f.read(), K) is None
    got = pack_fastq(p, K)
    same_tree(got, m_pack_fastq(p, K))
    assert got["lengths"].tolist() == [8, 0, 2]


@pytest.mark.parametrize("newline", ["\r\n", "\r"])
def test_carriage_returns_take_the_python_reader(tmp_path, newline):
    """With universal newlines a '\r' ends a line in the Python reader: the
    C passes refuse such text, so ``pack_fastq`` equals the reader's
    packing (mazu_tpu's fused pass packs a '\r' as a non-ACGT base)."""
    from mazu_tpu.io.fastq import read_fastq as m_read_fastq
    from mazu_tpu.io.reads import pack_reads as m_pack_reads

    text = "@a\nACGTAC\n+\nIIIIII\n@b\nGGTT\n+\nIIII\n".replace("\n", newline)
    p = write(tmp_path / "crlf.fastq", text)
    with open(p, "rb") as f:
        assert native.fastq_pack(f.read(), K) is None
    got = pack_fastq(p, K)
    same_tree(got, m_pack_reads([s for _, s in m_read_fastq(p)], K))
    assert got["lengths"].tolist() == [6, 4] and not got["meta"].has_bad


def test_pack_fastq_takes_the_native_pass(tmp_path, monkeypatch):
    """On valid text ``pack_fastq`` never reads through Python."""
    import mazu_tpu_torch.io.fastq as fastq

    def refuse(path):
        raise AssertionError("the Python reader ran")

    monkeypatch.setattr(fastq, "read_fastq", refuse)
    p = write(tmp_path / "r.fastq.gz", record_mix())
    assert pack_fastq(p, K)["meta"].R == 33


def reads_mix(seed: int, n: int = 200) -> list:
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        s = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 160))))
        if i % 4 == 1 and len(s) > 40:
            s = s[:20] + "N" + s[21:]
        if i % 9 == 2:
            s = s.lower()
        reads.append(s)
    reads[3] = "N" * 50
    reads[4] = "ACG"
    return reads


@pytest.mark.parametrize("seed,k,n", [(1, 31, 200), (2, 21, 200), (3, 5, 200), (4, 31, 5000)])
def test_kmerize_batch(seed, k, n):
    """``(bounds, positions, words)`` equal the reference's native batch
    and its per-read loop, including the compaction of invalid windows;
    5,000 reads run on several threads (a block of at least 256 reads a
    thread)."""
    reads = reads_mix(seed, n)
    bounds, pos, words = native.kmerize_batch(reads, k)
    assert bounds.dtype == np.int64 and pos.dtype == np.int64 and words.dtype == np.uint64
    for i, r in enumerate(reads):
        p, w = m_windows(r, k)
        np.testing.assert_array_equal(pos[bounds[i] : bounds[i + 1]], p)
        np.testing.assert_array_equal(words[bounds[i] : bounds[i + 1]], w)
    want = mnative.kmerize_batch(reads, k)
    if want is not None:  # the reference's own library builds lazily
        for g, w in zip((bounds, pos, words), want):
            np.testing.assert_array_equal(g, w)
    b0, p0, w0 = native.kmerize_batch([], k)
    assert b0.tolist() == [0] and len(p0) == len(w0) == 0
    b1, p1, _ = native.kmerize_batch([r.encode() for r in reads], k)
    np.testing.assert_array_equal(b1, bounds)
    np.testing.assert_array_equal(p1, pos)


C_TYPES = {
    "const char*": ctypes.c_char_p,
    "int64_t": ctypes.c_int64,
    "int64_t*": ctypes.c_void_p,
    "const int64_t*": ctypes.c_void_p,
    "const uint8_t*": ctypes.c_void_p,
    "uint64_t*": ctypes.c_void_p,
    "int32_t*": ctypes.c_void_p,
}


def test_entries_match_argtypes():
    """Each ``extern "C"`` entry of the source takes the ctypes types that
    ``io.native.ARGTYPES`` declares, in order, and returns int64."""
    src = native.SOURCE.read_text()
    entries = {}
    for m in re.finditer(r'extern "C" (\w+) (\w+)\(([^)]*)\)', src):
        assert m.group(1) == "int64_t", m.group(2)
        params = [" ".join(p.split()) for p in m.group(3).split(",")]
        entries[m.group(2)] = [re.sub(r"\s*\w+$", "", p).replace(" *", "*") for p in params]
    assert set(entries) == set(native.ARGTYPES)
    for name, types in entries.items():
        assert [C_TYPES[t] for t in types] == native.ARGTYPES[name], name
    lib = native.library()
    for name, types in native.ARGTYPES.items():
        assert getattr(lib, name).argtypes == types and getattr(lib, name).restype is ctypes.c_int64


_BUILD = """
import ctypes, sys
from pathlib import Path
from mazu_tpu_torch.io.native import SOURCE
from mazu_tpu_torch.ops.cuda_build import compile_host_library
lib = ctypes.CDLL(str(compile_host_library(SOURCE, Path(sys.argv[1]))))
lib.fastq_count.restype = ctypes.c_int64
maxlen = ctypes.c_int64(0)
print(lib.fastq_count(b"@r\\nACGT\\n+\\nIIII\\n", ctypes.c_int64(15), ctypes.byref(maxlen)),
      maxlen.value)
"""


def test_concurrent_first_builds(tmp_path):
    """Five processes building into one empty directory at once each load
    a whole library, and one library is left, with no partial file."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(5)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        assert out.split() == ["1", "4"]
    files = sorted(f.name for f in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("libhost_reads_") and files[0].endswith(".so")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no compiler, raises; nothing is
    left in the build directory."""
    broken = tmp_path / "broken.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="failed on broken.cpp"):
        compile_host_library(broken, out)
    assert not any(out.iterdir())
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        compile_host_library(native.SOURCE, tmp_path / "other")
