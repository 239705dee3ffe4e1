"""The plain versions of the gather-lab kernels L1-L5 against the lab
Pallas kernels of ``labs/pallas_probe.py`` and ``labs/tpu_dma_lab.py`` in
interpret mode, with tolerance 0; the lab entry points at their CPU sizes;
the wrappers' refusals, launch counters and L3/L4's fold scratch; and the
L2 yardstick ``l2_stream``'s plain version (the kernels themselves run
only on the card, in ``chip_smoke.py``)."""

import ctypes
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mazu_tpu_torch.labs import dma_lab, gather_probe
from mazu_tpu_torch.ops import gather_lab

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "labs"))
import pallas_probe  # noqa: E402
import tpu_dma_lab  # noqa: E402

BLK = 64


def _u32(n: int, seed: int, hi: int = 1 << 32) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


@pytest.mark.parametrize("n,m", [(64, 16), (256, 1000), (1024, 4096)])
def test_gather_u32_plain_equals_pallas(n, m):
    tbl = _u32(m, 1)
    idx = np.random.default_rng(2).integers(0, m, n, dtype=np.int32)
    idx[:8] = m - 1  # the last entry, and one index many times
    kernel = pl.pallas_call(
        pallas_probe.gather_kernel,
        out_shape=jax.ShapeDtypeStruct((n,), jnp.uint32),
        grid=(n // BLK,),
        in_specs=[_vmem((m,), lambda i: (0,)), _vmem((BLK,), lambda i: (i,))],
        out_specs=_vmem((BLK,), lambda i: (i,)),
        interpret=True,
    )
    want = np.asarray(kernel(tbl, idx))
    got = gather_lab.gather_u32(torch.from_numpy(tbl.view(np.int32)), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [64, 1024])
def test_hash_mix32x8_plain_equals_pallas(n):
    x = _u32(n, 3)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    kernel = pl.pallas_call(
        pallas_probe.hash_kernel,
        out_shape=jax.ShapeDtypeStruct((n,), jnp.uint32),
        grid=(n // BLK,),
        in_specs=[_vmem((BLK,), lambda i: (i,))],
        out_specs=_vmem((BLK,), lambda i: (i,)),
        interpret=True,
    )
    want = np.asarray(kernel(x))
    got = gather_lab.hash_mix32x8(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(gather_probe.mix32x8_np(x), want)


@pytest.fixture(scope="module")
def dma_case():
    T, N = 256, 64
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 1 << 31, size=(T, 128), dtype=np.int32)
    tbl[:, 0] |= np.int32(-(1 << 31))  # bit 31 set in a column
    idx = rng.integers(0, T, size=N, dtype=np.int32)
    idx[:4] = 7  # a row taken more than once cancels in pairs
    fns = tpu_dma_lab.build_fns(T, N, True)
    return tbl, idx, fns


@pytest.mark.parametrize("lab,port", [
    ("vmem_loop", gather_lab.xor_rows),
    ("dma_ring", gather_lab.xor_rows_ring),
    ("tiled", gather_lab.tiled),
    ("xla", lambda i, t: gather_lab.xor_fold(t[i.to(torch.int64)])),
])
def test_xor_rows_plain_equals_pallas(dma_case, lab, port):
    tbl, idx, fns = dma_case
    want = np.asarray(fns[lab](jnp.asarray(idx), jnp.asarray(tbl)))
    np.testing.assert_array_equal(want, tpu_dma_lab.reference(idx, tbl))
    got = port(torch.from_numpy(idx), torch.from_numpy(tbl))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 128)
    np.testing.assert_array_equal(got.numpy(), want)


PORTS = {
    "vmem_loop": gather_lab.xor_rows,
    "dma_ring": gather_lab.xor_rows_ring,
    "tiled": gather_lab.tiled,
    "xla": lambda i, t: gather_lab.xor_fold(t[i.to(torch.int64)]),
}


@pytest.fixture(scope="module")
def dma_edge_cases():
    """Batches at the edges of L3/L4's 32-index groups (N = 1, 31, 33) and
    one of pairs that cancel to zero, over dma_case's kind of table."""
    T = 256
    rng = np.random.default_rng(5)
    tbl = rng.integers(0, 1 << 31, size=(T, 128), dtype=np.int32)
    tbl[:, 0] |= np.int32(-(1 << 31))
    cases = {f"N={n}": rng.integers(0, T, n, dtype=np.int32) for n in (1, 31, 33)}
    half = rng.integers(0, T, 20, dtype=np.int32)
    cases["pairs"] = np.concatenate([half, half[::-1]])
    return tbl, {name: (idx, tpu_dma_lab.build_fns(T, len(idx), True))
                 for name, idx in cases.items()}


@pytest.mark.parametrize("case", ["N=1", "N=31", "N=33", "pairs"])
@pytest.mark.parametrize("lab", sorted(PORTS))
def test_xor_rows_plain_equals_pallas_at_edge_sizes(dma_edge_cases, lab, case):
    """As ``test_xor_rows_plain_equals_pallas``, at the edge sizes. The
    Pallas ``vmem_loop`` runs N // 8 steps of a loop unrolled by 8 with no
    tail, so it folds only the first N // 8 * 8 rows; the port's L3 folds
    every row, as ``tpu_dma_lab.reference`` and the other strategies do,
    and equals the Pallas kernel on that prefix."""
    tbl, cases = dma_edge_cases
    idx, fns = cases[case]
    got = PORTS[lab](torch.from_numpy(idx), torch.from_numpy(tbl))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 128)
    np.testing.assert_array_equal(got.numpy(), tpu_dma_lab.reference(idx, tbl))
    want = np.asarray(fns[lab](jnp.asarray(idx), jnp.asarray(tbl)))
    covered = len(idx) // 8 * 8 if lab == "vmem_loop" else len(idx)
    np.testing.assert_array_equal(want, tpu_dma_lab.reference(idx[:covered], tbl))
    prefix = PORTS[lab](torch.from_numpy(idx[:covered]), torch.from_numpy(tbl))
    np.testing.assert_array_equal(prefix.numpy(), want)
    if case == "pairs":
        assert not want.any()


def test_gather_rows_plain(dma_case):
    """L5 before its fold (the Pallas ``tiled`` above holds the fold): the
    rows themselves, in order."""
    tbl, idx, _ = dma_case
    got = gather_lab.gather_rows(torch.from_numpy(idx), torch.from_numpy(tbl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tbl[idx])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 37, 64])
def test_xor_fold(n):
    rows = np.random.default_rng(n).integers(-(1 << 31), 1 << 31, (n, 128)).astype(np.int32)
    want = np.bitwise_xor.reduce(rows, axis=0) if n else np.zeros(128, np.int32)
    np.testing.assert_array_equal(gather_lab.xor_fold(torch.from_numpy(rows)).numpy()[0], want)


def test_lab_entry_points_on_the_cpu(capsys):
    assert gather_probe.run(torch.device("cpu"), gather_probe.CPU_N, gather_probe.CPU_M) == {}
    assert dma_lab.run(torch.device("cpu"), dma_lab.CPU_T, dma_lab.CPU_N) == {}
    out = capsys.readouterr().out
    assert "CORRECT" in out and "dma_ring   ok=True" in out


def test_lab_gpu_mode_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for lab in (gather_probe, dma_lab):
        with pytest.raises(SystemExit, match="no CUDA device"):
            lab.main([])


def test_wrappers_refuse_other_devices_and_mixed_devices():
    meta_t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gather_lab.hash_mix32x8(meta_t)
    with pytest.raises(ValueError, match="several devices"):
        gather_lab.gather_u32(torch.zeros(4, dtype=torch.int32), meta_t)


FAKE_BLOCKS = 3  # one wave of blocks, as the fake card's occupancy queries give it


def fake_entry(name: str, kernel):
    """The fake card's C entry ``name``: a one-wave query gives FAKE_BLOCKS,
    any other entry is ``kernel``."""
    return (lambda: FAKE_BLOCKS) if name.endswith("_blocks") else kernel


@pytest.fixture
def fake_card(monkeypatch):
    """Treat CPU tensors as on the card with a kernel that returns
    ``status[0]`` (and one-wave queries that give FAKE_BLOCKS), to drive
    the wrappers' checks and counters here."""
    status = [0]
    monkeypatch.setattr(gather_lab, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(gather_lab, "_stream", lambda device: 0)
    monkeypatch.setattr(gather_lab, "_fn", lambda name: fake_entry(name, lambda *a: status[0]))
    monkeypatch.setattr(gather_lab, "LAUNCHES", dict.fromkeys(gather_lab.NAMES, 0))
    monkeypatch.setattr(gather_lab, "_WAVE", {})
    return status


def test_wrappers_check_inputs_and_count_launches(fake_card):
    i32 = torch.zeros(64, dtype=torch.int32)
    rows = torch.zeros(16, 128, dtype=torch.int32)
    gather_lab.gather_u32(i32, i32)
    gather_lab.hash_mix32x8(i32)
    gather_lab.xor_rows(i32, rows)
    gather_lab.xor_rows_ring(i32, rows)
    gather_lab.tiled(i32, rows)
    gather_lab.gather_rows(i32[:0], rows)  # nothing to launch
    assert gather_lab.LAUNCHES == dict.fromkeys(gather_lab.NAMES, 1)
    with pytest.raises(ValueError, match="int32"):
        gather_lab.gather_u32(i32.to(torch.int64), i32)
    with pytest.raises(ValueError, match="int32"):
        gather_lab.hash_mix32x8(i32.reshape(8, 8))
    with pytest.raises(ValueError, match=r"\[T, 128\]"):
        gather_lab.xor_rows(i32, torch.zeros(16, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        gather_lab.gather_rows(i32[::2], rows)
    fake_card[0] = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        gather_lab.xor_rows_ring(i32, rows)
    assert gather_lab.LAUNCHES["xor_rows_ring"] == 1


def test_row_folds_take_one_wave_of_scratch_and_never_fill_out(fake_card, monkeypatch):
    """L3's and L4's wrappers hand the kernel a [blocks, 128] int32 scratch
    for the blocks that the C side's one-wave query gives, launch that many
    blocks, and return the output the kernel wrote whole: nothing fills it
    before the launch."""
    idx = torch.arange(40, dtype=torch.int32)
    rows = torch.ones(64, gather_lab.ROW, dtype=torch.int32)
    calls, made = [], []

    def kernel(tbl, ii, part, out, n, blocks, stream):
        calls.append((part, out, n, blocks))
        ctypes.memset(out, 0x5A, 4 * gather_lab.ROW)
        return 0

    empty = torch.empty

    def recording_empty(*a, **k):
        made.append(empty(*a, **k))
        return made[-1]

    def no_fill(*a, **k):
        raise AssertionError("the output was filled before the launch")

    monkeypatch.setattr(gather_lab, "_fn", lambda name: fake_entry(name, kernel))
    monkeypatch.setattr(torch, "empty", recording_empty)
    for name in ("zeros", "zeros_like", "full", "full_like"):
        monkeypatch.setattr(torch, name, no_fill)
    for name in ("zero_", "fill_"):
        monkeypatch.setattr(torch.Tensor, name, no_fill)
    for fn in (gather_lab.xor_rows, gather_lab.xor_rows_ring):
        calls.clear()
        made.clear()
        got = fn(idx, rows)
        [(part, out, n, blocks)] = calls
        assert (n, blocks) == (40, FAKE_BLOCKS)
        [scratch] = [t for t in made if t.data_ptr() == part]
        assert scratch.dtype == torch.int32 and tuple(scratch.shape) == (FAKE_BLOCKS, 128)
        assert got.data_ptr() == out and tuple(got.shape) == (1, 128)
        assert bool((got == 0x5A5A5A5A).all())
    assert gather_lab.LAUNCHES == {**dict.fromkeys(gather_lab.NAMES, 0),
                                   "xor_rows": 1, "xor_rows_ring": 1}


@pytest.mark.parametrize("reps", [1, 2, 3])
def test_l2_stream_plain_folds_to_the_table(reps):
    tbl = np.random.default_rng(reps).integers(-(1 << 31), 1 << 31, (16, 128)).astype(np.int32)
    got = gather_lab.xor_fold(gather_lab.l2_stream(torch.from_numpy(tbl), reps, random=True))
    want = np.bitwise_xor.reduce(np.concatenate([tbl] * reps), axis=0)
    np.testing.assert_array_equal(got.numpy()[0], want)


def test_l2_stream_on_the_card_is_no_counted_kernel(fake_card, monkeypatch):
    """The yardstick reads a power-of-two table with one wave of blocks and
    counts no launch of the lab kernels."""
    calls = []
    monkeypatch.setattr(gather_lab, "_fn", lambda name: fake_entry(
        name, lambda *a: calls.append(a) or 0))
    part = gather_lab.l2_stream(torch.zeros(16, 128, dtype=torch.int32), 3, random=True)
    assert part.dtype == torch.int32 and tuple(part.shape) == (FAKE_BLOCKS, 128)
    [(_, bits, reps, random, out, blocks, _)] = calls
    assert (bits, reps, random, out, blocks) == (4, 3, 1, part.data_ptr(), FAKE_BLOCKS)
    assert gather_lab.LAUNCHES == dict.fromkeys(gather_lab.NAMES, 0)
    with pytest.raises(ValueError, match="power of two"):
        gather_lab.l2_stream(torch.zeros(12, 128, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match=r"\[T, 128\]"):
        gather_lab.l2_stream(torch.zeros(16, 64, dtype=torch.int32), 3)
