"""The plain versions of the gather-lab kernels L1-L5 against the lab
Pallas kernels of ``labs/pallas_probe.py`` and ``labs/tpu_dma_lab.py`` in
interpret mode, with tolerance 0; the lab entry points at their CPU sizes;
and the wrappers' refusals and launch counters (the kernels themselves run
only on the card, in ``chip_smoke.py``)."""

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


@pytest.fixture
def fake_card(monkeypatch):
    """Treat CPU tensors as on the card with a kernel that returns
    ``status[0]``, to drive the wrappers' checks and counters here."""
    status = [0]
    monkeypatch.setattr(gather_lab, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(gather_lab, "_stream", lambda device: 0)
    monkeypatch.setattr(gather_lab, "_fn", lambda name: lambda *a: status[0])
    monkeypatch.setattr(gather_lab, "LAUNCHES", dict.fromkeys(gather_lab.NAMES, 0))
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
