"""The mono2 main table in K1's 64-byte rows: ``mono2_probe.padded_table``,
the plain probe and the two-phase query on it against mazu_tpu (tolerance
0), the index's layout on the way to a device, the kernel's layout check,
and the adversarial batches and row spans that ``chip_smoke.py`` uses for
K1."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mazu_tpu.index import modindex as mmi
from mazu_tpu.kphf.kcdict import kcdict_k2u as ref_k2u
from mazu_tpu_torch.convert import arrays_from_numpy
from mazu_tpu_torch.index import modindex as mi
from mazu_tpu_torch.index.modindex import QueryIndex
from mazu_tpu_torch.kmer import revcomp_np
from mazu_tpu_torch.kphf.boophf32 import fold_hash32_np, mix32_np, unmix32_np
from mazu_tpu_torch.kphf.kcdict import kcdict_k2u
from mazu_tpu_torch.ops import mono2_probe
from mazu_tpu_torch.pytree import meta
from torch_fixtures import assert_same, build_pair, mono2_recipe, queries, tensor, toy_recipe

N = 600

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module", params=["mono2_dict", "toy"])
def pair(request):
    ref, port = build_pair(mono2_recipe() if request.param == "mono2_dict" else toy_recipe())
    work = queries(ref.k2u.unitigs, N, seed=13)
    return ref, port, work


def padded_k2u(port) -> dict:
    d = arrays_from_numpy(port.k2u.device_arrays(), "cpu")
    return {**d, "table": mono2_probe.padded_table(d["table"])}


def test_padded_table_columns(pair):
    ref, _, _ = pair
    host = ref.k2u.device_arrays()["table"]
    t = mono2_probe.padded_table(torch.from_numpy(host.view(np.int32)))
    assert t.dtype == torch.int32 and tuple(t.shape) == (host.shape[0], mono2_probe.ROW_WORDS)
    assert np.array_equal(t[:, :14].numpy().view(np.uint32), host)
    assert not t[:, 14:].any()
    with pytest.raises(ValueError):
        mono2_probe.padded_table(t)


@pytest.mark.parametrize("mode", ["main", "full"])
def test_plain_probe_on_padded_table(pair, mode):
    ref, port, work = pair
    want = ref_k2u(ref.k2u.device_arrays(), work, np, mode=mode)
    got = kcdict_k2u(padded_k2u(port), tensor(work), mode=mode)
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], want[key], key)


def test_wrapper_on_padded_table_matches_pallas_interpret(pair):
    import jax.numpy as jnp

    from mazu_tpu.ops.pallas_query import pallas_mono2_k2u

    ref, port, work = pair
    want = pallas_mono2_k2u(ref.k2u.device_arrays(), jnp.asarray(work), interpret=True)
    got = mono2_probe.mono2_k2u(padded_k2u(port), tensor(work))
    assert set(got) == set(want)
    for key in want:
        assert_same(got[key], np.asarray(want[key]), key)


@pytest.mark.parametrize("merge", [True, False])
def test_compact_query_on_padded_index(pair, merge):
    """``get_ref_pos_compact`` on a QueryIndex holding the padded table
    equals mazu_tpu's and the port's on the reference layout."""
    ref, port, work = pair
    mo = ref.max_occs()
    host = port.device_arrays()
    arrays = arrays_from_numpy(host, "cpu")
    arrays["k2u"]["table"] = mono2_probe.padded_table(arrays["k2u"]["table"])
    padded = QueryIndex(arrays)
    assert padded.arrays()["k2u"]["table"].shape[1] == mono2_probe.ROW_WORDS
    got = mi.get_ref_pos_compact(padded.arrays(), tensor(work), mo, merge=merge, m2=256)
    plain = mi.get_ref_pos_compact(arrays_from_numpy(host, "cpu"), tensor(work), mo,
                                   merge=merge, m2=256)
    want = mmi.get_ref_pos_compact(ref.device_arrays(fused=True), work, np, mo, merge=merge, m2=256)

    def same(g, p, path=""):  # port on the padded index vs port on the reference layout
        assert set(g) == set(p), path
        for key in p:
            if isinstance(p[key], dict):
                same(g[key], p[key], f"{path}{key}.")
            else:
                assert torch.equal(g[key], p[key]), path + key

    same(got, plain)
    if merge:
        for key in want:
            assert_same(got[key], want[key], key)
        return
    # pieces: the fake slots' lanes and phase-2 rows are unspecified
    for key in ("overflow", "n_ovf", "slot_real", "over_budget"):
        assert_same(got[key], want[key], key)
    for key in want["main"]:
        assert_same(got["main"][key], want["main"][key], f"main.{key}")
    real = np.asarray(want["slot_real"])
    assert_same(got["lanes"][torch.from_numpy(real)], np.asarray(want["lanes"])[real], "lanes")
    for key, w in want["phase2"].items():
        assert_same(got["phase2"][key][torch.from_numpy(real)], np.asarray(w)[real], f"phase2.{key}")


def test_index_pads_the_table_when_it_leaves_the_host(pair):
    _, port, _ = pair
    qi = QueryIndex(arrays_from_numpy(port.device_arrays(), "cpu"))
    table = qi.arrays()["k2u"]["table"]
    host_bytes = qi.nbytes()
    assert qi.to("cpu").arrays()["k2u"]["table"] is table  # the host keeps [T, 14]
    moved = qi.to("meta")
    t = moved.arrays()["k2u"]["table"]
    assert t.device.type == "meta" and tuple(t.shape) == (table.shape[0], mono2_probe.ROW_WORDS)
    assert moved.nbytes() == host_bytes + 2 * 4 * table.shape[0]  # the pad words only
    assert moved.arrays()["k2u"]["side"].shape[1] == 14


def test_layout_check(pair):
    _, port, work = pair
    d = padded_k2u(port)
    fw = tensor(work)
    mono2_probe.check_layout(d, fw)
    t = d["meta"].t
    flat = torch.zeros(t * mono2_probe.ROW_WORDS + 16, dtype=torch.int32)
    off = (16 - (flat.data_ptr() % 64) // 4) % 16  # first 64-byte boundary
    aligned = flat[off : off + t * mono2_probe.ROW_WORDS].view(t, mono2_probe.ROW_WORDS)
    aligned.copy_(d["table"])
    mono2_probe.check_layout({**d, "table": aligned}, fw)
    bad = {
        "14 wide": arrays_from_numpy(port.k2u.device_arrays(), "cpu")["table"],
        "misaligned": flat[off + 1 : off + 1 + t * mono2_probe.ROW_WORDS].view(
            t, mono2_probe.ROW_WORDS),
        "T not a power of two": d["table"][: t - 1],
        "int64": d["table"].to(torch.int64),
    }
    for name, table in bad.items():
        meta = d["meta"].replace(t=table.shape[0]) if name.startswith("T ") else d["meta"]
        with pytest.raises(ValueError):
            mono2_probe.check_layout({**d, "table": table, "meta": meta}, fw)
    with pytest.raises(ValueError):
        mono2_probe.check_layout(d, fw.to(torch.int32))


def test_k1_cases_hold_what_they_name(pair):
    ref, port, work = pair
    host = port.k2u.device_arrays()
    cases = chip_smoke.k1_cases(host, work)
    assert {"N=1", "N=255", "N=256", "N=257", f"N={N}+37", "foreign only", "slot-1 keys",
            "khi bit 31 keys", "all-A", "all-T"} <= set(cases)
    last_row = next(n for n in cases if n.endswith("(last occupied)"))
    row_t1 = next(n for n in cases if n.startswith("row T - 1"))
    d = arrays_from_numpy(host, "cpu")
    m = d["meta"]
    for name, words in cases.items():
        want = ref_k2u(ref.k2u.device_arrays(), words, np, mode="main")
        got = mono2_probe.mono2_k2u(d, tensor(words))
        for key in want:
            assert_same(got[key], want[key], f"{name}:{key}")
        if name in ("slot-1 keys", "khi bit 31 keys", last_row):
            assert not got["unresolved"].any(), name
        if name in ("foreign only", "side-table keys"):
            assert got["unresolved"].all(), name
    canon = np.minimum(cases[row_t1], revcomp_np(cases[row_t1], m.k))
    assert len(cases[row_t1]) == mono2_probe.TILE
    assert (fold_hash32_np(canon) & np.uint32(m.t - 1) == m.t - 1).all()
    assert set(mono2_probe.mono2_k2u(d, tensor(cases["slot-1 keys"]))["mt"].tolist()) == {1, 2}


def test_unmix32_inverts_mix32():
    x = np.random.default_rng(5).integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(unmix32_np(mix32_np(x)), x)
    assert np.array_equal(mix32_np(unmix32_np(x)), x)


def test_card_table_pads_only_the_mono2_main_table(pair):
    _, port, _ = pair
    d = arrays_from_numpy(port.k2u.device_arrays(), "cpu")
    padded = mono2_probe.card_table(d["meta"], d["table"])
    assert torch.equal(padded, mono2_probe.padded_table(d["table"]))
    assert mono2_probe.card_table(d["meta"], padded) is padded  # already in K1's rows
    other = torch.zeros(8, 14, dtype=torch.int32)
    assert mono2_probe.card_table(meta(kind="sshash"), other) is other
    assert mono2_probe.card_table(d["meta"].replace(scheme="mono"), other) is other


def test_row_spans():
    """A row of 56 bytes at h * 56 spans 2 or 3 sectors and 1 or 2
    blocks (2.5 and 1.75 over h mod 8); a 64-byte row one block."""
    from mazu_tpu_torch.kmer import revcomp
    from mazu_tpu_torch.kphf.boophf32 import fold_hash32
    from mazu_tpu_torch._words import umin

    k2u = {"meta": meta(k=21, t=1 << 12)}
    fw = torch.from_numpy(np.random.default_rng(3).integers(0, 1 << 42, 4096).astype(np.int64))
    h = fold_hash32(umin(fw, revcomp(fw, 21))) & ((1 << 12) - 1)
    lo = h.numpy() * 56
    want = tuple(int(((lo + 55) // s - lo // s + 1).sum()) for s in (32, 64))
    assert chip_smoke.row_spans(k2u, fw, 56) == want
    assert chip_smoke.row_spans(k2u, fw, 64) == (2 * 4096, 4096)
    per = {r: ((r * 56 + 55) // 32 - r * 56 // 32 + 1, (r * 56 + 55) // 64 - r * 56 // 64 + 1)
           for r in range(8)}
    assert sum(v[0] for v in per.values()) == 20 and sum(v[1] for v in per.values()) == 14
