"""The argument blocks of the CUDA kernels K1 (``csrc/mono2_probe.cu``), K2
(``csrc/bpos_probe.cu``), K3 (``csrc/capacity_probe.cu``), the mono2
phase 2 (``csrc/mono2_phase2.cu``), the ragged phase 2
(``csrc/occ_csr.cu``) and its residue K2U (``csrc/residue_k2u.cu``)
against their ctypes mirrors (``ops/mono2_probe._Args``,
``ops/bpos_probe._Args``, ``ops/capacity_probe._Args``,
``ops/mono2_phase2._Args``, ``ops/occ_csr._Args``,
``ops/residue_k2u._Args``), and the C
entries of the lab kernels
(``csrc/gather_lab.cu``) against ``ops/gather_lab.ARGTYPES``.

A field that drifts on one side shifts every field after it, and the
kernel then reads garbage and writes wrong outputs without an error; no
test on the CPU runs the kernel. So this test parses ``struct Args`` out of
each source and holds its field names, order and 8-byte sizes to the
ctypes structure, and the source's tile and limit constants to the
wrapper's. It needs no compiler and no card."""

from __future__ import annotations

import ctypes
import re

import pytest

from mazu_tpu_torch.ops import (
    bpos_probe, capacity_probe, gather_lab, mono2_phase2, mono2_probe, occ_csr, residue_k2u,
)

EIGHT_BYTE_INTS = {"int64_t", "uint64_t"}


def constexprs(src: str) -> dict:
    """The ``constexpr int`` constants of a source."""
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}


def struct_args(src: str) -> list:
    """(name, bytes) of each field of ``struct Args``, in order. Every field
    must be a pointer or a 64-bit integer (or an array of them)."""
    body = re.search(r"\nstruct Args \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    consts = constexprs(src)
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.fullmatch(r"(?:const )?(\w+)\s*(\*?)\s*(.+)", decl)
        assert m, f"cannot parse field declaration {decl!r}"
        ctype, star, names = m.groups()
        if not star:
            assert ctype in EIGHT_BYTE_INTS, f"{decl!r}: {ctype} is not an 8-byte field"
        for name in (n.strip() for n in names.split(",")):
            arr = re.fullmatch(r"(\w+)\[(\w+)\]", name)
            if arr:
                count = arr.group(2)
                fields.append((arr.group(1), 8 * int(consts.get(count, count))))
            else:
                assert re.fullmatch(r"\w+", name), f"cannot parse field name {name!r}"
                fields.append((name, 8))
    return fields


KERNELS = {
    "mono2_probe": (mono2_probe, {"kTile": "TILE", "kRowWords": "ROW_WORDS", "kSlotWords": "SW"}),
    "bpos_probe": (bpos_probe,
                   {"kTile": "TILE", "kMaxPlim": "MAX_PLIM", "kRecWords": "REC_WORDS"}),
    "capacity_probe": (capacity_probe, {"kTile": "TILE", "kMaxLevels": "MAX_LEVELS"}),
    "mono2_phase2": (mono2_phase2, {"kTile": "TILE", "kSlotWords": "SW", "kRowWords": "ROW_WORDS",
                                    "kSideRowWords": "SIDE_ROW_WORDS",
                                    "kMaxOccsLimit": "MAX_OCCS_LIMIT"}),
    "occ_csr": (occ_csr, {"kTile": "TILE", "kOccTile": "OCC_TILE"}),
    "residue_k2u": (residue_k2u, {"kTile": "TILE", "kMaxLevels": "MAX_LEVELS"}),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_args_block_matches_source(kernel):
    mod, consts = KERNELS[kernel]
    src = mod.SOURCE.read_text()
    c_fields = struct_args(src)
    py_fields = [(name, ctypes.sizeof(t)) for name, t in mod._Args._fields_]
    assert py_fields == c_fields
    # no padding on either side: each field starts where the last one ended
    offsets = [getattr(mod._Args, name).offset for name, _ in py_fields]
    assert offsets == [sum(size for _, size in c_fields[:j]) for j in range(len(c_fields))]
    assert ctypes.sizeof(mod._Args) == sum(size for _, size in c_fields)
    # the limits and tile size that the wrapper and chip_smoke.py rely on
    found = constexprs(src)
    assert {c: found[c] for c in consts} == {c: getattr(mod, py) for c, py in consts.items()}


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
           "int": ctypes.c_int}


def c_entries(src: str) -> dict:
    """The C type of each parameter of each ``extern "C" int`` entry."""
    return {m.group(1): [" ".join(p.split()[:-1]) for p in m.group(2).split(",") if p.strip()]
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}


def test_gather_lab_entries_match_argtypes():
    """Each entry of the lab source takes the ctypes types the wrapper
    declares, in order: an argument list one short (hash_mix32x8's had
    four types for five parameters) passes the rest by ctypes' default
    conversion, a C int, which cuts a 64-bit count or stream handle."""
    src = gather_lab.SOURCE.read_text()
    entries = c_entries(src)
    assert set(entries) == set(gather_lab.ARGTYPES) and set(gather_lab.NAMES) < set(entries)
    for name, types in entries.items():
        assert [C_TYPES[t] for t in types] == gather_lab.ARGTYPES[name], name
    assert constexprs(src)["kFoldWarps"] == gather_lab.FOLD_WARPS
