"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and lengths, and that every cell, configuration, traffic mix and
metric has its file."""

import json
import re

import pytest

from portbench.harness import PKG, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["name"] == c["name"]
        assert (PKG / "builds" / f"{conf['build']}.py").is_file()
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert len({w["name"] for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert (PKG / "workloads" / f"{w['name']}.json").is_file()
        mix = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PKG / "traffic" / f"{mix['kind']}.py").is_file()
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in BENCH["per_layer"])


def test_metrics():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("bad", ["a b", "x,y", "a/b", ".x", "", "µs"])
def test_the_name_rule_refuses(bad):
    assert not NAME.match(bad)
