"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and lengths, the files it names, and that every cell, metric and
entry has its file."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert {"case", "params", "assumed"} <= set(cfg)
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg["params"]
                   for k in c["reduced"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        tr = json.loads((ROOT / "lbm_bench" / "workloads"
                         / f"{w['name']}.json").read_text())
        assert (ROOT / "lbm_bench" / "entries"
                / f"{tr['entry']}.py").is_file()
        assert tr["limits"] and all(v > 0 for v in tr["limits"].values())


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    ms = BENCH[kind]
    assert 1 <= len(ms) <= (16 if kind == "end_to_end" else 128)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in ms:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _line(m["layer"]) and m["moves"] in e2e
            assert (ROOT / "lbm_bench" / "metrics"
                    / f"{m['name']}.py").is_file()
    if kind == "end_to_end":
        assert "setup_s" in e2e


def test_names_unique_across_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    assert e2e["setup_s"] == cells
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for c in cells:
        assert sum(c in w for w in e2e.values()) >= 2
        assert any(c in m.get("workloads", cells)
                   for m in BENCH["per_layer"])
