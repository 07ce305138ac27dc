"""Tiny copies of the benchmark's cells for CPU tests: a root directory
with BENCHMARK.json and the cells' files as committed, the
configurations cut to a few thousand cells and the chunks to a few
steps. The traffic's other keys (program, case, limits, control) stay
the committed ones."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_PARAMS = {
    "lid_cavity_256": {"n": 12},
    "coronary_291": {"shape": [40, 24, 48], "radius": 4},
}
TINY_TRAFFIC = {"chunk_steps": 6, "warmup_steps": 4}
# a bolus on for half of every 8 steps, so that the tiny runs carry c
TINY_BOLUS = {"period": 8, "on": 4}


def tiny_root(tmp: Path, traffic: dict | None = None) -> Path:
    """A copy of the benchmark's data under tmp at the tiny sizes;
    traffic: more keys to set in every cell's traffic."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "lbm_bench" / "configs").mkdir(parents=True)
    (tmp / "lbm_bench" / "workloads").mkdir(parents=True)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["params"].update(TINY_PARAMS[c["name"]])
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        src = ROOT / "lbm_bench" / "workloads" / f"{w['name']}.json"
        tr = json.loads(src.read_text())
        tr.update(TINY_TRAFFIC)
        if "bolus" in tr["program"]:
            tr["program"]["bolus"].update(TINY_BOLUS)
        tr.update(traffic or {})
        (tmp / "lbm_bench" / "workloads" / src.name).write_text(
            json.dumps(tr))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp
