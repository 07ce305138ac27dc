"""The harness run end to end on the CPU at tiny sizes (the program's
plain versions in place of its CUDA kernels): a sound run is correct,
the control and each fault the cells can have are not, a cell added as
files alone is found, and nothing of JAX is loaded.

The faults break the program's timed path underneath the harness: the
step that returns its state unchanged, the step that leaves half of the
cells out, and the step whose answer is altered where it is produced.
The cells run on one chip, so no exchange between chips can be left
out."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from lbm_bench.harness import load_cell, run_cell
from lbm_bench.tests.tiny import ROOT, tiny_root

CELLS = ["lid256.bgk_f32", "coronary291.vessel_bgk",
         "coronary291.clinical_wk", "coronary291.coupled_washout"]
SEED = 2**31 + 11


def _run(tmp_path, cell, **kw):
    return run_cell(cell, SEED, 0.2, False, "cpu", root=tiny_root(tmp_path),
                    **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    r = _run(tmp_path, cell)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {m["name"] for m in
                                 load_cell(cell)["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tmp_path, cell):
    r = _run(tmp_path, cell, control=True)
    assert not r["correct"], r["check"]


def _unchanged(step):
    def broken(f, out, cc, series, slot, t, **kw):
        step(f, out, cc, series, slot, t, **kw)
        out.copy_(f)
        return out
    return broken


def _half(step):
    def broken(f, out, cc, series, slot, t, **kw):
        step(f, out, cc, series, slot, t, **kw)
        n = f.shape[1] // 2
        out[:, :n] = f[:, :n]
        return out
    return broken


def _altered(step):
    def broken(f, out, cc, series, slot, t, **kw):
        step(f, out, cc, series, slot, t, **kw)
        fluid = torch.nonzero(cc.fluid.reshape(-1)).reshape(-1)
        out.view(19, -1)[5, fluid[len(fluid) // 2]] += 1e-3
        return out
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(tmp_path, monkeypatch, cell, fault):
    from lbm_tpu_torch.kernels import collide_stream

    monkeypatch.setattr(collide_stream, "step", fault(collide_stream.step))
    r = _run(tmp_path, cell)
    assert not r["correct"], r["check"]


def _scalar_fault(kind):
    def wrap(step):
        def broken(g, out, sc, t, **kw):
            step(g, out, sc, t, **kw)
            if kind == "unchanged":
                out.copy_(g)
            elif kind == "half":
                n = g.shape[1] // 2
                out[:, :n] = g[:, :n]
            else:
                fluid = torch.nonzero(sc.fluid.reshape(-1)).reshape(-1)
                out.view(7, -1)[0, fluid[len(fluid) // 2]] += 1e-3
            return out
        return broken
    return wrap


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_scalar_fault_fails(tmp_path, monkeypatch, kind):
    from lbm_tpu_torch.kernels import scalar_stream

    monkeypatch.setattr(scalar_stream, "scalar_stream",
                        _scalar_fault(kind)(scalar_stream.scalar_stream))
    r = _run(tmp_path, "coronary291.coupled_washout")
    assert not r["correct"], r["check"]


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "lid256.extra_cell", "config": "lid_cavity_256",
        "traffic": "extra_cell", "chips": 1, "why": "a test's cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = json.loads((root / "lbm_bench" / "workloads"
                     / "lid256.bgk_f32.json").read_text())
    tr["chunk_steps"] = 3
    (root / "lbm_bench" / "workloads" / "lid256.extra_cell.json").write_text(
        json.dumps(tr))
    r = run_cell("lid256.extra_cell", 3, 0.1, False, "cpu", root=root)
    assert r["correct"], r["check"]
    assert r["window"]["steps"] % 3 == 0


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    tiny_root(tmp_path)
    tops = _top_level_after(
        "from pathlib import Path\n"
        "from lbm_bench import run\n"
        "from lbm_bench.harness import run_cell\n"
        f"run_cell('lid256.bgk_f32', 1, 0.1, False, 'cpu', "
        f"root=Path({str(tmp_path)!r}))")
    assert not tops & {"jax", "jaxlib", "flax", "lbm_tpu"}
    assert "lbm_tpu_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    tops = _top_level_after(
        "from lbm_bench.reference.geometry import build\n"
        "from lbm_bench.reference.stepper import Stepper\n"
        "from lbm_bench import yardstick\n"
        "g = build('coronary', {'shape': [40, 24, 48], 'radius': 4})\n"
        "Stepper(g, None, 'cpu').run(2)")
    assert not tops & {"jax", "jaxlib", "flax", "lbm_tpu", "lbm_tpu_torch"}


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "lbm_bench.run", "--workload",
         "lid256.bgk_f32", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler window reads device "
                    "time")
    r = run_cell("lid256.bgk_f32", SEED, 0.5, True, "cuda",
                 root=tiny_root(tmp_path))
    assert r["correct"], r["check"]
    assert r["device"]["busy_s"] > 0
    assert "kernels.roofline_pct" in r["metrics"]
