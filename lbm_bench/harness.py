"""One run of one cell: set-up, the measured window, the traced chunk, and
the check against the plain reference.

Everything a cell is made of is found by name: the cell's traffic in
lbm_bench/workloads/<cell>.json, its configuration in the file that
BENCHMARK.json names, the entry it drives in entries/<entry>.py, each
per-layer metric's reader in metrics/<metric>.py and the reference's
geometry in reference/cases/<case>.py. Adding a cell, a configuration or
a metric adds files and BENCHMARK.json entries; this file stays.

A run:
  1. set-up (timed from the process's start): the CUDA context and the
     kernel libraries, the case and the seed's inputs, the program's
     object, `warmup_steps` steps through the entry; then a seeded sample
     of the state (a few whole x planes) and a scalar's fluid cells are
     kept for the check;
  2. the window: chunks of `chunk_steps` steps through the entry until
     `seconds` have passed, the host clock read after a synchronize at
     both ends; the program's launch counters read at both ends;
  3. with trace, one more chunk under torch.profiler;
  4. the check: one more chunk through the entry from a copy of the state
     the window left; the program is freed; the plain reference then
     steps the warm-up from its own initial state and the check chunk from
     that copy, and every compared number is held to its limit.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lbm_bench import yardstick
from lbm_bench.reference.geometry import build as build_geometry
from lbm_bench.reference.scalar import Coupled
from lbm_bench.reference.stepper import Stepper

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lbm_tpu")
# x planes of the state kept after the warm-up for the check
SAMPLE_PLANES = 4


def process_start() -> float:
    """This process's start on the time.time() clock, from /proc; the
    import of this module where /proc does not say."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"lbm_bench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's BENCHMARK.json entries and files, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "lbm_bench" / "workloads" / f"{name}.json").read_text())
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"]
                          if _applies(m, name)]}


def u0_noise(seed: int, shape, amp: float, device) -> np.ndarray:
    """The seed's inputs: a (3, X, Y, Z) float32 perturbation of the
    initial velocity, normal with deviation `amp`, drawn on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    noise = torch.randn((3,) + tuple(shape), generator=g, device=device,
                        dtype=torch.float32) * amp
    return noise.cpu().numpy()


def sample_planes(seed: int, nx: int) -> list[int]:
    rng = np.random.default_rng(int(seed))
    return sorted(int(x) for x in rng.choice(np.arange(1, nx - 1),
                                             SAMPLE_PLANES, replace=False))


class Spans:
    """Host-clock spans around the calls into the program's layers."""

    def __init__(self, device):
        self.device = device
        self.seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t0)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", control: bool = False, root: Path = ROOT,
             started: float | None = None) -> dict:
    """One run; returns the result line's object. control: run the
    program in the workload's lower-precision form (the control of the
    check), never in a benchmark run."""
    started = process_start() if started is None else started
    entered = time.time()
    spec_ = load_cell(name, root)
    cfg, tr = spec_["config"], spec_["traffic"]
    device = torch.device(device)
    program = dict(tr["program"])
    if control:
        program.update(tr["control"])
    entry = _load(PKG / "entries" / f"{program.pop('entry', tr['entry'])}.py")
    if "bolus" in program:
        # the seed sets the bolus's phase
        bolus = dict(program["bolus"])
        bolus["phase"] = int(np.random.default_rng([int(seed), 1]).integers(
            bolus["period"]))
        program["bolus"] = bolus
    chunk, warm = int(tr["chunk_steps"]), int(tr["warmup_steps"])
    params = {**cfg["params"], **tr.get("case", {})}
    spans = Spans(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # 1. set-up
    with spans("setup.kernels_s"):
        torch.empty(1, device=device)
        entry.load_kernels(device)
    with spans("setup.case_s"):
        spec = entry.make_case(cfg["case"], params)
        noise = u0_noise(seed, spec.shape, tr["u0_noise"], device)
        fluid = np.flatnonzero(spec.mask.reshape(-1) == 4)
        u0 = spec.u0.reshape(3, -1)
        u0[:, fluid] += noise.reshape(3, -1)[:, fluid]
        del u0
    with spans("setup.compile_s"):
        prog = entry.build(spec, program, device)
    with spans("warmup_s"):
        out_w = entry.chunk(prog, warm)
    xs = sample_planes(seed, spec.shape[0])
    st = entry.state(prog)
    kept = {"f": st["f"][:, xs].clone(), "out": out_w,
            # the scalar over every fluid cell: a few planes may lie
            # beyond the bolus's front, where the scalar is 0 on any path
            "g": (st["g"].reshape(7, -1)[:, torch.as_tensor(
                fluid, device=device)] if "g" in st else None),
            "wk": None if st["wk"] is None else st["wk"].clone()}
    del spec, st, fluid

    # 2. the window
    launches0 = entry.launches()
    steps0 = entry.state(prog)["t"]
    failed = 0
    # each chunk ends in its device read, so its end on the host clock is
    # where the device finished it
    ends = []
    sync(device)
    t0 = time.perf_counter()
    window_start = time.time()
    while True:
        out = entry.chunk(prog, chunk)
        ends.append(time.perf_counter() - t0)
        failed += not all(bool(np.all(np.isfinite(v))) for v in out.values()
                          if v is not None)
        if ends[-1] >= seconds:
            break
    chunks = len(ends)
    sync(device)
    window_s = time.perf_counter() - t0
    steps = entry.state(prog)["t"] - steps0
    launches = entry.launches() - launches0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    setup_s = window_start - started

    # 3. the traced chunk
    prof = None
    if trace:
        by_name, busy, wall, gaps, fill = yardstick.profile_window(
            lambda: entry.chunk(prog, chunk))
        prof = {"by_name": by_name, "busy_s": busy, "wall_s": wall,
                "gaps": gaps, "fill": fill, "steps": chunk}

    # 4. the check
    st = entry.state(prog)
    snap = {"f": st["f"].clone(), "t": st["t"],
            "g": st["g"].clone() if "g" in st else None,
            "wk": None if st["wk"] is None else st["wk"].clone()}
    out_c = entry.chunk(prog, chunk)
    st = entry.state(prog)
    end = {"f": st["f"], "g": st.get("g"), "wk": st["wk"]}
    del st, prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    geom = build_geometry(cfg["case"], params)
    check = judge(geom, noise, device, program, warm, chunk, kept, xs, snap,
                  end, out_c, tr["limits"])
    del snap, end, kept
    gc.collect()
    check_s = time.perf_counter() - t_check

    ctx = {"spans": spans.seconds, "steps": steps, "launches": launches,
           "profile": prof, "chunk": chunk,
           "bytes_per_step": (yardstick.bytes_per_step(
               geom, chunk, usq=entry.USQ_A_CHUNK, scalar=entry.SCALAR)
               if trace else None)}
    metrics = {}
    if trace:
        for m in spec_["per_layer"]:
            value = _load(PKG / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = geom.n_live * steps / window_s / 1e6
        # one rate under two names: the box cells' bound is set by their
        # own spread, not by the host-paced coronary cells'
        e2e = {"mlups": rate, "mlups.coronary": rate,
               "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in spec_["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in check.values()) and failed == 0,
              "attempted": chunks, "failed": failed, "metrics": metrics,
              "device": dev}
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["wall_s"]
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])
        gaps = sorted(prof["gaps"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[k, v[0]] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
        result["profile_fillers_seen"] = list(prof["fill"])
    spans.seconds["before_run_cell_s"] = entered - started
    result["window"] = {"seconds": window_s, "steps": steps,
                        "chunks": chunks, "launches": launches,
                        "spans": spans.seconds, "check_s": check_s,
                        "chunk_ends_s": ends}
    result["check"] = check
    return result


def judge(geom, noise, device, program, warm, chunk, kept, xs, snap, end,
          out_c, limits) -> dict:
    """The compared numbers, each with its limit. The reference steps the
    warm-up from its own initial state, then the check chunk from the
    program's state at its start."""
    flow = Stepper(geom, noise, device)
    coupled = (Coupled(flow, program["D"], program["bolus"])
               if "bolus" in program else None)
    ref = coupled or flow
    nums = {}
    out_w = ref.run(warm)
    nums["f_warmup"] = flow.max_abs_diff(kept["f"], xs)
    rel, pc, rec = [], [], []
    if coupled is not None:
        nums["g_warmup"] = coupled.g_fluid_max_abs_diff(kept["g"])
        rec.append(_max_abs(kept["out"]["record"], out_w))
    elif kept["out"]["series"] is not None:
        rel.append(_max_rel(kept["out"]["series"], out_w))
    if kept["wk"] is not None:
        pc.append(_max_rel(kept["wk"].cpu().numpy(), flow.wk.cpu().numpy()))
    if coupled is not None:
        coupled.load(snap["f"], snap["g"], snap["t"], snap["wk"])
    else:
        flow.load(snap["f"], snap["t"], snap["wk"])
    usq_a = (flow.usq() if geom.residual == "usq"
             and out_c["residual"] is not None else None)
    out_r = ref.run(chunk)
    nums["f_check"] = flow.max_abs_diff(end["f"], range(geom.shape[0]))
    if coupled is not None:
        nums["g_check"] = coupled.g_max_abs_diff(end["g"],
                                                 range(geom.shape[0]))
        rec.append(_max_abs(out_c["record"], out_r))
        nums["record"] = max(rec)
    elif out_c["series"] is not None:
        rel.append(_max_rel(out_c["series"], out_r))
        nums["velsum"] = max(rel)
    if usq_a is not None:
        usq_b = flow.usq()
        nums["usq_residual"] = abs(out_c["residual"]
                                   - abs(usq_a - usq_b) / usq_b)
    if end["wk"] is not None:
        pc.append(_max_rel(end["wk"].cpu().numpy(), flow.wk.cpu().numpy()))
        nums["p_c"] = max(pc)
    out = {}
    for k, v in nums.items():
        v = float(v) if np.isfinite(v) else float("inf")
        out[k] = {"value": v, "limit": float(limits[k])}
    return out


def _max_abs(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want)))


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return float(np.max(np.abs(got - want) / scale))


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the run must not hold."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
