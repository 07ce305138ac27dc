"""The benchmark's fixed measures: the card's published peak, the least
bytes a step must move, and the profiler window that reads device time.

They are computed from the benchmark's own geometry (reference/), never
from the program's tables, so a change to the program cannot move them.
"""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch

from lbm_bench.reference.geometry import Geometry
from lbm_bench.reference.lattice import E, FLUID, Q, WALL

# NVIDIA's published H100 SXM HBM3 bandwidth at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def _valid_any(geom: Geometry, p) -> np.ndarray:
    """(A, B) bool over the consumer plane of p: cells with at least one
    direction whose source on p's plane carries p's label."""
    on = np.take(geom.mask, p.coord, axis=p.axis) == p.label
    lat = [a for a in range(3) if a != p.axis]
    out = np.zeros_like(on)
    for i in p.dirs:
        out |= np.roll(on, shift=(int(E[i, lat[0]]), int(E[i, lat[1]])),
                       axis=(0, 1))
    return out


def step_bytes(geom: Geometry, pop: int = 4) -> int:
    """The least bytes one step of the fluid cells must move, whatever
    kernel runs it: each population they pull (a neighbour's, or their own
    opposite off a wall) and each own pre-step population a plane's
    rewrite reads, once; their 19 populations written once; their label
    bytes; the rewrite's tables (a valid byte a direction, and a phi*
    float where u is prescribed). Cells that are not fluid keep their
    state and cost nothing."""
    sel = geom.mask == FLUID
    wall = geom.mask == WALL
    nee = np.zeros_like(sel)
    tables = 0
    for p in geom.planes:
        idx = [slice(None)] * 3
        idx[p.axis] = p.coord + p.normal
        on = _valid_any(geom, p) & sel[tuple(idx)]
        nee[tuple(idx)] |= on
        per_dir = 1 if p.u == "extrapolate" else 5
        tables += int(on.sum()) * len(p.dirs) * per_dir
    reads = int((sel | nee).sum())
    for j in range(1, Q):
        back = tuple(-int(v) for v in E[j])
        pulled = ((np.roll(sel, back, (0, 1, 2)) & ~wall)
                  | (sel & np.roll(wall, back, (0, 1, 2))))
        reads += int((pulled | nee).sum())
    return reads * pop + int(sel.sum()) * (19 * pop + 1) + tables


def wk_flux_bytes(geom: Geometry, pop: int = 4) -> int:
    """The least bytes of priming the RCR outlets' flux: each footprint
    cell's 19 populations, its id and weight read, its term written; each
    outlet's Q written."""
    wk = [p for p in geom.planes if p.windkessel is not None]
    n = sum(int((np.take(geom.mask, p.coord, axis=p.axis) == p.label).sum())
            for p in wk)
    return n * (19 * pop + 4 + 4 + 4) + len(wk) * 4


def usq_bytes(geom: Geometry, pop: int = 4) -> int:
    """The least bytes of a chunk's usq residual: the fluid cells' 19
    populations read once."""
    return int((geom.mask == FLUID).sum()) * 19 * pop


def scalar_bytes(geom: Geometry) -> int:
    """The least bytes one D3Q7 step of the fluid cells in the flow's new
    state moves: per fluid cell its seven pulled and seven written g, its
    label byte and the flow state's 19 populations it rebuilds u from."""
    return int((geom.mask == FLUID).sum()) * (7 * 4 + 7 * 4 + 1 + 19 * 4)


def bytes_per_step(geom: Geometry, chunk: int, usq: bool = True,
                   scalar: bool = False) -> float:
    """A step's least bytes with its share of the once-a-chunk work: the
    flux prime of RCR outlets and, with usq, the residual's read; with
    scalar, the D3Q7 step beside the flow's."""
    per_chunk = wk_flux_bytes(geom) if any(
        p.windkessel is not None for p in geom.planes) else 0
    if usq and geom.residual == "usq":
        per_chunk += usq_bytes(geom)
    return (step_bytes(geom) + (scalar_bytes(geom) if scalar else 0)
            + per_chunk / chunk)


def roofline_pct(ctx):
    """The whole step's share of the memory roofline, in %: the least
    bytes a step moves (bytes_per_step) at HBM_BYTES_PER_S over the device
    seconds a step of every kernel in the traced chunk; None without a
    trace that saw the device work."""
    prof = ctx["profile"]
    if prof is None or prof["busy_s"] <= 0 or not ctx["bytes_per_step"]:
        return None
    device_s = prof["busy_s"] / prof["steps"]
    return 100.0 * ctx["bytes_per_step"] / HBM_BYTES_PER_S / device_s


# spin kernels (torch.cuda._sleep) launched inside the recorded cycle on
# either side of the traced run, to take in its place the kernel records
# the tracer drops at a window's edge; they stay out of every sum
FILLER = 256


def profile_window(run):
    """One torch.profiler window over run(): (by kernel name: [device s,
    launches], device busy s, wall s of run(), idle gaps by host op:
    {name: s}, fillers seen (before, after)). A warm-up cycle, whose
    events are dropped, comes first; the recorded cycle sleeps 0.1 s at
    either end and launches FILLER spin kernels on either side of run()."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    cycles = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: cycles.append(p.events())) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(FILLER):
            warm.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.2)
        prof.step()
        time.sleep(0.1)
        for _ in range(FILLER):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(FILLER):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.1)
        prof.step()
    events = cycles[0] if cycles else []
    dev, host = [], []
    for ev in events:
        if ev.name.startswith("ProfilerStep"):
            continue
        kind = str(ev.device_type)
        tr = ev.time_range
        if kind.endswith("CUDA"):
            dev.append((tr.start, tr.end, ev.name))
        elif kind.endswith("CPU"):
            host.append((tr.start, tr.end, ev.name))
    spin = [d for d in dev if "spin_kernel" in d[2]]
    dev = sorted(d for d in dev if "spin_kernel" not in d[2])
    first = dev[0][0] if dev else float("inf")
    fill = (sum(1 for d in spin if d[0] < first),
            sum(1 for d in spin if d[0] > first))
    by_name: dict = {}
    busy = 0.0
    for s, e, name in dev:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += (e - s) * 1e-6
        entry[1] += 1
        busy += (e - s) * 1e-6
    return by_name, busy, wall, idle_gaps(dev, host), fill


def idle_gaps(dev, host) -> dict:
    """Seconds the device sat idle between consecutive kernels, by the
    innermost host op running at each gap's middle ('host' where none)."""
    out: dict = {}
    end = None
    host = sorted(host)
    starts = [h[0] for h in host]
    for s, e, _ in dev:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            name = "host"
            # host ops nest: the latest-starting op that holds mid is the
            # innermost
            for k in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 400),
                           -1):
                if host[k][1] >= mid:
                    name = host[k][2]
                    break
            out[name] = out.get(name, 0.0) + (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return out
