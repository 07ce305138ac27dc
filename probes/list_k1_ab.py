#!/usr/bin/env python3
"""The fp32 collide-stream launch over a vessel's fluid cells of one tree
of the port, on the card: K1 [bgk+z] and [trt+cy+z] (TRT + Carreau blood)
on the full pulsatile coronary and K1d [bgk+halo] on its busiest 4-way y
shard, each on one fixed state (every call steps the same src into the
same dst) at rest (the initial state) and developed (after the path's
2000 steps; the shard's window of that state): the kernel's device time
a launch by torch.profiler, and a step's (the launch and its velsum
reduction) by CUDA events over a CUDA graph of 200 calls (no host time),
each beside its bound (chip_smoke.step_bytes at 3.35 TB/s, the shard's
planes added); the vessel and blood paths' ms/step (Simulation.run, host
clock around chunks of 500 steps that end in a device read; the median
of the chunks after the first) and device busy share (torch.profiler's
device time a step over 200 more steps, over that median); and, as a
control that no change to the list route may move, K1a [bgk] at lid
256^3 (the box launch) on its initial state. Run it for two trees in turns (parent, change, change,
parent) in one call to compare them on one card. --sharded: instead,
the sharded coronary path as chip_smoke's phase 16 runs it
(chip_smoke.sharded_rank on 4 gloo ranks sharing the card, the full
coronary split along y, K1d a step on each rank): 400 steps in chunks
of 100, each rank's ms/step (host clock, synchronized), rank 0's
chunks, the halo exchange alone a step and the launches.

    python3 probes/list_k1_ab.py [ROOT] [--build-only] [--quick]
                                 [--sharded]

ROOT: a checkout of the repo (default: this one), whose lbm_tpu_torch
and chip_smoke are imported; only its fp32 collide-stream units are built
(the box unit, the list unit where ROOT has one, the y-shard unit), into
ROOT's kernels/_build. --build-only builds, prints ptxas's registers,
spills and blocks an SM of the collide-stream instances, and stops (start
the trees' builds side by side, then time them in turns). --quick: the
kernels' times alone (no lid control, no path timing or profile: the
developed states come from untimed runs). Prints the card's name and
power limit, then one JSON object.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# the fp32 collide-stream units the probe builds and launches
UNITS = ("collide_stream", "collide_stream_list", "collide_stream_halo_y")


def sharded_rank(mesh, *args):
    """chip_smoke.sharded_rank on a rank whose library loader knows
    only UNITS (built by the probe's --build-only run)."""
    import chip_smoke as C
    from lbm_tpu_torch.kernels import _build

    _build._SOURCES = {k: v for k, v in _build._SOURCES.items()
                       if k in UNITS}
    return C.sharded_rank(mesh, *args)


def main() -> int:
    args = sys.argv[1:]
    build_only = "--build-only" in args
    quick = "--quick" in args
    sharded = "--sharded" in args
    args = [a for a in args
            if a not in ("--build-only", "--quick", "--sharded")]
    root = os.path.abspath(args[0] if args else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("list_k1_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.core.rheology import carreau_blood
    from lbm_tpu_torch.engine.compile import compile_shard
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K
    from lbm_tpu_torch.parallel.halo import ring_planes

    _build._SOURCES = {k: v for k, v in _build._SOURCES.items()
                       if k in UNITS}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    if sharded:
        from lbm_tpu_torch.parallel.launch import spawn

        with tempfile.TemporaryDirectory(dir=root,
                                         prefix=".chip_smoke_") as tmp:
            t0 = time.perf_counter()
            ranks = spawn(sharded_rank, 4, ("coronary", C.FULL_CORONARY,
                                            400, 100, tmp),
                          backend="gloo", device="cuda", timeout=900)
        res = {"card": smi, "root": root,
               "ms_per_step_by_rank": [round(r["ms"], 4) for r in ranks],
               "rank0_chunks_of_100": ranks[0]["chunks"],
               "exchange_ms_by_rank": [round(r["exchange_ms"], 4)
                                       for r in ranks],
               "launches_by_rank": [r["counts"] for r in ranks],
               "shapes": [list(r["shape"]) for r in ranks],
               "setup_s": [round(r["setup_s"], 2) for r in ranks],
               "wall_s": round(time.perf_counter() - t0, 1)}
        print("sharded coronary, 4 gloo ranks", json.dumps(res), flush=True)
        return 0
    t0 = time.perf_counter()
    libs = _build._load_all()
    out = {"card": smi, "root": root}
    if build_only:
        ptxas = {}
        for name, lib in libs.items():
            tag = "halo_y" if name.endswith("halo_y") else ""
            ptxas.update({k: list(v) + [C.blocks_per_sm(v[0])]
                          for k, v in C.ptxas_report(lib.log, tag=tag).items()
                          if k.startswith(("collide_stream_kernel[",
                                           "collide_stream_list_kernel["))})
        out.update(build_s={k: round(v.build_seconds, 1)
                            for k, v in libs.items()},
                   wall_s=round(time.perf_counter() - t0, 1), ptxas=ptxas)
        print(json.dumps(out), flush=True)
        return 0
    series = torch.zeros(1, dtype=torch.float64, device=device)

    def device_ms(fn, n=200):
        """The collide-stream kernel's device time a launch over n calls
        of fn (the profiler's time over the launches it saw; its velsum
        reduction left out)."""
        by_name, _ = C.profile_steps(lambda: [fn() for _ in range(n)], n)
        seen = [v for k, v in by_name.items()
                if "collide_stream" in k and "reduce" not in k]
        calls = sum(v[1] for v in seen)
        return sum(v[0] for v in seen) / calls if calls else 0.0

    def graph_ms(fn, n=200):
        """A call's device time over a CUDA graph of n calls (no host
        time between launches), by CUDA events around 5 replays."""
        try:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
            graph.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                graph.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / (5 * n)
        except Exception as exc:  # noqa: BLE001 - reported, not hidden
            return f"not measured: {type(exc).__name__}: {exc}"

    def fixed(f, cc, halo=None, alternate=False):
        """{device ms, graph ms} of one launch stepping f into a copy, and
        with alternate also of launches that step two buffers in turn from
        f, as a run does (each call's output the next one's input: what
        the card's L2 keeps of a step's output, the next step reads)."""
        bufs = [f.clone(), f.clone()]

        def go():
            K.collide_stream(bufs[0], bufs[1], cc, series, 0, 0, halo=halo)

        def turn():
            go()
            bufs.reverse()
        res = {}
        for tag, fn in (("", go),) + ((("pingpong_", turn),) if alternate
                                       else ()):
            fn()
            res[f"{tag}device_ms"] = round(device_ms(fn), 5)
            g = graph_ms(fn)
            res[f"{tag}graph_ms"] = round(g, 5) if isinstance(g, float) \
                else g
        del bufs
        return res

    def path(sim, steps, chunk):
        marks = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.run(max_steps=steps, time_save=chunk, verbose=False,
                on_save=lambda s, st, r: marks.append(time.perf_counter()))
        per = [round((b - a) / chunk * 1e3, 4)
               for a, b in zip([t] + marks, marks)]
        # the chunks after the first (which holds the run's set-up)
        ms = sorted(per[1:])[len(per[1:]) // 2]
        by_name, busy = C.profile_run(sim, 200)
        dev = sum(v[0] for v in by_name.values())
        k1 = sum(v[0] for k, v in by_name.items()
                 if "collide_stream" in k and "reduce" not in k)
        return {"ms_per_step_chunks": per, "median_ms_per_step": ms,
                "device_ms_per_step": round(dev, 5),
                "k1_device_ms": round(k1, 5),
                "busy_traced": round(busy, 3),
                "busy_untraced": round(dev / ms, 3)}

    def shard(spec, f_dev):
        """K1d on the busiest of 4 y shards, at rest and on the window of
        the developed state."""
        from lbm_tpu_torch.bridge import shard_window

        ccs = [compile_shard(spec, r, 4, 1, device) for r in range(4)]
        rank = max(range(4), key=lambda r: int(ccs[r].fluid.sum()))
        cc = ccs[rank]
        lat = [n for a, n in enumerate(cc.shape) if a != 1]
        planes = 2 * (5 * 4 + 1) * lat[0] * lat[1]
        res = {"rank": rank, "shape": list(cc.shape),
               "fluid": int(cc.fluid.sum()),
               "bound_ms": round(C.bound_ms(
                   C.step_bytes(cc, cc.fluid, cc.step_bcs) + planes), 6)}
        for label, f in (("rest", initial_f(cc)),
                         ("developed", shard_window(f_dev, rank, 4, 1))):
            halo = cc.halo(*ring_planes([f], 1)[0])
            res[label] = fixed(f, cc, halo, label == "developed")
        return res

    def coronary(spec, label):
        sim = Simulation(spec, device=device)
        cc = sim.cc
        res = {"instance": K.instance(cc) + "+z",
               "fluid": int(cc.fluid.sum()),
               "bound_ms": round(C.bound_ms(
                   C.step_bytes(cc, cc.fluid, cc.step_bcs)), 6)}
        tables = getattr(cc, "fluid_launch", None)
        if tables is not None:
            res["lanes"] = int(tables.links.numel())
            res["table_bytes"] = tables.nbytes
        res["rest"] = fixed(sim.f, cc)
        K.reset_launches()
        if quick:
            sim.run(max_steps=2000, time_save=1000, verbose=False)
        else:
            res["path"] = path(sim, 2000, 500)
        res["launches"] = dict(K.launches)
        res["developed"] = fixed(sim.f, cc, alternate=True)
        if spec.collision == "bgk":
            res["k1d"] = shard(spec, sim.f)
        out[label] = res
        print(label, json.dumps(res), flush=True)
        del sim
        C.free_device()

    if not quick:
        lid = Simulation(get_case("lid_driven_cavity", n=256),
                         device=device)
        out["lid 256^3 bgk (box, control)"] = dict(
            fixed(lid.f, lid.cc),
            bound_ms=round(C.bound_ms(C.step_bytes(
                lid.cc, lid.cc.fluid, lid.cc.step_bcs)), 5))
        del lid
        C.free_device()
    full = get_case("coronary", **C.FULL_CORONARY)
    coronary(full, "coronary full bgk")
    coronary(get_case("coronary", **C.FULL_CORONARY, collision="trt",
                      rheology=carreau_blood(full.units)),
             "coronary full trt+carreau blood")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
