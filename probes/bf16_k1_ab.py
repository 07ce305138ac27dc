#!/usr/bin/env python3
"""K1 on bf16 storage of one tree of the port, on the card: the
collide-stream launch's ms by CUDA events on one fixed state (each call
steps the same src into the same dst), at rest (the initial state) and on
the developed state, for [bgk+bf16] at lid 256^3 (developed: after the
bf16 lid path's 1000 steps) and [bgk+z+bf16] and [trt+cy+z+bf16] (TRT +
Carreau blood) on the full pulsatile coronary (developed: after 2000
steps), each beside its bound (chip_smoke.step_bytes at 3.35 TB/s); and
the bf16 lid and bf16 vessel paths' ms/step (Simulation.run, host clock
around chunks that end in a device read) and device busy share
(torch.profiler over 200 more steps). Run it for two trees in turns
(parent, change, change, parent) in one call to compare them on one
card.

    python3 probes/bf16_k1_ab.py [ROOT] [--flag NVCC_FLAG ...] [--build-only]

ROOT: a checkout of the repo (default: this one), whose lbm_tpu_torch
and chip_smoke are imported; only its bf16 single-step library is built
(into ROOT's kernels/_build, or with flags into a directory of their own
under it). --flag adds an nvcc flag to the build, a -D or an
optimisation flag (a form of the kernel to time, never a build the port
uses). --build-only builds, prints ptxas's registers and spills of the
collide-stream instances and the library's path, and stops (start the
variants' builds side by side, then time them in turns). Prints the
card's name and power limit, then one JSON object.
"""

import json
import os
import subprocess
import sys
import time


def main() -> int:
    args = sys.argv[1:]
    build_only = "--build-only" in args
    args = [a for a in args if a != "--build-only"]
    flags = []
    while "--flag" in args:
        i = args.index("--flag")
        flags.append(args[i + 1])
        del args[i:i + 2]
    root = os.path.abspath(args[0] if args else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bf16_k1_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.core.rheology import carreau_blood
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K

    _build._SOURCES = {k: v for k, v in _build._SOURCES.items()
                       if k == "collide_stream_bf16"}
    if flags:
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(flags)
        _build.BUILD_DIR = _build.BUILD_DIR / "".join(
            c if c.isalnum() else "_" for c in "".join(flags))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = _build.load_library(bf16=True)
    out = {"card": smi, "root": root, "flags": flags}
    if build_only:
        stack = {}
        out.update(build_s=round(time.perf_counter() - t0, 1),
                   path=str(lib.path), ptxas={
                       k: v + (stack.get(k),) for k, v in C.ptxas_report(
                           lib.log, tag="bf16", stack=stack).items()
                       if k.startswith(("collide_stream_kernel[",
                                        "collide_stream_pair_kernel["))})
        print(json.dumps(out), flush=True)
        return 0
    series = torch.zeros(1, dtype=torch.float64, device=device)

    def fixed_ms(sim, iters):
        src, dst = sim.f.clone(), sim.f.clone()
        return C.time_ms(lambda: K.collide_stream(src, dst, sim.cc, series,
                                                  0, 0), iters)

    def path(sim, steps, chunk):
        marks = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.run(max_steps=steps, time_save=chunk, verbose=False,
                on_save=lambda s, st, r: marks.append(time.perf_counter()))
        per = [round((b - a) / chunk * 1e3, 4)
               for a, b in zip([t] + marks, marks)]
        again = time.perf_counter()
        sim.run(max_steps=200, time_save=200, verbose=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - again) / 200 * 1e3
        by_name, busy = C.profile_run(sim, 200)
        dev = sum(v[0] for v in by_name.values())
        k1 = sum(v[0] for k, v in by_name.items() if "collide_stream" in k)
        return {"ms_per_step_chunks": per, "ms_per_step_200": round(ms, 4),
                "device_ms_per_step": round(dev, 5),
                "k1_device_ms": round(k1, 5),
                "busy_traced": round(busy, 3),
                "busy_untraced": round(dev / ms, 3)}

    def kernel_pair(spec, label, steps, chunk, iters):
        sim = Simulation(spec, device=device, store_dtype="bf16")
        cc = sim.cc
        bound = C.bound_ms(C.step_bytes(cc, cc.fluid, cc.step_bcs, 2))
        rest = fixed_ms(sim, iters)
        K.reset_launches()
        run = path(sim, steps, chunk)
        run["launches"] = dict(K.launches)
        dev = fixed_ms(sim, iters)
        out[label] = {"instance": K.instance(cc) + "+bf16",
                      "rest_ms": round(rest, 5),
                      "developed_ms": round(dev, 5),
                      "bound_ms": round(bound, 5), "path": run}
        print(label, json.dumps(out[label]), flush=True)
        del sim
        C.free_device()

    full = get_case("coronary", **C.FULL_CORONARY)
    kernel_pair(get_case("lid_driven_cavity", n=256), "lid 256^3", 1000,
                250, 500)
    kernel_pair(full, "coronary full", 2000, 1000, 2000)
    kernel_pair(get_case("coronary", **C.FULL_CORONARY, collision="trt",
                         rheology=carreau_blood(full.units)),
                "coronary full trt+carreau blood", 2000, 1000, 2000)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
