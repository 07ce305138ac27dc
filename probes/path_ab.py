#!/usr/bin/env python3
"""The lid main path, the force path, the fuse2 path, the vessel path,
the coupled washout and the thermal path (BGK, then TRT) of one tree of
the port, timed through Simulation.run (CoupledTransport.run,
BuoyantTransport.run) on the card, and the clinical path and clinical
coupled washout (the coronary with windkessel outlets) where the tree has
them: run it for two trees in turns (parent, change, change, parent) in
one call to compare them on one card.

    python3 probes/path_ab.py [ROOT]   # ROOT: a checkout of the repo
                                       # (default: this one); needs a card

ROOT's lbm_tpu_torch is imported (its kernels built into ROOT's
kernels/_build at first use). Prints one JSON object: the card's name and
power limit, ROOT, and for each path its ms/step over each chunk (host
clock around chunks that end in a device read), and the collide-stream
kernel's ms a launch on one fixed state (CUDA events over 500 launches
after a warm-up) at lid 256^3 [bgk] and gravity_channel 256^3
[trt+force], and of the force-field instances at heated_cavity_3d 256^3
([bgk+field], [trt+field]; 300 launches on the state the run left, the
two buffers in turn).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if sys.argv[1:] else
                           os.path.dirname(os.path.dirname(__file__)))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("path_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.scalar import CoupledTransport
    from lbm_tpu_torch.kernels import collide_stream as K

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"card": smi, "root": root}

    def chunks(spec, steps, time_save, fuse=1, sim=None):
        sim = sim or Simulation(spec, device=device, fuse=fuse)
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(max_steps=steps, time_save=time_save, verbose=False,
                on_save=lambda s, t, r: marks.append(time.perf_counter()))
        per = [(b - a) / time_save * 1e3
               for a, b in zip([t0] + marks, marks)]
        return sim, per

    def transport_chunks(make, steps, chunk):
        tr = make()
        per = []
        for _ in range(steps // chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run(chunk)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) / chunk * 1e3)
        del tr
        torch.cuda.empty_cache()
        return per

    def kernel_ms(sim, iters=500):
        f, spare = sim.f, sim._spare.clone()
        series = torch.zeros(1, dtype=torch.float64, device=device)
        for _ in range(50):
            K.collide_stream(f, spare, sim.cc, series, 0, 0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            K.collide_stream(f, spare, sim.cc, series, 0, 0)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    sim, out["lid_ms_per_step"] = chunks(
        get_case("lid_driven_cavity", n=256), 1000, 250)
    out["lid_k1_ms"] = kernel_ms(sim)
    del sim
    sim, out["force_ms_per_step"] = chunks(
        get_case("gravity_channel", n=256, nz=256, collision="trt"), 1000,
        250)
    out["force_k1_ms"] = kernel_ms(sim)
    del sim
    torch.cuda.empty_cache()
    sim, out["fuse2_ms_per_step"] = chunks(
        get_case("lid_driven_cavity", n=256), 1000, 250, fuse=2)
    del sim
    torch.cuda.empty_cache()
    full = dict(shape=[291, 291, 372], radius=12, pulsatile=[40, 2000])
    sim, out["vessel_ms_per_step"] = chunks(get_case("coronary", **full),
                                            2000, 500)
    del sim
    torch.cuda.empty_cache()
    out["coupled_ms_per_step"] = transport_chunks(
        lambda: CoupledTransport(get_case("coronary", **full), D=0.02,
                                 device=device), 2000, 500)
    from lbm_tpu_torch.cases import thermal as tcases
    from lbm_tpu_torch.engine.thermal import BuoyantTransport

    def field_ms(bt, iters=300):
        state = [bt.f, bt._f_spare]
        series = torch.zeros(1, dtype=torch.float64, device=device)

        def launch():
            K.collide_stream(state[0], state[1], bt.cc, series, 0, 0,
                             field=bt.field, g=bt.g)
            state.reverse()

        for _ in range(50):
            launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    spec, kw, _ = tcases.heated_cavity_3d(n=256, ra=1e4, pr=0.71)
    for coll, steps, key in (("bgk", 1000, "thermal"),
                             ("trt", 500, "thermal_trt")):
        made = []

        def make(coll=coll):
            made.append(BuoyantTransport(
                dataclasses.replace(spec, collision=coll), device=device,
                **kw))
            return made[-1]

        out[f"{key}_ms_per_step"] = transport_chunks(make, steps, 250)
        out[f"{key}_k1e_ms"] = field_ms(made[-1])
        del made
        torch.cuda.empty_cache()
    try:  # the windkessel outlets, in trees that have them
        clin = get_case("coronary", **full, windkessel=[
            (2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3)
        sim = Simulation(clin, device=device)
    except NotImplementedError:
        out["clinical_ms_per_step"] = None
    else:
        sim, out["clinical_ms_per_step"] = chunks(clin, 2000, 500, sim=sim)
        del sim
        torch.cuda.empty_cache()
        out["clinical_coupled_ms_per_step"] = transport_chunks(
            lambda: CoupledTransport(clin, tau_g=0.6, device=device), 2000,
            500)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
