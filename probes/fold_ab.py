#!/usr/bin/env python3
"""The windkessel fold's K1 against the same step without the fold, on one
state of the clinical coronary (the full coronary with
tools/demo_clinical_washout.py's RCR values, 2000 steps in): CUDA events
over back-to-back launches, in turns, of
  fold    the fold's launch (collide_stream_wk_kernel [bgk+wk]) and its
          reduction, its launch list the fold's (footprint cells first);
  plain   the [bgk+z] instance of the fp32 launch over the fluid cells
          (lbm_collide_stream_list: sector-aligned segments, a word of
          wall links a lane) with the same descriptors (its windkessel
          planes at their fixed rho) and its reduction;
each on two copies of the state in turn (the plain launches change the
outlets' physics: only their time is read). With --sass, the instruction
counts of the two kernels' SASS (cuobjdump from the CUDA toolkit). With
--host, the host's time a call of the fold's wrapper (collide_stream with
wk=) and of the prescribed-outlet coronary's, by cProfile over 2000 calls
each (the functions with the most time of their own).
Needs a card.

    python3 probes/fold_ab.py [--sass] [--host]
"""

import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fold_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.compile import SEG, fluid_launch_tables
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    spec = get_case("coronary", shape=[291, 291, 372], radius=12,
                    pulsatile=[40, 2000], windkessel=[
                        (2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3)
    sim = Simulation(spec, device=device)
    sim.run(max_steps=2000, time_save=500, verbose=False)
    cc = sim.cc
    state = [sim.f.clone(), sim._spare.clone()]
    wk = sim.wk.clone()
    series = torch.zeros(1, dtype=torch.float64, device=device)
    lib = _build.load_list_library().lib
    _, ci, cf = K.collision_descriptor(cc)
    nx, ny, nz = cc.shape
    bcs = cc.step_bcs
    tables = fluid_launch_tables(cc.mask)

    def plain():
        n_segs = tables.segs.shape[0]
        grid = -(-n_segs * SEG // lib.lbm_list_block_size())
        (ints, floats, valid, phis), partials = K._launch_scratch(
            cc, "k1", bcs, 0, grid)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lbm_collide_stream_list(
            state[0].data_ptr(), state[1].data_ptr(), nx, ny, nz,
            ci.ctypes.data, cf.ctypes.data, len(bcs), ints.ctypes.data,
            floats.ctypes.data, ctypes.addressof(valid),
            ctypes.addressof(phis), tables.segs.data_ptr(),
            tables.links.data_ptr(), None, n_segs, partials.data_ptr(),
            grid, series.data_ptr(), 0, None, stream)
        _build.check(lib, err, "lbm_collide_stream_list[bgk+z]")
        state.reverse()

    def fold():
        K.collide_stream(state[0], state[1], cc, series, 0, 0, wk=wk)
        state.reverse()

    runs = {"fold": fold, "plain": plain}

    def ms(fn, iters=1000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    out = {"card": smi, "ms": {k: [] for k in runs}}
    for _ in range(3):
        for name, fn in runs.items():
            out["ms"][name].append(ms(fn))
    if "--sass" in sys.argv[1:]:
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        out["sass"] = {}
        for unit, pat in (("collide_stream_list",
                           r"collide_stream_list_kernelILi0ELb0ELi0ELb0EfLin1"
                           r"ELb1E"),
                          ("windkessel",
                           r"collide_stream_wk_kernelILi0ELb0ELi0ELb0EfE")):
            so = _build._object_path(unit)
            text = subprocess.run([tool, "-sass", str(so)],
                                  capture_output=True, text=True).stdout
            for block in text.split("Function : ")[1:]:
                name = block.split("\n", 1)[0]
                if re.search(pat, name) and "bounded" not in name:
                    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                                     r"([A-Z][A-Z0-9_.]*)", block)
                    kinds = {}
                    for op in ops:
                        key = op.split(".")[0]
                        kinds[key] = kinds.get(key, 0) + 1
                    out["sass"][unit] = {"instructions": len(ops),
                                         "by_opcode": kinds}
    if "--host" in sys.argv[1:]:
        import cProfile
        import pstats

        vessel = Simulation(get_case("coronary", shape=[291, 291, 372],
                                     radius=12, pulsatile=[40, 2000]),
                            device=device)
        vstate = [vessel.f, vessel._spare]

        def vessel_step():
            K.collide_stream(vstate[0], vstate[1], vessel.cc, series, 0, 0)
            vstate.reverse()

        out["host"] = {}
        for name, fn in (("fold", fold), ("vessel", vessel_step)):
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(2000):
                fn()
            prof.disable()
            torch.cuda.synchronize()
            stats = pstats.Stats(prof)
            rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])
            out["host"][name] = {
                "us_per_call": stats.total_tt / 2000 * 1e6,
                "top": [(f"{os.path.basename(k[0])}:{k[1]} {k[2]}",
                         round(v[2] / 2000 * 1e6, 2)) for k, v in rows[:18]]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
