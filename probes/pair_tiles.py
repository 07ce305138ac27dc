#!/usr/bin/env python3
"""The fused pair (K2) built with other column tiles and occupancies, held
against two single-step launches and timed beside them on the card.

    python3 probes/pair_tiles.py [TY,TZ,BLOCKS ...]   # needs nvcc and a card

Each argument (default: the design's 8,32,2 and the alternatives
8,30,2 6,32,2 6,30,2 8,64,1 14,30,1) rebuilds collide_stream2.cu and
collide_stream2_bf16.cu with kTY, kTZ and kPairBlocksPerSM set, side by
side, into a temporary copy of kernels/csrc; prints ptxas's registers and
spills of the BGK and TRT instances and the blocks an SM; holds the pair
bit for bit against two K1 launches on lid 64^3, lid 66^3 TRT, pipe n=36
and gravity_channel 20x20x3; then times one K2 launch against two K1
launches, in turns, at lid 256^3 in fp32 and bf16, from rest
(chip_smoke.time_pair) and from the state of 1000 steps. Prints one JSON
object of the times (ms a launch) on its last line. Measurement only:
the port's build is untouched.
"""

import concurrent.futures
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DEFAULT = ["8,32,2", "8,30,2", "6,32,2", "6,30,2", "8,64,1", "14,30,1"]


def build(csrc, tmp, ty, tz, blocks):
    """nvcc jobs of the two pair units of one variant in a copy of csrc."""
    from lbm_tpu_torch.kernels import _build

    d = os.path.join(tmp, f"t{ty}x{tz}x{blocks}")
    shutil.copytree(csrc, d)
    h = os.path.join(d, "collide_stream2.cuh")
    s = open(h).read()
    for name, v in (("kTY", ty), ("kTZ", tz), ("kPairBlocksPerSM", blocks)):
        s = re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};",
                   s)
    open(h, "w").write(s)
    return [(sfx, [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                   os.path.join(d, f"lib{sfx}.so"),
                   os.path.join(d, f"collide_stream2{sfx}.cu")])
            for sfx in ("", "_bf16")]


def main() -> int:
    import torch

    import chip_smoke as cs
    import lbm_tpu_torch.engine.compile as C
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K

    if not torch.cuda.is_available():
        print("pair_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    variants = [tuple(int(v) for v in a.split(","))
                for a in (sys.argv[1:] or DEFAULT)]
    csrc = os.path.join(ROOT, "lbm_tpu_torch", "kernels", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(v, sfx, cmd) for v in variants
                for sfx, cmd in build(csrc, tmp, *v)]
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            procs = list(pool.map(
                lambda j: subprocess.run(j[2], capture_output=True,
                                         text=True), jobs))
        libs = {}
        for (v, sfx, cmd), p in zip(jobs, procs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {v}:\n{p.stderr}")
            so = cmd[cmd.index("-o") + 1]
            lib = ctypes.CDLL(so)
            _build._declare_pair(lib, sfx)
            libs[v, bool(sfx)] = _build.Library(lib, so, True, 0.0,
                                                p.stdout + p.stderr)
            regs = cs.ptxas_report(p.stdout + p.stderr, None,
                                   "bf16" if sfx else "")
            print(f"{v} {sfx or 'fp32'}: blocks an SM "
                  f"{sorted(set(cs.pair_blocks_per_sm(lib).values()))}, "
                  + "; ".join(f"{k} {r}" for k, r in sorted(regs.items())
                              if k.startswith(("collide_stream2_kernel[bgk",
                                               "collide_stream2_kernel[trt"))
                              and "force" not in k and "closure" not in k),
                  flush=True)
        developed = {}
        for dtype in (None, "bf16"):
            sim = Simulation(get_case("lid_driven_cavity", n=256),
                             device=dev, store_dtype=dtype)
            sim.run(max_steps=1000, time_save=1000, verbose=False)
            developed[dtype] = sim.f.clone()
            del sim
        cc = C.compile_case(get_case("lid_driven_cavity", n=256), dev)
        live_tile_ids = C.live_tile_ids
        out = {}
        for v in variants:
            _build.load_pair_library = \
                lambda bf16=False, v=v: libs[v, bool(bf16)]
            K.TILE = C.TILE = (64, v[0], v[1])
            C.live_tile_ids = functools.partial(live_tile_ids, tile=K.TILE)
            for label, name, kw in (
                    ("lid 64^3", "lid_driven_cavity", dict(n=64)),
                    ("lid 66^3 trt", "lid_driven_cavity",
                     dict(n=66, collision="trt")),
                    ("pipe n=36", "pipe", dict(n=36, curved=False)),
                    ("gravity_channel 20x20x3", "gravity_channel",
                     dict(n=20, nz=3, collision="trt"))):
                cs.compare_pair(f"{v} {label}", get_case(name, **kw), 6,
                                dev, True)
            row = {}
            for dtype, tag in ((None, "fp32"), ("bf16", "bf16")):
                timer = cs.time_pair if dtype is None else cs.time_pair_bf16
                r = timer(get_case("lid_driven_cavity", n=256), dev, 150,
                          f"{v} lid 256^3 {tag}")
                state = [developed[dtype].clone(), developed[dtype].clone()]
                series = torch.zeros(2, dtype=torch.float64, device=dev)

                def pair():
                    K.step2(state[0], state[1], cc, series, 0, 1000)
                    state.reverse()

                def two():
                    for k in (0, 1):
                        K.collide_stream(state[0], state[1], cc, series, k,
                                         1000 + k)
                        state.reverse()

                ms, two_ms = cs.in_turns(f"{v} lid 256^3 {tag} after 1000 "
                                         "steps", two, pair, 100, 100,
                                         names="two K1 launches/K2")
                row[tag] = {"rest": r["ms"], "rest_two_k1": r["two_k1_ms"],
                            "developed": ms, "developed_two_k1": two_ms}
                del state
            out[",".join(map(str, v))] = row
    print(json.dumps({"ms_a_launch": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
