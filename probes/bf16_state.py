#!/usr/bin/env python3
"""Time the collide-stream kernel (K1a, lbm_collide_stream [bgk]) and the
fused pair (K2, lbm_collide_stream2 [bgk]) on the 256^3 lid cavity in
fp32 and in bf16 storage, on the initial state and on the state after
1000 steps, by CUDA events (chip_smoke.time_ms). It runs twice: with the
kernels as built (IEEE division, bit-equal to their plain versions), and
in a second process built with nvcc's -prec-div=false, whose approximate
division is not bit-equal to anything: a measurement of what the
division's slow path costs, never a build the port uses.

    python3 probes/bf16_state.py       # one CUDA card and nvcc

Prints the card's name and power limit, then one line per build, dtype
and state.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def measure(build: str) -> None:
    from lbm_tpu_torch.kernels import _build

    if build == "fastdiv":
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-prec-div=false",)
    import torch

    import chip_smoke as C
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import collide_stream as K

    _build._load_all()
    dev = torch.device("cuda", 0)
    spec = get_case("lid_driven_cavity", n=256)
    for dtype in ("f32", "bf16"):
        sim = Simulation(spec, device=dev, store_dtype=dtype)
        series = torch.zeros(2, dtype=torch.float64, device=dev)
        for label in ("initial state", "after 1000 steps"):
            if label != "initial state":
                sim.run(max_steps=1000, time_save=1000, verbose=False)
            state = [sim.f.clone(), sim.f.clone()]

            def k1():
                K.collide_stream(state[0], state[1], sim.cc, series, 0, 0)
                state.reverse()

            def k2():
                K.step2(state[0], state[1], sim.cc, series, 0, 0)
                state.reverse()

            k1_ms = C.time_ms(k1, 100)
            state[:] = [sim.f.clone(), sim.f.clone()]
            k2_ms = C.time_ms(k2, 50)
            print(f"{build} division, {dtype}, {label}: K1a {k1_ms:.4f} ms, "
                  f"K2 {k2_ms:.4f} ms a launch (two steps)", flush=True)
        del sim, state
        C.free_device()


def main() -> int:
    if len(sys.argv) > 1:
        measure(sys.argv[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probes/bf16_state.py needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for build in ("ieee", "fastdiv"):
        subprocess.run([sys.executable, __file__, build], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
