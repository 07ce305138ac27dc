#!/usr/bin/env python3
"""Which divisions of the bf16 lid step would take the IEEE division's
slow path, on the card.

Two parts, both on the bf16 lid cavity 256^3 (K1 [bgk+bf16]), one at rest
(the initial state) and one developed (after 1000 steps):

1. The operands of every division the collide-stream step makes at a
   fluid cell, by site, sorted into classes: the moments' m / rho (three a
   cell, the dividend m_x, m_y or m_z), BGK's (p_i - feq_i) / tau (19 a
   cell), and the NEE rewrite's moments of the lid plane's own cells
   (three a consumer cell). Classes of a dividend: zero, subnormal,
   normal below 2^-87, normal in [2^-87, 2^88) (div_exact's range), at
   or above 2^88, inf or NaN; a divisor outside [2^-23, 2^24) is counted
   apart. The operands come from the dense step's plain arithmetic
   (engine/step.py on the widened state), which the kernel matches bit
   for bit.
2. What each class costs each division: a small CUDA kernel (built here
   with nvcc and the port's flags) divides a row of dividends of one class
   by 16 divisors near tau, 256 times a thread, with IEEE a / b and with
   div_exact (csrc/d3q19.cuh) from precomputed reciprocals, timed by CUDA
   events: a class whose IEEE time stands far above the normal one's
   takes the slow path (nvcc's range check is not documented and ncu does
   not run on the card's machine, so this is how it shows).

    python3 probes/div_path.py        # needs a card and nvcc

Prints the card's name and power limit, then one JSON object.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include "d3q19.cuh"

__global__ void div_ieee(const float* a, const float* b, int reps,
                         float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float x = a[i];
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) acc += x / b[r & 15];
  out[i] = acc;
}

__global__ void div_exact_k(const float* a, const float* b, const float* y,
                            int reps, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float x = a[i];
  float acc = 0.0f;
  for (int r = 0; r < reps; ++r) acc += div_exact(x, b[r & 15], y[r & 15]);
  out[i] = acc;
}

extern "C" int run(int exact, const float* a, const float* b,
                   const float* y, int n, int reps, float* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact) {
    div_exact_k<<<n / 256, 256, 0, s>>>(a, b, y, reps, out);
  } else {
    div_ieee<<<n / 256, 256, 0, s>>>(a, b, reps, out);
  }
  return (int)cudaGetLastError();
}
"""

# dividend classes of part 2: (label, value)
TIMED = [("+0", 0.0), ("-0", -0.0), ("subnormal 1e-40", 1e-40),
         ("normal 2^-100", 2.0 ** -100), ("normal 2^-87", 2.0 ** -87),
         ("normal 1e-8", 1e-8), ("normal 0.01", 0.01),
         ("normal 2^100", 2.0 ** 100)]


def classes(a, torch) -> dict:
    """Counts of a float32 tensor's values by dividend class."""
    bits = a.reshape(-1).view(torch.int32) & 0x7FFFFFFF
    exp = bits >> 23
    zero = bits == 0
    sub = (exp == 0) & ~zero
    special = exp == 255
    low = (exp > 0) & (exp < 40)
    high = (exp >= 215) & ~special
    return {"zero": int(zero.sum()), "subnormal": int(sub.sum()),
            "normal below 2^-87": int(low.sum()),
            "normal in range": int(((exp >= 40) & (exp < 215)).sum()),
            "2^88 or above": int(high.sum()),
            "inf or NaN": int(special.sum())}


def divisor_out(b, torch) -> int:
    """How many divisors lie outside div_exact's [2^-23, 2^24) or are not
    positive."""
    return int(((b < 2.0 ** -23) | (b >= 2.0 ** 24)).sum())


def sites(sim, torch) -> dict:
    """The division sites' operand classes over the fluid cells of one
    step from sim's state."""
    from lbm_tpu_torch.core.lattice import momentum, phi
    from lbm_tpu_torch.engine.step import pulled_state, velocity

    cc = sim.cc
    f32 = sim.f.float()
    fluid = cc.fluid
    pulled = pulled_state(cc, f32, 0, cc.kernel_bcs)
    rho, mom = momentum(pulled)
    safe = torch.where(rho == 0, torch.ones_like(rho), rho)
    out = {"cells": int(fluid.sum()),
           "moments m/rho": classes(torch.stack(mom)[:, fluid], torch),
           "moments divisor rho out of range": divisor_out(safe[fluid],
                                                           torch)}
    # the dense step's feq (engine/step.collide_cells)
    f_eq = rho[None] * phi(velocity(rho, mom))
    out["BGK (p - feq)/tau"] = classes((pulled - f_eq)[:, fluid], torch)
    del pulled, f_eq
    # the NEE rewrite's moments of its consumer cells' own populations
    own, own_mom = [], torch.stack(momentum(f32)[1])
    for bc in cc.kernel_bcs:
        sel = torch.zeros_like(fluid)
        sel.select(bc.axis, bc.consumer_coord).copy_(
            bc.valid.any(0) & fluid.select(bc.axis, bc.consumer_coord))
        own.append(own_mom[:, sel])
    if own:
        out["NEE moments m/rho"] = classes(torch.cat(own, dim=1), torch)
    return out


def timing(device, torch) -> dict:
    """ms per 10^9 divisions of each dividend class, IEEE and div_exact."""
    from lbm_tpu_torch.kernels import _build

    tmp = tempfile.mkdtemp(prefix="div_path_")
    src = os.path.join(tmp, "div_path.cu")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    so = os.path.join(tmp, "libdiv_path.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    "-I", str(_build.CSRC), "-o", so, src], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.run.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                        vp, vp]
    lib.run.restype = ctypes.c_int
    n, reps = 1 << 22, 256
    b = torch.linspace(0.55, 0.65, 16, device=device)
    y = 1.0 / b  # float32 division: RN(1/b)
    out = torch.empty(n, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    res = {}
    for label, value in TIMED:
        a = torch.full((n,), value, dtype=torch.float32, device=device)
        row = {}
        for exact in (0, 1):
            def go():
                err = lib.run(exact, a.data_ptr(), b.data_ptr(),
                              y.data_ptr(), n, reps, out.data_ptr(), stream)
                assert err == 0, err
            for _ in range(3):
                go()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                go()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 10
            row["div_exact" if exact else "ieee"] = round(
                ms / (n * reps) * 1e9, 4)
        res[label] = row
        print(f"{label}: ms per 10^9 divisions {row}", flush=True)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("div_path: needs a CUDA card", file=sys.stderr)
        return 1
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    out = {"card": smi, "timing": timing(device, torch)}
    sim = Simulation(get_case("lid_driven_cavity", n=256), device=device,
                     store_dtype="bf16")
    out["at rest"] = sites(sim, torch)
    print("at rest", json.dumps(out["at rest"]), flush=True)
    sim.run(max_steps=1000, time_save=1000, verbose=False)
    out["after 1000 steps"] = sites(sim, torch)
    print("after 1000 steps", json.dumps(out["after 1000 steps"]),
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
