#!/usr/bin/env python3
"""Two cells a thread against four, on the card: the bf16 kernel's
interior form (collide_stream.cuh collide_pair_stream: BGK, the pulled
words are the populations, both cells collided at once from packed
words) rebuilt here as a kernel of its own for a group of W z-neighbour
cells a thread, W = 2 (4-byte words, the kernel's form) and W = 4 (8-byte
words: a direction with e_z = 0 is one 8-byte load, a shifted one an
8-byte and a 4-byte load joined with __byte_perm). Each runs over the
interior groups of the bf16 lid 256^3 after 1000 steps (every cell of the
group fluid, no wall source, no z wrap, off the lid plane), is held bit
for bit against the port's bf16 step on those cells, and is timed by CUDA
events on one fixed state; ptxas gives each form's registers and spills.
A measurement of the width, never a build the port uses.

    python3 probes/quad_cells.py       # needs a card and nvcc

Prints the card's name and power limit, then one JSON object.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include "d3q19.cuh"

// W cells (x, y, W g .. W g + W - 1) a thread, BGK without a force, over
// the groups whose byte in `inner` is set; W / 2 packed words a direction.
template <int W>
__global__ void __launch_bounds__(256, 3)
group_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
             const uint8_t* __restrict__ inner, int nx, int ny, int nz,
             float tau, float ytau, unsigned* __restrict__ out_of_range) {
  constexpr int K = W / 2;
  const int ng = nz / W;
  const int g = blockIdx.x * 32 + threadIdx.x % 32;
  const int y = blockIdx.y * 8 + threadIdx.x / 32;
  const int x = blockIdx.z;
  if (g >= ng || y >= ny || !inner[(x * ny + y) * ng + g]) return;
  const unsigned n = (unsigned)nx * ny * nz;
  const int z0 = W * g;
  uint32_t pk[Q][K];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int xs = wrap(x - EX(i), nx);
    const int ys = wrap(y - EY(i), ny);
    const uint32_t* q =
        src + ((i * n + ((unsigned)xs * ny + ys) * nz + z0) >> 1);
    uint32_t w[K + 2];  // the words before, of and after the group
    if (EZ(i) > 0) w[0] = q[-1];
    if constexpr (K == 2) {  // one 8-byte load
      const uint2 v = *reinterpret_cast<const uint2*>(q);
      w[1] = v.x;
      w[2] = v.y;
    } else {
      w[1] = q[0];
    }
    if (EZ(i) < 0) w[K + 1] = q[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pk[i][k] = EZ(i) == 0  ? w[k + 1]
                 : EZ(i) > 0 ? __byte_perm(w[k], w[k + 1], 0x5432u)
                             : __byte_perm(w[k + 1], w[k + 2], 0x5432u);
    }
  }
  auto pop = [&](int i, int h) {
    const uint32_t v = pk[i][h / 2];
    return __uint_as_float(h % 2 ? (v & 0xffff0000u) : (v << 16));
  };
  DivRange range;
  float rho[W], ux[W], uy[W], uz[W], usq[W];
#pragma unroll
  for (int h = 0; h < W; ++h) {
    float rh = pop(0, h);
#pragma unroll
    for (int i = 1; i < Q; ++i) rh += pop(i, h);
    float mx = 0.0f, my = 0.0f, mz = 0.0f;
#pragma unroll
    for (int i = 1; i < Q; ++i) {
      const float v = pop(i, h);
      if (EX(i) > 0) mx += v;
      if (EX(i) < 0) mx -= v;
      if (EY(i) > 0) my += v;
      if (EY(i) < 0) my -= v;
      if (EZ(i) > 0) mz += v;
      if (EZ(i) < 0) mz -= v;
    }
    const float safe = rh == 0.0f ? 1.0f : rh;
    const float yr = __frcp_rn(safe);
    range.add(mx);
    range.add(my);
    range.add(mz);
    rho[h] = rh;
    ux[h] = div_core(mx, safe, yr);
    uy[h] = div_core(my, safe, yr);
    uz[h] = div_core(mz, safe, yr);
    usq[h] = ux[h] * ux[h] + uy[h] * uy[h] + uz[h] * uz[h];
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    uint32_t bits[K] = {};
#pragma unroll
    for (int h = 0; h < W; ++h) {
      const float p = pop(i, h);
      const float a = p - rho[h] * phi_i(i, ux[h], uy[h], uz[h], usq[h]);
      range.add(a);
      bits[h / 2] |= bf16_bits(p - div_core(a, tau, ytau)) << (16 * (h % 2));
    }
    uint32_t* d = dst + ((i * n + ((unsigned)x * ny + y) * nz + z0) >> 1);
    if constexpr (K == 2) {
      *reinterpret_cast<uint2*>(d) = make_uint2(bits[0], bits[1]);
    } else {
      d[0] = bits[0];
    }
  }
  if (!range.in()) atomicAdd(out_of_range, 1u);
}

extern "C" int run(int w, const void* src, void* dst, const void* inner,
                   int nx, int ny, int nz, float tau, float ytau,
                   unsigned* oor, void* stream) {
  const int ng = nz / w;
  const dim3 grid((ng + 31) / 32, (ny + 7) / 8, nx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto S = static_cast<const uint32_t*>(src);
  auto D = static_cast<uint32_t*>(dst);
  auto I = static_cast<const uint8_t*>(inner);
  if (w == 2) {
    group_kernel<2><<<grid, 256, 0, s>>>(S, D, I, nx, ny, nz, tau, ytau, oor);
  } else {
    group_kernel<4><<<grid, 256, 0, s>>>(S, D, I, nx, ny, nz, tau, ytau, oor);
  }
  return (int)cudaGetLastError();
}
"""


def groups(mask, lid_y: int, w: int):
    """Per group of w z cells: every cell FLUID, no WALL/MOVING source,
    not at a z end of its row, off the lid's consumer plane."""
    import numpy as np

    from lbm_tpu_torch.core.lattice import D3Q19
    from lbm_tpu_torch.geometry.mask import CellType

    stop = (mask == CellType.WALL) | (mask == CellType.MOVING)
    ok = mask == CellType.FLUID
    for i in range(1, D3Q19.Q):
        ok &= ~np.roll(stop, tuple(int(v) for v in D3Q19.E[i]), (0, 1, 2))
    nx, ny, nz = mask.shape
    g = ok.reshape(nx, ny, nz // w, w).all(axis=3)
    g[..., 0] = g[..., -1] = False
    g[:, lid_y] = False
    return g


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("quad_cells: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tmp = tempfile.mkdtemp(prefix="quad_cells_")
    src = os.path.join(tmp, "quad.cu")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    so = os.path.join(tmp, "libquad.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", so, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    ptxas, cur = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?\S*group_kernelILi(\d)E", line)
        if m:
            cur = f"W={m.group(1)}"
            ptxas.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            ptxas[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            ptxas[cur]["registers"] = int(m.group(1))
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.run.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_float, ctypes.c_float, vp, vp]
    lib.run.restype = ctypes.c_int
    device = torch.device("cuda", 0)
    spec = get_case("lid_driven_cavity", n=256)
    sim = Simulation(spec, device=device, store_dtype="bf16")
    sim.run(max_steps=1000, time_save=1000, verbose=False)
    f = sim.f
    series = torch.zeros(1, dtype=torch.float64, device=device)
    ref = K.collide_stream(f, f.clone(), sim.cc, series, 0, sim.t)
    tau = float(np.float32(sim.cc.tau))
    ytau = float(np.float32(1.0) / np.float32(tau))
    mask = np.asarray(spec.mask)
    lid_y = [bc.consumer_coord for bc in sim.cc.bcs if bc.axis == 1][0]
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {"card": smi, "ptxas": ptxas}
    for w in (2, 4):
        inner = groups(mask, lid_y, w)
        inner_t = torch.from_numpy(inner.astype(np.uint8).reshape(-1)).to(
            device)
        dst = f.clone()
        oor = torch.zeros(1, dtype=torch.int32, device=device)

        def go():
            err = lib.run(w, f.data_ptr(), dst.data_ptr(), inner_t.data_ptr(),
                          *spec.shape, tau, ytau, oor.data_ptr(), stream)
            assert err == 0, err

        go()
        torch.cuda.synchronize()
        cells = torch.from_numpy(np.repeat(inner, w, axis=2)).to(device)
        equal = bool(torch.equal(dst[:, cells], ref[:, cells]))
        ms = C.time_ms(go, 500)
        n_cells = int(cells.sum())
        out[f"W={w}"] = {"cells": n_cells, "ms": round(ms, 5),
                         "ns_per_cell": round(ms * 1e6 / n_cells, 5),
                         "bit_equal_to_the_port": equal,
                         "out_of_range_groups": int(oor.item())}
        print(f"W={w}", json.dumps(out[f"W={w}"]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
