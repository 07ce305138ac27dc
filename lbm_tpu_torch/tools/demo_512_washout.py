"""A contrast washout on the 512^3 coronary tree (the port of lbm_tpu's
tools/demo_512_washout.py): --flow-steps of flow on the kernel route (the
list K1 over the fluid cells), macro()'s u frozen on the device and the
flow state freed, then the D3Q7 transport K7 over the scalar's cell list
(engine/scalar.ScalarTransport(backend='kernel'), lbm_tpu's
ScalarTransportPallas) through a recorded washout: a bolus of --bolus
steps at the inlet, every boundary recorded (the record kernel over the
footprints' lists), in --chunk-step chunks after a warm-up chunk.

div_fix=False, as lbm_tpu's: the divergence compensation corrects a ~3%
saturation overshoot that does not matter to a transit-time demo.
Memory at 512^3: the flow's two 10.2 GB buffers, then u (1.6 GB) and
the scalar's two (8, X, Y, Z) buffers (4.3 GB each).

Usage: python -m lbm_tpu_torch.tools.demo_512_washout [--n 512]
         [--flow-steps 2000] [--steps 3000] [--bolus 800] [--chunk 500]
         [--device cuda]
Smoke: --n 36 --flow-steps 40 --steps 60 --bolus 20 --chunk 20 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from lbm_tpu_torch.tools import coronary_cube, device_label, sync


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--flow-steps", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--bolus", type=int, default=800)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    return ap.parse_args(argv)


def run_flow(sim, steps: int):
    """steps of flow in runner chunks of at most 1000 (lbm_tpu's)."""
    return sim.run(max_steps=steps, time_save=min(1000, steps),
                   verbose=False)


def transport(spec, u, bolus: int, device):
    """ScalarTransport on the frozen u: D = 0.02, c = 1 at boundary 0 for
    the first `bolus` steps, div_fix off, the kernel route (K7)."""
    from lbm_tpu_torch.engine.scalar import ScalarTransport
    from lbm_tpu_torch.parallel.launch import Gate

    return ScalarTransport(spec, u, D=0.02, inlet_c={0: Gate(bolus)},
                           div_fix=False, device=device, backend="kernel")


def washout(st, steps: int, chunk: int, rec: list):
    """A warm-up chunk, then the rest in `chunk`-step chunks, every
    boundary in `rec` recorded: (the warm-up's series, the timed series,
    the timed steps, their seconds)."""
    first = min(chunk, steps)
    warm = st.run(first, record=rec)
    sync(st.g.device)
    series = []
    left = steps - first
    t0 = time.perf_counter()
    while left > 0:
        m = min(chunk, left)
        series.append(st.run(m, record=rec))
        left -= m
    sync(st.g.device)
    elapsed = time.perf_counter() - t0
    timed = (np.concatenate(series, axis=0) if series
             else np.zeros((0, len(rec))))
    return warm, timed, steps - first, elapsed


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.n
    print(f"device: {device_label(args.device)}; coronary {n}^3 radius="
          f"{max(6, n // 36)}; flow on the kernel route, then K7",
          flush=True)
    from lbm_tpu_torch.engine.runner import Simulation

    spec = coronary_cube(n)
    ncell = n ** 3

    t0 = time.perf_counter()
    sim = Simulation(spec, device=args.device, backend="kernel")
    res = run_flow(sim, args.flow_steps)
    print(f"flow: {args.flow_steps} steps (backend={sim.backend}, "
          f"lowmem={sim.lowmem}) in {time.perf_counter() - t0:.0f}s, "
          f"{res.elapsed_s / max(res.steps, 1) * 1e3:.4f} ms/step",
          flush=True)
    flow_ms = res.elapsed_s / max(res.steps, 1) * 1e3

    t0 = time.perf_counter()
    u = sim.macro()[1]
    sync(u.device)
    print(f"macro freeze: {u.nbytes / 1e9:.1f} GB on {u.device} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    del sim  # the flow state goes before the transport's buffers come

    t0 = time.perf_counter()
    st = transport(spec, u, args.bolus, args.device)
    del u
    listed = ncell if st.sc.cells is None else st.sc.cells.numel()
    print(f"transport build: {time.perf_counter() - t0:.0f}s (cells listed "
          f"{listed}, fluid {int(st.fluid.sum())})", flush=True)

    rec = list(range(len(spec.boundaries)))
    _, series, nst, dt = washout(st, args.steps, args.chunk, rec)
    print(f"washout: {nst} steps in {dt:.1f}s = "
          f"{dt / max(nst, 1) * 1e3:.2f} ms/step "
          f"({ncell * nst / max(dt, 1e-12) / 1e6:.0f} MLUPS box-convention "
          "transport)", flush=True)
    peaks = [float(series[:, k].max()) for k in rec] if len(series) else []
    print("series peaks: " + " ".join(f"bc{k}={p:.3f}"
                                      for k, p in zip(rec, peaks)),
          flush=True)
    tot = st.total()
    print(f"scalar total: {tot:.2f}", flush=True)
    if not np.isfinite(tot):
        raise RuntimeError(f"scalar total {tot}")
    print("OK", flush=True)
    return {"flow_ms": flow_ms, "ms_step": dt / max(nst, 1) * 1e3,
            "peaks": peaks, "total": tot, "steps": nst}


if __name__ == "__main__":
    main()
