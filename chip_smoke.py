#!/usr/bin/env python3
"""Smoke test of lbm_tpu_torch on one NVIDIA GPU (H100 class, sm_90a).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints
no result line):
  1. a CUDA card is present; print its name and power limit, nvcc's
     version and torch's;
  2. build the CUDA kernels from kernels/csrc with nvcc and print the
     build time and ptxas's register report;
  3. hold each kernel against its plain PyTorch version on the card:
     lid cavity 64^3 and poiseuille 32^3 (f after 4 steps at rtol 3e-6,
     atol 1e-7, velsum at 1e-5 relative, macro() after 200 steps at
     relative L2 <= 1e-5, K3 at rtol 1e-6, atol 1e-7), then lid 256^3
     for 2 steps; time kernel and plain versions in turns with CUDA
     events;
  4. the main path: Simulation(lid_driven_cavity n=256).run(1000 steps,
     time_save=250) and macro(), with every launch counter reset just
     before and read just after (K1a must launch 1000 times, K3 at
     least once) and finite, bounded fields;
  5. the CLI: `python -m lbm_tpu_torch run` on the 64^3 cavity for 500
     steps writes VTK and CONVERGENCE.log.
Before the last line it prints one JSON object describing each kernel;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K1A_SOURCE = "lbm_tpu_torch/kernels/csrc/collide_stream.cu"


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls, by CUDA events, after
    iters // 5 warm-up calls."""
    import torch

    for _ in range(max(3, iters // 5)):
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


def rel_l2(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def check_close(name, got, ref, rtol, atol) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| everywhere; returns
    the max abs error."""
    import torch

    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    n_bad = int(bad.sum())
    require(n_bad == 0 and bool(torch.isfinite(got).all()),
            f"{name}: {n_bad} elements outside rtol={rtol} atol={atol} "
            f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def compare_case(case, steps, device, errs, macro_steps=None):
    """Kernel vs plain on one case: f and velsum after `steps` steps, K3 on
    the result, and optionally macro() after `macro_steps` steps."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    name, kw = case
    spec = get_case(name, **kw)
    cc = compile_case(spec, device)
    f0 = initial_f(cc)
    fk, buf = f0.clone(), torch.empty_like(f0)
    vs_k = torch.zeros(steps, dtype=torch.float64, device=device)
    fp = f0
    vs_p = torch.zeros(steps, dtype=torch.float64, device=device)
    for t in range(steps):
        K.collide_stream(fk, buf, cc, vs_k, t)
        fk, buf = buf, fk
        fp, vs = K.collide_stream_plain(fp, cc)
        vs_p[t] = vs
    torch.cuda.synchronize()
    tag = f"{name} {tuple(spec.shape)}"
    e_f = check_close(f"K1a f after {steps} steps, {tag}", fk, fp, 3e-6, 1e-7)
    vs_rel = float(((vs_k - vs_p).abs() / vs_p.abs()).max())
    require(vs_rel <= 1e-5, f"K1a velsum {tag}: rel err {vs_rel:.3e} > 1e-5")
    rho_k, u_k = K.macro(fk)
    rho_p, u_p = K.macro_plain(fk)
    e_m = max(check_close(f"K3 rho {tag}", rho_k, rho_p, 1e-6, 1e-7),
              check_close(f"K3 u {tag}", u_k, u_p, 1e-6, 1e-7))
    errs["K1a"] = max(errs["K1a"], e_f)
    errs["K3"] = max(errs["K3"], e_m)
    print(f"[3] {tag}: K1a f max abs err {e_f:.3e} after {steps} steps, "
          f"velsum max rel err {vs_rel:.3e}; K3 max abs err {e_m:.3e}",
          flush=True)
    if macro_steps:
        sk = Simulation(spec, device=device, backend="kernel")
        sp = Simulation(spec, device=device, backend="dense")
        rk = sk.run(max_steps=macro_steps, time_save=macro_steps,
                    verbose=False)
        rp = sp.run(max_steps=macro_steps, time_save=macro_steps,
                    verbose=False)
        (rho_k, u_k), (rho_p, u_p) = sk.macro(), sp.macro()
        e_rho, e_u = rel_l2(rho_k, rho_p), rel_l2(u_k, u_p)
        require(e_rho <= 1e-5 and e_u <= 1e-5,
                f"macro() after {macro_steps} steps {tag}: rel L2 rho "
                f"{e_rho:.3e}, u {e_u:.3e} > 1e-5")
        vs_rel = float((abs(rk.velsum_series - rp.velsum_series)
                        / abs(rp.velsum_series)).max())
        require(vs_rel <= 1e-5,
                f"velsum series over {macro_steps} steps {tag}: rel err "
                f"{vs_rel:.3e} > 1e-5")
        print(f"[3] {tag}: macro() after {macro_steps} steps rel L2 rho "
              f"{e_rho:.3e} u {e_u:.3e}; velsum series max rel err "
              f"{vs_rel:.3e}", flush=True)


def time_kernels(n, device, iters_k, iters_p):
    """(K1a ms, plain ms, K3 ms, plain ms) per call at lid n^3, in turns
    plain, kernel, kernel, plain."""
    import torch

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.compile import compile_case
    from lbm_tpu_torch.engine.step import initial_f
    from lbm_tpu_torch.kernels import collide_stream as K

    cc = compile_case(get_case("lid_driven_cavity", n=n), device)
    state = [initial_f(cc), None]
    state[1] = torch.empty_like(state[0])
    series = torch.zeros(1, dtype=torch.float64, device=device)
    plain_f = [initial_f(cc)]

    def k1a():
        K.collide_stream(state[0], state[1], cc, series, 0)
        state.reverse()

    def k1a_plain():
        plain_f[0] = K.collide_stream_plain(plain_f[0], cc)[0]

    f = state[0]
    out = {}
    for label, fn, iters in (("p1", k1a_plain, iters_p), ("k1", k1a, iters_k),
                             ("k2", k1a, iters_k), ("p2", k1a_plain, iters_p),
                             ("m_p1", lambda: K.macro_plain(f), iters_p),
                             ("m_k1", lambda: K.macro(f), iters_k),
                             ("m_k2", lambda: K.macro(f), iters_k),
                             ("m_p2", lambda: K.macro_plain(f), iters_p)):
        out[label] = time_ms(fn, iters)
    print(f"[3] timing lid {n}^3 (ms per call, turns plain/kernel/kernel/"
          f"plain): K1a {out['p1']:.4f} {out['k1']:.4f} {out['k2']:.4f} "
          f"{out['p2']:.4f}; K3 {out['m_p1']:.4f} {out['m_k1']:.4f} "
          f"{out['m_k2']:.4f} {out['m_p2']:.4f}", flush=True)
    return ((out["k1"] + out["k2"]) / 2, (out["p1"] + out["p2"]) / 2,
            (out["m_k1"] + out["m_k2"]) / 2, (out["m_p1"] + out["m_p2"]) / 2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)

    # -- phase 1: card and toolchain ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from lbm_tpu_torch.kernels import _build
    from lbm_tpu_torch.kernels import collide_stream as K

    nvcc = _build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    print(f"[1] {torch.cuda.get_device_name(0)}; nvcc {nvcc}: "
          f"{nvcc_version}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); python {sys.version.split()[0]}",
          flush=True)

    # -- phase 2: build ----------------------------------------------------
    lib = _build.load_library()
    print(f"[2] kernels {'built' if lib.built else 'found'} at "
          f"{os.path.relpath(lib.path, ROOT)} in {lib.build_seconds:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[2] ptxas: {line.strip()}", flush=True)

    # -- phase 3: kernels vs plain versions --------------------------------
    errs = {"K1a": 0.0, "K3": 0.0}
    compare_case(("lid_driven_cavity", dict(n=64)), 4, device, errs,
                 macro_steps=200)
    compare_case(("poiseuille", dict(n=32)), 4, device, errs,
                 macro_steps=200)
    compare_case(("lid_driven_cavity", dict(n=256)), 2, device, errs)
    t64 = time_kernels(64, device, iters_k=2000, iters_p=100)
    t256 = time_kernels(256, device, iters_k=1000, iters_p=20)

    # -- phase 4: the main path --------------------------------------------
    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation

    spec = get_case("lid_driven_cavity", n=256)
    sim = Simulation(spec, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    res = sim.run(max_steps=1000, time_save=250, verbose=False)
    rho, u = sim.macro()
    torch.cuda.synchronize()
    counts = dict(K.launches)
    require(counts["lbm_collide_stream_bgk"] == 1000,
            f"K1a launched {counts['lbm_collide_stream_bgk']} times in a "
            "1000-step run")
    require(counts["lbm_macro"] >= 1, "macro() did not launch K3")
    require(res.steps == 1000 and not res.converged,
            f"run took {res.steps} steps (converged={res.converged})")
    require(tuple(rho.shape) == (256,) * 3 and tuple(u.shape) == (3,) + (256,) * 3,
            "macro() shapes")
    require(bool(torch.isfinite(rho).all() and torch.isfinite(u).all()),
            "non-finite fields after 1000 steps")
    u_lid = 0.15 / 2.4705
    fluid = sim.cc.fluid
    u_max = float(u.norm(dim=0)[fluid].max())
    rho_dev = float((rho[fluid] - 1.0).abs().max())
    # sanity bounds of a lid-driven spin-up (the exactness check is phase 3)
    require(u_max <= 2.0 * u_lid and rho_dev < 0.2,
            f"fields out of physical range: max|u| {u_max:.4g} (lid "
            f"{u_lid:.4g}), max|rho-1| {rho_dev:.3g}")
    vs = res.velsum_series
    require(len(vs) == 1000 and bool((vs > 0).all()) and vs[-1] > vs[0],
            "velsum series is not the spin-up of a driven cavity")
    ms_step = res.elapsed_s / res.steps * 1e3
    print(f"[4] main path lid 256^3: {res.steps} steps in "
          f"{res.elapsed_s:.3f} s = {ms_step:.4f} ms/step (host clock, "
          f"synchronized), mlups_box {res.mlups_box:.1f}, mlups "
          f"{res.mlups:.1f}, mlups_live {res.mlups_live:.1f}; residual "
          f"{res.residual:.3e}; max|u| {u_max:.4g}, max|rho-1| "
          f"{rho_dev:.3g}; peak device memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; "
          f"launches {counts}", flush=True)

    # -- phase 5: the CLI --------------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lbm_tpu_torch", "run", "--case",
             "lid_driven_cavity", "--opt", "n=64", "--steps", "500",
             "--out", tmp],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        require(proc.returncode == 0,
                f"CLI run failed ({proc.returncode}):\n{proc.stdout}\n"
                f"{proc.stderr}")
        files = sorted(os.listdir(tmp))
        require("CONVERGENCE.log" in files
                and "lid_driven_cavity_500.vtk" in files,
                f"CLI outputs missing: {files}")
        last = proc.stdout.strip().splitlines()[-2:]
        print(f"[5] CLI run in {time.perf_counter() - t0:.1f} s wrote "
              f"{files}; {' | '.join(last)}", flush=True)

    kernels = [
        {"name": "lbm_collide_stream_bgk", "route": "cuda",
         "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:1333",
         "launches": counts["lbm_collide_stream_bgk"],
         "max_abs_err": errs["K1a"], "ms": t256[0], "plain_ms": t256[1]},
        {"name": "lbm_macro", "route": "cuda", "source": K1A_SOURCE,
         "replaces": "lbm_tpu/kernels/collide_stream.py:2470",
         "launches": counts["lbm_macro"],
         "max_abs_err": errs["K3"], "ms": t256[2], "plain_ms": t256[3]},
    ]
    print(f"[done] ms at 64^3: K1a {t64[0]:.4f} plain {t64[1]:.4f}, K3 "
          f"{t64[2]:.4f} plain {t64[3]:.4f}; total "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
