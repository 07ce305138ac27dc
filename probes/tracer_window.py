#!/usr/bin/env python3
"""Where torch.profiler's window loses kernel launches, on the card.

Each window profiles one run of 200 steps that launches two small kernels
a step (a.add_(1), b.add_(a): host-bound, as the coronary paths are),
torch.add in the first 100 steps and torch.mul in the last 100, so a loss
at the window's start shows as missing adds and one at its end as
missing muls. With --vessel, also the full pulsatile coronary's vessel
path (Simulation.run of 200 steps: the list kernel and its velsum
reduction a step). Four window forms, WINDOWS windows each:

  lead        profile(); 0.2 s asleep; the run; synchronize
  warmup      a schedule with a warm-up cycle (20 launches), 0.1 s
              asleep after the cycle's step; the run; synchronize
  warmup+tail the same, then 0.1 s asleep before the window's step
  lead+tail   lead, then 0.1 s asleep before the context ends

    python3 probes/tracer_window.py [--vessel] [--windows N]

--vessel builds the box and list units (kernels/_build) if they are not
built.
Prints the card's name and power limit, a line a form, then one JSON
object: for each form the launches seen over the launches made, by
kernel, in every window.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window(run, form):
    """{kernel name: launches seen} of one window of `form` over run()."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    tail = form.endswith("+tail")
    if form.startswith("lead"):
        with profile(activities=acts) as prof:
            time.sleep(0.2)
            run()
            torch.cuda.synchronize()
            if tail:
                time.sleep(0.1)
        events = prof.key_averages()
    else:
        cycles = []
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: cycles.append(
                         p.key_averages())) as prof:
            warm = torch.zeros(1, device="cuda")
            for _ in range(20):
                warm.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.2)
            prof.step()
            time.sleep(0.1)
            run()
            torch.cuda.synchronize()
            if tail:
                time.sleep(0.1)
            prof.step()
        events = cycles[0] if cycles else []
    return {ev.key: ev.count for ev in events
            if str(ev.device_type).endswith("CUDA")
            and not ev.key.startswith("ProfilerStep")
            and getattr(ev, "device_time_total", 0.0) > 0}


def short(got: dict) -> dict:
    """A window's counts by kernel, the synthetic run's as its first
    half's adds and its second half's muls."""
    out = {}
    for key, n in got.items():
        low = key.lower()
        name = ("add (first half)" if "add" in low
                else "mul (second half)" if "mul" in low
                else "list kernel" if "collide_stream_list" in key
                else "velsum reduction" if "velsum" in key else key[:60])
        out[name] = out.get(name, 0) + n
    return out


def main() -> int:
    args = sys.argv[1:]
    vessel = "--vessel" in args
    n_win = int(args[args.index("--windows") + 1]) if "--windows" in args \
        else 12
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("tracer_window: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    a = torch.zeros(1 << 16, device=device)
    b = torch.zeros(1 << 16, device=device)

    def synthetic():
        for k in range(200):
            if k < 100:
                a.add_(1.0)
                b.add_(a)
            else:
                a.mul_(1.0)
                b.mul_(a)

    runs = {"synthetic": (synthetic, 400)}
    if vessel:
        from lbm_tpu_torch.cases import get_case
        from lbm_tpu_torch.engine.runner import Simulation
        from lbm_tpu_torch.kernels import _build

        # the fp32 units the path launches (the box unit holds K3)
        _build._SOURCES = {k: v for k, v in _build._SOURCES.items()
                           if k in ("collide_stream", "collide_stream_list")}

        sim = Simulation(get_case("coronary", shape=[291, 291, 372],
                                  radius=12, pulsatile=[40, 2000]),
                         device=device)
        sim.run(max_steps=200, time_save=200, tol=-1.0, verbose=False)

        def path():
            sim.run(max_steps=200, time_save=200, tol=-1.0, verbose=False)

        runs["vessel"] = (path, 400)  # the kernel and its reduction
    out = {"card": smi}
    for label, (run, made) in runs.items():
        run()
        for form in ("lead", "warmup", "warmup+tail", "lead+tail"):
            seen = [short(window(run, form)) for _ in range(n_win)]
            total = [sum(w.values()) / made for w in seen]
            out[f"{label} {form}"] = seen
            print(f"{label} {form}: launches seen over made in each window "
                  f"{[round(x, 3) for x in total]}; by kernel {seen}",
                  flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
