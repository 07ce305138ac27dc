#!/usr/bin/env python3
"""Whether torch.profiler's windows lose kernel launches as a process
opens more profiler sessions or grows older, where in a window the lost
launches sat, and which window form keeps them all, on the card.

A diagnostic window profiles 200 steps of two launches each, in 8
segments of 25 steps that each launch their own elementwise kernel, so
the segments seen tell whether a loss sits at the window's start, its
end or throughout; it also counts the host's cudaLaunchKernel records.
The window is chip_smoke.py's (a warm-up cycle, 0.1 s asleep at either
end of the recorded run). The probe runs:

  fresh     three diagnostic windows in the fresh process;
  sessions  N short sessions (200 launches of one kernel each, as
            chip_smoke.py's device-time readings open them), a
            diagnostic window after every 25;
  age       a diagnostic window every 15 s for S seconds, with matmuls
            keeping the card busy in between;
  forms     three windows each of chip_smoke.py's form, the same with
            64 spin kernels before and after the run inside the
            recorded cycle ("filler"), and one profile() without a
            schedule ("lead+tail").

    python3 probes/tracer_age.py [--sessions N] [--seconds S]

Prints the card's name and power limit, a line a window, then one JSON
object with every window's reading.
"""

import json
import subprocess
import sys
import time


def segment_run(x, y):
    """200 steps, two launches a step: segment i (25 steps) launches its
    own elementwise kernel on x, and every step adds x into y."""
    import torch

    fns = (lambda: x.add_(1.0), lambda: x.mul_(1.0), lambda: x.div_(1.0),
           lambda: x.clamp_min_(0.0), lambda: x.abs_(), lambda: x.neg_(),
           lambda: x.sin_(), lambda: x.cos_())
    for seg in range(8):
        for _ in range(25):
            fns[seg]()
            torch.add(y, x, out=y)


def window(run, form="smoke"):
    """The kernel events (name, start us) of one window over run()."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if form == "lead+tail":
        with profile(activities=acts) as prof:
            time.sleep(0.2)
            run()
            torch.cuda.synchronize()
            time.sleep(0.1)
        return _events(prof.events())
    cycles = []
    filler = form == "filler"
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: cycles.append(p.events())) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(20):
            warm.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.2)
        prof.step()
        time.sleep(0.1)
        if filler:
            for _ in range(64):
                torch.cuda._sleep(1000)
        run()
        if filler:
            for _ in range(64):
                torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
        prof.step()
    return _events(cycles[0] if cycles else [])


def _events(events):
    gpu, launches = [], 0
    for ev in events:
        if str(ev.device_type).endswith("CUDA"):
            if ev.name.startswith("ProfilerStep"):
                continue
            gpu.append((ev.name, ev.time_range.start))
        elif ev.name in ("cudaLaunchKernel", "cuLaunchKernel",
                         "cudaLaunchKernelExC"):
            launches += 1
    gpu.sort(key=lambda e: e[1])
    return gpu, launches


def main() -> int:
    args = sys.argv[1:]
    n_sessions = int(args[args.index("--sessions") + 1]) \
        if "--sessions" in args else 150
    seconds = float(args[args.index("--seconds") + 1]) \
        if "--seconds" in args else 240.0
    import torch

    if not torch.cuda.is_available():
        print("tracer_age: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    x = torch.zeros(1 << 16, device="cuda")
    y = torch.zeros(1 << 16, device="cuda")
    segment_run(x, y)
    torch.cuda.synchronize()
    gpu, _ = window(lambda: segment_run(x, y))
    counts = {}
    for name, _ in gpu:
        counts[name] = counts.get(name, 0) + 1
    y_add = max(counts, key=counts.get)
    names = []
    for name, _ in gpu:
        if name != y_add and name not in names:
            names.append(name)
    print(f"segment kernels in time order: {names}; y's add {y_add}",
          flush=True)
    out = {"card": smi, "windows": []}

    def record(stage, form="smoke"):
        gpu, launches = window(lambda: segment_run(x, y), form)
        segs = [sum(1 for n, _ in gpu if n == name) for name in names]
        adds = sum(1 for n, _ in gpu if n == y_add)
        row = {"stage": stage, "form": form,
               "age_s": round(time.perf_counter() - t0, 1),
               "segments": segs, "y_adds": adds,
               "kernels": len(gpu), "host_launches": launches}
        out["windows"].append(row)
        print(json.dumps(row), flush=True)
        return len(gpu)

    for _ in range(3):
        record("fresh")

    z = torch.zeros(1, device="cuda")
    for s in range(1, n_sessions + 1):
        from torch.profiler import ProfilerActivity, profile, schedule
        cycles = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: cycles.append(
                         p.key_averages())) as prof:
            z.add_(1.0)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(200):
                z.add_(1.0)
            torch.cuda.synchronize()
            prof.step()
        seen = sum(ev.count for ev in (cycles[0] if cycles else [])
                   if str(ev.device_type).endswith("CUDA")
                   and not ev.key.startswith("ProfilerStep"))
        if seen != 200:
            print(f"session {s}: {seen} of 200 kernels seen", flush=True)
        if s % 25 == 0:
            record(f"after {s} sessions")

    a = torch.randn(4096, 4096, device="cuda")
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 15.0:
            for _ in range(20):
                a = torch.tanh(a @ a)
            torch.cuda.synchronize()
        record("age")

    for _ in range(3):
        for form in ("smoke", "filler", "lead+tail"):
            record("forms", form)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
