"""The benchmark's command: one run of one cell, printing one JSON line.

    python3 -m lbm_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (one more chunk under torch.profiler).
Every run checks the program's outputs against the plain reference and
prints each compared number beside its limit, last on standard error
and under "check", the line's last key. --control runs the program in the
cell's lower-precision form, to see the check fail; the benchmark's own
runs never pass it. Exits non-zero, printing no result, without a CUDA
device for the cell, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys

from lbm_bench.harness import forbidden_modules, load_cell, \
    process_start, run_cell


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    chips = load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", control=args.control,
                      started=started)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port must run without JAX",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
