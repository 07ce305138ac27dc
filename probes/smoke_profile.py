#!/usr/bin/env python3
"""Where chip_smoke.py's time goes, function by function.

    python3 probes/smoke_profile.py [--phase23]

runs chip_smoke.main() (or, with --phase23, phase23_main()) in this
process with each of chip_smoke's module-level functions wrapped by a
wall clock, then prints one JSON object {"smoke_profile": {function:
[inclusive seconds, calls]}} sorted by seconds. Inclusive: a function's
seconds contain those of the wrapped functions it calls. What the script
prints is unchanged; the wrappers cost one perf_counter pair a call.
Functions that spawned ranks run are not wrapped there (the ranks import
chip_smoke afresh). Needs the card, as chip_smoke.py does.
"""

from __future__ import annotations

import collections
import functools
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

STATS: dict = collections.defaultdict(lambda: [0.0, 0])


def _wrap(name, fn):
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            entry = STATS[name]
            entry[0] += time.perf_counter() - t0
            entry[1] += 1

    return timed


def main() -> int:
    skip = {"main", "phase21_main", "phase22_main", "phase23_main",
            "nccl_main"}
    for name, obj in list(vars(chip_smoke).items()):
        if (inspect.isfunction(obj) and obj.__module__ == "chip_smoke"
                and name not in skip):
            setattr(chip_smoke, name, _wrap(name, obj))
    entry = (chip_smoke.phase23_main if sys.argv[1:] == ["--phase23"]
             else chip_smoke.main)
    rc = entry()
    table = dict(sorted(((k, [round(v[0], 2), v[1]])
                         for k, v in STATS.items()),
                        key=lambda kv: -kv[1][0]))
    print(json.dumps({"smoke_profile": table}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
