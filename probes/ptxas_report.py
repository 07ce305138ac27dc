#!/usr/bin/env python3
"""ptxas's registers and spills of every kernel instance in a directory
of the port's CUDA sources, built with the port's nvcc flags
(kernels/_build.NVCC_FLAGS; collide_stream_halo.cu once per halo axis)
into a temporary directory, one nvcc process per unit side by side.
Point it at an older tree's kernels/csrc (unpacked with git archive) to
put that tree's registers beside this one's.

    python3 probes/ptxas_report.py [CSRC_DIR ...]   # needs nvcc

Prints one JSON object per directory: {"csrc": dir, "build_s": {unit:
seconds}, "ptxas": {instance: [registers, spill store bytes, spill load
bytes]}}, instance names as chip_smoke.ptxas_report gives them (a halo
unit's tagged "halo_x" / "halo_y").
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def units(csrc: str):
    """(unit name, source, extra flags, tag) of each translation unit."""
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        stem = name[:-3]
        if stem == "collide_stream_halo":
            for axis, tag in ((0, "halo_x"), (1, "halo_y")):
                yield (f"{stem}_{tag[-1]}", os.path.join(csrc, name),
                       (f"-DLBM_HALO_AXIS={axis}",), tag)
        else:
            yield stem, os.path.join(csrc, name), (), (
                "bf16" if stem.endswith("_bf16") else "")


def report(csrc: str) -> dict:
    import chip_smoke
    from lbm_tpu_torch.kernels import _build

    jobs = list(units(csrc))

    def build(job):
        _, source, extra, _ = job
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, "-o",
                 os.path.join(tmp, "lib.so"), source],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        return seconds, proc.stdout + proc.stderr

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(build, jobs))
    out = {"csrc": csrc, "build_s": {}, "ptxas": {}}
    for (name, _, _, tag), (seconds, log) in zip(jobs, done):
        out["build_s"][name] = round(seconds, 2)
        for k, v in chip_smoke.ptxas_report(log, tag=tag).items():
            out["ptxas"][k] = list(v)
    return out


if __name__ == "__main__":
    dirs = sys.argv[1:] or [os.path.join(ROOT, "lbm_tpu_torch", "kernels",
                                         "csrc")]
    for d in dirs:
        print(json.dumps(report(d)), flush=True)
