#!/usr/bin/env python3
"""ptxas's registers, spills and static shared memory of every kernel
instance in a directory of the port's CUDA sources, built with the port's
nvcc flags (kernels/_build.NVCC_FLAGS; collide_stream_halo.cu once per
halo axis) into a temporary directory, one nvcc process per unit side by
side; with a card, the fused pair's dynamic shared memory, threads and
blocks an SM of each instance (lbm_pair_blocks_per_sm, where the sources
have it). Point it at an older tree's kernels/csrc (unpacked with git
archive) to put that tree's registers beside this one's.

    python3 probes/ptxas_report.py [CSRC_DIR ...]   # needs nvcc

Prints one JSON object per directory: {"csrc": dir, "build_s": {unit:
seconds}, "ptxas": {instance: [registers, spill store bytes, spill load
bytes, static shared memory bytes, stack frame bytes]}, "pair":
{instance: [dynamic shared
memory bytes, threads, blocks an SM]}}, instance names as
chip_smoke.ptxas_report gives them (a halo unit's tagged "halo_x" /
"halo_y", a bf16 unit's "bf16").
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
    import ctypes

    import chip_smoke
    from lbm_tpu_torch.kernels import _build

    jobs = list(units(csrc))
    with tempfile.TemporaryDirectory() as tmp:

        def build(job):
            name, source, extra, _ = job
            so = os.path.join(tmp, f"lib{name}.so")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *extra, "-o", so,
                 source], capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
            return seconds, proc.stdout + proc.stderr, so

        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(build, jobs))
        out = {"csrc": csrc, "build_s": {}, "ptxas": {}, "pair": {}}
        for (name, _, _, tag), (seconds, log, so) in zip(jobs, done):
            out["build_s"][name] = round(seconds, 2)
            smem, stack = {}, {}
            for k, v in chip_smoke.ptxas_report(log, smem, tag=tag,
                                                stack=stack).items():
                out["ptxas"][k] = list(v) + [smem.get(k, 0),
                                             stack.get(k, 0)]
            if name.startswith("collide_stream2") and _card():
                lib = ctypes.CDLL(so)
                if hasattr(lib, "lbm_pair_blocks_per_sm"):
                    lib.lbm_pair_blocks_per_sm.argtypes = [ctypes.c_int]
                    lib.lbm_pair_smem_bytes.restype = ctypes.c_longlong
                    for k, n in chip_smoke.pair_blocks_per_sm(
                            lib, tag).items():
                        out["pair"][k] = [lib.lbm_pair_smem_bytes(),
                                          lib.lbm_pair_block_size(), n]
    return out


def _card() -> bool:
    try:
        import torch
    except ImportError:
        return False
    return torch.cuda.is_available()


if __name__ == "__main__":
    dirs = sys.argv[1:] or [os.path.join(ROOT, "lbm_tpu_torch", "kernels",
                                         "csrc")]
    for d in dirs:
        print(json.dumps(report(d)), flush=True)
