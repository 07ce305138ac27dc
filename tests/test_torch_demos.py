"""The port's demos (lbm_tpu_torch/tools/) run to their end on the CPU at
tiny shapes and few steps (--device cpu: the kernels' plain versions),
each in a process of its own with a timeout, and print their result
lines. demo_adjoint's own assertion (the converged split within 0.03 of
the target) needs its default horizon (600-step rollouts, 12 iterations,
4000 verification steps), which the card runs: here its fit and verify
stages run as functions at a tiny size."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lbm_tpu_torch.tools import demo_adjoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """The boxes are tiny: torch's intra-op threads would only contend with
    the other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DEMOS = {
    "demo_washout": (["--shape", "48,24,40", "--radius", "5",
                      "--flow-steps", "150", "--bolus", "150", "--steps",
                      "800", "--D", "0.08"],
                     ["outlet 4: arrival", "age: 800 steps", "OK"]),
    "demo_thermal": (["--n", "10", "--steps", "20", "--chunks", "2"],
                     ["Nu = ", "ms per coupled flow+temperature step"]),
    "demo_thermal_3d": (["--case", "cavity", "--n", "12", "--ra", "1e3",
                         "--steps", "50", "--chunks", "2"],
                        ["chunk 1:", "benchmark: Tric cubical cavity", "OK"]),
    "demo_blood_wss": (["--shape", "24,20,32", "--radius", "4", "--steps",
                        "2"],
                       ["rheology=carreau_blood", "run: 2 steps", "wss: "]),
    "demo_clinical_washout": (["--shape", "24,20,32", "--radius", "4",
                               "--spinup", "2", "--steps", "4", "--bolus",
                               "2", "--chunk", "2"],
                              ["washout: 4 steps", "windkessel P_c",
                               "scalar total", "OK"]),
    "ffr_sweep": (["--shape", "24,20,32", "--radius", "4", "--sev", "0,0.4",
                   "--hyper", "2", "--steps", "40"],
                  [" 0.40 ", "OK"]),
}


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_runs_to_its_end_on_the_cpu(name):
    args, lines = DEMOS[name]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"lbm_tpu_torch.tools.{name}", "--device",
         "cpu", *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.startswith("device: cpu")
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout[-2000:])


def test_demo_adjoint_stages(capsys):
    """demo_adjoint's fit (two adjoint iterations of 10-step rollouts)
    and verify (a Simulation on the fitted terminations) stages on the
    small coronary: the fit's history and theta, a split of the four
    outlets that sums to 1, and the stages' result lines."""
    args = demo_adjoint.parse_args(
        ["--device", "cpu", "--shape", "24,20,32", "--radius", "4",
         "--steps", "10", "--iters", "2", "--chunk", "5",
         "--verify-steps", "4"])
    assert isinstance(args, argparse.Namespace)
    shape = (24, 20, 32)
    target = np.asarray([0.40, 0.27, 0.20, 0.13], np.float32)
    theta, hist = demo_adjoint.fit_stage(args, shape, target)
    assert theta.shape == (4, 3) and np.isfinite(theta).all()
    assert len(hist) == 2 and all(np.isfinite(h[0]) for h in hist)
    np.testing.assert_array_equal(theta[:, :2],
                                  np.asarray(demo_adjoint.WK0,
                                             np.float32)[:, :2])
    split = demo_adjoint.verify_stage(args, shape, theta)
    assert split.shape == (4,) and abs(split.sum() - 1.0) < 1e-6
    out = capsys.readouterr().out
    for line in ("iter   1 loss", "fit: 2 adjoint iterations", "fitted Rd:",
                 "verify: kernel Simulation, 4 steps", "converged split:"):
        assert line in out, (line, out)
