"""Host-side simulation loop (torch port of lbm_tpu/engine/runner.py):
chunked stepping, convergence policy, throughput metering.

  - the hot loop advances `time_save` steps per chunk; the per-step
    velsum samples stay on the device in an (n,) float64 buffer that is
    read back once per chunk (the counterpart of lbm_tpu's scan output);
  - flavor 'velsum': per-step residual |s_k - s_{k-1}| / s_k with
    s = sum |u| (+ the non-fluid offset); the run stops once more than
    `stag_max` sub-tolerance steps were counted (the count is never
    reset, as in lbm_tpu);
  - flavor 'usq': windowed residual between consecutive chunks of
    sum u^2 over interior fluid cells;
  - MLUPS in three site conventions (RunResult).

backend='kernel' (default) steps with the CUDA kernels on a CUDA device
and their plain versions on the CPU; backend='dense' runs the dense
PyTorch step (engine/step.py), the counterpart of lbm_tpu's 'xla'.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from lbm_tpu_torch.engine.compile import canonical_device, compile_case
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import (
    fluid_speed_sum,
    init_override,
    initial_f,
    macro_fields,
    make_step,
)
from lbm_tpu_torch.kernels import collide_stream as kernels


@dataclasses.dataclass
class RunResult:
    """mlups counts non-DEAD sites (the reference's NLATTICE convention),
    mlups_live fluid cells only, mlups_box the full box (the dense
    cavity's raw-grid throughput). velsum_series holds this run's
    per-step velsum samples (offset included) for the 'velsum' flavor."""

    steps: int
    residual: float
    residual_history: list
    elapsed_s: float
    mlups: float
    converged: bool
    mlups_live: float = 0.0
    mlups_box: float = 0.0
    velsum_series: Optional[np.ndarray] = None


def _interior_region(shape):
    nx, ny, nz = shape
    return (slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1))


def resolve_device(device) -> torch.device:
    """The canonical torch.device, refusing CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return canonical_device(device)


class Simulation:
    """One case on one device.

    The state `f` is (19, nx, ny, nz) float32, z contiguous — the layout
    of lbm_tpu's dense backend and of the portable checkpoint. The kernel
    backend keeps a second buffer of the same shape and swaps the two
    each step.
    """

    def __init__(self, spec: CaseSpec, device="cuda", backend: str = "kernel"):
        if backend not in ("kernel", "dense"):
            raise ValueError(f"backend must be 'kernel' or 'dense': {backend!r}")
        self.device = resolve_device(device)
        self.backend = backend
        self.spec = spec
        self.cc = compile_case(spec, self.device)
        self._step = make_step(self.cc) if backend == "dense" else None
        self._usq_fn: Optional[Callable] = None
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self):
        self.f = initial_f(self.cc)
        self._spare = (torch.empty_like(self.f) if self.backend == "kernel"
                       else None)
        self.t = 0
        self._last_velsum: Optional[float] = None
        self._last_usq: Optional[float] = None

    def f_standard(self):
        """f in the portable (19, nx, ny, nz) layout."""
        return self.f

    def set_f_standard(self, f):
        """Load a (19, nx, ny, nz) state (array or tensor); the simulation
        keeps its own copy, since stepping writes into its buffers."""
        f = torch.as_tensor(f, dtype=torch.float32)
        if tuple(f.shape) != (19,) + tuple(self.spec.shape):
            raise ValueError(f"state shape {tuple(f.shape)} != "
                             f"(19, *{tuple(self.spec.shape)})")
        self.f = f.to(self.device, copy=True).contiguous()

    def macro(self):
        """(rho, u) persistent macroscopic fields (lattice units): moments
        at fluid cells, the init values elsewhere."""
        if self.backend == "dense":
            return macro_fields(self.cc, self.f)
        rho, u = kernels.macro(self.f)
        return init_override(self.cc, rho, u)

    # -- stepping ---------------------------------------------------------
    def _advance(self, n: int) -> np.ndarray:
        """n steps; returns the n velsum samples (offset included) with one
        device-to-host read."""
        series = torch.empty(n, dtype=torch.float64, device=self.device)
        for k in range(n):
            if self.backend == "kernel":
                kernels.collide_stream(self.f, self._spare, self.cc, series, k)
                self.f, self._spare = self._spare, self.f
            else:
                self.f, _, u = self._step(self.f)
                series[k] = fluid_speed_sum(self.cc, u)
        self.t += n
        return series.cpu().numpy() + self.cc.velsum_offset

    def _usq_value(self) -> float:
        """The 'usq' residual sample: sum of u^2 over interior fluid cells
        (plus static outlet-label cells when the spec counts them)."""
        if self._usq_fn is None:
            spec = self.spec
            region = _interior_region(spec.shape)
            mask_r = np.asarray(spec.mask)[region]
            fluid_r = torch.from_numpy(mask_r == 4).to(self.device)
            offset = 0.0
            if spec.usq_includes_outlet_labels:
                u0_r = np.asarray(spec.u0)[(slice(None),) + region]
                offset = float(np.sum(np.sum(u0_r**2, axis=0)[mask_r > 4],
                                      dtype=np.float64))

            def usq(u):
                ur = u[(slice(None),) + region]
                usq_f = ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2]
                return float(torch.where(fluid_r, usq_f, 0.0).sum(
                    dtype=torch.float64)) + offset

            self._usq_fn = usq
        return self._usq_fn(self.macro()[1])

    # -- main loop ----------------------------------------------------------
    def run(
        self,
        max_steps: Optional[int] = None,
        time_save: Optional[int] = None,
        tol: Optional[float] = None,
        stag_max: Optional[int] = None,
        on_save: Optional[Callable] = None,
        verbose: bool = True,
    ) -> RunResult:
        spec = self.spec
        max_steps = spec.max_steps if max_steps is None else max_steps
        time_save = spec.time_save if time_save is None else time_save
        tol = spec.tol if tol is None else tol
        stag_max = spec.stag_max if stag_max is None else stag_max
        flavor = spec.residual_flavor

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_start = time.perf_counter()
        tol_count = 0
        residual = float("inf")
        history: list[float] = []
        samples: list[np.ndarray] = []
        converged = False
        steps_done_at_start = self.t

        while self.t < steps_done_at_start + max_steps:
            n = min(time_save, steps_done_at_start + max_steps - self.t)
            s_series = self._advance(n)
            if flavor == "velsum":
                samples.append(s_series)
                prev = self._last_velsum
                for s in s_series:
                    if prev is not None and s != 0:
                        r = abs(s - prev) / s
                        if r <= tol:
                            tol_count += 1
                        residual = float(r)
                    prev = float(s)
                self._last_velsum = prev
            else:  # 'usq'
                s = self._usq_value()
                if self._last_usq is not None and s != 0:
                    residual = abs(self._last_usq - s) / s
                self._last_usq = s

            history.append(residual)
            elapsed = time.perf_counter() - t_start
            if verbose:
                print(
                    f"ITERATION # {self.t}, collapse time: "
                    f"{elapsed*1e3:.1f} ms, residual: {residual:.3e}"
                )
            if on_save is not None:
                on_save(self, self.t, residual)
            if flavor == "velsum" and tol_count > stag_max:
                converged = True
                break

        elapsed = time.perf_counter() - t_start
        steps = self.t - steps_done_at_start
        rate = steps / max(elapsed, 1e-12) / 1e6
        mask = np.asarray(spec.mask)
        return RunResult(
            steps=steps,
            residual=residual,
            residual_history=history,
            elapsed_s=elapsed,
            mlups=int((mask != 0).sum()) * rate,
            converged=converged,
            mlups_live=int((mask == 4).sum()) * rate,
            mlups_box=int(np.prod(spec.shape)) * rate,
            velsum_series=(np.concatenate(samples) if samples else None),
        )


__all__ = ["Simulation", "RunResult", "resolve_device"]
