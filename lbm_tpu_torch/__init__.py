"""lbm_tpu_torch — the D3Q19 BGK lattice-Boltzmann solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `lbm_tpu` (JAX/Pallas). It imports torch and numpy and never
jax, so it runs on a machine without JAX. It mirrors lbm_tpu's layout:
  core      — D3Q19 constants, equilibrium, moments, unit system
  geometry  — cell labels and the analytic masks of the ported cases
  engine    — case specs, compiled cases, the dense step, the runner,
              checkpoints
  kernels   — the CUDA collide-stream and moments kernels, their plain
              PyTorch versions and the nvcc/ctypes build
  cases     — lid_driven_cavity and poiseuille
  io        — VTK writer, convergence log
  bridge    — carries CaseSpecs and states across from lbm_tpu
"""

from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.core.units import UnitSystem

__version__ = "0.1.0"

__all__ = ["D3Q19", "UnitSystem", "__version__"]
