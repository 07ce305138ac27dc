"""lbm_tpu_torch — the D3Q19 BGK lattice-Boltzmann solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `lbm_tpu` (JAX/Pallas). It imports torch and numpy and never
jax, so it runs on a machine without JAX. It mirrors lbm_tpu's layout:
  core      — D3Q19 constants, equilibrium, moments, unit system
  geometry  — cell labels, the analytic masks of the ported cases and
              the reference's geo/bc file formats
  engine    — case specs, compiled cases, the dense step (Bouzidi curved
              walls included), the live-cell (sparse) step, the
              runner, checkpoints, wall stress, scalar transport (D3Q7)
              and Boussinesq thermal flow
  kernels   — the CUDA collide-stream (whole box and shard, z planes
              included), moments and D3Q7 scalar kernels, their plain
              PyTorch versions and the nvcc/ctypes build
  parallel  — the box split over the ranks of a torch.distributed group:
              the mesh, the ring exchange of the shards' edge planes, the
              sharded kernel and dense halo steps, spawning the ranks
  cases     — lid_driven_cavity, poiseuille, curved_vessel, coronary,
              gravity_channel, pipe and the thermal boxes
  io        — VTK writer, convergence log, the reference's snapshot
              files
  utils     — throughput meter, torch.profiler traces
  bridge    — carries CaseSpecs, states and transports across from
              lbm_tpu
"""

from lbm_tpu_torch.core.lattice import D3Q19
from lbm_tpu_torch.core.units import UnitSystem

__version__ = "0.1.0"

__all__ = ["D3Q19", "UnitSystem", "__version__"]
