from lbm_tpu_torch.io.convlog import ConvergenceLog
from lbm_tpu_torch.io.vtk import case_vtk, write_structured_points

__all__ = ["write_structured_points", "case_vtk", "ConvergenceLog"]
