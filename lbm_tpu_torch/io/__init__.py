from lbm_tpu_torch.io.convlog import ConvergenceLog
from lbm_tpu_torch.io.snapshots import (
    write_bc_csv,
    write_midplane,
    write_midplane_fluid,
)
from lbm_tpu_torch.io.vtk import case_vtk, write_structured_points

__all__ = ["write_structured_points", "case_vtk", "ConvergenceLog",
           "write_midplane", "write_midplane_fluid", "write_bc_csv"]
