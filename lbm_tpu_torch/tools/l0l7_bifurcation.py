"""Close the L0->L7 loop on the bifurcation (the port of lbm_tpu's
tools/l0l7_bifurcation.py): voxelize the vessel's STL with the in-repo
pipeline (geometry/preprocess), run the bifurcation case on that
self-generated geometry and on the shipped geo.txt, and quantify the
midplane-field delta between the two runs with
io/snapshots.compare_midplane, plus the 3D common-fluid |du|max/|u|max.

This tests whether the chain the reference only describes (MyCrust ->
smoothpatch -> geo_preprocess -> solver) closes.

Usage: python -m lbm_tpu_torch.tools.l0l7_bifurcation [--steps 4400]
       [--stl bif.stl] [--spacing 0.248925] [--device cuda]
       [--backend kernel]
Prints one summary line per component and the compare_midplane stats.
At its defaults it reads the reference's bifurcation files (bif.stl,
geo.txt, bc.txt under /root/reference/bifurcation) and exits non-zero,
naming the file, where one is missing.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from lbm_tpu_torch.tools import device_label

REFERENCE = "/root/reference/bifurcation"
SHAPE = (64, 83, 32)
MID_Z = 16


def _require_files(*paths) -> None:
    for path in paths:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"l0l7_bifurcation: no such file: {path}")


def l0l7(stl: str, shipped_geo: str, bc_path: str, steps: int = 4400,
         spacing: float = 0.248925, device="cuda", backend: str = "kernel",
         log=print) -> dict:
    """STL -> occupancy -> extruded open ends -> save_geo, the bifurcation
    case on that geometry and on `shipped_geo` (inlet profile from
    `bc_path`) for `steps` steps each, then compare_midplane at z=16 over
    the cells both mark fluid and the 3D common-fluid ratio. `log`
    receives each summary line. Returns the numbers it prints: occupancy,
    each run's (steps, residual, ms/step, MLUPS, cell counts, max|u|,
    finite, the inlet's peak), the midplane cell counts and stats, and
    ratio_3d. Raises FileNotFoundError naming the first missing file."""
    _require_files(stl, shipped_geo, bc_path)

    from lbm_tpu_torch.cases import get_case
    from lbm_tpu_torch.engine.runner import Simulation
    from lbm_tpu_torch.geometry.io import save_geo
    from lbm_tpu_torch.geometry.mask import CellType
    from lbm_tpu_torch.geometry.preprocess import (
        extrude_open_ends,
        stl_to_occupancy,
    )
    from lbm_tpu_torch.io.snapshots import compare_midplane

    t0 = time.perf_counter()

    def stamp(msg):
        log(f"[{time.perf_counter() - t0:6.1f}s] {msg}")

    # L0: STL -> occupancy with the in-repo voxelizer, registered on the
    # solver grid (spacing = CH in the STL's units, centered), the open
    # tube ends extruded to the y=1 / y=81 label planes like the shipped
    # preprocessing did.
    flag = extrude_open_ends(stl_to_occupancy(stl, SHAPE, spacing=spacing),
                             axis=1)
    out = {"occupancy": float(flag.mean())}
    stamp(f"voxelized {stl}: occupancy {flag.mean():.3f}")

    def run_case(geo_path, tag):
        spec = get_case("bifurcation", geo_path=geo_path, bc_path=bc_path,
                        max_steps=steps, time_save=max(1, steps // 4))
        m = np.asarray(spec.mask)
        stamp(f"{tag}: NLATTICE {int((m != 0).sum())}, inlet "
              f"{int((m == CellType.INLET).sum())}, outlet "
              f"{int((m == CellType.OUTLET).sum())}")
        sim = Simulation(spec, device=device, backend=backend)
        res = sim.run(verbose=False)
        u = sim.macro()[1].cpu().numpy()
        stamp(f"{tag}: {res.steps} steps, residual {res.residual:.3e}, "
              f"{res.elapsed_s / max(res.steps, 1) * 1e3:.4f} ms/step, "
              f"{res.mlups:.0f} MLUPS")
        out[tag] = {
            "steps": res.steps, "residual": res.residual,
            "ms_per_step": res.elapsed_s / max(res.steps, 1) * 1e3,
            "mlups": res.mlups, "nlattice": int((m != 0).sum()),
            "inlet": int((m == CellType.INLET).sum()),
            "outlet": int((m == CellType.OUTLET).sum()),
            "u_max": float(np.abs(u).max()),
            "finite": bool(np.isfinite(u).all()),
            "inlet_peak": float(np.abs(spec.boundaries[0].u_field).max())}
        return m, u

    with tempfile.TemporaryDirectory() as d:
        self_geo = os.path.join(d, "geo_self.txt")
        save_geo(self_geo, flag, order="xyz")
        mask_ref, u_ref = run_case(shipped_geo, "shipped-geo")
        mask_self, u_self = run_case(self_geo, "self-voxelized")

    # L7: midplane (z = nz/2) in-plane velocity, compared over the cells
    # BOTH geometries mark fluid (the reference's meas1.txt midplane
    # convention: components (uy, ux)).
    fl_ref = mask_ref[:, :, MID_Z] == CellType.FLUID
    fl_self = mask_self[:, :, MID_Z] == CellType.FLUID
    common = fl_ref & fl_self
    mid_ref = np.stack([u_ref[1, :, :, MID_Z], u_ref[0, :, :, MID_Z]])
    mid_self = np.stack([u_self[1, :, :, MID_Z], u_self[0, :, :, MID_Z]])
    stats = compare_midplane(mid_ref, mid_self, fluid=common)
    only = int(fl_ref.sum() - common.sum()), int(fl_self.sum() - common.sum())
    log(f"midplane fluid cells: shipped {int(fl_ref.sum())}, "
        f"self {int(fl_self.sum())}, common {int(common.sum())} "
        f"(shipped-only {only[0]}, self-only {only[1]})")
    log("compare_midplane(shipped vs self-voxelized): "
        + ", ".join(f"{k}={v:.4g}" for k, v in stats.items()))
    # whole-field check over the common fluid cells in 3D, relative to the
    # shipped run's velocity scale
    live = (mask_ref == CellType.FLUID) & (mask_self == CellType.FLUID)
    scale = np.abs(u_ref[:, live]).max()
    dmax = np.abs(u_ref[:, live] - u_self[:, live]).max()
    log(f"3D common-fluid |du|max/|u|max = {dmax / scale:.4f}")
    out.update(midplane={"shipped": int(fl_ref.sum()),
                         "self": int(fl_self.sum()),
                         "common": int(common.sum())},
               compare_midplane=stats, ratio_3d=float(dmax / scale))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4400)
    ap.add_argument("--stl", default=f"{REFERENCE}/bif.stl")
    ap.add_argument("--spacing", type=float, default=0.248925,
                    help="cell size in STL units (bif.stl is in mm; "
                    "the case CH is 0.000248925 m). Registers the "
                    "voxelization on the solver grid so the vessel "
                    "reaches the y=1 / y=81 opening planes the "
                    "bifurcation labeler expects.")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    ap.add_argument("--backend", default="kernel",
                    choices=("kernel", "dense", "sparse"))
    args = ap.parse_args(argv)
    files = (args.stl, f"{REFERENCE}/geo.txt", f"{REFERENCE}/bc.txt")
    try:
        _require_files(*files)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"device: {device_label(args.device)}; bifurcation {SHAPE}, "
          f"{args.steps} steps a run, backend {args.backend}", flush=True)
    l0l7(*files, steps=args.steps, spacing=args.spacing, device=args.device,
         backend=args.backend, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
