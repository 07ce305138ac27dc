"""Demos of the port, each run as `python -m lbm_tpu_torch.tools.<name>`
with lbm_tpu's tools/<name>.py arguments and defaults plus --device
(default cuda; 'cpu' runs the kernels' plain versions):

  demo_adjoint            RCR outlet calibration by the adjoint, then a
                          kernel Simulation on the fitted terminations
  demo_washout            bolus washout curves and the mean-age field
  demo_thermal            the dense heated cavity, Nu against de Vahl Davis
  demo_thermal_3d         the 3D heated cavity / Rayleigh-Benard on the
                          kernels, Nu against Tric et al.
  demo_blood_wss          Carreau blood on the coronary tree, WSS in Pa
  demo_clinical_washout   pulsatile coronary, RCR outlets, coupled washout
  ffr_sweep               resting and hyperemic FFR against stenosis
  l0l7_bifurcation        STL -> voxels -> the bifurcation case, its
                          midplane against the shipped geometry's run
"""


def device_label(device) -> str:
    """The device a demo runs on, for its first line: the card's name on
    CUDA, 'cpu' otherwise."""
    import torch

    from lbm_tpu_torch.engine.runner import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


def sync(device) -> None:
    """Wait for the device's queued work (a demo's clock reads after it)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
