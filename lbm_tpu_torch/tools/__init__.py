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
  demo_512_outputs        the 512^3 coronary under lowmem: macro(), the
                          live-cell wss(), a binary VTK, an uncompressed
                          checkpoint restored and stepped on
  demo_512_washout        512^3 flow, then K7 through a recorded washout
  demo_512_sharded        the 512^3 coronary on y over 8 gloo ranks (K1d)
  profile_clinical        the clinical step's cost, one mechanism a row
  profile_shard           the sharded step's overhead on one rank
"""


def coronary_cube(n: int):
    """The n^3 synthetic coronary tree of lbm_tpu's 512^3 demos (radius
    max(6, n // 36)) with the 'velsum' residual: the runner then keeps
    each step's velsum (the coronary's stop count, 10**9, never ends a
    run) and reads no macro() a chunk."""
    import dataclasses

    from lbm_tpu_torch.cases import get_case

    spec = get_case("coronary", shape=(n, n, n), radius=max(6, n // 36))
    return dataclasses.replace(spec, residual_flavor="velsum")


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
