"""The 512^3 demos and the profile tools (lbm_tpu_torch/tools/
demo_512_outputs, demo_512_washout, demo_512_sharded, profile_clinical,
profile_shard) run to their end on the CPU at tiny sizes (--device cpu:
the kernels' plain versions), each in a process of its own with a
timeout (started before the test computes its reference, which runs
meanwhile); their printed lines and the numbers main() returns are held
against lbm_tpu's plain reference run in this process (Simulation(
backend='xla'), its dense ScalarTransport).

lbm_tpu's own tools/demo_512_sharded.py (the sharded Pallas step in
interpret mode) prints 1.7511e+00 and 2.9110e+00 at --n 72 --ndev 2,
which its xla run of the same case does not reproduce (4.4450e+00,
7.3374e+00 as its fluid velsums); the port's sharded run is held to the
xla run and to its own unsharded kernel route."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.scalar import ScalarTransport as RefScalarTransport
from lbm_tpu.engine.stress import wall_normals, wss_field
from lbm_tpu.io.vtk import write_structured_points as ref_write
from lbm_tpu_torch.engine import checkpoint
from lbm_tpu_torch.engine.runner import Simulation
from lbm_tpu_torch.io.vtk import write_structured_points
from lbm_tpu_torch.tools import coronary_cube, demo_512_sharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """The boxes are tiny: torch's intra-op threads would only contend with
    the other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_tool(name: str, args: list) -> subprocess.Popen:
    """lbm_tpu_torch.tools.<name> with --device cpu, started in a process
    of its own (finish_tool collects it): the test computes its reference
    meanwhile."""
    code = ("import json, sys\n"
            f"from lbm_tpu_torch.tools import {name}\n"
            f"out = {name}.main(sys.argv[1:])\n"
            "print(json.dumps(out, default=float))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", code, "--device", "cpu", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_tool(proc: subprocess.Popen) -> tuple[str, dict]:
    """(stdout, main()'s returned numbers) of start_tool's process, which
    must exit 0 within 240 s; the numbers cross as its output's last
    line."""
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    assert out.startswith("device: cpu")
    *lines, last = out.strip().splitlines()
    return "\n".join(lines), json.loads(last)


def run_tool(name: str, args: list) -> tuple[str, dict]:
    return finish_tool(start_tool(name, args))


def vtk_fields(path: str) -> tuple[tuple, list]:
    """((nx, ny, nz), the field names in order) of a binary
    STRUCTURED_POINTS file, each field's header and its big-endian f4
    block walked in turn; the walk must end at the file's last byte."""
    with open(path, "rb") as fh:
        data = fh.read()
    head = data.index(b"POINT_DATA")
    pos = data.index(b"\n", head) + 1
    lines = data[:pos].decode().splitlines()
    assert lines[0] == "# vtk DataFile Version 2.0" and lines[2] == "BINARY"
    dims = tuple(int(v) for v in lines[4].split()[1:])
    n = int(np.prod(dims))
    names = []
    while pos < len(data):
        end = data.index(b"\n", pos)
        kind, name, _ = data[pos:end].decode().split()
        pos = end + 1
        if kind == "SCALARS":
            assert data[pos:].startswith(b"LOOKUP_TABLE default\n")
            pos += len(b"LOOKUP_TABLE default\n")
        pos += 4 * n * (3 if kind == "VECTORS" else 1)
        assert data[pos:pos + 1] == b"\n", (name, pos)
        pos += 1
        names.append(name)
    assert pos == len(data)
    return dims, names


def ref_velsum_spec(n: int):
    spec = ref_get_case("coronary", shape=(n, n, n), radius=max(6, n // 36))
    return dataclasses.replace(spec, residual_flavor="velsum")


def ref_chunk(ref, n: int) -> np.ndarray:
    """n steps of lbm_tpu's xla Simulation from its state, its fluid
    velsums (offset taken off) returned."""
    f, _, s = ref._build_chunk(n)(ref.f, jnp.int32(ref.t))
    ref.f, ref.t = f, ref.t + n
    return np.asarray(s, np.float64) - ref.cc.velsum_offset


def test_demo_512_outputs_matches_lbm_tpu(tmp_path):
    """--n 36 --force-lowmem --steps 4 --resume-steps 2: the first chunk's
    velsum sum, |u|max, the WSS cells' count, mean and max in Pa and the
    resumed chunk's velsum sum against lbm_tpu's xla run of the same
    steps at rtol 1e-5; the VTK's fields and size; its checkpoint (t = 8)
    restored into a port Simulation equals lbm_tpu's state at step 8."""
    out_dir = str(tmp_path / "d512")
    proc = start_tool("demo_512_outputs", [
        "--n", "36", "--force-lowmem", "--steps", "4", "--resume-steps",
        "2", "--out", out_dir])
    ref = RefSimulation(ref_velsum_spec(36), backend="xla")
    first = ref_chunk(ref, 2).sum() + ref_chunk(ref, 2).sum()
    ref_chunk(ref, 2)
    ref_chunk(ref, 2)
    _, u = ref.macro()
    # Simulation.wss()'s dense route, one jitted program
    normals = wall_normals(ref.spec.mask, None)
    w = np.asarray(jax.jit(lambda f: wss_field(ref.cc, f, ref.t, normals))(
        ref.f), np.float64)
    cpre = ref.spec.units.C_pre
    f8 = np.asarray(ref.f_standard())
    resumed = ref_chunk(ref, 2).sum()
    text, got = finish_tool(proc)
    for line in ("sim constructed (lowmem)", "hot loop:", "|u|max",
                 "wss (dense stress route): ", "VTK written:",
                 "checkpoint (uncompressed):", "restored t=8",
                 "ALL OUTPUT SURFACES OK at 36^3"):
        assert line in text, (line, text)
    np.testing.assert_allclose(got["velsum"], first, rtol=1e-5)
    np.testing.assert_allclose(got["u_max"], np.abs(np.asarray(u)).max(),
                               rtol=1e-5)
    assert got["wss"]["count"] == int((w > 0).sum()) == 1360
    np.testing.assert_allclose(
        [got["wss"]["mean_pa"], got["wss"]["max_pa"]],
        [w.sum() / (w > 0).sum() * cpre, w.max() * cpre], rtol=1e-5)
    np.testing.assert_allclose(got["resume_velsum"], resumed, rtol=1e-5)
    assert got["resume_t"] == 10

    dims, names = vtk_fields(got["vtk"])
    assert dims == (34, 32, 34) and names == ["DENSITY", "PRESSURE",
                                              "VELOCITY"]
    assert got["vtk_bytes"] == os.path.getsize(got["vtk"])

    spec = ref_velsum_spec(36)
    from lbm_tpu_torch.cases import get_case

    sim = Simulation(get_case("coronary", shape=(36,) * 3, radius=6),
                     device="cpu", backend="dense")
    checkpoint.restore(sim, got["ckpt"])
    assert sim.t == got["t"] == 8 and spec.shape == (36, 36, 36)
    np.testing.assert_allclose(sim.f.numpy(), f8, rtol=1e-5, atol=1e-7)


def test_demo_512_washout_matches_lbm_tpu():
    """--n 36 --flow-steps 40 --steps 60 --bolus 20 --chunk 20: each
    boundary's series peak over the timed chunks and total() against
    lbm_tpu's xla flow and its dense ScalarTransport on the frozen u
    (div_fix off) at rtol 1e-5 (lbm_tpu's interpret run of its tool:
    bc0 0.674, total 47.44)."""
    proc = start_tool("demo_512_washout", [
        "--n", "36", "--flow-steps", "40", "--steps", "60", "--bolus",
        "20", "--chunk", "20"])
    spec = ref_get_case("coronary", shape=(36,) * 3, radius=6)
    ref = RefSimulation(spec, backend="xla")
    ref.run(max_steps=40, time_save=40, verbose=False)
    u = np.asarray(ref.macro()[1], np.float32)
    st = RefScalarTransport(spec, u, D=0.02,
                            inlet_c={0: lambda t: jnp.where(t < 20, 1.0,
                                                            0.0)},
                            div_fix=False)
    rec = list(range(len(spec.boundaries)))
    st.run(20, record=rec)
    series = np.concatenate([st.run(20, record=rec) for _ in range(2)])
    text, got = finish_tool(proc)
    assert "series peaks: bc0=0.674 bc1=0.000 bc2=0.001" in text
    assert "scalar total: 47.44" in text and text.endswith("OK")
    np.testing.assert_allclose(got["peaks"], series.max(axis=0), rtol=1e-5)
    np.testing.assert_allclose(got["total"], st.total(), rtol=1e-5)
    assert got["steps"] == 40


def test_demo_512_sharded_matches_the_unsharded_runs():
    """--n 72 --ndev 2 --steps 2 on two gloo CPU ranks: each step's velsum
    summed over the ranks against the port's unsharded kernel route and
    lbm_tpu's xla run at 1e-5 relative; fewer listed lanes than window
    cells on each rank ("skip active"); each rank's window finite with
    zeros at DEAD cells."""
    proc = start_tool("demo_512_sharded", ["--n", "72", "--ndev", "2",
                                           "--steps", "2"])
    spec = coronary_cube(72)
    sim = Simulation(spec, device="cpu", backend="kernel")
    res = sim.run(max_steps=2, time_save=2, verbose=False)
    port = res.velsum_series - sim.case.velsum_offset
    ref = RefSimulation(ref_velsum_spec(72), backend="xla")
    xla = ref_chunk(ref, 2)
    text, got = finish_tool(proc)
    assert "skip active" in text and "72^3 sharded x2 OK" in text
    assert max(got["lanes"]) < got["cells"] == 72 * 36 * 72
    assert got["flags"] == [[1, 1], [1, 1]]
    # the plain versions count no launch (the card's run counts K1d's)
    assert got["launches"] == [{}, {}]
    np.testing.assert_allclose(got["velsum"], port, rtol=1e-5)
    np.testing.assert_allclose(got["velsum"], xla, rtol=1e-5)


def test_spec_files_round_trip(tmp_path):
    """save_spec / load_spec: every field back, the box-sized arrays
    mapped copy on write (the files stay as written) and equal."""
    spec = coronary_cube(36)
    demo_512_sharded.save_spec(spec, str(tmp_path))
    back = demo_512_sharded.load_spec(str(tmp_path))
    assert isinstance(back.mask, np.memmap) and back.mask.mode == "c"
    other = demo_512_sharded.load_spec(str(tmp_path))
    other.u0[0, 0, 0, 0] = 7.0
    assert back.u0[0, 0, 0, 0] == 0.0
    for f in dataclasses.fields(spec):
        a, b = getattr(spec, f.name), getattr(back, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif f.name != "boundaries":
            assert a == b, f.name
    assert [bc.coord for bc in back.boundaries] == [
        bc.coord for bc in spec.boundaries]


@pytest.mark.parametrize("name,args,rows", [
    ("profile_clinical", ["--shape", "48,24,40", "--radius", "5",
                          "--steps", "4"],
     ["flow", "flow+wksub", "flow+wk", "flow+wk+pulse", "coupled",
      "clinical"]),
    ("profile_shard", ["--n", "16", "--steps", "4"],
     ["v1_unsharded", "v2_halokernel", "v3_noexch", "v4_sharded"])])
def test_profile_tool_prints_every_row(name, args, rows):
    text, got = run_tool(name, args)
    assert list(got) == rows
    for row in rows:
        assert f"\n{row}" in "\n" + text, (row, text)
        assert np.isfinite(got[row]["ms"]) and got[row]["ms"] > 0


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_vtk_writer_bytes_match_lbm_tpu(tmp_path, binary, as_tensor):
    """The writer orders every field as a tensor (NumPy fields converted
    first): its file is byte for byte lbm_tpu's writer's on the same
    float64 scalar and float32 vector fields, cropped."""
    rng = np.random.default_rng(18)
    fields = {"DENSITY": rng.random((7, 6, 5)),
              "VELOCITY": rng.random((3, 7, 6, 5), dtype=np.float32)}
    kw = dict(spacing=0.5, origin=(1.0, 2.0, 0.0), crops=(1, 0, 1),
              binary=binary)
    ref_write(str(tmp_path / "ref.vtk"), fields, **kw)
    port = ({k: torch.from_numpy(v) for k, v in fields.items()}
            if as_tensor else fields)
    write_structured_points(str(tmp_path / "port.vtk"), port, **kw)
    assert ((tmp_path / "port.vtk").read_bytes()
            == (tmp_path / "ref.vtk").read_bytes())
