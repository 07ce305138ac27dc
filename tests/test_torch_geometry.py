"""The port's host geometry tools (lbm_tpu_torch/geometry/native.py,
preprocess.py, reconstruct.py) held against lbm_tpu's on the CPU: the
native library (built with g++ by the port into its own ignored directory)
against lbm_tpu's native library, the NumPy plain versions against lbm_tpu's
NumPy paths, on lbm_tpu's own test inputs (tests/test_native_tools.py,
tests/test_reconstruct.py); the build's hashed object and its loud
failure; preprocess's occupancy, labels and CLI on a small synthetic
STL."""

import os
import subprocess

import numpy as np
import pytest
import torch

import lbm_tpu.geometry.native as ref_native
import lbm_tpu.geometry.preprocess as ref_pre
import lbm_tpu.geometry.reconstruct as ref_rec
from lbm_tpu_torch.geometry import native, preprocess, reconstruct
from test_native_tools import _icosphere
from test_reconstruct import _sphere_cloud, _tube_cloud

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_one_thread():
    """Host code only: torch's intra-op threads would only contend with the
    other test workers' for the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_numpy(monkeypatch):
    """Put lbm_tpu's geometry ops on their NumPy paths for the rest of the
    test (its native library taken away, as tests/test_native_tools.py
    does)."""
    ref_native._load()
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_LIB_TRIED", True)


def _noisy_sphere(subdiv, scale, seed):
    verts, faces = _icosphere(subdiv)
    rng = np.random.default_rng(seed)
    return verts + scale * rng.standard_normal(verts.shape), faces


@pytest.mark.parametrize("native_route", [True, False])
def test_vertex_neighbours_match_lbm_tpu(native_route, monkeypatch):
    _, faces = _icosphere(2)
    if native_route:
        assert ref_native.have_native()
    else:
        _ref_numpy(monkeypatch)
    got = native.vertex_neighbours(faces, 162, native=native_route)
    want = ref_native.vertex_neighbours(faces, 162)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["inversedistance", "curvature"])
def test_smoothing_matches_lbm_tpu(mode, monkeypatch):
    """Each route against lbm_tpu's same route at 1e-12, and the port's
    native against its NumPy plain version at lbm_tpu's 1e-9."""
    noisy, faces = _noisy_sphere(2, 0.05, 1)
    kw = dict(iterations=10, mode=mode)
    nat = native.smooth_mesh(noisy, faces, **kw)
    np.testing.assert_allclose(nat, ref_native.smooth_mesh(noisy, faces,
                                                           **kw),
                               rtol=0, atol=1e-12)
    plain = native.smooth_mesh(noisy, faces, native=False, **kw)
    _ref_numpy(monkeypatch)
    np.testing.assert_allclose(plain, ref_native.smooth_mesh(noisy, faces,
                                                             **kw),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(nat, plain, rtol=0, atol=1e-9)
    assert np.std(np.linalg.norm(nat, axis=1)) < np.std(
        np.linalg.norm(noisy, axis=1))


def test_voxelize_matches_lbm_tpu(monkeypatch):
    """The unit sphere in a 40^3 grid (margin 4), cell for cell: native
    against lbm_tpu's native, NumPy against lbm_tpu's NumPy and against
    native."""
    verts, faces = _icosphere(3)
    tris = verts[faces]
    nat = native.voxelize_mesh(tris, (40, 40, 40), margin=4)
    np.testing.assert_array_equal(
        nat, ref_native.voxelize_mesh(tris, (40, 40, 40), margin=4))
    plain = native.voxelize_mesh(tris, (40, 40, 40), margin=4, native=False)
    _ref_numpy(monkeypatch)
    np.testing.assert_array_equal(
        plain, ref_native.voxelize_mesh(tris, (40, 40, 40), margin=4))
    np.testing.assert_array_equal(nat, plain)
    vol = nat.sum() * (2.0 / 32) ** 3
    assert abs(vol - 4 / 3 * np.pi) / (4 / 3 * np.pi) < 0.05


def test_native_builds_a_hashed_object_in_its_ignored_directory():
    """The library lands in geometry/_build under a name carrying the
    hash of source, compiler and flags (a git-ignored directory, nothing
    under tools/native), and a second load finds it."""
    lib = native.load()
    assert lib.path == native.library_path()
    assert lib.path.parent == native.BUILD_DIR
    assert lib.path.name.startswith("liblbm_geo_") and len(
        lib.path.stem) == len("liblbm_geo_") + 16
    assert "tools" not in os.path.relpath(lib.path, ROOT).split(os.sep)
    assert native.SOURCE.parent.parent == native.BUILD_DIR.parent
    ignored = subprocess.run(
        ["git", "check-ignore", "-q",
         os.path.relpath(native.BUILD_DIR / ".lock", ROOT)], cwd=ROOT)
    assert ignored.returncode == 0, "geometry/_build/ is not git-ignored"
    assert native.load() is lib and native.have_native()


def test_a_broken_compiler_raises(monkeypatch, tmp_path):
    """CXX=false: no object, a RuntimeError naming the command and its
    exit code, have_native() False, and no NumPy fallback."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match=r"lbm_geo build failed \(exit 1\)"
                       r": false -O3"):
        native.smooth_mesh(*_icosphere(1), iterations=1)
    assert not native.have_native()
    assert [p.name for p in tmp_path.iterdir()] == [".lock"]
    monkeypatch.setenv("CXX", os.path.join(str(tmp_path), "no-such-cxx"))
    with pytest.raises(RuntimeError, match="no-such-cxx"):
        native.voxelize_mesh(np.zeros((1, 3, 3)), (2, 2, 2), spacing=1.0)


def test_stl_loading_matches_lbm_tpu(tmp_path):
    """A binary STL (chip_smoke's writer) and the same triangles as ASCII:
    the port's load_stl equals lbm_tpu's on both."""
    verts, faces = _icosphere(1)
    binary = tmp_path / "s.stl"
    chip_smoke.write_binary_stl(str(binary), verts, faces)
    ascii_ = tmp_path / "a.stl"
    with open(ascii_, "w") as fh:
        fh.write("solid s\n")
        for t in verts[faces]:
            fh.write("facet normal 0 0 0\nouter loop\n")
            for v in t:
                fh.write("vertex " + " ".join(f"{c:.17g}" for c in v) + "\n")
            fh.write("endloop\nendfacet\n")
        fh.write("endsolid s\n")
    for p in (binary, ascii_):
        got = native.load_stl(str(p))
        np.testing.assert_array_equal(got, ref_native.load_stl(str(p)))
    np.testing.assert_array_equal(native.load_stl(str(ascii_)),
                                  verts[faces])
    np.testing.assert_array_equal(native.load_stl(str(binary)),
                                  verts[faces].astype(np.float32))


def test_fit_plane_normal_matches_lbm_tpu():
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                    np.zeros(200)], axis=1)
    pts += 0.001 * rng.standard_normal((200, 3))
    n = native.fit_plane_normal(pts)
    np.testing.assert_array_equal(n, ref_native.fit_plane_normal(pts))
    assert abs(abs(n[2]) - 1) < 1e-3


# -- reconstruct ------------------------------------------------------------

def test_cloud_to_occupancy_and_boundary_mesh_match_lbm_tpu():
    """The sphere cloud (40^3) and the open tube cloud (32 x 32 x 72, the
    per-slice fills) exactly; voxel_boundary_mesh of the cube and of the
    sphere's occupancy exactly."""
    for pts, shape in ((_sphere_cloud(), (40, 40, 40)),
                       (_tube_cloud(), (32, 32, 72))):
        got = reconstruct.cloud_to_occupancy(pts, shape)
        want = ref_rec.cloud_to_occupancy(pts, shape)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    cube = np.zeros((8, 8, 8), np.int32)
    cube[2:6, 2:6, 2:6] = 1
    for occ, origin, spacing in ((cube, (0.0, 0.0, 0.0), 1.0), got):
        v, f = reconstruct.voxel_boundary_mesh(occ, origin, spacing)
        rv, rf = ref_rec.voxel_boundary_mesh(occ, origin, spacing)
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(f, rf)
    assert len(reconstruct.voxel_boundary_mesh(cube)[1]) == 6 * 16 * 2


def test_reconstruct_surface_matches_lbm_tpu():
    verts, faces = reconstruct.reconstruct_surface(_sphere_cloud(),
                                                   (40, 40, 40),
                                                   smooth_iters=6)
    rv, rf = ref_rec.reconstruct_surface(_sphere_cloud(), (40, 40, 40),
                                         smooth_iters=6)
    np.testing.assert_array_equal(faces, rf)
    np.testing.assert_allclose(verts, rv, rtol=0, atol=1e-12)


def _fibonacci_sphere(n=1600):
    i = np.arange(n)
    phi = np.arccos(1 - 2 * (i + 0.5) / n)
    th = np.pi * (1 + 5**0.5) * i
    return np.stack([np.sin(phi) * np.cos(th), np.sin(phi) * np.sin(th),
                     np.cos(phi)], 1)


@pytest.mark.parametrize("shell", ["closed sphere", "open hemisphere"])
def test_ball_pivot_matches_lbm_tpu(shell):
    """tests/test_reconstruct.py's two ball-pivot inputs: the same
    vertices and the same faces in the same order (the front's order and
    cKDTree's query order decide the triangulation), and the closed
    sphere's 2V-4 faces."""
    pts = _fibonacci_sphere()
    if shell == "open hemisphere":
        pts = pts[pts[:, 2] > 0]
    v, f = reconstruct.ball_pivot_surface(pts)
    rv, rf = ref_rec.ball_pivot_surface(pts)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(f, rf)
    if shell == "closed sphere":
        assert len(f) == 2 * len(pts) - 4


def test_alpha_shape_and_median_spacing_match_lbm_tpu(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((3000, 3))
    pts = pts[np.linalg.norm(pts, axis=1) < 1.0]
    v, f = reconstruct.alpha_shape_surface(pts)
    rv, rf = ref_rec.alpha_shape_surface(pts)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(f, rf)
    cloud = _sphere_cloud(500)
    assert (reconstruct.median_spacing(cloud)
            == ref_rec.median_spacing(cloud))
    tets = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 0, 1, 2]])
    np.testing.assert_array_equal(reconstruct._circumradii(pts, tets),
                                  ref_rec._circumradii(pts, tets))
    centers = reconstruct._ball_centers(pts[0], pts[1], pts[2], 5.0)
    for a, b in zip(centers, ref_rec._ball_centers(pts[0], pts[1], pts[2],
                                                   5.0)):
        np.testing.assert_array_equal(a, b)
    from scipy.io import savemat

    mat = tmp_path / "cloud.mat"
    savemat(str(mat), {"p": pts})
    np.testing.assert_array_equal(reconstruct.load_point_cloud_mat(str(mat)),
                                  ref_rec.load_point_cloud_mat(str(mat)))
    with pytest.raises(KeyError, match="'q' not in"):
        reconstruct.load_point_cloud_mat(str(mat), var="q")


# -- preprocess -------------------------------------------------------------

def _tube_stl(path):
    """A closed tube along y (radius 5 in a 24 x 32 x 24 box, its ends
    short of the box's) as a binary STL of its voxel surface."""
    x, y, z = np.meshgrid(np.arange(24), np.arange(32), np.arange(24),
                          indexing="ij")
    occ = (((x - 11.5) ** 2 + (z - 11.5) ** 2 <= 25) & (y >= 4)
           & (y <= 27)).astype(np.int32)
    verts, faces = reconstruct.voxel_boundary_mesh(occ)
    chip_smoke.write_binary_stl(str(path), verts, faces)


def test_preprocess_matches_lbm_tpu(tmp_path):
    """stl_to_occupancy (with and without smoothing, fitted and at a given
    spacing), extrude_open_ends and label_occupancy equal lbm_tpu's, and
    the CLI writes lbm_tpu's geo.txt byte for byte (labeled and
    --binary)."""
    stl = tmp_path / "tube.stl"
    _tube_stl(stl)
    shape = (24, 32, 24)
    for kw in ({}, dict(smooth_iters=3), dict(spacing=1.0),
               dict(smooth_iters=2, smooth_mode="inversedistance",
                    spacing=1.0)):
        flag = preprocess.stl_to_occupancy(str(stl), shape, **kw)
        np.testing.assert_array_equal(
            flag, ref_pre.stl_to_occupancy(str(stl), shape, **kw))
        ext = preprocess.extrude_open_ends(flag, axis=1)
        np.testing.assert_array_equal(
            ext, ref_pre.extrude_open_ends(flag, axis=1))
        geo = preprocess.label_occupancy(ext)
        np.testing.assert_array_equal(geo, ref_pre.label_occupancy(ext))
    assert set(np.unique(geo)) == {-1, 0, 1, 2, 3, 4}
    for extra in ([], ["--binary"], ["--smooth", "2", "--order", "yxz"]):
        args = [str(stl), "", "--shape", *map(str, shape), *extra]
        args[1] = str(tmp_path / "port.txt")
        assert preprocess.main(args) == 0
        args[1] = str(tmp_path / "ref.txt")
        assert ref_pre.main(args) == 0
        assert ((tmp_path / "port.txt").read_bytes()
                == (tmp_path / "ref.txt").read_bytes())
    with pytest.raises(ValueError, match="empty occupancy"):
        preprocess.label_occupancy(np.zeros(shape, np.int32))
