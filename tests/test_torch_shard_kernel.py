"""The sharded collide-stream step (K1d) of lbm_tpu_torch on the CPU, its
shards held in one process: the plain versions of lbm_collide_stream_halo
and lbm_fix_z_plane_halo (the kernel wrappers with a halo, on CPU
tensors) stitched from 2 and 4 shards against lbm_tpu's sharded Pallas
step in interpret mode on the 8-device virtual mesh and, bit for bit,
against the port's whole-box step; the dense halo step against lbm_tpu's
make_halo_step; the shard windows compile_shard builds; the wrappers'
halo checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.step import initial_f as ref_initial_f
from lbm_tpu.engine.step import make_step as ref_make_step
from lbm_tpu.kernels.collide_stream import pack_state, pad_spec, unpack_state
from lbm_tpu.parallel.halo import make_halo_step as ref_make_halo_step
from lbm_tpu.parallel.mesh import free_axis as ref_free_axis
from lbm_tpu.parallel.mesh import lattice_mesh as ref_lattice_mesh
from lbm_tpu.parallel.mesh import lattice_sharding, shard_compiled
from lbm_tpu.parallel.pallas_sharded import make_pallas_sharded_step
from lbm_tpu_torch.bridge import gather_windows, shard_window
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine.compile import (
    compile_case,
    compile_shard,
    shard_rows,
)
from lbm_tpu_torch.engine.step import initial_f, make_step, pulled_state, \
    step_tail
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import collide_stream as K
from lbm_tpu_torch.parallel.halo import edge_planes, ring_planes
from lbm_tpu_torch.parallel.mesh import free_axis

RTOL, ATOL = 3e-6, 1e-7
CORONARY = dict(shape=(32, 32, 32), radius=5)


def _noisy_initial(cc, seed=0):
    """The initial state plus seeded noise of 1e-4 of each population, as
    a float32 NumPy array (the same input for both packages)."""
    f = initial_f(cc).numpy()
    rng = np.random.default_rng(seed)
    return (f * (1 + 1e-4 * rng.standard_normal(f.shape))).astype(np.float32)


def _stitched_kernel_route(spec, f0, axis, world, steps):
    """K1d's wrappers (their plain versions on the CPU) on `world` shards
    held in one process: the stitched state and each step's velsum summed
    over the shards."""
    ccs = [compile_shard(spec, r, world, axis) for r in range(world)]
    f = torch.from_numpy(f0)
    fs = [shard_window(f, r, world, axis) for r in range(world)]
    outs = [torch.empty_like(x) for x in fs]
    series = torch.zeros(world, steps, dtype=torch.float64)
    for t in range(steps):
        planes = ring_planes(fs, axis)
        for r, c in enumerate(ccs):
            K.step(fs[r], outs[r], c, series[r], t, t,
                   halo=c.halo(*planes[r]))
        fs, outs = outs, fs
    return gather_windows(fs, axis, spec.shape[axis]), series.sum(0)


@pytest.fixture(scope="module")
def sharded_pallas_coronary():
    """lbm_tpu's sharded Pallas step (interpret mode, 8 shards on y) on
    the padded coronary from the seeded state, 2 steps: the unpadded f
    (zeros at DEAD cells) and the last velsum."""
    spec = get_case("coronary", **CORONARY)
    f0 = _noisy_initial(compile_case(spec))
    spec_pad = pad_spec(ref_get_case("coronary", **CORONARY))
    cc_pad = ref_compile_case(spec_pad)
    fp = np.array(ref_initial_f(cc_pad))
    fp[:, 1:-1, 1:-1, :] = f0
    step, init, unblock = make_pallas_sharded_step(
        cc_pad, ref_lattice_mesh(), shard_axis=1, interpret=True)
    step = jax.jit(step)
    p = init(pack_state(jnp.asarray(fp),
                        jnp.asarray(np.asarray(spec_pad.mask))))
    for t in range(2):
        p, vs = step(p, jnp.int32(t))
    f = np.asarray(unpack_state(unblock(p)))[:, 1:-1, 1:-1, :]
    return spec, f0, np.ascontiguousarray(f), float(vs)


@pytest.mark.parametrize("world", [2, 4])
def test_stitched_shards_match_lbm_tpu_sharded_pallas(
        sharded_pallas_coronary, world):
    """The coronary split along y (its z-plane sub-outlets' fixups run on
    the shards' faces): the port's stitched shards against lbm_tpu's
    8-shard Pallas path on the live cells (rtol 3e-6, atol 1e-7), the
    velsum at 1e-5, and bit for bit against the port's whole-box step."""
    spec, f0, f_ref, vs_ref = sharded_pallas_coronary
    f, vs = _stitched_kernel_route(spec, f0, 1, world, 2)
    live = np.asarray(spec.mask) != CellType.DEAD
    np.testing.assert_allclose(f.numpy()[:, live], f_ref[:, live],
                               rtol=RTOL, atol=ATOL)
    assert abs(float(vs[-1]) - vs_ref) <= 1e-5 * vs_ref
    assert (f_ref[:, ~live] == 0).all()
    cc = compile_case(spec)
    whole = torch.from_numpy(f0)
    for t in range(2):
        whole, _ = K.step_plain(whole, cc, t)
    assert torch.equal(f, whole)


# lbm_tpu's sharded branch list (tests/test_pallas_sharded.py) and the
# lid cavity, split along x
BRANCHES = [
    ("lid_driven_cavity", dict(n=16)),
    ("poiseuille", dict(n=16)),
    ("poiseuille", dict(n=16, collision="trt")),
    ("poiseuille", dict(n=16, force=(0.0, 1e-5, 0.0))),
    ("lid_driven_cavity", dict(n=16, lid="bounceback")),
    ("poiseuille", dict(n=16, collision="mrt")),
    ("poiseuille", dict(n=16, smagorinsky_cs=0.17)),
    ("poiseuille", dict(n=16, rheology={"model": "carreau", "nu0": 0.3,
                                        "nu_inf": 0.02, "lam": 3000.0,
                                        "n": 0.5})),
]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,kw", BRANCHES)
def test_stitched_shards_equal_the_whole_box(name, kw, world):
    """Every collision branch through the halo wrappers, 3 steps on the
    seeded state: the stitched shards and their summed velsums equal the
    whole-box step's, bit for bit (the same arithmetic; only the pull
    across the faces reads the planes)."""
    spec = get_case(name, **kw)
    cc = compile_case(spec)
    f0 = _noisy_initial(cc, seed=1)
    f, vs = _stitched_kernel_route(spec, f0, 0, world, 3)
    whole = torch.from_numpy(f0)
    want = torch.zeros(3, dtype=torch.float64)
    for t in range(3):
        whole, want[t] = K.step_plain(whole, cc, t)
    assert torch.equal(f, whole)
    torch.testing.assert_close(vs, want, rtol=1e-12, atol=0.0)


# tests/test_parallel.py's halo-exchange cases are the same list
HALO_CASES = BRANCHES


@pytest.mark.parametrize("name,kw", HALO_CASES)
def test_dense_halo_step_matches_lbm_tpu_make_halo_step(name, kw):
    """The dense twin's step on 4 shards in one process (what
    make_halo_step runs between exchanges), 7 steps from the seeded
    state, against lbm_tpu's make_halo_step on the 8-device mesh (rtol
    3e-6, atol 1e-7) and bit for bit against the port's whole-box dense
    step."""
    spec = get_case(name, **kw)
    axis = free_axis(spec)
    assert axis == ref_free_axis(ref_get_case(name, **kw))
    cc = compile_case(spec)
    f0 = _noisy_initial(cc, seed=2)
    ccs = [compile_shard(spec, r, 4, axis) for r in range(4)]
    fs = [shard_window(torch.from_numpy(f0), r, 4, axis) for r in range(4)]
    whole, step = torch.from_numpy(f0), make_step(cc)
    for t in range(7):
        planes = ring_planes(fs, axis)
        fs = [step_tail(c, fs[r], pulled_state(c, fs[r], t,
                                               halo=c.halo(*planes[r])))[0]
              for r, c in enumerate(ccs)]
        whole = step(whole, t)[0]
    f = gather_windows(fs, axis, spec.shape[axis])
    assert torch.equal(f, whole)

    ref_cc = ref_compile_case(ref_get_case(name, **kw))
    mesh = ref_lattice_mesh()
    ref_step = jax.jit(ref_make_halo_step(shard_compiled(ref_cc, mesh, axis),
                                          mesh, shard_axis=axis))
    g = jax.device_put(jnp.asarray(f0),
                       lattice_sharding(axis=axis, mesh=mesh, leading=1))
    for t in range(7):
        g = ref_step(g, jnp.int32(t))[0]
    np.testing.assert_allclose(f.numpy(), np.asarray(g), rtol=RTOL,
                               atol=ATOL)


def test_shard_windows_are_the_whole_box_rows():
    """compile_shard on the coronary split along y into 3 (31 rows padded
    to 33): each rank's labels, boundary tables and live-block list are
    the whole box's rows of them, the neighbour rows' labels wrap around
    the ring, the z windows cover their valid cells in local coordinates,
    and the ranks' residual offsets add up to the whole box's."""
    spec = get_case("coronary", shape=(24, 31, 32), radius=4,
                    pulsatile=(4, 8))
    cc = compile_case(spec)
    n, world = 31, 3
    rows = shard_rows(n, world)
    assert rows == 11
    pad = np.pad(np.asarray(spec.mask), ((0, 0), (0, rows * world - n),
                                         (0, 0)))
    offsets = 0.0
    for r in range(world):
        c = compile_shard(spec, r, world, 1)
        assert c.shape == (24, rows, 32)
        assert np.array_equal(c.mask.numpy(), pad[:, r * rows:(r + 1) * rows])
        assert np.array_equal(c.mask_lo.numpy(), pad[:, (r * rows - 1) % 33])
        assert np.array_equal(c.mask_hi.numpy(),
                              pad[:, ((r + 1) * rows) % 33])
        for bc, whole_bc in zip(c.bcs, cc.bcs):
            lat = 1 if bc.axis == 2 else 0  # y among the lateral axes
            want = shard_window(whole_bc.valid, r, world, lat)
            assert torch.equal(bc.valid, want)
            if whole_bc.phi_star_series is not None:
                assert torch.equal(bc.phi_star_series, shard_window(
                    whole_bc.phi_star_series, r, world, lat, lead=2))
            if bc.window is not None:
                x0, x1, y0, y1 = bc.window
                v = bc.valid.any(0)
                assert v.sum() == v[x0:x1, y0:y1].sum() > 0
        offsets += c.velsum_offset
    assert offsets == pytest.approx(cc.velsum_offset, rel=1e-12)


def test_padding_that_would_cut_the_wrap_is_refused():
    """gravity_channel's fluid reaches its z ends (the periodic pull wraps
    there): 16 rows split 3 ways would pad the axis, so compile_shard
    refuses, while 4 ways needs no pad; a boundary on the shard axis is
    refused in lbm_tpu's words."""
    spec = get_case("gravity_channel", n=16, nz=16)
    compile_shard(spec, 0, 4, 2)
    with pytest.raises(ValueError, match="divides 16"):
        compile_shard(spec, 0, 3, 2)
    with pytest.raises(ValueError,
                       match="BC on axis 1 conflicts with shard axis 1"):
        compile_shard(get_case("poiseuille", n=16), 0, 2, 1)


def test_halo_slot_table_is_the_lattice_order():
    """The CUDA source's halo_slot tables: direction i's row in its plane
    is its rank among inbound_dirs(axis, e_axis(i))."""
    import re

    from lbm_tpu_torch.core.lattice import D3Q19
    from lbm_tpu_torch.engine.step import inbound_dirs
    from lbm_tpu_torch.kernels import _build

    src = _build.HEADER.read_text()
    body = src[src.index("constexpr int halo_slot"):]
    for axis, name in ((0, "x"), (1, "y")):
        table = re.search(name + r"\[Q\] = \{([^}]*)\}", body).group(1)
        slots = [int(v) for v in table.split(",")]
        for i in range(1, 19):
            e = int(D3Q19.E[i][axis])
            if e:
                assert slots[i] == inbound_dirs(axis, e).index(i)


def test_halo_wrapper_checks():
    """The halo wrappers refuse planes of the wrong shape or type, bf16
    state, a force field and a z axis."""
    spec = get_case("lid_driven_cavity", n=8)
    c = compile_shard(spec, 0, 2, 0)
    f = initial_f(c)
    lo, hi = edge_planes(f, 0)
    s = torch.zeros(1, dtype=torch.float64)
    K.collide_stream(f, f.clone(), c, s, 0, 0, halo=c.halo(lo, hi))
    bad = [c.halo(lo[:4], hi), c.halo(lo.double(), hi),
           (2,) + c.halo(lo, hi)[1:],
           c.halo(lo, hi)[:3] + (c.mask_lo.int(), c.mask_hi)]
    for halo in bad:
        with pytest.raises(ValueError):
            K.collide_stream(f, f.clone(), c, s, 0, 0, halo=halo)
    with pytest.raises(ValueError, match="float32"):
        fb = f.to(torch.bfloat16)
        K.collide_stream(fb, fb.clone(), c, s, 0, 0, halo=c.halo(lo, hi))


def test_whole_box_dense_step_matches_lbm_tpu_on_the_seeded_state():
    """The reference both sharded routes are held to: the port's whole-box
    dense step against lbm_tpu's on the seeded coronary state, 2 steps."""
    spec = get_case("coronary", **CORONARY)
    cc = compile_case(spec)
    f0 = _noisy_initial(cc)
    ref = jax.jit(ref_make_step(ref_compile_case(ref_get_case(
        "coronary", **CORONARY))))
    g, f = jnp.asarray(f0), torch.from_numpy(f0)
    step = make_step(cc)
    for t in range(2):
        g = ref(g, jnp.int32(t))[0]
        f = step(f, t)[0]
    np.testing.assert_allclose(f.numpy(), np.asarray(g), rtol=RTOL,
                               atol=ATOL)
