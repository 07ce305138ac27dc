"""The chunked state read (kernels.extract_rows, unpack_state_lowmem,
Simulation(lowmem=True)) and the checkpoints around it held against
lbm_tpu on the CPU: its unpack_state_lowmem on the Pallas state in
interpret mode, and its packed (lowmem) checkpoints, fp32 and bf16."""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cases import get_case as ref_get_case
from lbm_tpu.engine import checkpoint as ref_ckpt
from lbm_tpu.engine.compile import compile_case as ref_compile_case
from lbm_tpu.engine.runner import Simulation as RefSimulation
from lbm_tpu.engine.step import initial_f as ref_initial_f
from lbm_tpu.kernels.collide_stream import (
    make_pallas_step,
    pack_state,
    pad_spec,
    unpack_state_lowmem,
)
from lbm_tpu_torch.cases import get_case
from lbm_tpu_torch.engine import checkpoint as ckpt
from lbm_tpu_torch.engine.runner import LOWMEM_BYTES, Simulation
from lbm_tpu_torch.kernels import collide_stream as K

COR = dict(shape=(24, 20, 32), radius=4)


@pytest.mark.parametrize("shape,rows", [((19, 7, 5, 6), 2),
                                        ((19, 13, 4, 3), 5),
                                        ((19, 3, 8, 8), 3)])
def test_extract_rows_chunks_reassemble_the_state(shape, rows):
    f = torch.from_numpy(np.random.default_rng(2).random(shape,
                                                         dtype=np.float32))
    parts = []
    for x0 in range(0, shape[1], rows):
        w = min(rows, shape[1] - x0)
        part = K.extract_rows_plain(f, x0, w)
        assert part.is_contiguous() and tuple(part.shape) == \
            (19, w) + shape[2:]
        assert torch.equal(K.extract_rows(f, x0, w), part)
        parts.append(part)
    assert torch.equal(torch.cat(parts, dim=1), f)
    with pytest.raises(ValueError, match="rows"):
        K.extract_rows(f, shape[1] - 1, 2)


def test_chunked_read_matches_lbm_tpu_unpack_state_lowmem():
    """Simulation(lowmem=True).f_standard() on a stepped coronary against
    lbm_tpu's unpack_state_lowmem of its Pallas state (in place, interpret
    mode), 2 steps from the same initial state."""
    spec0 = ref_get_case("coronary", **COR)
    spec = pad_spec(spec0)
    cc = ref_compile_case(spec)
    step = jax.jit(make_pallas_step(cc, interpret=True, in_place=True))
    p = pack_state(ref_initial_f(cc), jnp.asarray(np.asarray(cc.spec.mask)))
    for t in range(2):
        p, _ = step(p, jnp.int32(t))
    want = unpack_state_lowmem(p, spec0, ring=1, interpret=True)

    sim = Simulation(get_case("coronary", **COR), device="cpu", lowmem=True)
    assert sim.lowmem
    sim.run(max_steps=2, time_save=2, verbose=False)
    got = sim.f_standard()
    assert got.device.type == "cpu" and got.data_ptr() != sim.f.data_ptr()
    assert torch.equal(got, sim.f)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-6, atol=1e-7)


def test_lowmem_switches_on_above_lbm_tpus_threshold():
    assert LOWMEM_BYTES == 4e9
    assert not Simulation(get_case("lid_driven_cavity", n=16),
                          device="cpu").lowmem
    # 374^3 cells are just below one 4e9-byte buffer, 375^3 above
    assert 19 * 4 * 374**3 < LOWMEM_BYTES < 19 * 4 * 375**3
    assert K.chunk_rows((512, 512, 512)) == 12
    assert K.chunk_rows((4, 9000, 9000)) == 1


def _ref_packed_checkpoint(path, steps, name="coronary", case=COR, **kw):
    """A packed checkpoint of lbm_tpu's lowmem Pallas Simulation after
    `steps` steps (interpret mode)."""
    ref = RefSimulation(ref_get_case(name, **case), backend="pallas",
                        lowmem=True, **kw)
    ref.run(max_steps=steps, time_save=steps, verbose=False)
    ref_ckpt.save_sim(str(path), ref)
    return ref


def test_packed_lbm_tpu_checkpoint_resumes_in_port(tmp_path):
    """lbm_tpu's packed checkpoint is cropped on the host into the port,
    which resumes it as lbm_tpu resumes it into its dense backend (its
    host-cropped restore)."""
    path = tmp_path / "packed.ckpt.npz"
    ref = _ref_packed_checkpoint(path, 2)
    _, _, _, meta = ckpt.load(str(path))
    assert meta["layout"]["packed"] and meta["layout"]["dtype"] == "float32"
    sim = Simulation(get_case("coronary", **COR), device="cpu")
    ckpt.restore(sim, str(path))
    assert sim.t == 2
    assert torch.equal(sim.f, torch.from_numpy(np.asarray(
        ref.f_standard())))
    ref_dense = RefSimulation(ref_get_case("coronary", **COR),
                              backend="xla")
    ref_ckpt.restore(ref_dense, str(path))
    np.testing.assert_array_equal(sim.f.numpy(),
                                  np.asarray(ref_dense.f_standard()))
    sim.run(max_steps=3, time_save=3, verbose=False)
    ref_dense.run(max_steps=3, time_save=3, verbose=False)
    np.testing.assert_allclose(sim.f.numpy(),
                               np.asarray(ref_dense.f_standard()),
                               rtol=3e-6, atol=1e-7)


@pytest.mark.parametrize("store_dtype", ["f32", "bf16"])
def test_packed_bf16_checkpoint_restores(tmp_path, store_dtype):
    """lbm_tpu's packed bf16 checkpoint (its bf16 lowmem run; np.savez
    keeps the bfloat16 words as |V2 void, which lbm_tpu's own restore
    cannot read) restores into a port run of either storage dtype: f is
    the payload widened bit for bit, which is the writer's f_standard()."""
    path = tmp_path / "bf16.ckpt.npz"
    ref = _ref_packed_checkpoint(path, 2, "lid_driven_cavity", dict(n=8),
                                 store_dtype="bf16")
    payload, _, _, meta = ckpt.load(str(path))
    assert meta["layout"]["dtype"] == "bfloat16"
    assert payload.dtype.kind == "V" and payload.dtype.itemsize == 2
    ring = int(meta["layout"]["ring"])
    words = payload.view(np.uint16)[ring:ring + 8, ring:ring + 8, :19, :8]
    widened = (words.astype(np.uint32) << 16).view(np.float32) \
        .transpose(2, 0, 1, 3)
    sim = Simulation(get_case("lid_driven_cavity", n=8), device="cpu",
                     store_dtype=store_dtype)
    ckpt.restore(sim, str(path))
    assert sim.t == 2
    assert sim.f.dtype == (torch.bfloat16 if store_dtype == "bf16"
                           else torch.float32)
    np.testing.assert_array_equal(sim.f_standard().numpy(), widened)
    np.testing.assert_array_equal(sim.f_standard().numpy(),
                                  np.asarray(ref.f_standard()))


def test_bf16_portable_checkpoint_round_trip(tmp_path):
    """A bf16 run saves the portable float32 layout (never |V2) and
    resumes from it bit-equal to an uninterrupted run; the file restores
    into an fp32 run too, as the widened state."""
    spec = get_case("coronary", **COR, pulsatile=(4, 8))
    a = Simulation(spec, device="cpu", store_dtype="bf16")
    a.run(max_steps=3, time_save=3, verbose=False)
    path = str(tmp_path / "bf16.ckpt.npz")
    ckpt.save_sim(path, a)
    f, t, _, meta = ckpt.load(path)
    assert f.dtype == np.float32 and t == 3 and "layout" not in meta
    b = Simulation(spec, device="cpu", store_dtype="bf16")
    ckpt.restore(b, path)
    assert b.t == 3 and torch.equal(b.f, a.f)
    a.run(max_steps=2, time_save=2, verbose=False)
    b.run(max_steps=2, time_save=2, verbose=False)
    assert torch.equal(a.f, b.f) and torch.equal(a._spare, b._spare)
    c = Simulation(spec, device="cpu")
    ckpt.restore(c, path)
    assert c.f.dtype == torch.float32 and torch.equal(c.f, torch.from_numpy(f))


def test_lowmem_checkpoint_round_trip(tmp_path):
    """save -> restore -> 2 more steps under lowmem equals an
    uninterrupted run bit for bit; the file is the portable layout,
    uncompressed, and resumes in lbm_tpu."""
    spec = get_case("coronary", **COR, pulsatile=(4, 8))
    a = Simulation(spec, device="cpu", lowmem=True)
    a.run(max_steps=3, time_save=3, verbose=False)
    path = str(tmp_path / "lowmem.ckpt.npz")
    ckpt.save_sim(path, a)
    with zipfile.ZipFile(path) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    b = Simulation(spec, device="cpu", lowmem=True)
    ckpt.restore(b, path)
    assert b.t == 3 and torch.equal(b.f, a.f)
    a.run(max_steps=2, time_save=2, verbose=False)
    b.run(max_steps=2, time_save=2, verbose=False)
    assert torch.equal(a.f, b.f) and torch.equal(a._spare, b._spare)
    ref = RefSimulation(ref_get_case("coronary", **COR, pulsatile=(4, 8)),
                        backend="xla")
    ref_ckpt.restore(ref, path)
    assert ref.t == 3
