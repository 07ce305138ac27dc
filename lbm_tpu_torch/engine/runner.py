"""Host-side simulation loop (torch port of lbm_tpu/engine/runner.py):
chunked stepping, convergence policy, throughput metering.

  - the hot loop advances `time_save` steps per chunk; the per-step
    velsum samples stay on the device in an (n,) float64 buffer that is
    read back once per chunk (the counterpart of lbm_tpu's scan output);
  - flavor 'velsum': per-step residual |s_k - s_{k-1}| / s_k with
    s = sum |u| (+ the non-fluid offset); the run stops once more than
    `stag_max` sub-tolerance steps were counted (the count is never
    reset, as in lbm_tpu);
  - flavor 'usq': windowed residual between consecutive chunks of
    sum u^2 over interior fluid cells;
  - MLUPS in three site conventions (RunResult).

backend='kernel' (default) steps with the CUDA kernels on a CUDA device
and their plain versions on the CPU: one collide-stream launch a step
over the case's fluid cells, its z-plane boundaries included, and the
reduction of its velsum partials. It
refuses, with NotImplementedError, the two compositions the kernel lacks
(compile.kernel_refusal: MRT + force, closure + force) and never moves
to another backend by itself. backend='dense' runs the dense PyTorch
step (engine/step.py), the counterpart of lbm_tpu's 'xla', for every
composition. backend='sparse' runs the live-cell step (engine/sparse.py,
lbm_tpu's 'sparse'): the state is (19, n_live) over the non-DEAD cells
in compaction order; f_standard() scatters it (zeros at DEAD cells),
set_f_standard() gathers the live cells of a dense state, macro()
scatters the live cells' moments (rho 1, u 0 at DEAD cells). It refuses
what lbm_tpu's refuses, in lbm_tpu's words: a mesh, bf16 storage, and
the kernel backend's fuse=2 and lowmem. Bouzidi curved walls
(CaseSpec.wall_sdf) run on 'dense' and 'sparse'; the kernel backend
refuses them in lbm_tpu's words (compile.kernel_refusal). Every step gets
its absolute index, so a series boundary's phase continues across chunks
and resumed runs.

fuse=2 (kernel backend) advances a chunk of n steps as n // 2 launches of
the fused pair (two steps per read and write of the state) and one
single step for an odd tail, lbm_tpu's chunk shape; it refuses, with
ValueError in lbm_tpu's words, a case with a z-plane boundary, lowmem and
the dense backend. lowmem (auto above LOWMEM_BYTES of one state buffer,
lbm_tpu's per-device threshold) makes f_standard() read the state to host
memory in x-row chunks (kernels.unpack_state_lowmem) and checkpoints go
uncompressed. A checkpoint written on any backend restores on any other
(the portable dense layout).

Windkessel (RCR) outlets (PlaneBC.windkessel) carry their P_c in
`Simulation.wk`, an (n_wk,) float32 tensor on the run's device, set at
reset() from the outlets' windkessel_p0 and stepped on the device: by the
collide-stream launch with the outlets' flux folded in (its reduction
commits P_c and stages the next step's flux; the flux kernel,
kernels.windkessel_prime, primes it once at the start of each chunk) or
by the dense or sparse step (make_step_wk, make_sparse_step_wk); a chunk
reads nothing of it to the host. Checkpoints carry it
(engine/checkpoint.py), and stress(), wss() and wss_accumulator()
re-apply the outlets with it.

wss() and wss_accumulator() take lbm_tpu's route: the live-cell stress
(engine/stress.wss_sparse) on the sparse backend always, and on the
kernel backend once the dense pull's five (19, X, Y, Z) fp32 arrays
would pass 6e9 bytes (5 * 19 * 4 * cells > 6e9, the full coronary and
up), the live cells' populations gathered straight out of the state
(`_sparse_cc_f`); otherwise, and for stress(), the dense pull.

store_dtype='bf16' (kernel backend) stores the state in bfloat16 at half
the bytes; the kernels compute in fp32, widening every load and
narrowing every store once (lbm_tpu's bf16 storage, bit for bit). The
dense backend refuses it in lbm_tpu's words, and the lowmem threshold
counts 4 bytes a population whatever the storage, as lbm_tpu's does.

mesh= (a parallel/mesh.LatticeMesh) splits the box along shard_axis
(default: the first axis without a boundary plane) over the group's
ranks, each holding only its window (engine/compile.compile_shard) on
its own device; every rank constructs the Simulation and calls run,
f_standard, set_f_standard and macro together. The kernel backend steps
with the sharded K1d kernels (parallel/sharded.py), the dense backend
with the halo step (parallel/halo.py). run() sums the ranks' velsum
series once a chunk, in rank order on the host, so every rank takes the
same stop decision; f_standard() and macro() gather the whole box on
every rank, f_standard() with zeros at DEAD cells (lbm_tpu's sharded
unblock contract). Windkessel outlets run under a mesh on the dense
backend, lbm_tpu's GSPMD windkessel route (parallel/halo.make_halo_step's
windkessel form): the outlets' flux partials add across ranks in rank
order once a step, every rank carries the same P_c, and run() checks at
the end of each chunk that every rank's wk is equal bit for bit. Refused
under a mesh, in lbm_tpu's words: bf16 storage, fuse=2, the kernel
backend on z, a boundary on the shard axis, lowmem (its chunked read is
single-device) and windkessel outlets on the kernel backend.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from lbm_tpu_torch.engine.compile import (
    canonical_device,
    compile_case,
    compile_shard,
    fuse2_refusal,
    has_windkessel,
    kernel_refusal,
    wk_init,
)
from lbm_tpu_torch.engine.spec import CaseSpec
from lbm_tpu_torch.engine.step import (
    fluid_speed_sum,
    init_override,
    initial_f,
    macro_fields,
    make_step,
    make_step_wk,
)
from lbm_tpu_torch.geometry.mask import CellType
from lbm_tpu_torch.kernels import collide_stream as kernels

# One state buffer above this many bytes turns lowmem on (lbm_tpu's
# per-device threshold, engine/runner.py): 375^3 cells and up.
LOWMEM_BYTES = 4e9


def store_dtype_of(store_dtype) -> torch.dtype:
    """The torch dtype of a store_dtype argument (lbm_tpu's names: None,
    'f32', 'fp32', 'float32', 'bf16', 'bfloat16'); ValueError in lbm_tpu's
    words for anything else."""
    if store_dtype in (None, "f32", "fp32", "float32"):
        return torch.float32
    if store_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"store_dtype must be f32 or bf16, got {store_dtype}")


@dataclasses.dataclass
class RunResult:
    """mlups counts non-DEAD sites (the reference's NLATTICE convention),
    mlups_live fluid cells only, mlups_box the full box (the dense
    cavity's raw-grid throughput). velsum_series holds this run's
    per-step velsum samples (offset included) for the 'velsum' flavor."""

    steps: int
    residual: float
    residual_history: list
    elapsed_s: float
    mlups: float
    converged: bool
    mlups_live: float = 0.0
    mlups_box: float = 0.0
    velsum_series: Optional[np.ndarray] = None


def _interior_region(shape):
    nx, ny, nz = shape
    return (slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1))


def mesh_refusal(backend: str, fuse: int, lowmem, store_dtype: torch.dtype,
                 shard_axis: int, windkessel: bool = False):
    """Why a run under a mesh cannot take these options (ValueError), in
    lbm_tpu's words, or None."""
    if windkessel and backend == "kernel":
        return ("the sharded kernel path does not thread the windkessel "
                "P_c carry yet — use backend='dense' with mesh= (GSPMD "
                "windkessel is supported there), or a single-chip kernel "
                "run")
    if store_dtype == torch.bfloat16:
        return ("store_dtype='bf16' is single-chip for now (the sharded "
                "z-fixup path computes in the storage dtype)")
    if fuse == 2:
        return ("fuse=2 requires a single-chip run with all NEE boundaries "
                "on x/y planes")
    if lowmem:
        return ("lowmem's chunked read of the state is single-device "
                "(lbm_tpu reads a sharded state through its gather)")
    if backend == "kernel" and shard_axis == 2:
        return ("backend='kernel' cannot shard along z (the sharded kernel "
                "path shards axis 0 (x) or 1 (y) only). This case's only "
                "BC-free axis is z — use backend='dense' with mesh=.")
    return None


def resolve_device(device) -> torch.device:
    """The canonical torch.device, refusing CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return canonical_device(device)


class Simulation:
    """One case on one device.

    The state `f` is (19, nx, ny, nz) float32, z contiguous — the layout
    of lbm_tpu's dense backend and of the portable checkpoint — or
    bfloat16 with store_dtype='bf16'. The kernel
    backend keeps a second buffer of the same shape and swaps the two
    each launch. The kernels load and store fluid cells only, so the two
    buffers must hold equal non-fluid state, and every writer of the state
    writes both: reset() (initial_f and its clone), set_f_standard()
    (checkpoint.restore calls it) and, under a mesh, compile_shard's
    window with set_f_standard's shard_window.
    fuse: 1, or 2 for two fused steps per launch; lowmem: None (auto), or
    force the chunked host read of f_standard() on or off; store_dtype:
    None/'f32' or 'bf16' (kernel backend). mesh, shard_axis: a sharded
    run (see the module docstring); device must then name the mesh's
    device type, and the state lives on mesh.device.
    """

    def __init__(self, spec: CaseSpec, device="cuda", backend: str = "kernel",
                 fuse: int = 1, lowmem: Optional[bool] = None,
                 store_dtype=None, mesh=None, shard_axis: Optional[int] = None):
        if backend not in ("kernel", "dense", "sparse"):
            raise ValueError("backend must be 'kernel', 'dense' or 'sparse': "
                             f"{backend!r}")
        self.store_dtype = store_dtype_of(store_dtype)
        if self.store_dtype == torch.bfloat16 and backend != "kernel":
            raise ValueError(
                "store_dtype='bf16' is a packed-Pallas-state feature; the "
                "dense/sparse backends keep fp32 state")
        if fuse not in (1, 2):
            raise ValueError(f"fuse must be 1 or 2: {fuse!r}")
        if fuse == 2 and backend != "kernel":
            raise ValueError("fuse=2 runs the kernel backend's fused pair of "
                             f"steps; backend={backend!r} has none")
        if backend == "sparse" and mesh is not None:
            raise ValueError(
                "backend='sparse' is single-device: the gather/scatter index "
                "space has no spatial shard decomposition. Use "
                "backend='dense' or backend='kernel' (mesh=) for multi-chip "
                "runs.")
        if backend == "sparse" and lowmem:
            raise ValueError("lowmem is the kernel backend's chunked read of "
                             "the dense state; backend='sparse' holds the "
                             "live cells only")
        if backend == "kernel":
            reason = kernel_refusal(spec)
            if reason is not None:  # before compiling (link_q, lists)
                raise NotImplementedError(reason)
        self.mesh = mesh
        self.shard_axis = None
        if mesh is not None:
            from lbm_tpu_torch.parallel.mesh import free_axis

            self.shard_axis = (free_axis(spec) if shard_axis is None
                               else shard_axis)
            reason = mesh_refusal(backend, fuse, lowmem, self.store_dtype,
                                  self.shard_axis,
                                  has_windkessel(spec.boundaries))
            if reason is not None:
                raise ValueError(reason)
            if resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r}, but the mesh's ranks "
                                 f"run on {mesh.device.type}")
            lowmem = False
        elif shard_axis is not None:
            raise ValueError("shard_axis= needs mesh=")
        self.lowmem = (backend == "kernel"
                       and 19 * 4 * int(np.prod(spec.shape)) > LOWMEM_BYTES
                       if lowmem is None else bool(lowmem))
        if fuse == 2:
            reason = fuse2_refusal(spec, self.lowmem)
            if reason is not None:
                raise ValueError(reason)
        self.fuse = fuse
        self.backend = backend
        self.spec = spec
        self.sc = None
        if backend == "sparse":
            from lbm_tpu_torch.engine.sparse import compile_sparse

            self.device = resolve_device(device)
            self.sc = compile_sparse(spec, self.device)
            self.cc = None
        elif mesh is None:
            self.device = resolve_device(device)
            self.cc = compile_case(spec, self.device)
        else:
            self.device = mesh.device
            self.cc = compile_shard(spec, mesh.rank, mesh.world,
                                    self.shard_axis, self.device)
        if backend == "kernel":
            kernels.collision_descriptor(self.cc)  # refuses what it lacks
            if self.device.type == "cuda" and not has_windkessel(
                    self.cc.bcs):
                # the launch tables: set-up, not the first chunk's time
                if self.store_dtype == torch.bfloat16:
                    kernels.pair_launch(self.cc)
                elif self.cc.fluid_cells is not None:
                    _ = self.cc.fluid_launch
        self._step = self._make_step()
        self._usq_fn: Optional[Callable] = None
        self.reset()

    def _make_step(self):
        """The step the backend and mesh call for: None for the
        whole-box kernel route (kernels.step)."""
        if self.backend == "sparse":
            from lbm_tpu_torch.engine.sparse import (
                make_sparse_step,
                make_sparse_step_wk,
            )

            return (make_sparse_step_wk(self.sc)
                    if has_windkessel(self.sc.bcs)
                    else make_sparse_step(self.sc))
        if self.mesh is None:
            if self.backend != "dense":
                return None
            return (make_step_wk(self.cc) if has_windkessel(self.cc.bcs)
                    else make_step(self.cc))
        if self.backend == "dense":
            from lbm_tpu_torch.parallel.halo import make_halo_step

            return make_halo_step(self.cc, self.mesh, self.shard_axis)
        from lbm_tpu_torch.parallel.sharded import make_sharded_step

        return make_sharded_step(self.cc, self.mesh, self.shard_axis)

    def _gather(self, t, lead: int):
        """A window field of `lead` leading dims as the whole box's, on
        every rank (the pad rows cut)."""
        whole = self.mesh.all_gather(t, dim=lead + self.shard_axis)
        return whole.narrow(lead + self.shard_axis, 0,
                            self.spec.shape[self.shard_axis])

    @property
    def case(self):
        """The compiled case the state is stepped on: the SparseCase on the
        sparse backend, the CompiledCase (a ShardCase under a mesh)
        otherwise."""
        return self.sc if self.sc is not None else self.cc

    # -- state ------------------------------------------------------------
    def reset(self):
        if self.sc is not None:
            from lbm_tpu_torch.engine.sparse import initial_f_sparse

            self.f = initial_f_sparse(self.sc)
        else:
            # fp32 feq, then narrowed (lbm_tpu's pack_state dtype=):
            # non-fluid cells hold the rounded feq for good
            self.f = initial_f(self.cc).to(self.store_dtype)
        self._spare = self.f.clone() if self.backend == "kernel" else None
        self.t = 0
        # the windkessel outlets' carried P_c, in boundary order
        w0 = wk_init(self.case.bcs)
        self.wk = (None if w0 is None
                   else torch.from_numpy(w0).to(self.device))
        self._last_velsum: Optional[float] = None
        self._last_usq: Optional[float] = None
        # run()'s cell counts (non-solid, FLUID, box), made on its first
        # call: two passes over the box's mask on the host took tens of
        # ms a run at 291x291x372, which timed short runs read as steps
        self._cell_counts: Optional[tuple[int, int, int]] = None

    def f_standard(self):
        """f in the portable (19, nx, ny, nz) float32 layout: the state
        itself (a bf16 state widened), or under lowmem a copy in host
        memory read in x-row chunks. Under a mesh the whole box gathered
        on every rank, zeros at DEAD cells; on the sparse backend the live
        cells scattered, zeros at DEAD cells."""
        if self.lowmem:
            return kernels.unpack_state_lowmem(self.f)
        if self.sc is not None:
            from lbm_tpu_torch.engine.sparse import scatter_dense

            return scatter_dense(self.sc, self.f)
        if self.mesh is not None:
            return self._gather(self.window_standard(), 1)
        return self.f.float()

    def window_standard(self):
        """Under a mesh, this rank's part of f_standard(), not gathered:
        its window in float32 with zeros at DEAD cells (pad rows
        included)."""
        if self.mesh is None:
            raise ValueError("window_standard() is a sharded run's")
        dead = (self.cc.mask == CellType.DEAD)[None]
        return torch.where(dead, 0.0, self.f)

    def set_f_standard(self, f):
        """Load a (19, nx, ny, nz) state (array or tensor) into both
        buffers, narrowed to the storage dtype; the simulation keeps its
        own copies, since stepping writes into them. Both, since the
        kernels never write a non-fluid cell. The sparse backend keeps the
        live cells, in compaction order."""
        f = torch.as_tensor(f, dtype=torch.float32)
        if tuple(f.shape) != (19,) + tuple(self.spec.shape):
            raise ValueError(f"state shape {tuple(f.shape)} != "
                             f"(19, *{tuple(self.spec.shape)})")
        if self.sc is not None:
            from lbm_tpu_torch.engine.sparse import gather_live

            self.f = gather_live(self.sc, f).to(self.device).contiguous()
            return
        if self.mesh is not None:
            from lbm_tpu_torch.bridge import shard_window

            f = shard_window(f, self.mesh.rank, self.mesh.world,
                             self.shard_axis)
        self.f = f.to(self.device, copy=True).to(self.store_dtype) \
            .contiguous()
        if self.backend == "kernel":
            self._spare = self.f.clone()

    def macro(self):
        """(rho, u) persistent macroscopic fields (lattice units): moments
        at fluid cells, the init values elsewhere; under a mesh the whole
        box's, on every rank."""
        rho, u = self._window_macro()
        if self.mesh is None:
            return rho, u
        return self._gather(rho, 0), self._gather(u, 1)

    # -- wall outputs (engine/stress.py) ----------------------------------
    def _dense_cc_f(self):
        """(compiled whole box, its fp32 state) for the stress outputs: the
        run's own case and state, or under a mesh (or on the sparse
        backend) the whole box compiled once on this device and the
        gathered (scattered) state."""
        if self.mesh is None and self.cc is not None:
            return self.cc, self.f.float()
        if getattr(self, "_stress_cc", None) is None:
            self._stress_cc = compile_case(self.spec, self.device)
        return self._stress_cc, self.f_standard()

    def _wss_via_sparse(self) -> bool:
        """lbm_tpu's wss() route: the live-cell stress on the sparse backend,
        and on the kernel backend once the dense pull (about five (19, X,
        Y, Z) fp32 arrays) would pass 6e9 bytes."""
        if self.backend == "sparse":
            return True
        if self.backend != "kernel":
            return False
        return 5 * 19 * 4 * int(np.prod(self.spec.shape)) > 6e9

    def _sparse_cc_f(self):
        """(SparseCase, its fp32 (19, n_live) state) for the live-cell
        stress: the run's own, or on the kernel backend a SparseCase
        compiled once and the live cells' populations gathered straight
        out of the (19, X, Y, Z) state (one index_select, widened to fp32
        after the gather; under a mesh out of the gathered box): no dense
        pull is built."""
        if self.sc is not None:
            return self.sc, self.f
        if self.backend != "kernel":
            raise ValueError("the live-cell stress route is the sparse and "
                             "kernel backends'")
        from lbm_tpu_torch.engine.sparse import compile_sparse, gather_live

        if getattr(self, "_stress_sc", None) is None:
            self._stress_sc = compile_sparse(self.spec, self.device)
        sc = self._stress_sc
        f = self.f if self.mesh is None else self.f_standard()
        return sc, gather_live(sc, f).float()

    def _normals_sparse(self, sc):
        if getattr(self, "_wss_normals_sparse", None) is None:
            from lbm_tpu_torch.engine.stress import compact_normals, wall_normals

            self._wss_normals_sparse = compact_normals(
                sc, wall_normals(self.spec.mask, self.spec.wall_sdf))
        return self._wss_normals_sparse

    def _normals(self, cc):
        if getattr(self, "_wss_normals", None) is None:
            from lbm_tpu_torch.engine.stress import wall_normals

            self._wss_normals = torch.from_numpy(wall_normals(
                self.spec.mask, self.spec.wall_sdf)).to(cc.device)
        return self._wss_normals

    def stress(self):
        """(sigma6, rho, u) deviatoric-stress outputs of the current state
        (engine/stress.stress_fields, lattice units) on the run's device,
        from the dense pre-collision pull with sim.wk: an output-rate
        operation (about five (19, X, Y, Z) fp32 arrays at once)."""
        from lbm_tpu_torch.engine.stress import stress_fields

        cc, f = self._dense_cc_f()
        return stress_fields(cc, f, self.t, wk=self.wk)

    def wss(self):
        """(X, Y, Z) wall shear stress magnitude (lattice units; times
        units.C_pre for Pa), nonzero at wall-adjacent fluid cells (the
        wall normals are built once); through the live-cell stress where
        _wss_via_sparse says, where only this field goes dense."""
        from lbm_tpu_torch.engine.stress import wss_field

        if self._wss_via_sparse():
            from lbm_tpu_torch.engine.sparse import scatter_dense
            from lbm_tpu_torch.engine.stress import wss_sparse

            sc, f_s = self._sparse_cc_f()
            return scatter_dense(sc, wss_sparse(
                sc, f_s, self.t, self._normals_sparse(sc), wk=self.wk))
        cc, f = self._dense_cc_f()
        return wss_field(cc, f, self.t, self._normals(cc), wk=self.wk)

    def wss_accumulator(self):
        """A WSSAccumulator (TAWSS and OSI) bound to this run's case, or a
        SparseWSSAccumulator where wss() takes the live-cell route; call
        acc.sample_sim(self) at each sampling time (tawss_field() and
        osi_field() are (X, Y, Z) either way)."""
        from lbm_tpu_torch.engine.stress import (
            SparseWSSAccumulator,
            WSSAccumulator,
        )

        if self._wss_via_sparse():
            sc, _ = self._sparse_cc_f()
            return SparseWSSAccumulator(sc, self._normals_sparse(sc))
        cc, _ = self._dense_cc_f()
        return WSSAccumulator(cc, self._normals(cc))

    def _window_macro(self):
        """macro() of the state this process holds (its window under a
        mesh)."""
        if self.sc is not None:
            from lbm_tpu_torch.engine.sparse import (
                macro_fields_sparse,
                scatter_dense,
            )

            rho, u = macro_fields_sparse(self.sc, self.f)
            return (scatter_dense(self.sc, rho, fill=1.0),
                    scatter_dense(self.sc, u))
        if self.backend == "dense":
            return macro_fields(self.cc, self.f)
        return init_override(self.cc, *kernels.macro(self.f, self.cc.force))

    # -- stepping ---------------------------------------------------------
    def _advance(self, n: int) -> np.ndarray:
        """n steps; returns the n velsum samples (offset included) with one
        device-to-host read."""
        series = torch.empty(n, dtype=torch.float64, device=self.device)
        pairs = n // 2 if self.fuse == 2 else 0
        for k in range(0, 2 * pairs, 2):
            kernels.step2(self.f, self._spare, self.cc, series, k, self.t + k)
            self.f, self._spare = self._spare, self.f
        for k in range(2 * pairs, n):
            if self.backend != "kernel":
                if self.wk is None:
                    self.f, _, u = self._step(self.f, self.t + k)
                else:
                    self.f, _, u, self.wk = self._step(self.f, self.t + k,
                                                       self.wk)
                series[k] = fluid_speed_sum(self.case, u)
                continue
            if self.mesh is None:
                # a chunk primes the windkessel fold once, whatever
                # happened to the state between chunks
                kernels.step(self.f, self._spare, self.cc, series, k,
                             self.t + k, wk=self.wk, prime=k == 0)
            else:
                self._step(self.f, self._spare, series, k, self.t + k)
            self.f, self._spare = self._spare, self.f
        self.t += n
        samples = series.cpu().numpy() + self.case.velsum_offset
        if self.mesh is not None:
            if self.wk is not None and not self.mesh.same_on_every_rank(
                    self.wk):
                raise RuntimeError(
                    f"rank {self.mesh.rank}: the ranks' windkessel P_c "
                    f"differ at step {self.t} (this rank's "
                    f"{self.wk.tolist()}): the replicated carry drifted")
            return self.mesh.sum_in_rank_order(samples)
        return samples

    def _usq_value(self) -> float:
        """The 'usq' residual sample: sum of u^2 over interior fluid cells
        (plus static outlet-label cells when the spec counts them); under
        a mesh each rank sums its own rows and the ranks' sums add in rank
        order."""
        if self.mesh is not None:
            return self._usq_value_sharded()
        if self._usq_fn is None:
            spec = self.spec
            region = _interior_region(spec.shape)
            mask_r = np.asarray(spec.mask)[region]
            fluid_r = torch.from_numpy(mask_r == 4).to(self.device)
            offset = 0.0
            if spec.usq_includes_outlet_labels:
                u0_r = np.asarray(spec.u0)[(slice(None),) + region]
                offset = float(np.sum(np.sum(u0_r**2, axis=0)[mask_r > 4],
                                      dtype=np.float64))

            def usq(u):
                ur = u[(slice(None),) + region]
                usq_f = ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2]
                return float(torch.where(fluid_r, usq_f, 0.0).sum(
                    dtype=torch.float64)) + offset

            self._usq_fn = usq
        return self._usq_fn(self.macro()[1])

    def _usq_value_sharded(self) -> float:
        if self._usq_fn is None:
            from lbm_tpu_torch.bridge import shard_window

            spec = self.spec
            region = _interior_region(spec.shape)
            mask = np.asarray(spec.mask)
            sel = np.zeros(mask.shape, bool)
            sel[region] = mask[region] == CellType.FLUID
            sel = torch.from_numpy(shard_window(
                sel, self.mesh.rank, self.mesh.world, self.shard_axis,
                lead=0)).to(self.device)
            offset = 0.0
            if spec.usq_includes_outlet_labels:
                mask_r = mask[region]
                u0_r = np.asarray(spec.u0)[(slice(None),) + region]
                offset = float(np.sum(np.sum(u0_r**2, axis=0)[mask_r > 4],
                                      dtype=np.float64))

            def usq(u):
                usq_f = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
                own = torch.where(sel, usq_f, 0.0).sum(dtype=torch.float64)
                total = self.mesh.sum_in_rank_order([float(own)])
                return float(total[0]) + offset

            self._usq_fn = usq
        return self._usq_fn(self._window_macro()[1])

    # -- main loop ----------------------------------------------------------
    def run(
        self,
        max_steps: Optional[int] = None,
        time_save: Optional[int] = None,
        tol: Optional[float] = None,
        stag_max: Optional[int] = None,
        on_save: Optional[Callable] = None,
        verbose: bool = True,
    ) -> RunResult:
        spec = self.spec
        max_steps = spec.max_steps if max_steps is None else max_steps
        time_save = spec.time_save if time_save is None else time_save
        tol = spec.tol if tol is None else tol
        stag_max = spec.stag_max if stag_max is None else stag_max
        flavor = spec.residual_flavor

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_start = time.perf_counter()
        tol_count = 0
        residual = float("inf")
        history: list[float] = []
        samples: list[np.ndarray] = []
        converged = False
        steps_done_at_start = self.t

        while self.t < steps_done_at_start + max_steps:
            n = min(time_save, steps_done_at_start + max_steps - self.t)
            s_series = self._advance(n)
            if flavor == "velsum":
                samples.append(s_series)
                prev = self._last_velsum
                for s in s_series:
                    if prev is not None and s != 0:
                        r = abs(s - prev) / s
                        if r <= tol:
                            tol_count += 1
                        residual = float(r)
                    prev = float(s)
                self._last_velsum = prev
            else:  # 'usq'
                s = self._usq_value()
                if self._last_usq is not None and s != 0:
                    residual = abs(self._last_usq - s) / s
                self._last_usq = s

            history.append(residual)
            elapsed = time.perf_counter() - t_start
            if verbose:
                print(
                    f"ITERATION # {self.t}, collapse time: "
                    f"{elapsed*1e3:.1f} ms, residual: {residual:.3e}"
                )
            if on_save is not None:
                on_save(self, self.t, residual)
            if flavor == "velsum" and tol_count > stag_max:
                converged = True
                break

        elapsed = time.perf_counter() - t_start
        steps = self.t - steps_done_at_start
        rate = steps / max(elapsed, 1e-12) / 1e6
        if self._cell_counts is None:
            mask = np.asarray(spec.mask)
            self._cell_counts = (int((mask != 0).sum()),
                                 int((mask == 4).sum()),
                                 int(np.prod(spec.shape)))
        n_cells, n_fluid, n_box = self._cell_counts
        return RunResult(
            steps=steps,
            residual=residual,
            residual_history=history,
            elapsed_s=elapsed,
            mlups=n_cells * rate,
            converged=converged,
            mlups_live=n_fluid * rate,
            mlups_box=n_box * rate,
            velsum_series=(np.concatenate(samples) if samples else None),
        )


__all__ = ["Simulation", "RunResult", "resolve_device", "LOWMEM_BYTES"]
