"""The ring exchange of a shard's edge planes and the dense halo step
(torch port of lbm_tpu/parallel/halo.py).

Each rank owns a contiguous slab of the shard axis. Per step it sends
its last row's five populations with e_axis = +1 to its high neighbour
(that neighbour's `lo`) and its first row's five with e_axis = -1 to its
low neighbour (its `hi`): only the populations that stream across the
face, 5 of 19. The ring wraps, as jnp.roll does, so rank 0's lo is the
last rank's last row. `edge_rows` cuts any such pair out of a state:
the flow's five (`edge_planes`), the one D3Q7 channel that crosses a
face (engine/scalar.py's sharded transports), one velocity component.
`exchange` does it with one torch.distributed.batch_isend_irecv of four
point-to-point operations; for an x shard a row is contiguous, for a y
shard it is a strided slice packed into a contiguous send buffer. A ring of one is its own
neighbour: its planes are its own rows, taken without a send whatever
the backend (gloo has no send to oneself; NCCL's batch_isend_irecv to
oneself did deliver on the H100, but a copy needs no group).

make_halo_step is the dense twin under a mesh: engine/step.py's dense
step on the rank's window (engine/compile.compile_shard) with the
shard-axis pull spliced from the received planes (lbm_tpu's _pull_ext).
Like lbm_tpu's GSPMD dense path it may shard z (the curved vessel) and
carries Bouzidi curved walls (each shard's links take the whole box's q,
and opp(i)'s pull across a face reads the received planes, so the shards
stay the whole box's step bit for bit). With windkessel (RCR) outlets it
is lbm_tpu's GSPMD windkessel step: each rank sums its part of each
outlet's footprint flux, the ranks' (n_wk,) partials add in rank order
(one small collective a step, LatticeMesh.add_in_rank_order) and every
rank applies the same update to the same sum, so P_c stays replicated.
It refuses a boundary on the shard axis (compile_shard).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from lbm_tpu_torch.engine.compile import ShardCase, has_windkessel
from lbm_tpu_torch.engine.step import (
    inbound_dirs,
    pulled_state,
    pulled_state_wk,
    step_tail,
)
from lbm_tpu_torch.parallel.mesh import LatticeMesh


def edge_rows(x, axis: int, up, down, first: int = 0, last: int = -1):
    """(edge_lo, edge_hi) a shard of a (C, X, Y, Z) state sends: channels
    `up` of its row `last` along lattice axis `axis` (the high
    neighbour's lo) and channels `down` of its row `first` (the low
    neighbour's hi), each a contiguous (len, A, B) tensor."""
    n = x.shape[1 + axis]
    hi_row = x.select(1 + axis, last % n)
    lo_row = x.select(1 + axis, first)
    return hi_row[list(up)].contiguous(), lo_row[list(down)].contiguous()


def edge_planes(f, axis: int):
    """(edge_lo, edge_hi) a shard of the flow sends: its last row's five
    populations with e_axis = +1 (the high neighbour's lo) and its first
    row's five with e_axis = -1 (the low neighbour's hi), each a
    contiguous (5, A, B) tensor."""
    return edge_rows(f, axis, inbound_dirs(axis, 1), inbound_dirs(axis, -1))


class Exchange:
    """The ring exchange of one rank's edge planes, reusing its buffers:
    under gloo with CUDA ranks, pinned host buffers through which the
    planes cross (device to host, synchronise, send and receive, host to
    device, on the current stream), one set for each shape and dtype it
    has carried (a coupled step swaps the flow's and the scalar's planes
    in one exchange, then one velocity component)."""

    def __init__(self, mesh: LatticeMesh):
        self.mesh = mesh
        self._host = {}

    def _staging(self, like):
        key = (tuple(like.shape), like.dtype)
        if key not in self._host:
            self._host[key] = [torch.empty(like.shape, dtype=like.dtype,
                                           pin_memory=True)
                               for _ in range(4)]
        return self._host[key]

    def __call__(self, edge_lo, edge_hi):
        """(lo, hi) this rank receives for the planes it sends."""
        mesh = self.mesh
        if mesh.world == 1:
            return edge_lo, edge_hi
        staged = mesh.staged and edge_lo.is_cuda
        if staged:
            send_lo, send_hi, lo, hi = self._staging(edge_lo)
            send_lo.copy_(edge_lo)
            send_hi.copy_(edge_hi)
            torch.cuda.current_stream(edge_lo.device).synchronize()
        else:
            send_lo, send_hi = edge_lo, edge_hi
            lo, hi = torch.empty_like(edge_lo), torch.empty_like(edge_hi)
        high = (mesh.rank + 1) % mesh.world
        low = (mesh.rank - 1) % mesh.world
        ops = [dist.P2POp(dist.isend, send_lo, high, mesh.group),
               dist.P2POp(dist.irecv, lo, low, mesh.group),
               dist.P2POp(dist.isend, send_hi, low, mesh.group),
               dist.P2POp(dist.irecv, hi, high, mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            return (lo.to(edge_lo.device, non_blocking=True),
                    hi.to(edge_hi.device, non_blocking=True))
        return lo, hi


def exchange(edge_lo, edge_hi, mesh: LatticeMesh):
    """(lo, hi): the low neighbour's edge_lo and the high neighbour's
    edge_hi, around the ring."""
    return Exchange(mesh)(edge_lo, edge_hi)


def ring_planes(states, axis: int) -> list[tuple]:
    """The (lo, hi) each of the ring's shards receives, for all its
    shards' states held in one process (rank order): exchange without a
    process group."""
    edges = [edge_planes(f, axis) for f in states]
    n = len(states)
    return [(edges[(r - 1) % n][0], edges[(r + 1) % n][1]) for r in range(n)]


def make_halo_step(cc: ShardCase, mesh: LatticeMesh,
                   shard_axis: int) -> Callable:
    """The dense step of one rank's window under `mesh`: (f, t) -> (f',
    rho, u), t the absolute step; f' equals the rank's rows of the whole
    box's dense step, bit for bit. With windkessel outlets (f, t, wk) ->
    (f', rho, u, wk'), wk the replicated (n_wk,) fp32 P_c: the outlets'
    flux is the ranks' partials added in rank order, so f' and wk' match
    the whole box's within the rounding of that sum."""
    if not isinstance(cc, ShardCase) or cc.shard_axis != shard_axis \
            or (cc.rank, cc.world) != (mesh.rank, mesh.world):
        raise ValueError("make_halo_step takes this rank's "
                         "compile_shard(spec, mesh.rank, mesh.world, "
                         "shard_axis) window")
    swap = Exchange(mesh)

    if has_windkessel(cc.bcs):
        def step_wk(f, t, wk):
            lo, hi = swap(*edge_planes(f, shard_axis))
            pulled, wk_new = pulled_state_wk(
                cc, f, t, wk, halo=cc.halo(lo, hi),
                reduce=mesh.add_in_rank_order)
            return (*step_tail(cc, f, pulled), wk_new)

        return step_wk

    def step(f, t):
        lo, hi = swap(*edge_planes(f, shard_axis))
        return step_tail(cc, f, pulled_state(cc, f, t, halo=cc.halo(lo, hi)))

    return step


__all__ = ["edge_rows", "edge_planes", "exchange", "Exchange", "ring_planes",
           "make_halo_step"]
