"""The sharded kernel step (torch port of
lbm_tpu/parallel/pallas_sharded.py).

Each rank steps its own window (engine/compile.compile_shard) with the
K1d kernel, in three parts a step:
  1. pack its edge planes (parallel/halo.edge_planes) and send them
     around the ring,
  2. receive its neighbours' planes (one batch_isend_irecv),
  3. launch lbm_collide_stream_halo over its fluid cells, its x/y and
     z-plane boundaries in the one launch: its faces' pulls read the
     received planes (for a z plane's consumer cells too, lbm_tpu's halo
     patch of its z fixup's slab).

The kernels read the pre-step state from the ping-pong source, which
stays intact, so lbm_tpu's TPU-capacity machinery has no counterpart:
the in-place output, the seam rows, the optimization barrier and the
dead-tile filler of shard_tile_lists. A rank launches its own grid over
its own fluid-cell list, so no list is padded to a common length. The
velsum stays per rank; the runner sums the ranks' series once a chunk
(engine/runner.py).
"""

from __future__ import annotations

from typing import Callable

from lbm_tpu_torch.engine.compile import ShardCase
from lbm_tpu_torch.kernels import collide_stream as kernels
from lbm_tpu_torch.parallel.halo import Exchange, edge_planes
from lbm_tpu_torch.parallel.mesh import LatticeMesh


def make_sharded_step(cc: ShardCase, mesh: LatticeMesh,
                      shard_axis: int) -> Callable:
    """step(f, out, series, slot, t): one step of this rank's window f
    into out at absolute step t, series[slot] its fluid velsum. Shards x
    or y (lbm_tpu's kernel path cannot shard z)."""
    if shard_axis not in (0, 1):
        raise ValueError(
            f"backend='kernel' cannot shard along z (shard_axis="
            f"{shard_axis}): lbm_tpu's sharded kernel path shards axis 0 "
            "(x) or 1 (y) only. Cases whose only BC-free axis is z (e.g. "
            "curved_vessel) must use backend='dense' with mesh=.")
    if not isinstance(cc, ShardCase) or cc.shard_axis != shard_axis \
            or (cc.rank, cc.world) != (mesh.rank, mesh.world):
        raise ValueError("make_sharded_step takes this rank's "
                         "compile_shard(spec, mesh.rank, mesh.world, "
                         "shard_axis) window")
    swap = Exchange(mesh)

    def step(f, out, series, slot: int, t: int):
        lo, hi = swap(*edge_planes(f, shard_axis))
        return kernels.step(f, out, cc, series, slot, t,
                            halo=cc.halo(lo, hi))

    return step


__all__ = ["make_sharded_step"]
