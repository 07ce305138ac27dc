// The sharded collide-stream step (K1d, with its z planes) on fp32 state:
// the kernel of collide_stream.cuh over a shard's box and the list kernel
// of collide_stream_list.cuh over its fluid cells, with HALO =
// LBM_HALO_AXIS, 0 for a shard of a box split along x and 1 for one split
// along y, each in the 14 collision-branch instances lbm_tpu's sharded
// path takes (every fp32 branch but the force field's). kernels/_build.py
// compiles this source twice, with -DLBM_HALO_AXIS=0 and =1, into two
// shared objects built beside the others, and the unsharded instances of
// collide_stream.cu keep their code, registers and spills.
//
// lbm_collide_stream_halo replaces lbm_tpu/kernels/collide_stream.py::
// _kernel's halo_axis branch (its halo operands :1386-1406, the ring-row
// DMAs :1453-1531 and _HaloSplitCopy :1610-1643, called by
// parallel/pallas_sharded.py through _pallas_bulk's lo/hi operands
// :1964-2026): the step of one shard of L rows along the shard axis,
// whose sources beyond its own rows come from the two planes its ring
// neighbours sent (the five populations that stream across each face,
// and the two neighbour rows' labels, which are static). Every other
// source wraps as in the whole-box kernel, and a bounce-back off a
// neighbour's wall reads the cell's own opposite population. The TPU
// kernel copies the ring rows into its VMEM tile by DMA from the shard or
// the plane, whichever a per-tile predicate picks; here the pull of a
// face cell reads the plane directly (two compares a shard-axis
// direction, folded away for the other nine). The same launch replaces
// the sharded z fixup (pallas_sharded.py:380-465: the pre-step slab, its
// shard-edge rows patched from the planes, and the splice): a z plane's
// consumer cells on the shard's faces pull from the planes like any
// other cell.
//
// What bounds it: bytes, as the whole-box kernel: the local step's bytes
// plus the two 5-population planes and their labels, which are 5/19 of
// one row of the state each. The exchange that fills the planes runs
// before the launch, outside the kernel (parallel/sharded.py).

#include "collide_stream_list.cuh"

#if !defined(LBM_HALO_AXIS) || (LBM_HALO_AXIS != 0 && LBM_HALO_AXIS != 1)
#error "build with -DLBM_HALO_AXIS=0 (x shards) or -DLBM_HALO_AXIS=1 (y)"
#endif

namespace {

Halo make_halo(const float* lo, const float* hi, const int8_t* mask_lo,
               const int8_t* mask_hi) {
  Halo h;
  h.lo = lo;
  h.hi = hi;
  h.mask_lo = mask_lo;
  h.mask_hi = mask_hi;
  return h;
}

}  // namespace

extern "C" {

int lbm_block_size() { return kBlock; }

int lbm_list_block_size() { return kListBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lbm_collide_stream's arguments (no force field) plus the shard axis
// (0: x, 1: y; the unit's LBM_HALO_AXIS, or the call is refused) and its
// halo planes: lo, hi (5, A, B) fp32, mask_lo, mask_hi (A, B) int8, with
// (A, B) = (ny, nz) or (nx, nz) of the local box (nx, ny, nz). The step
// over the shard's box: a shard with a fluid-cell list launches
// lbm_collide_stream_halo_list.
int lbm_collide_stream_halo(const float* src, float* dst, const int8_t* mask,
                            int nx, int ny, int nz, const int* coll_int,
                            const float* coll_float, int n_bc,
                            const int* bc_int, const float* bc_float,
                            const void* const* valid_ptrs,
                            const void* const* phi_ptrs, double* partials,
                            int n_partials, double* series, int t,
                            int halo_axis, const float* lo, const float* hi,
                            const int8_t* mask_lo, const int8_t* mask_hi,
                            void* stream) {
  if (halo_axis != LBM_HALO_AXIS) return (int)cudaErrorInvalidValue;
  return collide_stream<float, LBM_HALO_AXIS>(
      src, dst, mask, nx, ny, nz, coll_int, coll_float, n_bc, bc_int,
      bc_float, valid_ptrs, phi_ptrs, nullptr, 0, partials, n_partials,
      series, t, nullptr, stream, make_halo(lo, hi, mask_lo, mask_hi));
}

// The same step over the shard's fluid cells (collide_stream_list.cuh):
// lbm_collide_stream_list's arguments plus the shard axis and its planes.
int lbm_collide_stream_halo_list(const float* src, float* dst, int nx,
                                 int ny, int nz, const int* coll_int,
                                 const float* coll_float, int n_bc,
                                 const int* bc_int, const float* bc_float,
                                 const void* const* valid_ptrs,
                                 const void* const* phi_ptrs,
                                 const int* segs, const int* links,
                                 const int* moving, int n_segs,
                                 double* partials, int n_partials,
                                 double* series, int t, int halo_axis,
                                 const float* lo, const float* hi,
                                 const int8_t* mask_lo,
                                 const int8_t* mask_hi, void* stream) {
  if (halo_axis != LBM_HALO_AXIS) return (int)cudaErrorInvalidValue;
  return collide_stream_list<float, LBM_HALO_AXIS>(
      src, dst, nx, ny, nz, coll_int, coll_float, n_bc, bc_int, bc_float,
      valid_ptrs, phi_ptrs, segs, links, moving, n_segs, partials,
      n_partials, series, t, nullptr, stream,
      make_halo(lo, hi, mask_lo, mask_hi));
}

}  // extern "C"
