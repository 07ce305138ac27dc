// The fp32 collide-stream step over a vessel's fluid cells (K1b and K1c
// over the list: collide_stream_list_kernel of collide_stream_list.cuh,
// its 18 collision-branch instances, each with the z planes' code), the
// C entry of the launch that kernels/collide_stream.py makes whenever a
// whole-box fp32 case has a fluid-cell list. Its own translation unit, so
// nvcc builds it beside collide_stream.cu (whose box instances keep their
// code) and the other units (kernels/_build.py).

#include "collide_stream_list.cuh"

extern "C" {

int lbm_list_block_size() { return kListBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lbm_collide_stream's arguments with the launch tables
// (engine/compile.FluidLaunch) in place of the mask: segs (n_segs, 2)
// int32, links (kSegLanes n_segs) int32, moving the same or null (without
// moving walls).
int lbm_collide_stream_list(const float* src, float* dst, int nx, int ny,
                            int nz, const int* coll_int,
                            const float* coll_float, int n_bc,
                            const int* bc_int, const float* bc_float,
                            const void* const* valid_ptrs,
                            const void* const* phi_ptrs, const int* segs,
                            const int* links, const int* moving, int n_segs,
                            double* partials, int n_partials, double* series,
                            int t, const float* gfield, void* stream) {
  return collide_stream_list<float>(
      src, dst, nx, ny, nz, coll_int, coll_float, n_bc, bc_int, bc_float,
      valid_ptrs, phi_ptrs, segs, links, moving, n_segs, partials,
      n_partials, series, t, gfield, stream);
}

}  // extern "C"
