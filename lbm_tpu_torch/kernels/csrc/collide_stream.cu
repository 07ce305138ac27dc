// The collide-stream (K1a + K1b + K1c, K1e, with the z planes of K5 + K6)
// and moments (K3) kernels on fp32 state: the C entries of collide_stream.cuh
// with S = float. Every pointer and the stream cross as void*-sized
// ctypes values (kernels/_build.py); each entry returns cudaGetLastError()
// or cudaErrorInvalidValue for a malformed call.

#include "collide_stream.cuh"

extern "C" {

int lbm_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The step over the box: a case with a fluid-cell list launches
// lbm_collide_stream_list (collide_stream_list.cu).
int lbm_collide_stream(const float* src, float* dst, const int8_t* mask,
                       int nx, int ny, int nz, const int* coll_int,
                       const float* coll_float, int n_bc, const int* bc_int,
                       const float* bc_float, const void* const* valid_ptrs,
                       const void* const* phi_ptrs, double* partials,
                       int n_partials, double* series, int t,
                       const float* gfield, void* stream) {
  return collide_stream<float>(src, dst, mask, nx, ny, nz, coll_int,
                               coll_float, n_bc, bc_int, bc_float, valid_ptrs,
                               phi_ptrs, nullptr, 0, partials, n_partials,
                               series, t, gfield, stream);
}

int lbm_macro(const float* f, float* rho, float* u, long long n_cells,
              const float* half_force, void* stream) {
  return macro<float>(f, rho, u, n_cells, half_force, stream);
}

}  // extern "C"
