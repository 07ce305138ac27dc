// The collide-stream (K1a + K1b + K1c, with the z planes of K5 + K6) and
// moments (K3) kernels on bf16 state: the C entries of
// collide_stream.cuh with S = __nv_bfloat16, under the fp32 entries'
// names with _bf16 appended and the same arguments, the state pointers
// (src, dst, f) pointing at bf16 words. Its own translation unit, so
// nvcc builds it beside the fp32 instances (kernels/_build.py). A force
// field (gfield) has no bf16 instance: the entries return
// cudaErrorInvalidValue for it, as for any malformed call.

#include "collide_stream.cuh"

using bf16 = __nv_bfloat16;

extern "C" {

int lbm_block_size() { return kBlock; }

const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lbm_collide_stream_bf16(const void* src, void* dst, const int8_t* mask,
                            int nx, int ny, int nz, const int* coll_int,
                            const float* coll_float, int n_bc,
                            const int* bc_int, const float* bc_float,
                            const void* const* valid_ptrs,
                            const void* const* phi_ptrs, const int* cells,
                            int n_listed, double* partials, int n_partials,
                            double* series, int t, const float* gfield,
                            void* stream) {
  return collide_stream<bf16>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), mask, nx, ny,
      nz, coll_int, coll_float, n_bc, bc_int, bc_float, valid_ptrs, phi_ptrs,
      cells, n_listed, partials, n_partials, series, t, gfield, stream);
}

int lbm_macro_bf16(const void* f, float* rho, float* u, long long n_cells,
                   const float* half_force, void* stream) {
  return macro<bf16>(static_cast<const bf16*>(f), rho, u, n_cells,
                     half_force, stream);
}

}  // extern "C"
