// The collide-stream (K1a + K1b + K1c, with the z planes of K5 + K6) and
// moments (K3) kernels on bf16 state: the C entries of
// collide_stream.cuh with S = __nv_bfloat16, under the fp32 entries'
// names with _bf16 appended and the same arguments, the state pointers
// (src, dst, f) pointing at bf16 words. The step is the paired kernel
// (collide_stream_pairs: a thread a pair of z-neighbour cells, its 14
// branches with and without the z planes' code), whose list holds
// interior pair ids and cell ids (engine/compile.CompiledCase
// .pair_launch) and which takes three more arguments: how many entries
// are pairs, the box's interior bits (engine/compile.pair_interior_bits)
// and whether the grid takes the interior pairs from the box. Its own
// translation unit, so
// nvcc builds it beside the fp32 instances (kernels/_build.py). A force
// field (gfield) has no bf16 instance: the entries return
// cudaErrorInvalidValue for it, as for any malformed call.

#include "collide_stream.cuh"

using bf16 = __nv_bfloat16;

namespace {

__global__ void __launch_bounds__(kBlock)
div_exact_sweep_kernel(float b, float y_host, unsigned long long* out) {
  const float y = __frcp_rn(b);
  const unsigned long long stride = (unsigned long long)gridDim.x * kBlock;
  unsigned long long bad = 0;
  for (unsigned long long a = (unsigned long long)blockIdx.x * kBlock +
                              threadIdx.x;
       a < (1ull << 32); a += stride) {
    const float av = __uint_as_float((unsigned)a);
    const float q = div_exact(av, b, y);
    const float r = av / b;
    bad += __float_as_uint(q) != __float_as_uint(r) && !(q != q && r != r);
  }
  if (bad) atomicAdd(out, bad);
  if (blockIdx.x == 0 && threadIdx.x == 0 &&
      __float_as_uint(y) != __float_as_uint(y_host)) {
    atomicAdd(out + 1, 1ull);
  }
}

}  // namespace

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
                            const void* const* phi_ptrs,
                            const int* entries, int n_listed, int n_inner,
                            const uint32_t* interior, int box,
                            double* partials, int n_partials, double* series,
                            int t, const float* gfield, void* stream) {
  return collide_stream_pairs<bf16>(
      static_cast<const bf16*>(src), static_cast<bf16*>(dst), mask, nx, ny,
      nz, coll_int, coll_float, n_bc, bc_int, bc_float, valid_ptrs, phi_ptrs,
      entries, n_listed, n_inner, interior, box, partials, n_partials, series,
      t, gfield, stream);
}

// div_exact's check: every fp32 bit pattern a (all 2^32 dividends)
// divided by b, div_exact(a, b, __frcp_rn(b)) against IEEE a / b bit for
// bit (a NaN quotient matching a NaN); out[0] += the dividends whose
// quotients differ, out[1] += 1 when the host's 1.0f / b (the paired
// kernel's reciprocal of a launch divisor) differs from __frcp_rn(b).
// Not on any path: chip_smoke.py and tests/test_torch_cuda.py call it.
int lbm_div_exact_check(float b, unsigned long long* out, void* stream) {
  div_exact_sweep_kernel<<<4096, kBlock, 0, static_cast<cudaStream_t>(
                                               stream)>>>(b, 1.0f / b, out);
  return (int)cudaGetLastError();
}

int lbm_macro_bf16(const void* f, float* rho, float* u, long long n_cells,
                   const float* half_force, void* stream) {
  return macro<bf16>(static_cast<const bf16*>(f), rho, u, n_cells,
                     half_force, stream);
}

}  // extern "C"
