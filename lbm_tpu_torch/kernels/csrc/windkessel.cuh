// The windkessel (RCR) outlets for NVIDIA Hopper (sm_90a), on fp32 or
// bf16 state: the collide-stream launch with the outlets' flux folded in
// (the WK instances of collide_stream.cuh) and its one-block reduction,
// and the flux kernel that primes the fold. windkessel.cu instantiates
// them for float storage (and the flux kernel for both), windkessel_bf16
// .cu the fold for bf16 storage.
//
// lbm_tpu evaluates a windkessel outlet inside its fixup
// (lbm_tpu/engine/step.py apply_bc_fixup, run after its kernel by
// kernels/collide_stream.py::_fix_xy_plane_windowed and, through K6 and
// K5, ::_fix_z_plane_windowed): the outward flux Q over the outlet's
// footprint on its consumer plane from the moments of the PRE-step
// populations (with the Guo half force), one backward-Euler step of P_c,
// and the rewrite's rho* (d3q19.cuh, WK). Here a step is one fold launch
// and its reduction:
//   - each thread of an outlet's descriptor derives rho* from P_c and
//     Q_staged, the flux of the state the launch reads;
//   - each footprint cell writes its term weight * u[axis] of the state
//     it stores;
//   - the reduction sums the velsum, then commits P_c <- P_c' with
//     Q_staged (the update whose rho* the launch used) and stages the new
//     Q_staged from the terms.
// The pre-step state of step n + 1 is the post-step state of step n, so
// Q and P_c are the ones a flux from the pre-step state gives, bit for
// bit: each term is the same fp32 product of the same moments of the same
// stored values, summed in the same order. When the state did not come
// from the last fold launch (a run's first step, a state loaded or reset,
// a call on another state), the flux kernel primes the fold: it writes
// every footprint term (a non-fluid footprint cell never changes, so its
// term stays) and Q_staged, and leaves P_c alone.
//
// Both sums run in one fixed order, with no float atomics: one block of
// kWKBlock threads an outlet, thread j summing the terms of rows begin +
// j, begin + j + kWKBlock, ... from 0, then the partials in a halving
// tree (kernels/collide_stream.windkessel_flux_plain and the fold's plain
// version repeat it). The build has -fmad=false.

#pragma once

#include "collide_stream.cuh"

namespace {

// The fixed-order sum of `acc` over a group of kWKBlock threads (lane =
// the thread's rank in it) into part[0] of the group's shared slots; every
// thread of the block calls it.
__device__ __forceinline__ void wk_group_sum(float acc, float* part,
                                             int lane) {
  part[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (unsigned s = kWKBlock / 2; s > 0; s >>= 1) {
    if (lane < (int)s) {
      part[threadIdx.x] = part[threadIdx.x] + part[threadIdx.x + s];
    }
    __syncthreads();
  }
}

// The prime: one block an outlet writes terms[k] = weights[k] * u[axis]
// of each footprint cell k of the state src and q[b] = sign * their sum.
template <bool FORCE, typename S>
__global__ void __launch_bounds__(kWKBlock)
windkessel_flux_kernel(const S* __restrict__ src, long long n_cells,
                       const __grid_constant__ WKSet set,
                       const int* __restrict__ cells,
                       const float* __restrict__ weights,
                       float* __restrict__ terms, float* __restrict__ q) {
  const WK& d = set.wk[blockIdx.x];
  float acc = 0.0f;
  for (int k = d.begin + threadIdx.x; k < d.end; k += kWKBlock) {
    const long long cell = cells[k];
    float p[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) p[i] = widen(src[i * n_cells + cell]);
    float rho, ux, uy, uz;
    moments19<FORCE>(p, set.half_force, rho, ux, uy, uz);
    const float ua = d.axis == 0 ? ux : (d.axis == 1 ? uy : uz);
    const float term = weights[k] * ua;
    terms[k] = term;
    acc = acc + term;
  }
  __shared__ float part[kWKBlock];
  wk_group_sum(acc, part, threadIdx.x);
  if (threadIdx.x == 0) q[blockIdx.x] = d.sign * part[0];
}

// The fold's reduction, one block of kReduceBlock threads: the velsum as
// velsum_reduce_kernel's, then each outlet's commit and stage, outlets
// kReduceBlock / kWKBlock at a time.
__global__ void __launch_bounds__(kReduceBlock)
velsum_reduce_wk_kernel(const double* __restrict__ partials, int n,
                        double* __restrict__ series, int t,
                        const __grid_constant__ WKFold fold) {
  velsum_reduce(partials, n, series, t, 0);
  const int n_wk = fold.set.n;
  if ((int)threadIdx.x < n_wk) {
    const WK& d = fold.set.wk[threadIdx.x];
    const float q = fold.q[threadIdx.x];
    fold.pc[threadIdx.x] = (fold.pc[threadIdx.x] + q / d.cap) / d.denom;
  }
  __syncthreads();  // each commit has read its Q before the stage writes
  __shared__ float part[kReduceBlock];
  const int lane = threadIdx.x % kWKBlock;
  for (int b0 = 0; b0 < n_wk; b0 += kReduceBlock / kWKBlock) {
    const int b = b0 + threadIdx.x / kWKBlock;
    float acc = 0.0f;
    if (b < n_wk) {
      const WK& d = fold.set.wk[b];
      for (int k = d.begin + lane; k < d.end; k += kWKBlock) {
        acc = acc + fold.terms[k];
      }
    }
    wk_group_sum(acc, part, lane);
    if (lane == 0 && b < n_wk) {
      fold.q[b] = fold.set.wk[b].sign * part[threadIdx.x];
    }
    __syncthreads();
  }
}

template <typename S>
using FoldLauncher = void (*)(const StepArgs<S>&, const Collision&,
                              const BCSet&, const ZBCSet&, const WKFold&);

template <typename S, int K>
void launch_fold(const StepArgs<S>& a, const Collision& c, const BCSet& b,
                 const ZBCSet& z, const WKFold& w) {
  using I = Inst<K>;
  if constexpr (kBounded<K, true>) {
    bounded::collide_stream_wk_kernel<I::kColl, I::kClosure, I::kForce,
                                      I::kMovingWall, S>
        <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                          a.nz, c, b, z, a.cells, a.n_listed,
                                          a.partials, w);
  } else {
    collide_stream_wk_kernel<I::kColl, I::kClosure, I::kForce,
                             I::kMovingWall, S>
        <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                          a.nz, c, b, z, a.cells, a.n_listed,
                                          a.partials, w);
  }
}

// every whole-box instance without a force field (the port refuses
// windkessel outlets beside one)
template <typename S, int K>
constexpr FoldLauncher<S> fold_entry() {
  if constexpr (has_instance<S, K>() && Inst<K>::kForce != kFieldForce) {
    return &launch_fold<S, K>;
  } else {
    return nullptr;
  }
}
template <typename S, int... K>
constexpr std::array<FoldLauncher<S>, kNumKeys> fold_table(
    std::integer_sequence<int, K...>) {
  return {fold_entry<S, K>()...};
}
template <typename S>
constexpr std::array<FoldLauncher<S>, kNumKeys> kFoldTable =
    fold_table<S>(std::make_integer_sequence<int, kNumKeys>{});

// One fold step (the C entries lbm_collide_stream_wk and
// lbm_collide_stream_wk_bf16): collide_stream's arguments (no force field)
// with bc_wk, one int a boundary row (its outlet among the n_wk, or -1),
// and the fold: the outlets' rows (wk_int, wk_float, on the host, as
// parse_wk), the footprint weights, foot (n_foot codes row * 3 + axis of
// the list's first n_foot cells), terms, q (Q_staged) and pc (P_c, updated
// in place), all on the device. cells must be given. Returns
// cudaGetLastError().
template <typename S>
int collide_stream_fold(const S* src, S* dst, const int8_t* mask, int nx,
                        int ny, int nz, const int* coll_int,
                        const float* coll_float, int n_bc, const int* bc_int,
                        const float* bc_float, const void* const* valid_ptrs,
                        const void* const* phi_ptrs, const int* bc_wk,
                        const int* cells, int n_listed, double* partials,
                        int n_partials, double* series, int t, int n_wk,
                        const int* wk_int, const float* wk_float,
                        const float* weights, const int* foot, int n_foot,
                        float* terms, float* q, float* pc, void* stream) {
  WKFold fold = {};
  if (!cells || !bc_wk || n_foot < 0 || n_foot > n_listed || !weights ||
      !terms || !q || !pc || (n_foot > 0 && !foot) ||
      !parse_wk(n_wk, wk_int, wk_float, nullptr, fold.set)) {
    return (int)cudaErrorInvalidValue;
  }
  fold.pc = pc;
  fold.q = q;
  fold.terms = terms;
  fold.weights = weights;
  fold.foot = foot;
  fold.n_foot = n_foot;
  StepArgs<S> args;
  Collision coll = {};
  BCSet bcs = {};
  ZBCSet zbcs = {};
  const int key = prepare_step<S, -1>(
      src, dst, mask, nx, ny, nz, coll_int, coll_float, n_bc, bc_int,
      bc_float, valid_ptrs, phi_ptrs, bc_wk, n_wk, cells, n_listed, partials,
      n_partials, nullptr, stream, Halo{}, args, coll, bcs, zbcs);
  if (key < 0) return -key;
  if (kFoldTable<S>[key] == nullptr) return (int)cudaErrorInvalidValue;
  kFoldTable<S>[key](args, coll, bcs, zbcs, fold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_wk_kernel<<<1, kReduceBlock, 0, args.stream>>>(
      partials, n_partials, series, t, fold);
  return (int)cudaGetLastError();
}

// The prime (lbm_windkessel_flux, lbm_windkessel_flux_bf16): wk_int and
// wk_float as parse_wk's, half_force null or the host F/2 3-vector;
// cells, weights: the footprints' cell ids and fp32 weights on the
// device; terms (one a footprint row) and q ((n_wk,)) written on the
// device. Returns cudaGetLastError().
template <typename S>
int windkessel_prime(const S* src, long long n_cells, int n_wk,
                     const int* wk_int, const float* wk_float,
                     const float* half_force, const int* cells,
                     const float* weights, float* terms, float* q,
                     void* stream) {
  WKSet set = {};
  if (n_cells <= 0 ||
      !parse_wk(n_wk, wk_int, wk_float, half_force, set)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half_force) {
    windkessel_flux_kernel<true, S><<<n_wk, kWKBlock, 0, s>>>(
        src, n_cells, set, cells, weights, terms, q);
  } else {
    windkessel_flux_kernel<false, S><<<n_wk, kWKBlock, 0, s>>>(
        src, n_cells, set, cells, weights, terms, q);
  }
  return (int)cudaGetLastError();
}

}  // namespace
