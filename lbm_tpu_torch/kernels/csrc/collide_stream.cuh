// D3Q19 collide-stream, z-plane fixup and moments kernels for NVIDIA
// Hopper (sm_90a): the kernels and their host entries, templated on the
// state's storage type. collide_stream.cu instantiates them for float
// storage and collide_stream_bf16.cu for bf16 storage, each its own
// translation unit and shared object (kernels/_build.py compiles the two
// side by side).
//
// lbm_collide_stream (K1a + K1b + K1c) replaces lbm_tpu/kernels/
// collide_stream.py::_kernel: its BGK body _subtile_compute, the K1b
// branches (TRT, the Guo body force, Ladd moving walls, the per-cell tau
// closures of LES and rheology, MRT), ::_row_fix (the in-kernel NEE rows,
// series phases included), the per-tile velsum and the live-tile list
// (`tids`, ::live_tile_ids: here a list of the fluid cells).
// lbm_fix_z_plane replaces ::_extract_z_slab
// (K6), ::_splice_z_plane_inplace (K5) and the XLA arithmetic of
// ::_fix_z_plane_windowed between them, with the same branches.
// lbm_macro (K3) replaces ::packed_macro, with its F/2 force shift.
// The force-field instances (K1e) replace the same _kernel's `fforce`
// mode: the Boussinesq force F = buoy (c - c_ref) per fluid cell, c the
// sum of the cell's seven pre-step D3Q7 populations g (read from the
// scalar state's source buffer, 7 loads at the own cell), with the Guo
// half shift and the parity-split source per cell.
//
// State layout: f[19][nx][ny][nz] fp32 or bf16, z contiguous, two ping-pong
// buffers (the kernels read `src` and write `dst`, never in place, so a
// cell's NEE rewrite always sees its own PRE-step populations). The mask
// is int8 (GHOST -1 and MOVING -2 are negative labels).
//
// Semantics are those of the dense step (lbm_tpu_torch/engine/step.py):
// the pull wraps modulo on all three axes, exactly like torch.roll, so
// the kernels need no padding ring. Arithmetic follows the dense step's
// operation order (moments summed in direction order, u = (m + F/2) /
// rho by division, phi as w*(1 + 3cu + 4.5cu^2 - 1.5|u|^2), BGK and TRT
// dividing by tau, 2 tau and 2 tau_minus, the Guo source as cp g_even +
// cm g_odd with the dense step's fp32 constants, the closures' Picard
// loop with IEEE logf/expf/log1pf/sqrtf), and the build turns off FMA
// contraction (kernels/_build.py), so BGK, TRT, force and moving walls
// are bit for bit the dense step's. MRT multiplies f - feq by the dense
// step's fp32 19x19 K in its summation order (a zero entry adds a zero),
// so it is bit-equal too: lbm_tpu's kernel form, the rank update over the
// ten tunable moment rows (core/mrt.py mrt_rank_update), rounds
// differently and drifted to a max abs error of 1.9e-6 against the dense
// step after 200 steps of the 64^3 cavity on the H100. K's entries come
// by value and are read from the constant bank, not registers.
//
// The collision branch is a template: <collision, closure?, force (none,
// constant, field), moving>, 18 valid instances per kernel (a closure
// needs BGK or TRT; a force excludes MRT and closures, as lbm_tpu's
// kernel does). The
// closure's kind (Smagorinsky, power law, Carreau(-Yasuda), Casson) is a
// uniform runtime switch inside the closure instance: one template
// instance per kind took the build from 4 s to 60 s on the H100. The
// host entry picks the instance from the case's descriptor, so the BGK
// instance is the BGK-only kernel's code and pays for no branch it does
// not take.
//
// bf16 storage (lbm_tpu's pack_state dtype=bfloat16, its _subtile_compute
// :626-646, _row_fix :1083-1094, _fix_z_plane_windowed :2233-2336 and
// packed_macro's widening reads) is the storage type S = __nv_bfloat16:
// every load widens to fp32, the step computes in fp32 as above, every
// store narrows once with round-to-nearest-even, and a non-fluid cell
// keeps its words in both buffers, so a bf16 step is "widen, the fp32
// step, narrow", bit for bit. The z-plane fixup reads the bf16 pre-step
// source and narrows on its write, which is that same narrowing. bf16
// has every instance but the force field's (14 collide-stream and 14
// fixup instances, K3 with and without the force shift): lbm_tpu's
// transports keep fp32 state. Its loads are 64 B a warp a direction, half
// a 128-byte line; pairing them (__nv_bfloat162, 16-byte vectors) is later
// work.
//
// What bounds K1a: bytes first. A fluid cell reads 19 populations and
// writes 19 (152 B in fp32, 76 B in bf16), plus 18 one-byte neighbor mask reads that mostly hit
// L1/L2; the ~250 flops of BGK are below the card's ratio, but the
// instruction count (22 IEEE divisions, cell-index div/mod, 18 wraps) and
// 78 registers a thread keep this first version short of the bandwidth
// roofline. The K1b branches move the same bytes; a closure adds a few
// dozen transcendental calls a fluid cell and MRT ~720 flops, so they
// add registers (and spills) before they add time. It is one thread per
// cell with z the fastest thread index, so the 18 neighbor gathers of a
// warp are 32 consecutive floats each (shifted by at most one element
// along z) and coalesce. Only fluid cells are loaded and stored: the two
// ping-pong buffers hold equal non-fluid state (every writer of the state
// writes both), so a wall, DEAD or GHOST cell costs its mask byte and
// nothing more. In a vessel tree 1.2% of the cells are fluid (the
// full-size coronary; 93% of its 256-cell blocks hold none): there the
// launch takes the ascending list of the fluid cells (a thread a listed
// cell), so warps carry fluid cells densely and consecutive threads still
// take consecutive z cells of a vessel's rows, at 4 bytes a cell for the
// list. Velsum partials are reduced in double and in a fixed order, so
// the stop rule fires at the same step in every run.
//
// lbm_fix_z_plane runs after K1a, once per z-plane boundary, over the
// boundary's static window on its consumer plane: it pulls from the
// intact source buffer (the slab copy K6 made on the TPU is this read),
// applies the NEE rewrite with the same device function as K1a, collides
// and writes the plane's fluid cells into the destination (K5's splice).
// A window is a few thousand cells, so it is bound by launch latency.
// It adds sum |u_fixed| - |u_pre-NEE| over the cells it rewrote to the
// step's velsum, since K1a counted those cells before the rewrite.
//
// The device functions (pull, NEE rewrite, collision branches, velsum
// reduction) and the descriptor parsers live in d3q19.cuh, which the
// fused pair (collide_stream2.cuh) includes too.
//
// Both kernels take the halo axis as a last template parameter HALO:
// -1 for a whole box (every instance of collide_stream.cu and
// collide_stream_bf16.cu, whose code, registers and spills it leaves as
// they were), 0 or 1 for one shard of a box split along x or y (K1d,
// instantiated by collide_stream_halo.cu), whose pulls across its faces
// read the planes its neighbours sent (pull19 in d3q19.cuh).

#pragma once

#include "d3q19.cuh"

namespace {

// Thread k of the launch steps the k-th cell of the fluid-cell list
// `cells` (n_listed ids, ascending), or cell k of the box when `cells` is
// null. Only fluid cells are loaded and stored: a non-fluid cell holds
// the same state in both buffers, so the step leaves it. HALO -1: the
// whole box; 0 or 1: a shard split along x or y, pulling across its
// faces from `halo`.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO>
__device__ __forceinline__ void collide_stream_cells(
    const S* __restrict__ src, S* __restrict__ dst,
    const int8_t* __restrict__ mask, int nx, int ny, int nz,
    const Collision& coll, const BCSet& bcs, const int* __restrict__ cells,
    int n_listed, double* __restrict__ partials, const Halo& halo) {
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host check)
  const long long k = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long cell_ll =
      cells ? (k < n_listed ? (long long)cells[k] : n_cells) : k;
  float speed = 0.0f;
  if (cell_ll < n_cells && mask[cell_ll] == kFluid) {
    const int cell = (int)cell_ll;
    const int z = cell % nz;
    const int xy = cell / nz;
    const int y = xy % ny;
    const int x = xy / ny;
    float p[Q];
    pull19<MOVING, HALO>(src, mask, x, y, z, nx, ny, nz, n_cells, cell,
                         coll.bb, p, halo);
#pragma unroll
    for (int b = 0; b < kMaxBCs; ++b) {
      if (b >= bcs.n) break;
      const BCDesc& bc = bcs.bc[b];
      if ((bc.axis == 0 ? x : y) != bc.coord) continue;
      const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
      // the NEE rewrite keeps the static force (none under a field)
      nee_fix<FORCE == kConstForce>(bc, src, n_cells, cell, lat,
                                    coll.half_force, p);
    }
    float ff[3], fh[3];
    const float* F = coll.force;
    const float* half = coll.half_force;
    if constexpr (FORCE == kFieldForce) {
      field_force(coll, n_cells, cell, ff, fh);
      F = ff;
      half = fh;
    }
    speed = sqrtf(collide_store<COLL, CLOSURE, FORCE>(p, coll, F, half, dst,
                                                       n_cells, cell));
  }
  block_sum((double)speed, partials);
}

template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO = -1>
__global__ void __launch_bounds__(kBlock)
collide_stream_kernel(const S* __restrict__ src, S* __restrict__ dst,
                      const int8_t* __restrict__ mask, int nx, int ny,
                      int nz, const __grid_constant__ Collision coll,
                      BCSet bcs, const int* __restrict__ cells,
                      int n_listed, double* __restrict__ partials,
                      const Halo halo) {
  collide_stream_cells<COLL, CLOSURE, FORCE, MOVING, S, HALO>(
      src, dst, mask, nx, ny, nz, coll, bcs, cells, n_listed, partials,
      halo);
}

namespace bounded {
// The BGK force-field instances, held to three blocks an SM (80
// registers), their occupancy before the fluid test moved ahead of every
// load (91 registers, two blocks, without the bound).
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO = -1>
__global__ void __launch_bounds__(kBlock, 3)
collide_stream_kernel(const S* __restrict__ src, S* __restrict__ dst,
                      const int8_t* __restrict__ mask, int nx, int ny,
                      int nz, const __grid_constant__ Collision coll,
                      BCSet bcs, const int* __restrict__ cells,
                      int n_listed, double* __restrict__ partials,
                      const Halo halo) {
  collide_stream_cells<COLL, CLOSURE, FORCE, MOVING, S, HALO>(
      src, dst, mask, nx, ny, nz, coll, bcs, cells, n_listed, partials,
      halo);
}
}  // namespace bounded

// One z-plane boundary over its window [x0, x0+wx) x [y0, y0+wy) of the
// consumer plane z = bc.coord: the whole step again for the window's
// fluid cells, now with the NEE rewrite. partials[block] gets the sum of
// |u_fixed| - |u_pre-NEE| over its cells. HALO as in
// collide_stream_kernel: a shard's window rows on its faces pull from the
// exchanged planes (lbm_tpu's halo patch of the pre-step slab).
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO = -1>
__global__ void __launch_bounds__(kBlock)
fix_z_plane_kernel(const S* __restrict__ src, S* __restrict__ dst,
                   const int8_t* __restrict__ mask, int nx, int ny, int nz,
                   const __grid_constant__ Collision coll, BCDesc bc, int x0,
                   int wx, int y0, int wy, double* __restrict__ partials,
                   const Halo halo) {
  const long long n_cells = (long long)nx * ny * nz;
  const int k = blockIdx.x * kBlock + threadIdx.x;
  double delta = 0.0;
  if (k < wx * wy) {
    const int x = x0 + k / wy;
    const int y = y0 + k % wy;
    const int z = bc.coord;
    const int cell = (x * ny + y) * nz + z;
    if (mask[cell] == kFluid) {
      float p[Q];
      pull19<MOVING, HALO>(src, mask, x, y, z, nx, ny, nz, n_cells, cell,
                           coll.bb, p, halo);
      float ff[3], fh[3];
      const float* F = coll.force;
      const float* half = coll.half_force;
      if constexpr (FORCE == kFieldForce) {
        field_force(coll, n_cells, cell, ff, fh);
        F = ff;
        half = fh;
      }
      float rho, ux, uy, uz;
      moments19<FORCE != kNoForce>(p, half, rho, ux, uy, uz);
      const float before = sqrtf(ux * ux + uy * uy + uz * uz);
      nee_fix<FORCE == kConstForce>(bc, src, n_cells, cell,
                                    (long long)x * ny + y, coll.half_force,
                                    p);
      const float after = sqrtf(collide_store<COLL, CLOSURE, FORCE>(
          p, coll, F, half, dst, n_cells, cell));
      delta = (double)after - (double)before;
    }
  }
  block_sum(delta, partials);
}

template <bool FORCE, typename S>
__global__ void __launch_bounds__(kBlock)
macro_kernel(const S* __restrict__ f, float* __restrict__ rho_out,
             float* __restrict__ u_out, long long n_cells, float h0,
             float h1, float h2) {
  const long long cell = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (cell >= n_cells) return;
  float p[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) p[i] = widen(f[i * n_cells + cell]);
  const float half_force[3] = {h0, h1, h2};
  float rho, ux, uy, uz;
  moments19<FORCE>(p, half_force, rho, ux, uy, uz);
  rho_out[cell] = rho;
  u_out[cell] = ux;
  u_out[n_cells + cell] = uy;
  u_out[2 * n_cells + cell] = uz;
}

template <typename S>
struct StepArgs {
  const S* src;
  S* dst;
  const int8_t* mask;
  int nx, ny, nz;
  const int* cells;
  int n_listed;
  double* partials;
  unsigned grid;
  cudaStream_t stream;
  Halo halo;
};

template <typename S>
struct FixArgs {
  const S* src;
  S* dst;
  const int8_t* mask;
  int nx, ny, nz;
  int x0, wx, y0, wy;
  double* partials;
  unsigned grid;
  cudaStream_t stream;
  Halo halo;
};

template <typename S, int K, int HALO>
void launch_step(const StepArgs<S>& a, const Collision& c, const BCSet& b) {
  using I = Inst<K>;
  if constexpr (I::kForce == kFieldForce && I::kColl == kBGK) {
    bounded::collide_stream_kernel<I::kColl, I::kClosure, I::kForce,
                                   I::kMovingWall, S, HALO>
        <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                          a.nz, c, b, a.cells, a.n_listed,
                                          a.partials, a.halo);
  } else {
    collide_stream_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall,
                          S, HALO>
        <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                          a.nz, c, b, a.cells, a.n_listed,
                                          a.partials, a.halo);
  }
}

template <typename S, int K, int HALO>
void launch_fix(const FixArgs<S>& a, const Collision& c, const BCDesc& b) {
  using I = Inst<K>;
  fix_z_plane_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall, S,
                     HALO>
      <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                        a.nz, c, b, a.x0, a.wx, a.y0, a.wy,
                                        a.partials, a.halo);
}

template <typename S>
using StepLauncher = void (*)(const StepArgs<S>&, const Collision&,
                              const BCSet&);
template <typename S>
using FixLauncher = void (*)(const FixArgs<S>&, const Collision&,
                             const BCDesc&);

template <typename S, int K, int HALO>
constexpr StepLauncher<S> step_entry() {
  if constexpr (has_instance<S, K, HALO>()) {
    return &launch_step<S, K, HALO>;
  } else {
    return nullptr;
  }
}
template <typename S, int K, int HALO>
constexpr FixLauncher<S> fix_entry() {
  if constexpr (has_instance<S, K, HALO>()) {
    return &launch_fix<S, K, HALO>;
  } else {
    return nullptr;
  }
}
template <typename S, int HALO, int... K>
constexpr std::array<StepLauncher<S>, kNumKeys> step_table(
    std::integer_sequence<int, K...>) {
  return {step_entry<S, K, HALO>()...};
}
template <typename S, int HALO, int... K>
constexpr std::array<FixLauncher<S>, kNumKeys> fix_table(
    std::integer_sequence<int, K...>) {
  return {fix_entry<S, K, HALO>()...};
}
// one table per storage type and halo axis; a translation unit
// instantiates only the tables its entries use
template <typename S, int HALO>
constexpr std::array<StepLauncher<S>, kNumKeys> kStepTable =
    step_table<S, HALO>(std::make_integer_sequence<int, kNumKeys>{});
template <typename S, int HALO>
constexpr std::array<FixLauncher<S>, kNumKeys> kFixTable =
    fix_table<S, HALO>(std::make_integer_sequence<int, kNumKeys>{});

// The host entries, exported under their C names by collide_stream.cu
// (S = float) and collide_stream_bf16.cu (S = __nv_bfloat16, names
// ending in _bf16), with HALO = -1; collide_stream_halo.cu exports the
// shard entries (S = float, HALO 0 and 1), whose `halo` planes must all
// be set.

// One step from src into dst with the collision branch of the descriptor
// rows coll_int/coll_float (CInt/CFloat) and the x/y-plane boundaries;
// series[t] = sum over fluid cells of |u|. gfield: the pre-step scalar
// state g[7][n_cells] of a field force (CI_force == 2), else null.
// cells: null (a thread a cell of the box) or a device list of n_listed
// cell ids, ascending, holding every fluid cell (a non-fluid id is
// skipped). Only fluid cells are written: dst must already hold src's
// non-fluid cells. partials holds one double per launched block
// (n_partials: ceil(n_listed / kBlock), at least 1, with a list).
// Boundary rows as parse_bc; phi_ptrs[b] is this step's phase table of a
// series boundary. Returns cudaGetLastError().
template <typename S, int HALO = -1>
int collide_stream(const S* src, S* dst, const int8_t* mask, int nx, int ny,
                   int nz, const int* coll_int, const float* coll_float,
                   int n_bc, const int* bc_int, const float* bc_float,
                   const void* const* valid_ptrs, const void* const* phi_ptrs,
                   const int* cells, int n_listed, double* partials,
                   int n_partials, double* series, int t,
                   const float* gfield, void* stream,
                   const Halo& halo = Halo{}) {
  const long long n_cells = (long long)nx * ny * nz;
  const long long grid =
      cells ? (n_listed + kBlock - 1) / kBlock : (n_cells + kBlock - 1) / kBlock;
  if (n_bc < 0 || n_bc > kMaxBCs || n_cells <= 0 ||
      n_cells > 0x7fffffffLL || n_listed < 0 || n_listed > n_cells ||
      (grid > 0 ? grid : 1) != n_partials) {
    return (int)cudaErrorInvalidValue;
  }
  if (HALO >= 0 && !(halo.lo && halo.hi && halo.mask_lo && halo.mask_hi)) {
    return (int)cudaErrorInvalidValue;
  }
  Collision coll = {};
  const int key = parse_collision(coll_int, coll_float, gfield, coll);
  if (key < 0 || kStepTable<S, HALO>[key] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  BCSet bcs = {};
  bcs.n = n_bc;
  for (int b = 0; b < n_bc; ++b) {
    if (!parse_bc(bc_int + b * kBCInts, bc_float + 2 * b, valid_ptrs[b],
                  phi_ptrs[b], nx, ny, nz, bcs.bc[b]) ||
        bcs.bc[b].axis == 2) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StepArgs<S> args = {src, dst, mask, nx, ny, nz, cells, n_listed,
                            partials, (unsigned)n_partials, s, halo};
  kStepTable<S, HALO>[key](args, coll, bcs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, n_partials,
                                                   series, t, 0);
  return (int)cudaGetLastError();
}

// The z-plane NEE fixup of one boundary (descriptor row as parse_bc,
// axis 2) with the collision branch of coll_int/coll_float, over the
// window [x0, x1) x [y0, y1) of its consumer plane: src is the pre-step
// state, dst the collide-stream kernel's output; series[t] += sum
// |u_fixed| - |u_pre-NEE| over the rewritten cells. gfield as in
// lbm_collide_stream. partials holds
// ceil((x1-x0)*(y1-y0) / lbm_block_size()) doubles. Returns
// cudaGetLastError(). halo as in collide_stream.
template <typename S, int HALO = -1>
int fix_z_plane(const S* src, S* dst, const int8_t* mask, int nx, int ny,
                int nz, const int* coll_int, const float* coll_float,
                const int* bc_int, const float* bc_float, const void* valid,
                const void* phi, int x0, int x1, int y0, int y1,
                double* partials, int n_partials, double* series, int t,
                const float* gfield, void* stream,
                const Halo& halo = Halo{}) {
  const long long n_cells = (long long)nx * ny * nz;
  const int wx = x1 - x0, wy = y1 - y0;
  BCDesc bc = {};
  if (n_cells <= 0 || n_cells > 0x7fffffffLL || x0 < 0 || y0 < 0 ||
      wx <= 0 || wy <= 0 || x1 > nx || y1 > ny ||
      !parse_bc(bc_int, bc_float, valid, phi, nx, ny, nz, bc) ||
      bc.axis != 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (HALO >= 0 && !(halo.lo && halo.hi && halo.mask_lo && halo.mask_hi)) {
    return (int)cudaErrorInvalidValue;
  }
  Collision coll = {};
  const int key = parse_collision(coll_int, coll_float, gfield, coll);
  if (key < 0 || kFixTable<S, HALO>[key] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = ((long long)wx * wy + kBlock - 1) / kBlock;
  if (grid != n_partials) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FixArgs<S> args = {src, dst, mask, nx, ny, nz, x0, wx, y0, wy,
                           partials, (unsigned)grid, s, halo};
  kFixTable<S, HALO>[key](args, coll, bc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, n_partials,
                                                   series, t, 1);
  return (int)cudaGetLastError();
}

// rho = sum_i f_i and u = (sum_i e_i f_i + F/2) / rho (rho == 0 read as
// 1) per cell; rho (n_cells,), u (3, n_cells). half_force: null, or the
// host (F/2) 3-vector of a forced case. Returns cudaGetLastError().
template <typename S>
int macro(const S* f, float* rho, float* u, long long n_cells,
          const float* half_force, void* stream) {
  if (n_cells <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_cells + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half_force) {
    macro_kernel<true, S><<<(unsigned)blocks, kBlock, 0, s>>>(
        f, rho, u, n_cells, half_force[0], half_force[1], half_force[2]);
  } else {
    macro_kernel<false, S><<<(unsigned)blocks, kBlock, 0, s>>>(
        f, rho, u, n_cells, 0.0f, 0.0f, 0.0f);
  }
  return (int)cudaGetLastError();
}

}  // namespace
