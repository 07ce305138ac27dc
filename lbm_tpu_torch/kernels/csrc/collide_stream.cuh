// D3Q19 collide-stream and moments kernels for NVIDIA Hopper (sm_90a):
// the kernels and their host entries, templated on the state's storage
// type. collide_stream.cu instantiates them for float
// storage and collide_stream_bf16.cu for bf16 storage, each its own
// translation unit and shared object (kernels/_build.py compiles the two
// side by side).
//
// lbm_collide_stream (K1a + K1b + K1c) replaces lbm_tpu/kernels/
// collide_stream.py::_kernel: its BGK body _subtile_compute, the K1b
// branches (TRT, the Guo body force, Ladd moving walls, the per-cell tau
// closures of LES and rheology, MRT), ::_row_fix (the in-kernel NEE rows,
// series phases included), the per-tile velsum and the live-tile list
// (`tids`, ::live_tile_ids: here a list of the fluid cells). The same
// launch applies the z-plane boundaries, which lbm_tpu runs after its
// kernel as ::_extract_z_slab (K6), the XLA arithmetic of
// ::_fix_z_plane_windowed and ::_splice_z_plane_inplace (K5).
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
// constant, field), moving>, 18 valid instances per kernel, each built
// with and without the z planes' code (ZPLANES) (a closure
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
// step, narrow", bit for bit, the z planes' rewrite included. bf16
// has every instance but the force field's (14 collide-stream branches,
// K3 with and without the force shift): lbm_tpu's transports keep fp32
// state. Its step is the paired kernel (collide_stream_pair_kernel,
// collide_stream_bf16.cu), built for this card: per-cell bf16 loads were
// 64 B a warp a direction, and the per-cell kernel took 1.10 ms at lid
// 256^3, 30% of its bytes' bound, held back by instructions, not bytes
// (cell-index div/mod, 19 load instructions for 38 bytes, 22 IEEE
// divisions whose slow path zero dividends take: 1.40 ms at rest). A
// thread takes an interior pair of z-neighbour cells (x, y, 2j) and
// (x, y, 2j + 1): both fluid, no wall or moving source, on no boundary's
// plane (engine/compile.pair_interior_bits; 97% of the lid's fluid
// cells). It loads each direction as one aligned 4-byte word, or two
// joined with __byte_perm when the pair is shifted in z, collides both
// cells at once straight from the packed words, a direction at a time,
// and stores each direction as one word; (x, y) come from the grid of
// the box form (32 pairs by 8 y rows a block, which the L1 shares) or
// from the pair's id. Every other fluid cell takes a thread of its own,
// the per-cell body (step_cell). Its divisions are exact without the
// slow path: div_exact by reciprocals taken once a divisor (d3q19.cuh),
// and, for the pairs, div_core under one range test a pair. The launch
// bound holds it to 80 registers, three blocks an SM.
//
// What bounds K1a: bytes first. A fluid cell reads 19 populations and
// writes 19 (152 B in fp32, 76 B in bf16), plus 18 one-byte neighbor mask
// reads that mostly hit L1/L2; the ~250 flops of BGK are below the card's
// ratio, but the instruction count (22 IEEE divisions, cell-index
// div/mod, 18 wraps) and 78 registers a thread keep this first version
// short of the bandwidth roofline. The K1b branches move the same bytes; a closure adds a few
// dozen transcendental calls a fluid cell and MRT ~720 flops, so they
// add registers (and spills) before they add time. It is one thread per
// cell with z the fastest thread index, so the 18 neighbor gathers of a
// warp are 32 consecutive floats each (shifted by at most one element
// along z) and coalesce. Only fluid cells are loaded and stored: the two
// ping-pong buffers hold equal non-fluid state (every writer of the state
// writes both), so a wall, DEAD or GHOST cell costs its mask byte and
// nothing more. In a vessel tree 1.2% of the cells are fluid (the
// full-size coronary; 93% of its 256-cell blocks hold none): there the
// fp32 launch takes the fluid cells' runs in sector-aligned segments, a
// word of wall links a lane (collide_stream_list_kernel,
// collide_stream_list.cuh; the box form below still reads a list where
// the windkessel fold's launch gives it one). Velsum partials are reduced
// in double and in a fixed order, so the stop rule fires at the same step
// in every run.
//
// The z planes. On the TPU, z is the lane axis of lbm_tpu's rows, so its
// in-kernel rewrite (_row_fix) takes x/y planes only, and each z-plane
// boundary is a slab copy (K6), a dense recompute of the window and a
// splice (K5) after the kernel. Here the source buffer stays intact and
// the NEE rewrite reads only the consumer cell's own pre-step
// populations, so a z plane is one more descriptor of the same pass: the
// test is z == coord, the lateral index x * ny + y, the rewrite NEE's.
// Its descriptors (ZBC, at most kMaxZBCs) are a set of their own, and
// compact: a z plane's directions are the five with e_z = sign, in
// direction order, so they are constants of the code. A consumer cell of
// a z plane is no other boundary's (engine/compile.check_z_windows), so a
// cell has at most one z plane to apply, and applying it after the x/y
// planes is the dense step's order: a loop that is not unrolled finds it
// by its valid bytes, and one inlined nee_fix_z rewrites the cell. (On
// the H100's toolchain, nee_fix inside that loop took every instance to
// 128 registers, and nee_fix on the found descriptor, whose 18 direction
// slots it reads at a run-time index, to 94-96; BGK takes 76 this way.)
// The velsum counts |u| after every rewrite. A case without z planes
// launches each branch's instance built without this code.
//
// Windkessel (RCR) outlets. lbm_tpu fixes a windkessel plane on any axis
// after its kernel (::_fix_xy_plane_windowed, and K6 + K5 on z through
// ::_fix_z_plane_windowed), since its rho* = rho_fixed + 3 (Q Rp + P_c)
// changes every step, Q the outlet's flux over the pre-step state. Here
// such a plane is one more descriptor of the pass (bc.wk), and the flux is
// folded into the launch (the WK instances, built only into the
// windkessel units, windkessel.cu and windkessel_bf16.cu): the pre-step
// state of a step is the post-step state of the one before, which the
// launch holds, so a thread of a footprint cell (the listed cells' first
// n_foot, in footprint order) writes its term weight * u[axis] of the
// state it just stored, and the launch's one-block reduction commits P_c
// with the Q this launch used and stages the next Q from those terms
// (windkessel.cuh). Every thread that meets an outlet's descriptor
// derives rho* from P_c and the staged Q; no block writes P_c during the
// launch. Its order among the planes is free: no cell of a windkessel
// plane is another boundary's consumer cell (engine/compile
// .check_z_windows). The port refuses windkessel outlets beside a force
// field (as lbm_tpu's dense runtime-force step does) and on shards, so
// only whole-box instances without a field have a WK twin, and every
// other instance keeps its code, registers and spills
// (probes/ptxas_report.py).
//
// The device functions (pull, NEE rewrite, collision branches, velsum
// reduction) and the descriptor parsers live in d3q19.cuh, which the
// fused pair (collide_stream2.cuh) includes too.
//
// The kernel takes the halo axis as a last template parameter HALO:
// -1 for a whole box (every instance of collide_stream.cu and
// collide_stream_bf16.cu, whose code, registers and spills it leaves as
// they were), 0 or 1 for one shard of a box split along x or y (K1d,
// instantiated by collide_stream_halo.cu), whose pulls across its faces
// read the planes its neighbours sent (pull19 in d3q19.cuh).

#pragma once

#include <string.h>

#include "d3q19.cuh"

namespace {

constexpr int kMaxZBCs = 8;  // z-plane boundaries a launch takes

// One z-plane boundary on its consumer plane z = coord, lateral index
// x * ny + y: its directions are the five with e_z = sign, in direction
// order (the host checks the descriptor row's), so they are constants of
// the code and the descriptor holds only scalars.
struct ZBC {
  int coord;
  int sign;
  int rho_is_fixed;
  int u_extrap;
  float rho_fixed;
  float omega;
  long long plane;         // nx * ny
  const uint8_t* valid;    // (5, nx, ny) bytes
  const float* phi_star;   // (5, nx, ny) fp32 of this step's phase, or null
  int wk;                  // a windkessel outlet's index in the WKFold, or -1
};

struct ZBCSet {
  int n;
  ZBC bc[kMaxZBCs];
};

// The rank of direction i among the five with its e_z, in direction
// order: its row in a z plane's tables.
__host__ __device__ constexpr int z_rank(int i) {
  int r = 0;
  for (int j = 1; j < i; ++j) r += EZ(j) == EZ(i);
  return r;
}

// nee_fix for a z-plane boundary: the same rewrite, in the same
// operation order, with the directions known to the code (WKF and DIVX
// as nee_fix's).
template <bool FORCE, typename S, bool WKF = false, bool DIVX = false>
__device__ __forceinline__ void nee_fix_z(const ZBC& bc,
                                          const S* __restrict__ src,
                                          long long n_cells, int cell,
                                          long long lat,
                                          const float* half_force, float* p,
                                          const WKFold* fold = nullptr) {
  float own[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    own[i] = widen(src[(long long)i * n_cells + cell]);
  }
  float rp, uxp, uyp, uzp;
  moments19<FORCE, DIVX>(own, half_force, rp, uxp, uyp, uzp);
  const float usqp = uxp * uxp + uyp * uyp + uzp * uzp;
  float rho_star = bc.rho_is_fixed ? bc.rho_fixed : rp;
  if constexpr (WKF) {
    if (bc.wk >= 0) rho_star = wk_rho_star(*fold, bc.wk);
  }
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    if (EZ(i) == 0 || EZ(i) != bc.sign) continue;
    const long long at = z_rank(i) * bc.plane + lat;
    if (!bc.valid[at]) continue;
    const float phi_nbr = phi_i(i, uxp, uyp, uzp, usqp);
    const float phi_star = bc.u_extrap ? phi_nbr : bc.phi_star[at];
    const float feq_nbr = rp * phi_nbr;
    p[i] = rho_star * phi_star + (own[i] - feq_nbr) * bc.omega;
  }
}

// The z-plane descriptor of a parsed axis-2 row; false unless its
// directions are the five with one sign of e_z, in direction order.
bool to_zbc(const BCDesc& d, ZBC& z) {
  if (d.axis != 2) return false;
  z.sign = 0;
  for (int i = 1; i < Q && z.sign == 0; ++i) {
    if (d.slot[i] >= 0) z.sign = EZ(i);
  }
  for (int i = 1; i < Q; ++i) {
    const int want = EZ(i) != 0 && EZ(i) == z.sign ? z_rank(i) : -1;
    if (d.slot[i] != want) return false;
  }
  z.coord = d.coord;
  z.rho_is_fixed = d.rho_is_fixed;
  z.u_extrap = d.u_extrap;
  z.rho_fixed = d.rho_fixed;
  z.omega = d.omega;
  z.plane = d.plane;
  z.valid = d.valid;
  z.phi_star = d.phi_star;
  z.wk = d.wk;
  return z.sign != 0;
}

// Thread k of the launch steps the k-th cell of the fluid-cell list
// `cells` (n_listed ids, ascending), or cell k of the box when `cells` is
// null. Only fluid cells are loaded and stored: a non-fluid cell holds
// the same state in both buffers, so the step leaves it. HALO -1: the
// whole box; 0 or 1: a shard split along x or y, pulling across its
// faces from `halo`. ZPLANES: the instance applies z-plane descriptors
// (a case without them launches the instance without their code). WK:
// the windkessel fold (`fold`; the list's first fold->n_foot cells are
// the outlets' footprint cells, the rest ascending).
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO, bool ZPLANES, bool WK = false>
__device__ __forceinline__ void collide_stream_cells(
    const S* __restrict__ src, S* __restrict__ dst,
    const int8_t* __restrict__ mask, int nx, int ny, int nz,
    const Collision& coll, const BCSet& bcs, const ZBCSet& zbcs,
    const int* __restrict__ cells, int n_listed,
    double* __restrict__ partials, const Halo& halo,
    const WKFold* fold = nullptr) {
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host check)
  // TRT under a field force reads its cell's seven g before the pull, so
  // their loads overlap the pull's and only c - c_ref stays live
  constexpr bool kEarlyField = COLL == kTRT && FORCE == kFieldForce;
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
    float dc = 0.0f;
    if constexpr (kEarlyField) dc = field_dc(coll, n_cells, cell);
    float p[Q];
    pull19<MOVING, HALO>(src, mask, x, y, z, nx, ny, nz, n_cells, cell,
                         coll.bb, p, halo);
#pragma unroll
    for (int b = 0; b < kMaxBCs; ++b) {
      if (b >= bcs.n) break;
      const BCDesc& bc = bcs.bc[b];
      if ((bc.axis == 0 ? x : y) != bc.coord) continue;
      const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
      // the NEE rewrite keeps the static force (none under a field); the
      // fold's instance derives a windkessel outlet's rho*
      nee_fix<FORCE == kConstForce, S, WK>(bc, src, n_cells, cell, lat,
                                           coll.half_force, p, fold);
    }
    if constexpr (ZPLANES) {
      // the z plane that rewrites this cell, if one does: the one whose
      // valid table holds it (a consumer cell of a z-plane boundary is no
      // other boundary's); found by a light loop, then rewritten once
      const long long zlat = (long long)x * ny + y;
      int zb = -1;
#pragma unroll 1
      for (int b = 0; b < zbcs.n; ++b) {
        const ZBC& bc = zbcs.bc[b];
        if (z != bc.coord) continue;
#pragma unroll
        for (int d = 0; d < 5; ++d) {
          if (bc.valid[d * bc.plane + zlat]) zb = b;
        }
      }
      if (zb >= 0) {
        nee_fix_z<FORCE == kConstForce, S, WK>(zbcs.bc[zb], src, n_cells,
                                               cell, zlat, coll.half_force,
                                               p, fold);
      }
    }
    float ff[3], fh[3];
    const float* F = coll.force;
    const float* half = coll.half_force;
    if constexpr (FORCE == kFieldForce) {
      if constexpr (kEarlyField) {
        field_from(coll, dc, ff, fh);
      } else {
        field_force(coll, n_cells, cell, ff, fh);
      }
      F = ff;
      half = fh;
    }
    speed = sqrtf(collide_store<COLL, CLOSURE, FORCE>(p, coll, F, half, dst,
                                                       n_cells, cell));
    if constexpr (WK) {
      // a footprint cell: its term of the outlet's flux, from the state
      // as stored (a bf16 store widened back), as the flux kernel
      // computes it from a pre-step state
      if (k < fold->n_foot) {
        const int code = fold->foot[k];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          p[i] = widen(dst[(long long)i * n_cells + cell]);
        }
        float rho, ux, uy, uz;
        moments19<FORCE == kConstForce>(p, coll.half_force, rho, ux, uy, uz);
        const int axis = code % 3;
        const float ua = axis == 0 ? ux : (axis == 1 ? uy : uz);
        fold->terms[code / 3] = fold->weights[code / 3] * ua;
      }
    }
  }
  block_sum((double)speed, partials);
}

template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO = -1, bool ZPLANES = false>
__global__ void __launch_bounds__(kBlock)
collide_stream_kernel(const S* __restrict__ src, S* __restrict__ dst,
                      const int8_t* __restrict__ mask, int nx, int ny,
                      int nz, const __grid_constant__ Collision coll,
                      BCSet bcs, const __grid_constant__ ZBCSet zbcs,
                      const int* __restrict__ cells, int n_listed,
                      double* __restrict__ partials, const Halo halo) {
  collide_stream_cells<COLL, CLOSURE, FORCE, MOVING, S, HALO, ZPLANES>(
      src, dst, mask, nx, ny, nz, coll, bcs, zbcs, cells, n_listed, partials,
      halo);
}

// The windkessel fold's instance: a whole box with the z planes' code
// (a windkessel outlet may lie on any axis).
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S>
__global__ void __launch_bounds__(kBlock)
collide_stream_wk_kernel(const S* __restrict__ src, S* __restrict__ dst,
                         const int8_t* __restrict__ mask, int nx, int ny,
                         int nz, const __grid_constant__ Collision coll,
                         BCSet bcs, const __grid_constant__ ZBCSet zbcs,
                         const int* __restrict__ cells, int n_listed,
                         double* __restrict__ partials,
                         const __grid_constant__ WKFold fold) {
  collide_stream_cells<COLL, CLOSURE, FORCE, MOVING, S, -1, true, true>(
      src, dst, mask, nx, ny, nz, coll, bcs, zbcs, cells, n_listed, partials,
      Halo{}, &fold);
}

namespace bounded {
// The force-field instances and the TRT constant-force ones with the z
// planes' code, held to three blocks an SM (80 registers). Without the
// bound [bgk+field] takes 91 registers, two blocks, and [trt+force+z] 89,
// two blocks, at which it ran 25% slower at gravity_channel 256^3 on the
// H100 (probes/path_ab.py); [trt+field] took 90, two blocks, before its
// per-direction loop (d3q19.cuh collide_store).
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO = -1, bool ZPLANES = false>
__global__ void __launch_bounds__(kBlock, 3)
collide_stream_kernel(const S* __restrict__ src, S* __restrict__ dst,
                      const int8_t* __restrict__ mask, int nx, int ny,
                      int nz, const __grid_constant__ Collision coll,
                      BCSet bcs, const __grid_constant__ ZBCSet zbcs,
                      const int* __restrict__ cells, int n_listed,
                      double* __restrict__ partials, const Halo halo) {
  collide_stream_cells<COLL, CLOSURE, FORCE, MOVING, S, HALO, ZPLANES>(
      src, dst, mask, nx, ny, nz, coll, bcs, zbcs, cells, n_listed, partials,
      halo);
}

template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S>
__global__ void __launch_bounds__(kBlock, 3)
collide_stream_wk_kernel(const S* __restrict__ src, S* __restrict__ dst,
                         const int8_t* __restrict__ mask, int nx, int ny,
                         int nz, const __grid_constant__ Collision coll,
                         BCSet bcs, const __grid_constant__ ZBCSet zbcs,
                         const int* __restrict__ cells, int n_listed,
                         double* __restrict__ partials,
                         const __grid_constant__ WKFold fold) {
  collide_stream_cells<COLL, CLOSURE, FORCE, MOVING, S, -1, true, true>(
      src, dst, mask, nx, ny, nz, coll, bcs, zbcs, cells, n_listed, partials,
      Halo{}, &fold);
}
}  // namespace bounded

// Whether instance K (with or without the z planes' code) launches the
// bounded kernel.
template <int K, bool ZPLANES>
constexpr bool kBounded =
    Inst<K>::kForce == kFieldForce ||
    (Inst<K>::kForce == kConstForce && Inst<K>::kColl == kTRT && ZPLANES);

// K1 on bf16 storage (the header's "bf16 storage"): a thread an interior
// pair of z-neighbour cells (x, y, 2j) and (x, y, 2j + 1), or a cell.
// kPairLanes pairs along z by kPairRows rows along y make a block of the
// box form, so a warp's loads of a direction span 64 z cells, 128 bytes
// of bf16.
constexpr int kPairLanes = 32;
constexpr int kPairRows = kBlock / kPairLanes;
// Blocks an SM the kernel is built for (its launch bound): 3 holds it to
// 80 registers. At lid 256^3 on the H100 its forms ran 1.11 ms with 128
// registers and two blocks against 0.90 with 80 and a few spilled words,
// and 1.41 with 64 and four blocks (spilling hundreds of bytes;
// probes/bf16_k1_ab.py, PERF.md).
constexpr int kPairMinBlocks = 3;

// RN(1/tau), RN(1/(2 tau)), RN(1/(2 tau_minus)): the launch's divisors'
// reciprocals for div_exact, rounded once by the host entry; in_range:
// the divisors the collision divides by (BGK tau, TRT 2 tau and 2
// tau_minus) inside div_exact's range (else no pair takes the streaming
// collision).
struct PairRcp {
  float y[3];
  int in_range;
};

// A cell's population i from the pair's packed word: the half h (0: the
// even z cell), widened.
__device__ __forceinline__ float half_of(uint32_t w, int h) {
  return __uint_as_float(h ? (w & 0xffff0000u) : (w << 16));
}

// The same value by __byte_perm: the collision's loop widens its
// populations again this way, an expression the compiler does not merge
// with half_of's, so that it recomputes them rather than keeping the
// moments' 38 widened values live (not timed against the merged form).
__device__ __forceinline__ float half_again(uint32_t w, int h) {
  return __uint_as_float(__byte_perm(w, 0u, h ? 0x3244u : 0x1044u));
}

// The collision of an interior pair (both cells fluid, no rewrite, no
// moving source: the pulled words are the populations), both cells at
// once a direction (or, TRT, a direction and its opposite) at a time,
// straight from the packed words, each direction stored as one 4-byte
// word: moments19's, collide_store's and its Guo source's arithmetic in
// their order, BGK or TRT with no force or the constant one, every
// division div_core by the reciprocals collide_store's DIVX form takes.
// Its dividends' range is tested once for the pair (DivRange) and rho's
// for each cell: false (nothing to keep; the stores are rewritten) when
// one lies outside div_exact's range, and the caller steps the pair cell
// by cell. speed: the two cells' |u|, summed in z order.
template <int COLL, int FORCE>
__device__ __forceinline__ bool collide_pair_stream(
    const uint32_t* pk, const Collision& c, const PairRcp& r,
    uint32_t* __restrict__ w, unsigned n, unsigned c0, double& speed) {
  static_assert((COLL == kBGK || COLL == kTRT) && FORCE != kFieldForce,
                "BGK or TRT, without a force field");
  DivRange range;
  bool rho_in = true;
  float rho[2], ux[2], uy[2], uz[2], usq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float rh = half_of(pk[0], h);
#pragma unroll
    for (int i = 1; i < Q; ++i) rh += half_of(pk[i], h);
    float mx = 0.0f, my = 0.0f, mz = 0.0f;
#pragma unroll
    for (int i = 1; i < Q; ++i) {
      const float v = half_of(pk[i], h);
      if (EX(i) > 0) mx += v;
      if (EX(i) < 0) mx -= v;
      if (EY(i) > 0) my += v;
      if (EY(i) < 0) my -= v;
      if (EZ(i) > 0) mz += v;
      if (EZ(i) < 0) mz -= v;
    }
    if constexpr (FORCE == kConstForce) {
      mx = mx + c.half_force[0];
      my = my + c.half_force[1];
      mz = mz + c.half_force[2];
    }
    const float safe = rh == 0.0f ? 1.0f : rh;
    rho_in = rho_in && div_b_in_range(__float_as_uint(safe));
    const float y = __frcp_rn(safe);
    range.add(mx);
    range.add(my);
    range.add(mz);
    rho[h] = rh;
    ux[h] = div_core(mx, safe, y);
    uy[h] = div_core(my, safe, y);
    uz[h] = div_core(mz, safe, y);
    usq[h] = ux[h] * ux[h] + uy[h] * uy[h] + uz[h] * uz[h];
  }
  // the post-collision population i of half h from its relaxed value:
  // the Guo source added under a force
  auto source = [&](int i, int h, float post) {
    if constexpr (FORCE == kConstForce) {
      const float uf =
          ux[h] * c.force[0] + uy[h] * c.force[1] + uz[h] * c.force[2];
      const float eu = e_dot(i, ux[h], uy[h], uz[h]);
      const float g_even = WGT(i) * (9.0f * eu * c.e_f[i] - 3.0f * uf);
      return post + (c.cp * g_even + c.cm_odd[i]);
    } else {
      return post;
    }
  };
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int o = OPP(i);
    if (COLL == kTRT && o < i) continue;  // stored with its opposite
    unsigned bits_i = 0u, bits_o = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p = half_again(pk[i], h);
      const float fi = rho[h] * phi_i(i, ux[h], uy[h], uz[h], usq[h]);
      if constexpr (COLL == kBGK) {
        const float a = p - fi;
        range.add(a);
        bits_i |= bf16_bits(source(i, h, p - div_core(a, c.tau, r.y[0])))
                  << (16 * h);
      } else {
        // TRT: direction o's s is i's (a sum), its d is -d, so its
        // quotients are i's, the second negated
        const float po = half_again(pk[o], h);
        const float fo = rho[h] * phi_i(o, ux[h], uy[h], uz[h], usq[h]);
        const float sum = (p + po) - (fi + fo);
        const float dif = (p - po) - (fi - fo);
        range.add(sum);
        range.add(dif);
        const float qs = div_core(sum, c.two_tau, r.y[1]);
        const float qd = div_core(dif, c.two_tau_m, r.y[2]);
        bits_i |= bf16_bits(source(i, h, p - qs - qd)) << (16 * h);
        if (o != i) {
          bits_o |= bf16_bits(source(o, h, po - qs + qd)) << (16 * h);
        }
      }
    }
    w[(i * n + c0) >> 1] = bits_i;
    if (COLL == kTRT && o != i) w[(o * n + c0) >> 1] = bits_o;
  }
  speed = (double)sqrtf(usq[0]);
  speed += (double)sqrtf(usq[1]);
  return range.in() && rho_in;
}

// One fluid cell's step, collide_stream_cells' (pull19, the NEE
// rewrites, the z plane, collide_store) with collide_store's DIVX
// division; returns its |u|.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, bool ZPLANES>
__device__ __forceinline__ float step_cell(
    const __nv_bfloat16* __restrict__ src, __nv_bfloat16* __restrict__ dst,
    const int8_t* __restrict__ mask, int x, int y, int z, int nx, int ny,
    int nz, int cell, const Collision& coll, const PairRcp& rcp,
    const BCSet& bcs, const ZBCSet& zbcs) {
  using bf16 = __nv_bfloat16;
  const long long n_cells = (long long)nx * ny * nz;
  float p[Q];
  pull19<MOVING>(src, mask, x, y, z, nx, ny, nz, n_cells, cell, coll.bb, p);
#pragma unroll
  for (int b = 0; b < kMaxBCs; ++b) {
    if (b >= bcs.n) break;
    const BCDesc& bc = bcs.bc[b];
    if ((bc.axis == 0 ? x : y) != bc.coord) continue;
    const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
    nee_fix<FORCE == kConstForce, bf16, false, true>(
        bc, src, n_cells, cell, lat, coll.half_force, p);
  }
  if constexpr (ZPLANES) {
    const long long zlat = (long long)x * ny + y;
    int zb = -1;
#pragma unroll 1
    for (int b = 0; b < zbcs.n; ++b) {
      const ZBC& bc = zbcs.bc[b];
      if (z != bc.coord) continue;
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        if (bc.valid[d * bc.plane + zlat]) zb = b;
      }
    }
    if (zb >= 0) {
      nee_fix_z<FORCE == kConstForce, bf16, false, true>(
          zbcs.bc[zb], src, n_cells, cell, zlat, coll.half_force, p);
    }
  }
  return sqrtf(collide_store<COLL, CLOSURE, FORCE, bf16, true>(
      p, coll, coll.force, coll.half_force, dst, n_cells, cell, rcp.y));
}

// Whether an instance collides its interior pairs at once.
template <int COLL, bool CLOSURE>
constexpr bool kStreamed = (COLL == kBGK || COLL == kTRT) && !CLOSURE;

// One interior pair's step (both cells fluid, no source a wall or a
// moving wall, no z wrap, on no boundary's consumer plane;
// engine/compile.pair_interior_bits) in an instance that streams: each
// direction's two populations as one aligned 4-byte word (e_z = 0) or
// two joined with __byte_perm (e_z = +-1), both cells collided at once
// (collide_pair_stream). False when a dividend leaves div_exact's range
// (the caller then steps the two cells one after the other); speed: the
// two cells' |u| in z order.
template <int COLL, int FORCE>
__device__ __forceinline__ bool stream_pair(
    const __nv_bfloat16* __restrict__ src, __nv_bfloat16* __restrict__ dst,
    int x, int y, int z0, int nx, int ny, int nz, const Collision& coll,
    const PairRcp& rcp, double& speed) {
  const unsigned n = (unsigned)nx * ny * nz;  // 19 n < 2^32 (host check)
  const unsigned c0 = ((unsigned)x * ny + y) * nz + z0;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
  uint32_t pk[Q];
  pk[0] = sw[c0 >> 1];
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const int xs = wrap(x - EX(i), nx);
    const int ys = wrap(y - EY(i), ny);
    const unsigned e = i * n + ((unsigned)xs * ny + ys) * nz + z0;
    const uint32_t* q = sw + (e >> 1);
    // e_z = +1: (z0 - 1, z0); e_z = -1: (z0 + 1, z0 + 2)
    pk[i] = EZ(i) == 0  ? q[0]
            : EZ(i) > 0 ? __byte_perm(q[-1], q[0], 0x5432u)
                        : __byte_perm(q[0], q[1], 0x5432u);
  }
  return rcp.in_range &&
         collide_pair_stream<COLL, FORCE>(
             pk, coll, rcp, reinterpret_cast<uint32_t*>(dst), n, c0, speed);
}

// The launch takes a list `entries` (engine/compile.CompiledCase
// .pair_launch): its first n_inner entries interior pair ids (x * ny +
// y) * ceil(nz / 2) + j, a thread a pair, the rest fluid cell ids, a
// thread a cell (the fluid cells of every other pair). With box (the
// box form), the grid's first nx z-slices take the interior pairs from
// the box instead, the pair (blockIdx.x * kPairLanes + lane, blockIdx.y *
// kPairRows + row) in (j, y) of x row blockIdx.z, stepped when its bit in
// `interior` is set (engine/compile.pair_interior_bits; the grid gives
// (x, y) with no division and a block 8 y rows for the L1 to share), and
// the slices after them take the list's cells. Each block's velsum goes
// to its partial, in the grid's block order.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, bool ZPLANES>
__global__ void __launch_bounds__(kBlock, kPairMinBlocks)
collide_stream_pair_kernel(const __nv_bfloat16* __restrict__ src,
                           __nv_bfloat16* __restrict__ dst,
                           const int8_t* __restrict__ mask, int nx, int ny,
                           int nz, const __grid_constant__ Collision coll,
                           const PairRcp rcp, BCSet bcs,
                           const __grid_constant__ ZBCSet zbcs,
                           const int* __restrict__ entries, int n_listed,
                           int n_inner, const uint32_t* __restrict__ interior,
                           int box, double* __restrict__ partials) {
  constexpr bool kPairs = kStreamed<COLL, CLOSURE>;  // else cells only
  const unsigned slot =
      (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const int nzp = (nz + 1) >> 1;
  // this thread's pair (x, y, z, two cells) or cell (one), or none
  int x = 0, y = 0, z = 0, cells = 0;
  bool pair = false;
  if (kPairs && box && (int)blockIdx.z < nx) {
    const int j = blockIdx.x * kPairLanes + threadIdx.x % kPairLanes;
    y = blockIdx.y * kPairRows + threadIdx.x / kPairLanes;
    x = blockIdx.z;
    z = 2 * j;
    const unsigned id = (x * ny + y) * nzp + j;
    pair = j < nzp && y < ny && (interior[id >> 5] >> (id & 31u)) & 1u;
  } else {
    const unsigned block =
        slot - (box ? (unsigned)nx * gridDim.x * gridDim.y : 0u);
    const long long k =
        (box ? n_inner : 0) + (long long)block * kBlock + threadIdx.x;
    if (k < n_listed) {
      const int id = entries[k];
      if (kPairs && k < n_inner) {
        const int row = id / nzp;
        x = row / ny;
        y = row - x * ny;
        z = 2 * (id - row * nzp);
        pair = true;
      } else if (mask[id] == kFluid) {
        const int xy = id / nz;
        x = xy / ny;
        y = xy - x * ny;
        z = id - xy * nz;
        cells = 1;
      }
    }
  }
  double speed = 0.0;
  if constexpr (kPairs) {
    // an interior pair whose dividends leave div_exact's range is stepped
    // again, cell by cell (its stores rewritten)
    if (pair && !stream_pair<COLL, FORCE>(src, dst, x, y, z, nx, ny, nz,
                                          coll, rcp, speed)) {
      speed = 0.0;
      cells = 2;
    }
  }
#pragma unroll 1
  for (int c = 0; c < cells; ++c) {
    speed += (double)step_cell<COLL, CLOSURE, FORCE, MOVING, ZPLANES>(
        src, dst, mask, x, y, z + c, nx, ny, nz, (x * ny + y) * nz + z + c,
        coll, rcp, bcs, zbcs);
  }
  block_sum_to(speed, partials + slot);
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

template <typename S, int K, int HALO, bool ZPLANES>
void launch_kernel(const StepArgs<S>& a, const Collision& c, const BCSet& b,
                   const ZBCSet& z) {
  using I = Inst<K>;
  if constexpr (kBounded<K, ZPLANES>) {
    bounded::collide_stream_kernel<I::kColl, I::kClosure, I::kForce,
                                   I::kMovingWall, S, HALO, ZPLANES>
        <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                          a.nz, c, b, z, a.cells, a.n_listed,
                                          a.partials, a.halo);
  } else {
    collide_stream_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall,
                          S, HALO, ZPLANES>
        <<<a.grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                          a.nz, c, b, z, a.cells, a.n_listed,
                                          a.partials, a.halo);
  }
}

// A case with z-plane boundaries launches the instance with their code; a
// case without launches the one without it, whose code is the kernel's
// before the z planes joined it (at lid 256^3 [bgk] the z code cost 0.9%
// and at gravity_channel 256^3 [trt+force] 3%: probes/path_ab.py).
template <typename S, int K, int HALO>
void launch_step(const StepArgs<S>& a, const Collision& c, const BCSet& b,
                 const ZBCSet& z) {
  if (z.n > 0) {
    launch_kernel<S, K, HALO, true>(a, c, b, z);
  } else {
    launch_kernel<S, K, HALO, false>(a, c, b, z);
  }
}

template <typename S>
using StepLauncher = void (*)(const StepArgs<S>&, const Collision&,
                              const BCSet&, const ZBCSet&);

template <typename S, int K, int HALO>
constexpr StepLauncher<S> step_entry() {
  if constexpr (has_instance<S, K, HALO>()) {
    return &launch_step<S, K, HALO>;
  } else {
    return nullptr;
  }
}
template <typename S, int HALO, int... K>
constexpr std::array<StepLauncher<S>, kNumKeys> step_table(
    std::integer_sequence<int, K...>) {
  return {step_entry<S, K, HALO>()...};
}
// one table per storage type and halo axis; a translation unit
// instantiates only the tables its entries use
template <typename S, int HALO>
constexpr std::array<StepLauncher<S>, kNumKeys> kStepTable =
    step_table<S, HALO>(std::make_integer_sequence<int, kNumKeys>{});

// The descriptors and launch arguments of one step (the host entries'
// shared checks): the collision rows coll_int/coll_float (CInt/CFloat);
// at most kMaxBCs boundaries on x/y planes and kMaxZBCs on z planes,
// each in the order of its rows (parse_bc; phi_ptrs[b] is this step's
// phase table of a series boundary); bc_wk: null, or one int a row, a
// windkessel outlet's index among n_wk (the fold's) or -1; gfield: the
// pre-step scalar state g[7][n_cells] of a field force (CI_force == 2),
// else null; cells: null (a thread a cell of the box) or a device list of
// n_listed cell ids holding every fluid cell (a non-fluid id is
// skipped); partials: one double per launched block (n_partials:
// ceil(n_listed / kBlock), at least 1, with a list; n_blocks instead
// where it is given: the paired kernel's grid). Returns the instance
// key, or -cudaErrorInvalidValue on a malformed call.
template <typename S, int HALO>
int prepare_step(const S* src, S* dst, const int8_t* mask, int nx, int ny,
                 int nz, const int* coll_int, const float* coll_float,
                 int n_bc, const int* bc_int, const float* bc_float,
                 const void* const* valid_ptrs, const void* const* phi_ptrs,
                 const int* bc_wk, int n_wk, const int* cells, int n_listed,
                 double* partials, int n_partials, const float* gfield,
                 void* stream, const Halo& halo, StepArgs<S>& args,
                 Collision& coll, BCSet& bcs, ZBCSet& zbcs,
                 long long n_blocks = -1) {
  const int bad = -(int)cudaErrorInvalidValue;
  const long long n_cells = (long long)nx * ny * nz;
  const long long grid =
      n_blocks >= 0 ? n_blocks
      : cells       ? (n_listed + kBlock - 1) / kBlock
                    : (n_cells + kBlock - 1) / kBlock;
  if (n_bc < 0 || n_bc > kMaxBCs + kMaxZBCs || n_cells <= 0 ||
      n_cells > 0x7fffffffLL || n_listed < 0 || n_listed > n_cells ||
      (grid > 0 ? grid : 1) != n_partials) {
    return bad;
  }
  if (HALO >= 0 && !(halo.lo && halo.hi && halo.mask_lo && halo.mask_hi)) {
    return bad;
  }
  const int key = parse_collision(coll_int, coll_float, gfield, coll);
  if (key < 0) return bad;
  for (int b = 0; b < n_bc; ++b) {
    BCDesc d = {};
    if (!parse_bc(bc_int + b * kBCInts, bc_float + 2 * b, valid_ptrs[b],
                  phi_ptrs[b], nx, ny, nz, d) ||
        (d.axis == 2 ? zbcs.n == kMaxZBCs : bcs.n == kMaxBCs)) {
      return bad;
    }
    d.wk = bc_wk ? bc_wk[b] : -1;
    if (d.wk >= n_wk) return bad;
    if (d.axis != 2) {
      bcs.bc[bcs.n++] = d;
    } else if (!to_zbc(d, zbcs.bc[zbcs.n++])) {
      return bad;
    }
  }
  args = {src, dst, mask, nx, ny, nz, cells, n_listed, partials,
          (unsigned)n_partials, static_cast<cudaStream_t>(stream), halo};
  return key;
}

// The host entries, exported under their C names by collide_stream.cu
// (S = float) and collide_stream_bf16.cu (S = __nv_bfloat16, names
// ending in _bf16), with HALO = -1; collide_stream_halo.cu exports the
// shard entry (S = float, HALO 0 and 1), whose `halo` planes must all
// be set; windkessel.cuh the fold's.

// One step from src into dst with the collision branch and boundaries of
// the descriptor rows (prepare_step); series[t] = sum over fluid cells of
// |u| after the rewrites. Only fluid cells are written: dst must already
// hold src's non-fluid cells. Returns cudaGetLastError().
template <typename S, int HALO = -1>
int collide_stream(const S* src, S* dst, const int8_t* mask, int nx, int ny,
                   int nz, const int* coll_int, const float* coll_float,
                   int n_bc, const int* bc_int, const float* bc_float,
                   const void* const* valid_ptrs, const void* const* phi_ptrs,
                   const int* cells, int n_listed, double* partials,
                   int n_partials, double* series, int t,
                   const float* gfield, void* stream,
                   const Halo& halo = Halo{}) {
  StepArgs<S> args;
  Collision coll = {};
  BCSet bcs = {};
  ZBCSet zbcs = {};
  const int key = prepare_step<S, HALO>(
      src, dst, mask, nx, ny, nz, coll_int, coll_float, n_bc, bc_int,
      bc_float, valid_ptrs, phi_ptrs, nullptr, 0, cells, n_listed, partials,
      n_partials, gfield, stream, halo, args, coll, bcs, zbcs);
  if (key < 0) return -key;
  if (kStepTable<S, HALO>[key] == nullptr) return (int)cudaErrorInvalidValue;
  kStepTable<S, HALO>[key](args, coll, bcs, zbcs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, args.stream>>>(
      partials, n_partials, series, t, 0);
  return (int)cudaGetLastError();
}

// The paired bf16 kernel's instances: with the z planes' code for a case
// with z-plane boundaries, without it for one without.
using PairLauncher = void (*)(const StepArgs<__nv_bfloat16>&, dim3,
                              const Collision&, const PairRcp&, const BCSet&,
                              const ZBCSet&, int, const uint32_t*, int);

template <int K>
void launch_pair(const StepArgs<__nv_bfloat16>& a, dim3 grid,
                 const Collision& c, const PairRcp& r, const BCSet& b,
                 const ZBCSet& z, int n_inner, const uint32_t* interior,
                 int box) {
  using I = Inst<K>;
  if (z.n > 0) {
    collide_stream_pair_kernel<I::kColl, I::kClosure, I::kForce,
                               I::kMovingWall, true>
        <<<grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                        a.nz, c, r, b, z, a.cells,
                                        a.n_listed, n_inner, interior, box,
                                        a.partials);
  } else {
    collide_stream_pair_kernel<I::kColl, I::kClosure, I::kForce,
                               I::kMovingWall, false>
        <<<grid, kBlock, 0, a.stream>>>(a.src, a.dst, a.mask, a.nx, a.ny,
                                        a.nz, c, r, b, z, a.cells,
                                        a.n_listed, n_inner, interior, box,
                                        a.partials);
  }
}

template <int K>
constexpr PairLauncher pair_entry() {
  if constexpr (has_instance<__nv_bfloat16, K>()) {
    return &launch_pair<K>;
  } else {
    return nullptr;
  }
}
template <int... K>
constexpr std::array<PairLauncher, kNumKeys> pair_table(
    std::integer_sequence<int, K...>) {
  return {pair_entry<K>()...};
}
// a variable template, instantiated only by the unit whose entry uses it
template <typename S>
constexpr std::array<PairLauncher, kNumKeys> kPairTable =
    pair_table(std::make_integer_sequence<int, kNumKeys>{});

// One step of bf16 state from src into dst by the paired kernel, with
// collide_stream's descriptor rows, series slot and contract (only fluid
// cells written), over `entries` (n_listed of them: n_inner interior pair
// ids, then cell ids; engine/compile.CompiledCase.pair_launch) with box
// 0, or with box 1 over the box's interior pairs (their bits in
// `interior`, engine/compile.pair_interior_bits) and the list's cells: a
// (ceil(ceil(nz / 2) / kPairLanes), ceil(ny / kPairRows), nx + the cells'
// slices) grid. partials: one double a block (n_partials: the grid's
// blocks). src and dst 4-byte aligned, 19 n_cells < 2^32. Returns
// cudaGetLastError().
template <typename S>
int collide_stream_pairs(const S* src, S* dst, const int8_t* mask, int nx,
                         int ny, int nz, const int* coll_int,
                         const float* coll_float, int n_bc,
                         const int* bc_int, const float* bc_float,
                         const void* const* valid_ptrs,
                         const void* const* phi_ptrs, const int* entries,
                         int n_listed, int n_inner,
                         const uint32_t* interior, int box, double* partials,
                         int n_partials, double* series, int t,
                         const float* gfield, void* stream) {
  static_assert(std::is_same<S, __nv_bfloat16>::value, "bf16 storage");
  const long long n_cells = (long long)nx * ny * nz;
  if (nx <= 0 || ny <= 0 || nz <= 0 || Q * n_cells >= (1LL << 32) ||
      nx > 65535 || !entries || !interior || n_inner < 0 ||
      n_inner > n_listed || (box != 0 && box != 1) ||
      (reinterpret_cast<uintptr_t>(src) & 3) ||
      (reinterpret_cast<uintptr_t>(dst) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nzp = (nz + 1) / 2;
  dim3 grid;
  if (box) {
    grid.x = (unsigned)((nzp + kPairLanes - 1) / kPairLanes);
    grid.y = (unsigned)((ny + kPairRows - 1) / kPairRows);
    const long long slice = (long long)grid.x * grid.y * kBlock;
    grid.z = (unsigned)(nx + (n_listed - n_inner + slice - 1) / slice);
  } else {
    const long long blocks = (n_listed + kBlock - 1LL) / kBlock;
    grid.x = (unsigned)(blocks > 0 ? blocks : 1);
  }
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  StepArgs<S> args;
  Collision coll = {};
  BCSet bcs = {};
  ZBCSet zbcs = {};
  const int key = prepare_step<S, -1>(
      src, dst, mask, nx, ny, nz, coll_int, coll_float, n_bc, bc_int,
      bc_float, valid_ptrs, phi_ptrs, nullptr, 0, entries, n_listed,
      partials, n_partials, gfield, stream, Halo{}, args, coll, bcs, zbcs,
      (long long)grid.x * grid.y * grid.z);
  if (key < 0) return -key;
  if (kPairTable<S>[key] == nullptr) return (int)cudaErrorInvalidValue;
  // RN(1/b) of each launch divisor: host float division rounds to nearest
  auto bits = [](float v) {
    uint32_t u;
    memcpy(&u, &v, sizeof u);
    return u;
  };
  const bool trt = coll_int[CI_coll] == kTRT;
  const PairRcp rcp = {{1.0f / coll.tau, 1.0f / coll.two_tau,
                        1.0f / coll.two_tau_m},
                       trt ? div_b_in_range(bits(coll.two_tau)) &&
                                 div_b_in_range(bits(coll.two_tau_m))
                           : div_b_in_range(bits(coll.tau))};
  kPairTable<S>[key](args, grid, coll, rcp, bcs, zbcs, n_inner, interior,
                     box);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, args.stream>>>(
      partials, n_partials, series, t, 0);
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
