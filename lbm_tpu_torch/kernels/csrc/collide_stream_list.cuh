// The fp32 collide-stream step over a vessel's fluid cells, built for the
// H100: collide_stream_list_kernel, the launch of K1b/K1c (the whole box,
// collide_stream_list.cu) and K1d (a shard, collide_stream_halo.cu) over
// the fluid cells, with collide_stream_kernel's template parameters and
// arithmetic (collide_stream.cuh), so it is bit for bit the same step. It
// replaces lbm_tpu/kernels/collide_stream.py::_kernel over its live-tile
// list (`tids`, ::live_tile_ids :2651), with its halo_axis branch on a
// shard (:1386-1531).
//
// The launch over a list of fluid-cell ids that it replaces took a thread
// a listed id, then three integer div/mods for (x, y, z), then 18
// neighbour mask bytes (an x neighbour's 108 KB away) before it could
// address the 18 populations it pulls: four dependent rounds of loads
// for a cell. Here (engine/compile.fluid_launch_tables):
//   - each row's fluid runs are covered by segments of kSegLanes cells
//     aligned to kSegLanes in the flattened cell id, a thread a lane, so
//     a direction's loads and stores of a segment fall in whole 32-byte
//     sectors (two when the pull shifts in z); segments ascend as the
//     cells do, so a block holds neighbouring y rows of one x, whose
//     gathers the L1 shares; on the full coronary 425,080 lanes for its
//     379,508 fluid cells;
//   - a segment carries its x, y and lane 0's z (one 8-byte word, read
//     by its lanes at once), so no division makes a cell's coordinates;
//   - a lane's 4-byte word carries its cell's wall links (bit i:
//     direction i's source is a wall, so the pull reads the cell's own
//     opposite population), so no mask byte is loaded and the 19
//     population loads issue in one round after the two table loads; an
//     instance with moving walls reads a second word of moving-source
//     bits (the wall links count both, as pull19 tests both);
//   - a lane of a segment whose cell is not fluid (LANE_IDLE) or lies
//     outside the row (LANE_OUT) steps nothing: both buffers hold the
//     same non-fluid state (storing its unchanged populations, for whole
//     sectors, took 11% longer).
// The links of a shard's face rows come from its neighbours' rows
// (ShardCase.mask_lo/mask_hi), and its pulls across the faces read the
// exchanged planes, as pull19's HALO form does. The box launch
// (collide_stream_kernel, a thread a cell of the box) keeps its code.
//
// What bounds it on the H100 (probes/list_k1_ab.py, PERF.md): the memory
// traffic, not the collision or the list. The dependent rounds above
// cost about 5% of the old launch ([bgk+z] 0.0555 ms against 0.0587 in
// the same form); with the collision taken out, the pull and the stores
// alone took 0.0537 ms. The fluid cells' loads and stores touch 66.6 MB
// in 32-byte sectors (0.0199 ms at 3.35 TB/s), scattered over the 38
// planes of the two buffers, 126 MB apart: the card moves them at about
// 1.2 TB/s, and fetching 64 to 256 bytes a miss took longer. L2 eviction
// hints (loads evict-first, stores evict-last) gained nothing on the full
// coronary, whose two buffers' sectors exceed the 50 MB L2, and 15% on a
// 4-way y shard (not taken: its path interleaves four ranks).

#pragma once

#include "collide_stream.cuh"

namespace {

// Lanes a segment (engine/compile.SEG): 32 bytes of fp32 a direction.
constexpr int kSegLanes = 8;
// Threads a block of the launch, and blocks an SM it is built for (its
// launch bound: 768 threads an SM, 80 registers). [bgk+z] on the full
// coronary took 0.0533 ms a launch in blocks of 128, 0.0555 in blocks of
// 256 and 0.0542 in blocks of 64; at 64 registers (1024 threads an SM,
// 40-112 spilled bytes) 0.0569 (H100, probes/list_k1_ab.py).
constexpr int kListBlock = 128;
constexpr int kListMinBlocks = 6;
// A lane's word without links: a non-fluid cell of the row (kIdle, bit 0
// set), or a lane outside the row (kOut, every bit); engine/compile
// LANE_IDLE and LANE_OUT.
constexpr uint32_t kIdle = 1u;
constexpr uint32_t kOut = 0xffffffffu;

// pull19's populations of cell (x, y, z) with its wall links given:
// direction i's value at x - e_i (wrapped), or, where bit i of `links` is
// set, the cell's own opposite population, plus bb[i] where bit i of
// `moving` is set (MOVING). HALO 0 or 1: a shard's sources beyond its
// rows on that axis come from the planes h.
template <bool MOVING, int HALO, typename S>
__device__ __forceinline__ void pull19_linked(
    const S* __restrict__ src, uint32_t links, uint32_t moving, int x, int y,
    int z, int nx, int ny, int nz, long long n_cells, int cell,
    const float* bb, float* p, const Halo& h) {
  p[0] = widen(src[cell]);
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const bool own = (links >> i) & 1u;
    const S* at = src + (long long)OPP(i) * n_cells + cell;
    if (!own) {
      const int xs = wrap(x - EX(i), nx);
      const int ys = wrap(y - EY(i), ny);
      const int zs = wrap(z - EZ(i), nz);
      at = src + (long long)i * n_cells + (xs * ny + ys) * nz + zs;
      if constexpr (HALO >= 0) {
        // a source beyond the shard's face lies in the neighbour's plane
        static_assert(std::is_same<S, float>::value, "a shard is fp32");
        const int ea = e_axis(HALO, i);
        const int c = HALO == 0 ? x : y;
        if (ea != 0 && c == (ea > 0 ? 0 : (HALO == 0 ? nx : ny) - 1)) {
          at = (ea > 0 ? h.lo : h.hi) +
               (long long)halo_slot(HALO, i) * (HALO == 0 ? ny : nx) * nz +
               (HALO == 0 ? ys : xs) * nz + zs;
        }
      }
    }
    const float v = widen(*at);
    if constexpr (MOVING) {
      p[i] = (moving >> i) & 1u ? v + bb[i] : v;
    } else {
      p[i] = v;
    }
  }
}

// Thread k steps lane k % kSegLanes of segment k / kSegLanes: segs[s] =
// (x | y << 16, z of lane 0), links[k] its word (kIdle and kOut step
// nothing), moving[k] its moving-source bits (MOVING). The rest is
// collide_stream_cells' step of a fluid cell: the x/y planes' NEE
// rewrites, the z plane's, the force, collide_store, the block's velsum
// partial in a fixed order. Every instance carries the z planes' code (a
// case without z planes walks an empty descriptor set): on this launch it
// costs no register (each instance took as many without it), and one
// instance a branch halves the units' build.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO>
__device__ __forceinline__ void collide_stream_segs(
    const S* __restrict__ src, S* __restrict__ dst, int nx, int ny, int nz,
    const Collision& coll, const BCSet& bcs, const ZBCSet& zbcs,
    const int2* __restrict__ segs,
    const uint32_t* __restrict__ links, const uint32_t* __restrict__ moving,
    int n_lanes, double* __restrict__ partials, const Halo& halo) {
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host check)
  constexpr bool kEarlyField = COLL == kTRT && FORCE == kFieldForce;
  // a closure's divisions by rho and tau_eff div_exact's (the same values,
  // without the IEEE slow path that zero dividends take, as at rest
  // its relaxation's do): [trt+cy+z] on the resting full coronary took
  // 0.0696 ms with IEEE division and 0.0586 with it, developed 0.0586 and
  // 0.0584; BGK gained nothing and K1d [bgk+halo] lost 4% (H100,
  // probes/list_k1_ab.py)
  constexpr bool kDivx = CLOSURE;
  const int k = blockIdx.x * kListBlock + threadIdx.x;
  const uint32_t word = k < n_lanes ? links[k] : kOut;
  float speed = 0.0f;
  if (!(word & kIdle)) {
    const int2 seg = segs[k / kSegLanes];
    const int x = seg.x & 0xffff;
    const int y = (unsigned)seg.x >> 16;
    const int z = seg.y + k % kSegLanes;
    const int cell = (x * ny + y) * nz + z;
    float dc = 0.0f;
    if constexpr (kEarlyField) dc = field_dc(coll, n_cells, cell);
    float p[Q];
    pull19_linked<MOVING, HALO>(src, word, MOVING ? moving[k] : 0u, x, y, z,
                                nx, ny, nz, n_cells, cell, coll.bb, p, halo);
#pragma unroll
    for (int b = 0; b < kMaxBCs; ++b) {
      if (b >= bcs.n) break;
      const BCDesc& bc = bcs.bc[b];
      if ((bc.axis == 0 ? x : y) != bc.coord) continue;
      const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
      nee_fix<FORCE == kConstForce, S, false, kDivx>(
          bc, src, n_cells, cell, lat, coll.half_force, p);
    }
    {  // the z plane that rewrites this cell, if one does
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
        nee_fix_z<FORCE == kConstForce, S, false, kDivx>(
            zbcs.bc[zb], src, n_cells, cell, zlat, coll.half_force, p);
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
    speed = sqrtf(collide_store<COLL, CLOSURE, FORCE, S, kDivx>(
        p, coll, F, half, dst, n_cells, cell));
  }
  // the block's velsum partial, summed in a fixed order
  __shared__ double red[kListBlock];
  red[threadIdx.x] = (double)speed;
  __syncthreads();
#pragma unroll
  for (unsigned s = kListBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S,
          int HALO>
__global__ void __launch_bounds__(kListBlock, kListMinBlocks)
collide_stream_list_kernel(const S* __restrict__ src, S* __restrict__ dst,
                           int nx, int ny, int nz,
                           const __grid_constant__ Collision coll,
                           BCSet bcs, const __grid_constant__ ZBCSet zbcs,
                           const int2* __restrict__ segs,
                           const uint32_t* __restrict__ links,
                           const uint32_t* __restrict__ moving, int n_lanes,
                           double* __restrict__ partials, const Halo halo) {
  collide_stream_segs<COLL, CLOSURE, FORCE, MOVING, S, HALO>(
      src, dst, nx, ny, nz, coll, bcs, zbcs, segs, links, moving, n_lanes,
      partials, halo);
}

// The launch's tables: segs (n_segs), links and moving (kSegLanes n_segs
// words; moving null unless the instance has moving walls).
struct ListArgs {
  const int2* segs;
  const uint32_t* links;
  const uint32_t* moving;
  int n_lanes;
};

template <typename S, int K, int HALO>
void launch_list(const StepArgs<S>& a, const ListArgs& l, const Collision& c,
                 const BCSet& b, const ZBCSet& z) {
  using I = Inst<K>;
  collide_stream_list_kernel<I::kColl, I::kClosure, I::kForce,
                             I::kMovingWall, S, HALO>
      <<<a.grid, kListBlock, 0, a.stream>>>(
          a.src, a.dst, a.nx, a.ny, a.nz, c, b, z, l.segs, l.links,
          l.moving, l.n_lanes, a.partials, a.halo);
}

template <typename S>
using ListLauncher = void (*)(const StepArgs<S>&, const ListArgs&,
                              const Collision&, const BCSet&, const ZBCSet&);

template <typename S, int K, int HALO>
constexpr ListLauncher<S> list_entry() {
  if constexpr (has_instance<S, K, HALO>()) {
    return &launch_list<S, K, HALO>;
  } else {
    return nullptr;
  }
}
template <typename S, int HALO, int... K>
constexpr std::array<ListLauncher<S>, kNumKeys> list_table(
    std::integer_sequence<int, K...>) {
  return {list_entry<S, K, HALO>()...};
}
template <typename S, int HALO>
constexpr std::array<ListLauncher<S>, kNumKeys> kListTable =
    list_table<S, HALO>(std::make_integer_sequence<int, kNumKeys>{});

// One step of fp32 state from src into dst over the fluid cells of the
// launch tables (engine/compile.FluidLaunch: n_segs segments, their
// lanes' links and, for an instance with moving walls, moving-source
// bits), with collide_stream's descriptor rows, series slot and contract
// (only fluid cells written); partials: one double a block of the
// ceil(kSegLanes n_segs / kListBlock) blocks. HALO 0 or 1: a shard's, its
// halo planes all set. Returns cudaGetLastError().
template <typename S, int HALO = -1>
int collide_stream_list(const S* src, S* dst, int nx, int ny, int nz,
                        const int* coll_int, const float* coll_float,
                        int n_bc, const int* bc_int, const float* bc_float,
                        const void* const* valid_ptrs,
                        const void* const* phi_ptrs, const int* segs,
                        const int* links, const int* moving, int n_segs,
                        double* partials, int n_partials, double* series,
                        int t, const float* gfield, void* stream,
                        const Halo& halo = Halo{}) {
  const long long n_lanes = (long long)n_segs * kSegLanes;
  if (n_segs <= 0 || n_lanes > 0x7fffffffLL || !segs || !links ||
      (reinterpret_cast<uintptr_t>(segs) & 7) || nx >= (1 << 16) ||
      ny >= (1 << 16) || (moving != nullptr) != (coll_int[CI_moving] != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  StepArgs<S> args;
  Collision coll = {};
  BCSet bcs = {};
  ZBCSet zbcs = {};
  const int key = prepare_step<S, HALO>(
      src, dst, nullptr, nx, ny, nz, coll_int, coll_float, n_bc, bc_int,
      bc_float, valid_ptrs, phi_ptrs, nullptr, 0, nullptr, 0, partials,
      n_partials, gfield, stream, halo, args, coll, bcs, zbcs,
      (n_lanes + kListBlock - 1) / kListBlock);
  if (key < 0) return -key;
  if (kListTable<S, HALO>[key] == nullptr) return (int)cudaErrorInvalidValue;
  const ListArgs l = {reinterpret_cast<const int2*>(segs),
                      reinterpret_cast<const uint32_t*>(links),
                      reinterpret_cast<const uint32_t*>(moving),
                      (int)n_lanes};
  kListTable<S, HALO>[key](args, l, coll, bcs, zbcs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, args.stream>>>(
      partials, n_partials, series, t, 0);
  return (int)cudaGetLastError();
}

}  // namespace
