// Two fused D3Q19 steps per launch (K2) and the chunked state read (K4)
// for NVIDIA Hopper (sm_90a): the kernels and their host entries,
// templated on the state's storage type. collide_stream2.cu instantiates
// them for float storage and collide_stream2_bf16.cu for bf16 storage,
// each its own translation unit and shared object, compiled side by side.
//
// lbm_collide_stream2 replaces lbm_tpu/kernels/collide_stream.py::_kernel2
// (via ::_pallas_bulk2 and make_pallas_step(fuse=2)): it advances f by two
// steps, t and t + 1, with one read and one write of the state. It takes
// every branch the single-step kernel takes except the force field (BGK,
// TRT, MRT, the closures, the constant Guo force, moving walls; lbm_tpu
// refuses force_field with fuse=2 too), the x/y-plane NEE boundaries with
// a phase table for each of the two steps, and the live-unit list (the
// `tids` of _kernel2). z-plane boundaries are refused by the host: their
// fixup runs after the bulk step and cannot sit between the two.
//
// Layout and semantics are the single-step kernel's (collide_stream.cuh):
// SoA f[19][nx][ny][nz] in fp32 or bf16, z contiguous, modulo wrap on all
// three axes, ping-pong buffers whose non-fluid cells are equal. The
// design is an x-marching column, as lbm_tpu's tile spans a whole axis
// with a skirt (_kernel2 :1727, ntiles = gx * gy :1759); here the
// marching axis is x, the largest stride, so that a plane of the column
// is whole z rows. One block of kPairThreads threads owns a unit: a kTY x
// kTZ (y, z) column tile (8 x 32: a warp stores one 128-byte fp32 row)
// over a segment of up to kSeg x planes (ceil-div over the box, so any
// extent works), and marches over it plane by plane, step j:
//   - pass 1 computes step t on mid plane j (x = xs - 1 + j), the tile
//     plus a one-cell skirt ((kTY + 2) x (kTZ + 2) cells, a thread each),
//     from device memory with the single-step kernel's per-cell body
//     (pull19 with wall and moving-wall bounce-back, nee_fix with step t's
//     phase, collide_store) into a ring of four fp32 mid planes in shared
//     memory; consecutive threads take consecutive z, so each pull is a
//     coalesced run of a z row. A non-fluid cell's slot gets its source
//     populations, and each mid cell keeps its mask byte. Only the cells
//     the unit owns (tile interior, inside the box, x inside the segment)
//     count toward step t's velsum: the skirt and the two warm-up planes
//     are recomputed by the units that own them (lbm_tpu's `vs_win`/
//     `owned`);
//   - pass 2, in the same step, computes step t + 1 on plane x = xs + j -
//     3 from mid planes j - 3 .. j - 1, applies nee_fix with step t + 1's
//     phase reading each cell's own populations from the mid ring, and
//     stores its fluid cells to dst; each counts toward step t + 1's
//     velsum. Non-fluid cells are not stored: dst already holds them.
// The two passes touch different slots of the ring (plane j in slot j mod
// 4), so one barrier a step publishes mid plane j and frees the slot of
// plane j - 3, and nothing is copied. Every global index is wrapped and
// the ring is indexed only locally, so a box axis shorter than the tile
// (pipe n = 36, a 3-cell z) works. Arithmetic is the shared device
// functions' (d3q19.cuh), so a pair equals two single-step launches bit
// for bit; the velsums are summed per block in double in a fixed order,
// as there, but over other blocks, so they agree to rounding.
//
// What bounds it: a pair moves one state's bytes (one read, one write)
// against two for two single steps, and the skirt's re-reads mostly hit
// L2; but the step is bound by the time its collisions take to issue, not
// by bytes (K1 at lid 256^3: 1.16 ms against a 0.73 ms byte bound), so
// what counts is the collisions a pair computes, (kTY + 2)(kTZ + 2) /
// (kTY kTZ) = 1.33x a plane's in pass 1 plus (kSeg + 2) / kSeg for the
// warm-up planes (the 8^3 cube of the first design: 1.95x), and the warps
// in flight. The ring (104,720 bytes) leaves room for two blocks of 11
// warps an SM, which caps a thread at 80 registers (small spills).
// Measured on the H100 (PERF.md): staging the source planes in shared
// memory too, by cp.async, left one block an SM (11 warps) and took 3.20
// ms a launch at lid 256^3 where this design takes 2.47; the other tiles
// and occupancies that probes/pair_tiles.py builds do no better.
//
// bf16 storage (S = __nv_bfloat16) widens pass 1's loads and narrows pass
// 2's stores; the mid ring stays fp32 whatever the storage, as lbm_tpu's
// does (collide_stream.py:2084-2086), so a bf16 pair rounds once: "widen,
// two fp32 steps, narrow", bit for bit. That is lbm_tpu's bf16 fuse=2
// result, and not two bf16 single steps, which narrow in between.
//
// lbm_extract_rows replaces ::_extract_rows (the HBM-to-HBM DMA of x rows
// behind unpack_state_lowmem): out[c, i, y, z] = f[c, x0 + i, y, z] for the
// 19 channels, a contiguous (19, wx, Y, Z) chunk in the state's own type.
// Each channel's rows are one contiguous span, so it is a copy of 19
// spans, 16 bytes a thread where alignment allows; bound by bytes (each
// read and written once; a bf16 chunk is half the bytes).

#pragma once

#include "d3q19.cuh"

namespace {

constexpr int kTY = 8;                  // column tile, y rows
constexpr int kTZ = 32;                 // column tile, z cells (a warp)
constexpr int kSeg = 64;                // x planes a unit writes
constexpr int kPairBlocksPerSM = 2;     // the launch bounds' occupancy
constexpr int kMZ = kTZ + 2;            // mid plane row
constexpr int kMid = (kTY + 2) * kMZ;   // mid plane cells
constexpr int kRowW = (kTZ + 31) / 32 * 32;  // threads a row of the tile
constexpr int kZLead = (kRowW - kTZ) / 2;    // of them before z0
// a mid cell a thread, and whole warps a z row of the tile
constexpr int kPairThreads =
    ((kMid > kRowW * kTY ? kMid : kRowW * kTY) + 31) / 32 * 32;
constexpr int kMidSlots = 4;            // mid planes x - 1 .. x + 2
// the mid ring, its mask bytes
constexpr size_t kPairSmem =
    (size_t)kMidSlots * kMid * (Q * sizeof(float) + 1);
constexpr int kCopyBlock = 256;
static_assert(kPairThreads <= 1024 &&
                  kPairSmem * kPairBlocksPerSM <= 232448 &&
                  kPairThreads * sizeof(double) <= kPairSmem,
              "a block's threads and shared memory on sm_90");

// v mod n in [0, n), for any int v
__device__ __forceinline__ int wrap_mod(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// The pulled populations of mid cell m of plane x from the mid ring
// (lo, c, hi: planes x - 1, x, x + 1, with their mask bytes).
template <bool MOVING>
__device__ __forceinline__ void pull_mid(const float* lo, const float* c,
                                         const float* hi, const int8_t* klo,
                                         const int8_t* kc, const int8_t* khi,
                                         int m, const float* bb, float* p) {
  p[0] = c[m];
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const float* s = EX(i) > 0 ? lo : (EX(i) < 0 ? hi : c);
    const int8_t* k = EX(i) > 0 ? klo : (EX(i) < 0 ? khi : kc);
    const int nb = m - EY(i) * kMZ - EZ(i);
    const int8_t mk = k[nb];
    if constexpr (MOVING) {
      const float v = mk == kWall || mk == kMoving ? c[OPP(i) * kMid + m]
                                                   : s[i * kMid + nb];
      p[i] = mk == kMoving ? v + bb[i] : v;
    } else {
      p[i] = mk == kWall ? c[OPP(i) * kMid + m] : s[i * kMid + nb];
    }
  }
}

// The NEE rewrites of the x/y-plane boundaries of one step at global cell
// (x, y, z), own pre-step populations at own[k * stride + idx] (the
// state in device memory, or a mid plane).
template <bool FORCE, typename S>
__device__ __forceinline__ void nee_all(const BCSet& bcs, const S* own,
                                        long long stride, int idx, int x,
                                        int y, int z, int nz,
                                        const float* half_force, float* p) {
#pragma unroll
  for (int b = 0; b < kMaxBCs; ++b) {
    if (b >= bcs.n) break;
    const BCDesc& bc = bcs.bc[b];
    if ((bc.axis == 0 ? x : y) != bc.coord) continue;
    const long long lat = (long long)(bc.axis == 0 ? y : x) * nz + z;
    nee_fix<FORCE>(bc, own, stride, idx, lat, half_force, p);
  }
}

// partials[blockIdx.x] = the block's sum of v1, partials[gridDim.x +
// blockIdx.x] of v2, each in a fixed order (red: kPairThreads doubles of
// shared memory, free).
__device__ __forceinline__ void pair_sum(double v1, double v2, double* red,
                                         double* __restrict__ partials) {
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    red[threadIdx.x] = which ? v2 : v1;
    __syncthreads();
#pragma unroll
    for (int s = 512; s > 0; s >>= 1) {  // fixed order, any block size
      if (threadIdx.x < s && threadIdx.x + s < kPairThreads) {
        red[threadIdx.x] += red[threadIdx.x + s];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[which * gridDim.x + blockIdx.x] = red[0];
    __syncthreads();
  }
}

// Launch block b marches unit units[b], or unit b when `units` is null;
// unit ids run over the (gs, gy, gz) grid of x segments and (y, z)
// column tiles, z fastest. partials[b] gets the block's step-t velsum,
// partials[gridDim.x + b] its step t + 1 velsum.
template <int COLL, bool CLOSURE, int FORCE, bool MOVING, typename S>
__global__ void __launch_bounds__(kPairThreads, kPairBlocksPerSM)
collide_stream2_kernel(const S* __restrict__ src, S* __restrict__ dst,
                       const int8_t* __restrict__ mask, int nx, int ny,
                       int nz, int gy, int gz,
                       const __grid_constant__ Collision coll, BCSet bcs_t,
                       BCSet bcs_t1, const int* __restrict__ units,
                       double* __restrict__ partials) {
  extern __shared__ __align__(16) float mids[];  // [kMidSlots][Q][kMid]
  int8_t* mmask = reinterpret_cast<int8_t*>(mids + kMidSlots * Q * kMid);
  constexpr bool kForce = FORCE == kConstForce;
  const int tid = threadIdx.x;
  const long long n_cells = (long long)nx * ny * nz;  // < 2^31 (host)
  const int unit = units ? units[blockIdx.x] : (int)blockIdx.x;
  const int xs = unit / (gy * gz) * kSeg;
  const int y0 = unit / gz % gy * kTY;
  const int z0 = unit % gz * kTZ;
  const int len = min(kSeg, nx - xs);

  // pass 1's mid cell: row mr, column mc, global y and z wrapped
  const int mr = tid / kMZ, mc = tid - mr * kMZ;
  const bool p1 = tid < kMid;
  const int my = wrap_mod(y0 - 1 + mr, ny), mz = wrap_mod(z0 - 1 + mc, nz);
  const bool owned = mr >= 1 && mr <= kTY && mc >= 1 && mc <= kTZ &&
                     y0 + mr - 1 < ny && z0 + mc - 1 < nz;
  // pass 2's cell: row oy of the tile, a warp 32 of its z cells
  const int oy = tid / kRowW, oz = tid % kRowW - kZLead;
  const int y = y0 + oy, z = z0 + oz;
  const bool p2 = oy < kTY && oz >= 0 && oz < kTZ && y < ny && z < nz;
  const int om = (oy + 1) * kMZ + oz + 1;

  double vs1 = 0.0, vs2 = 0.0;
  // step j computes mid plane j (x = xs - 1 + j, slot j % 4) and, from j
  // = 3, writes plane x = xs + j - 3 from mid planes j - 3 .. j - 1: the
  // two passes touch different slots, so one barrier a step publishes
  // mid plane j and frees the slot of j - 3
  for (int j = 0; j < len + 3; ++j) {
    float* mid = mids + (j % kMidSlots) * (Q * kMid);
    if (p1 && j < len + 2) {
      const int x = wrap_mod(xs - 1 + j, nx);
      const int cell = (x * ny + my) * nz + mz;
      const int8_t mk = mask[cell];
      mmask[(j % kMidSlots) * kMid + tid] = mk;
      if (mk != kFluid) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          mid[i * kMid + tid] = widen(src[i * n_cells + cell]);
        }
      } else {
        float p[Q];
        pull19<MOVING>(src, mask, x, my, mz, nx, ny, nz, n_cells, cell,
                       coll.bb, p);
        nee_all<kForce>(bcs_t, src, n_cells, cell, x, my, mz, nz,
                        coll.half_force, p);
        const float usq = collide_store<COLL, CLOSURE, FORCE>(
            p, coll, coll.force, coll.half_force, mid, kMid, tid);
        if (owned && j >= 1 && j <= len) vs1 += (double)sqrtf(usq);
      }
    }

    // pass 2: step t + 1 at plane x = xs + j - 3, its fluid cells stored
    if (j >= 3 && p2) {
      const int8_t* kc = mmask + ((j - 2) % kMidSlots) * kMid;
      if (kc[om] == kFluid) {
        const float* c = mids + ((j - 2) % kMidSlots) * (Q * kMid);
        const int x = xs + j - 3;
        float p[Q];
        pull_mid<MOVING>(mids + ((j - 3) % kMidSlots) * (Q * kMid), c,
                         mids + ((j - 1) % kMidSlots) * (Q * kMid),
                         mmask + ((j - 3) % kMidSlots) * kMid, kc,
                         mmask + ((j - 1) % kMidSlots) * kMid, om, coll.bb,
                         p);
        nee_all<kForce>(bcs_t1, c, kMid, om, x, y, z, nz, coll.half_force,
                        p);
        vs2 += (double)sqrtf(collide_store<COLL, CLOSURE, FORCE>(
            p, coll, coll.force, coll.half_force, dst, n_cells,
            (x * ny + y) * nz + z));
      }
    }
    __syncthreads();
  }
  pair_sum(vs1, vs2, reinterpret_cast<double*>(mids), partials);
}

// out[c][k] = f[c * plane + off + k] for k < n, the 19 channels on
// blockIdx.y; T is float4 when every span is 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kCopyBlock)
extract_rows_kernel(const T* __restrict__ f, T* __restrict__ out,
                    long long plane, long long off, long long n) {
  const long long c = blockIdx.y;
  const T* from = f + c * plane + off;
  T* to = out + c * n;
  for (long long k = (long long)blockIdx.x * kCopyBlock + threadIdx.x; k < n;
       k += (long long)gridDim.x * kCopyBlock) {
    to[k] = from[k];
  }
}

template <typename S>
struct PairArgs {
  const S* src;
  S* dst;
  const int8_t* mask;
  int nx, ny, nz, gy, gz;
  const int* units;
  double* partials;
  unsigned grid;
  cudaStream_t stream;
};

template <typename S>
using PairLauncher = int (*)(const PairArgs<S>&, const Collision&,
                             const BCSet&, const BCSet&);

template <typename S, int K>
int launch_pair(const PairArgs<S>& a, const Collision& c, const BCSet& bt,
                const BCSet& bt1) {
  using I = Inst<K>;
  cudaError_t err = cudaFuncSetAttribute(
      collide_stream2_kernel<I::kColl, I::kClosure, I::kForce,
                             I::kMovingWall, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPairSmem);
  if (err != cudaSuccess) return (int)err;
  collide_stream2_kernel<I::kColl, I::kClosure, I::kForce, I::kMovingWall, S>
      <<<a.grid, kPairThreads, kPairSmem, a.stream>>>(
          a.src, a.dst, a.mask, a.nx, a.ny, a.nz, a.gy, a.gz, c, bt, bt1,
          a.units, a.partials);
  return (int)cudaGetLastError();
}

// The pair has every single-step instance but the force field's, in
// either storage.
template <typename S, int K>
constexpr PairLauncher<S> pair_entry() {
  if constexpr (Inst<K>::kValid && Inst<K>::kForce != kFieldForce) {
    return &launch_pair<S, K>;
  } else {
    return nullptr;
  }
}
template <typename S, int... K>
constexpr std::array<PairLauncher<S>, kNumKeys> pair_table(
    std::integer_sequence<int, K...>) {
  return {pair_entry<S, K>()...};
}
template <typename S>
constexpr std::array<PairLauncher<S>, kNumKeys> kPairTable =
    pair_table<S>(std::make_integer_sequence<int, kNumKeys>{});

bool parse_bcs(int n_bc, const int* bc_int, const float* bc_float,
               const void* const* valid_ptrs, const void* const* phi_ptrs,
               int nx, int ny, int nz, BCSet& bcs) {
  bcs.n = n_bc;
  for (int b = 0; b < n_bc; ++b) {
    if (!parse_bc(bc_int + b * kBCInts, bc_float + 2 * b, valid_ptrs[b],
                  phi_ptrs[b], nx, ny, nz, bcs.bc[b]) ||
        bcs.bc[b].axis == 2) {
      return false;
    }
  }
  return true;
}

// Blocks of instance K (instance_key) an SM holds at once, or -1 on an
// error; pair_blocks_per_sm(key) of a runtime key, -1 for a key without
// an instance.
template <typename S, int K>
int pair_occupancy() {
  using I = Inst<K>;
  const auto kernel = collide_stream2_kernel<I::kColl, I::kClosure,
                                             I::kForce, I::kMovingWall, S>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kPairSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kPairThreads, kPairSmem) != cudaSuccess) {
    return -1;
  }
  return n;
}
using OccupancyFn = int (*)();
template <typename S, int K>
constexpr OccupancyFn occupancy_entry() {
  if constexpr (Inst<K>::kValid && Inst<K>::kForce != kFieldForce) {
    return &pair_occupancy<S, K>;
  } else {
    return nullptr;
  }
}
template <typename S, int... K>
constexpr std::array<OccupancyFn, kNumKeys> occupancy_table(
    std::integer_sequence<int, K...>) {
  return {occupancy_entry<S, K>()...};
}
template <typename S>
int pair_blocks_per_sm(int key) {
  static constexpr std::array<OccupancyFn, kNumKeys> table =
      occupancy_table<S>(std::make_integer_sequence<int, kNumKeys>{});
  return key < 0 || key >= kNumKeys || table[key] == nullptr ? -1
                                                             : table[key]();
}

// The extent of the pair's unit along axis 0 (x: the segment), 1 (y) or
// 2 (z: the column tile), or 0 for another axis.
int pair_unit(int axis) {
  return axis == 0 ? kSeg : (axis == 1 ? kTY : (axis == 2 ? kTZ : 0));
}

// The host entries, exported under their C names by collide_stream2.cu
// (S = float) and collide_stream2_bf16.cu (S = __nv_bfloat16, names
// ending in _bf16).

// Two steps from src into dst at absolute steps t and t + 1 with the
// collision branch of coll_int/coll_float (CInt/CFloat; no force field)
// and the x/y-plane boundaries (rows as parse_bc): phi_t[b] and phi_t1[b]
// are boundary b's phase tables of the two steps (null for u_extrap).
// series[slot] and series[slot + 1] = the fluid velsums of the two steps.
// units: null (every unit of the ceil-div (kSeg, kTY, kTZ) grid) or a
// device list of n_units unit ids; the units left out must hold only
// DEAD cells. Only fluid cells are written: dst must already hold src's
// non-fluid cells. partials holds 2 doubles a launched unit (n_partials).
// Returns cudaGetLastError().
template <typename S>
int collide_stream2(const S* src, S* dst, const int8_t* mask, int nx, int ny,
                    int nz, const int* coll_int, const float* coll_float,
                    int n_bc, const int* bc_int, const float* bc_float,
                    const void* const* valid_ptrs, const void* const* phi_t,
                    const void* const* phi_t1, const int* units, int n_units,
                    double* partials, int n_partials, double* series,
                    int slot, void* stream) {
  const long long n_cells = (long long)nx * ny * nz;
  if (nx <= 0 || ny <= 0 || nz <= 0 || n_cells > 0x7fffffffLL ||
      n_bc < 0 || n_bc > kMaxBCs) {
    return (int)cudaErrorInvalidValue;
  }
  const int gs = (nx + kSeg - 1) / kSeg, gy = (ny + kTY - 1) / kTY,
            gz = (nz + kTZ - 1) / kTZ;
  const long long all_units = (long long)gs * gy * gz;
  const long long grid = units ? n_units : all_units;
  if (grid <= 0 || grid > all_units || 2 * grid != n_partials) {
    return (int)cudaErrorInvalidValue;
  }
  Collision coll = {};
  const int key = parse_collision(coll_int, coll_float, nullptr, coll);
  if (key < 0 || kPairTable<S>[key] == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  BCSet bt = {}, bt1 = {};
  if (!parse_bcs(n_bc, bc_int, bc_float, valid_ptrs, phi_t, nx, ny, nz, bt) ||
      !parse_bcs(n_bc, bc_int, bc_float, valid_ptrs, phi_t1, nx, ny, nz,
                 bt1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PairArgs<S> args = {src, dst, mask, nx, ny, nz, gy, gz, units,
                            partials, (unsigned)grid, s};
  int err = kPairTable<S>[key](args, coll, bt, bt1);
  if (err != 0) return err;
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials, (int)grid,
                                                   series, slot, 0);
  velsum_reduce_kernel<<<1, kReduceBlock, 0, s>>>(partials + grid, (int)grid,
                                                   series, slot + 1, 0);
  return (int)cudaGetLastError();
}

// x rows [x0, x0 + wx) of the (19, X, Y, Z) state f into the contiguous
// (19, wx, Y, Z) out, both in storage type S. Returns cudaGetLastError().
template <typename S>
int extract_rows(const S* f, S* out, int X, int Y, int Z, int x0, int wx,
                 void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || x0 < 0 || wx <= 0 || x0 + wx > X) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row = (long long)Y * Z;
  long long plane = X * row, off = x0 * row, n = wx * row;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr long long per_vec = 16 / sizeof(S);  // elements in a float4
  const bool vec = row % per_vec == 0 &&
                   reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    plane /= per_vec, off /= per_vec, n /= per_vec;
  }
  const long long blocks = (n + kCopyBlock - 1) / kCopyBlock;
  const dim3 grid((unsigned)(blocks < 8192 ? blocks : 8192), Q);
  if (vec) {
    extract_rows_kernel<float4><<<grid, kCopyBlock, 0, s>>>(
        reinterpret_cast<const float4*>(f), reinterpret_cast<float4*>(out),
        plane, off, n);
  } else {
    extract_rows_kernel<S><<<grid, kCopyBlock, 0, s>>>(f, out, plane, off,
                                                      n);
  }
  return (int)cudaGetLastError();
}

}  // namespace
