// The flat multi-step kernel for Hopper (sm_90a): n_steps wall-free D2Q9
// lattice-Boltzmann steps (channel forcing with the all-or-nothing guard,
// periodic pull, BGK collision) in ONE launch over a stacked ping-pong
// pair, with up to T steps per pass through device memory.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::make_flat_step's
// pl.pallas_call (ops/fused_kernel.py:1845; _make_kernel(multipass=P),
// :212-232, advance_flat :1514-1575, guards :387-404): P passes of T
// fused steps per launch over a stacked (2, 9, NX, NYP) buffer, in place,
// each pass running its T steps on a row window held in VMEM and writing
// device memory once. Here the count of steps is one run-time number,
// n_steps (even), and T (`temporal`) is the most steps a pass runs. The TPU
// kernel's block rows, rotating slots, mirror pads, refresh phase and
// cross-pass VMEM carry are staging and have no counterpart.
//
// What bounds it. Through device memory one step moves 72 B a site in
// float32 (36 B in bf16), and the kernel this one replaced (one grid-wide
// barrier per step, every step through device memory) could not go below
// that. A pass of L steps held in shared memory reads its tile, halos
// included, once and writes the tile's interior once, so its bytes per
// site-step fall about as 1/L; what it pays instead is the halos: each
// tile reads 1.2-1.8 times its output sites and computes the shrinking
// halo levels again (about 1.1-1.4 times the sites), with IEEE division
// and no fused multiply-add. On an H100 a pass costs about as much as one
// step through device memory (its load and store) and each level after
// the first about a fourth of that (PERF.md), so the time per step falls
// with the steps a pass runs: T (`temporal`, fused_kernel.FLAT_TEMPORAL)
// and the tile's shape (kW, kNT) are chosen by measurement.
//
// The design:
// - a persistent cooperative grid, as many CTAs as the card holds at once
//   with the tile's dynamic shared memory (two CTAs of 256 threads per SM,
//   so that one CTA's loads run under the other's levels), each walking
//   the output tiles (R rows x C columns) of a pass in a grid-stride loop;
//   cooperative_groups' grid-wide sync separates passes
//   and orders one pass's stores before the next pass's loads (the
//   buffers are neither const nor __restrict__, and the loads are 16-byte
//   cp.async.cg copies through L2, never the non-coherent path);
// - a tile of `rows` x kW sites in shared memory (kW = 72 columns; rows:
//   what two CTAs per SM leave, read from the card), from which a pass of
//   L steps writes output tiles of (rows - 2L) x (kW - 2 PAD) sites, PAD =
//   L rounded up to a 16-byte vector's columns: per output tile, the
//   (R + 2L) x (C + 2L) source sites of all 9 planes, in the storage type,
//   loaded with periodic wrap in both axes by modulo indices (on a lattice
//   smaller than the tile one site appears more than once), as rows of the
//   9 planes interleaved ([row][plane][column]), so that every pull's
//   offset is a compile-time constant;
// - L levels in place, the region shrinking by one site a level on each
//   side. A level reads and writes the same nine slots per site, in two
//   alternating layouts: natural (slot (x, s) holds f_s(x)) and pushed
//   (slot (x + e_s, opp s) holds f_s(x), i.e. a site's own slots hold what
//   it pulls). A level from natural to pushed reads f_s(x - e_s) from
//   slot (x - e_s, s) and writes its result for speed s into slot
//   (x + e_s, opp s), which is where it read speed opp s; a level from
//   pushed to natural reads its own slots (x, opp s) and writes (x, s).
//   Either way no site's write can reach another site's read, so a level
//   needs one barrier and no copy of the tile;
// - forcing at source sites of GLOBAL column 0 (in the wrap halo and at
//   every level, not at the tile's column 0), decided by the guard at the
//   level being read: a tile that holds column 0 first writes the guard of
//   each such site into a bit mask in shared memory (the level's writes
//   would otherwise race with other sites' guard reads), then a barrier;
// - the last level writes the output tile from registers to the
//   destination parity, one site per thread along rows, and the next
//   tile's loads start at the barrier that closes it.
// The pass plan (fused_kernel.flat_schedule, handed in as runs of equal
// passes) keeps the parity contract: passes of at most T steps, odd in
// number, cover the first n_steps - 1 steps and end at parity 1; one pass
// of one step writes parity 0. A pass cannot write its own source parity
// while other CTAs still read halos from it.
//
// A site's update is the step kernel's (lbm_step.cu) with the shared
// collision of lbm_collide.cuh, and every level rounds to storage (bf16 to
// nearest even) as the plain version rounds after every step, so with
// -fmad=false the kernel rounds exactly like n_steps chained steps of the
// plain PyTorch version (fused_kernel.flat_reference in the port, whose
// tiled form fused_kernel.flat_reference_blocked follows this kernel's
// tiles): bitwise, for any T. fast_math (rcp.approx.f32) has no
// bitwise reference.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lbm_collide.cuh"
#include "lbm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// runs of the pass plan: count[i] passes of len[i] steps each, in order
constexpr int kRuns = 4;
struct Plan {
  int len[kRuns];
  int count[kRuns];
};

// bytes of dynamic shared memory of a tile of `rows` rows: the 9
// interleaved planes, then one guard bit per site in 32-bit words
constexpr int64_t tile_bytes(int64_t rows, int64_t itemsize) {
  return rows * 9 * kW * itemsize + 4 * ((rows * kW + 31) / 32);
}

// Guard bits of the column-0 sites among rows [ra, rb) and columns
// [ca, cb) of the tile, read at the current level in its layout: bit (r kW
// + c) holds whether f6, f3 and f7 all stay above their decrements. Bits
// of every other site stay 0. `first`: the first tile column >= ca whose
// global column is 0; the others follow every ny columns.
template <typename T, bool PUSHED>
__device__ __forceinline__ void guard_bits(const T* sm, uint32_t* guard, int ra, int rb,
                                           int first, int cb, int ny, const Params& k) {
  const int occ = first < cb ? (cb - 1 - first) / ny + 1 : 0;
  const int n = (rb - ra) * occ;
  const int o6 = slot_offset<PUSHED>(6);
  const int o3 = slot_offset<PUSHED>(3);
  const int o7 = slot_offset<PUSHED>(7);
  for (int i = threadIdx.x; i < n; i += kNT) {
    const int r = ra + i / occ;
    const int c = first + (i - (i / occ) * occ) * ny;
    const T* site = sm + r * 9 * kW + c;
    const bool ok = (load(site + o6) - k.a58 > 0.0f) && (load(site + o3) - k.a14 > 0.0f) &&
                    (load(site + o7) - k.a58 > 0.0f);
    const int g = r * kW + c;
    const uint32_t bit = 1u << (g & 31);
    if (ok) {
      atomicOr(&guard[g >> 5], bit);
    } else {
      atomicAnd(&guard[g >> 5], ~bit);
    }
  }
}

// One level over rows [ra, rb) x columns [ca, cb) of the tile: each site
// pulls its 9 values from shared memory, adds the forcing where the source
// has global column 0 and its guard bit is set (HAS0), collides, and
// writes back into the slots it read (PUSHED: the source layout is the
// pushed one; the result is in the other). The last level (LAST) writes
// its sites to dst instead, tile site (r, c) at dst[out0 + r ny + c] of
// each plane: the output tile goes to device memory from registers, and
// the next tile's loads may start as soon as every site has been read.
template <typename T, bool PUSHED, bool HAS0, bool LAST>
__device__ __forceinline__ void tile_level(T* sm, const uint32_t* guard, int ra, int rb, int ca,
                                           int cb, T* dst, int64_t out0, int ny, int64_t plane,
                                           const Params& k, int fast_math) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};

  const int n = (rb - ra) * (cb - ca);
  Walk at(cb - ca);
  for (int i = threadIdx.x; i < n; i += kNT, at.next()) {
    const int r = ra + at.a, c = ca + at.b;
    T* site = sm + r * 9 * kW + c;
    float p[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      // natural: f_s(x - e_s) at slot (x - e_s, s); pushed: slot (x, opp s)
      p[s] = load(site + (PUSHED ? OPP[s] * kW : (s - 9 * EX[s]) * kW - EY[s]));
    }
    if (HAS0) {
      const int g = r * kW + c;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        if (FORCE[s] != 0) {
          const int y = g - EX[s] * kW - EY[s];  // the source site
          if ((guard[y >> 5] >> (y & 31)) & 1u) {
            const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
            p[s] = p[s] + (FORCE[s] > 0 ? a : -a);
          }
        }
      }
    }
    float out[9];
    collide<kNone>(p, [] { return 0; }, k, fast_math, out);
    if (LAST) {
      T* g = dst + out0 + static_cast<int64_t>(r) * ny + c;
#pragma unroll
      for (int s = 0; s < 9; ++s) store(g + s * plane, out[s]);
    } else {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        // natural source: into slot (x + e_s, opp s), where p[opp s] was
        // read; pushed source: into slot (x, s)
        store(site + (PUSHED ? s * kW : (9 * EX[s] + OPP[s]) * kW + EY[s]), out[s]);
      }
    }
  }
}

// tile_level in the layout a level reads
template <typename T, bool HAS0, bool LAST>
__device__ __forceinline__ void level(bool pushed, T* sm, const uint32_t* guard, int ra, int rb,
                                      int ca, int cb, T* dst, int64_t out0, int ny,
                                      int64_t plane, const Params& k, int fast_math) {
  if (pushed) {
    tile_level<T, true, HAS0, LAST>(sm, guard, ra, rb, ca, cb, dst, out0, ny, plane, k, fast_math);
  } else {
    tile_level<T, false, HAS0, LAST>(sm, guard, ra, rb, ca, cb, dst, out0, ny, plane, k, fast_math);
  }
}

// Start a tile's loads into shared memory as asynchronous 16-byte copies
// (vec; else plain loads, done on return) and clear its guard bits where
// it holds column 0.
template <typename T>
__device__ __forceinline__ void load_tile(T* sm, uint32_t* guard, const TileAt& a, const T* src,
                                          int nx, int ny, int64_t plane, int vec) {
  constexpr int V = vec_columns<T>();
  // 16-byte vectors of columns (vec), else single columns; the 9 planes of
  // one (row, vector) item together
  const int k0 = vec ? a.lc0 / V : a.lc0;
  const int nb = (vec ? (a.lc1 + V - 1) / V : a.lc1) - k0;
  const int n = a.lr1 * nb;
  Walk at(nb);
  for (int i = threadIdx.x; i < n; i += kNT, at.next()) {
    const int lr = at.a;
    const int lc = vec ? (k0 + at.b) * V : k0 + at.b;
    const T* g = src + static_cast<int64_t>(wrap(a.gr0 + lr, nx)) * ny + wrap(a.gc0 + lc, ny);
    T* d = sm + lr * 9 * kW + lc;
    if (vec) {
#pragma unroll
      for (int s = 0; s < 9; ++s) copy16_async(d + s * kW, g + s * plane);
    } else {
#pragma unroll
      for (int s = 0; s < 9; ++s) d[s * kW] = g[s * plane];
    }
  }
  if (a.has0) {
    const int words = (a.lr1 * kW + 31) / 32;
    for (int i = threadIdx.x; i < words; i += kNT) guard[i] = 0u;
  }
}

// The L levels of a loaded tile, the last of which stores the output tile.
template <typename T>
__device__ __forceinline__ void tile_levels(T* sm, uint32_t* guard, const TileAt& a, T* dst,
                                            int ny, int64_t plane, const Params& k,
                                            int fast_math) {
  // the output tile's sites at dst[out0 + r ny + c] for tile site (r, c)
  const int64_t out0 = static_cast<int64_t>(a.gr0) * ny + a.gc0;
  for (int t = 1; t <= a.L; ++t) {
    const int g = a.L - t;  // how far level t reaches beyond the output
    const int ra = a.L - g, rb = a.L + a.Re + g;
    const int ca = a.pad - g, cb = a.pad + a.Ce + g;
    const bool pushed = (t % 2) == 0;  // level 1 reads the loaded (natural) tile
    const bool last = t == a.L;
    if (a.has0) {
      const int lo = ca - 1;
      const int first = lo + wrap(a.first0 - lo, ny);
      if (pushed) {
        guard_bits<T, true>(sm, guard, ra - 1, rb + 1, first, cb + 1, ny, k);
      } else {
        guard_bits<T, false>(sm, guard, ra - 1, rb + 1, first, cb + 1, ny, k);
      }
      __syncthreads();
      if (last) {
        level<T, true, true>(pushed, sm, guard, ra, rb, ca, cb, dst, out0, ny, plane, k, fast_math);
      } else {
        level<T, true, false>(pushed, sm, guard, ra, rb, ca, cb, dst, out0, ny, plane, k,
                              fast_math);
      }
    } else if (last) {
      level<T, false, true>(pushed, sm, guard, ra, rb, ca, cb, dst, out0, ny, plane, k, fast_math);
    } else {
      level<T, false, false>(pushed, sm, guard, ra, rb, ca, cb, dst, out0, ny, plane, k, fast_math);
    }
    // every read of this level before the next level's (or tile's) writes
    __syncthreads();
  }
}

// f2: (2, 9, nx, ny), the live state at parity 0. rows: the tile's rows; a
// pass of L steps writes output tiles of (rows - 2 L) x (kW - 2
// column_halo(L)) sites. vec: NY a multiple of V and f2 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kNT, kCtasPerSm)
lbm_flat_steps(T* f2, int nx, int ny, int rows, Plan plan, int vec, Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  uint32_t* guard =
      reinterpret_cast<uint32_t*>(smem + static_cast<int64_t>(rows) * 9 * kW * sizeof(T));
  cg::grid_group grid = cg::this_grid();
  const int64_t plane = static_cast<int64_t>(nx) * ny;  // plane offsets in 64 bits
  int passes = 0;
  for (int run = 0; run < kRuns; ++run) passes += plan.count[run];

  int parity = 0, done = 0;
  for (int run = 0; run < kRuns; ++run) {
    const int L = plan.len[run];
    const int pad = column_halo<T>(L);
    const int R = rows - 2 * L;
    const int C = kW - 2 * pad;
    const int tiles_y = (ny + C - 1) / C;
    const int tiles = ((nx + R - 1) / R) * tiles_y;
    for (int p = 0; p < plan.count[run]; ++p) {
      const T* src = f2 + static_cast<int64_t>(parity) * 9 * plane;
      T* dst = f2 + static_cast<int64_t>(parity ^ 1) * 9 * plane;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileAt a(tile, tiles_y, R, C, nx, ny, L, pad);
        // the previous tile's last level has read the shared tile (its
        // closing barrier) before these loads overwrite it
        load_tile<T>(sm, guard, a, src, nx, ny, plane, vec);
        copies_wait();
        __syncthreads();
        tile_levels<T>(sm, guard, a, dst, ny, plane, k, fast_math);
      }
      parity ^= 1;
      // every store of this pass before any load of the next
      if (++done < passes) grid.sync();
    }
  }
}

// The tile's rows for storage T on the current card (tile_rows), its
// dynamic shared bytes and what the card gives the kernel with them: its
// attributes and CTAs per SM.
template <typename T>
cudaError_t tile_info(int* rows, int64_t* smem, cudaFuncAttributes* attr, int* per_sm) {
  cudaError_t err = tile_rows(tile_bytes, sizeof(T), rows);
  if (err != cudaSuccess) return err;
  *smem = tile_bytes(*rows, sizeof(T));
  auto kernel = lbm_flat_steps<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kNT, *smem);
}

template <typename T>
int launch_flat(void* f2, int nx, int ny, const Plan& plan, int vec, const Params& k,
                int fast_math, int64_t blocks, cudaStream_t st) {
  if (vec && ny % vec_columns<T>()) return static_cast<int>(cudaErrorInvalidValue);
  int rows = 0, per_sm = 0;
  int64_t smem = 0;
  cudaFuncAttributes attr;
  cudaError_t err = tile_info<T>(&rows, &smem, &attr, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every pass leaves an output tile, and the tile count stays under 2^30
  // (32-bit tile arithmetic); the grid covers the largest count
  int64_t tiles = 0;
  for (int run = 0; run < kRuns; ++run) {
    if (plan.count[run] == 0) continue;
    const int64_t R = rows - 2 * plan.len[run], C = kW - 2 * column_halo<T>(plan.len[run]);
    if (R < 1 || C < 1 || ((nx + R - 1) / R) * ((ny + C - 1) / C) >= (1LL << 30)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tiles = std::max(tiles, ((nx + R - 1) / R) * ((ny + C - 1) / C));
  }
  int device = 0, cooperative = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the co-resident grid, no larger than the work; an explicit count is
  // taken as it is, and the cooperative launch refuses one too large
  int64_t n_blocks = blocks > 0 ? blocks : static_cast<int64_t>(per_sm) * sms;
  if (blocks <= 0 && n_blocks > tiles) n_blocks = tiles;
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  T* f = static_cast<T*>(f2);
  Plan pl = plan;
  Params kk = k;
  void* args[] = {&f, &nx, &ny, &rows, &pl, &vec, &kk, &fast_math};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_flat_steps<T>),
                                    dim3(static_cast<unsigned>(n_blocks)), dim3(kNT), args,
                                    static_cast<size_t>(smem), st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error: it is returned, not left behind
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_steps wall-free steps in one cooperative launch on `stream`. f2: (2, 9,
// nx, ny), device, contiguous, float32 (storage 0) or bf16 (storage 1), the
// live state at parity 0; updated in place, the result at parity 0 (parity
// 1 holds the state one step earlier). plan: 2 x 4 host int64, the steps
// of each run's passes, then each run's count of passes (the runs of
// fused_kernel.flat_schedule); a pass of L steps must leave an output tile
// (lbm_flat_steps_info gives the tile). vec: NY a multiple of the vector's
// columns and f2 16-byte aligned (16-byte loads), else 0. blocks: 0 sizes
// the grid to what is co-resident; a positive count is launched as given
// (a count the card cannot hold at once is refused). params: 9 host floats
// in Params order. Returns 0, or the CUDA error of the refused launch.
extern "C" int lbm_flat_steps_launch(void* f2, int64_t nx, int64_t ny, int64_t storage,
                                     int64_t fast_math, const void* plan, int64_t vec,
                                     int64_t blocks, const void* params, void* stream) {
  if (f2 == nullptr || plan == nullptr || nx < 1 || ny < 1 || nx >= (1LL << 30) ||
      ny >= (1LL << 30) || storage < 0 || storage > 1 || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* h = static_cast<const int64_t*>(plan);
  Plan pl{};
  int64_t steps = 0;
  for (int i = 0; i < kRuns; ++i) {
    if (h[i] < 0 || h[i] > 64 || h[kRuns + i] < 0 || h[kRuns + i] >= (1LL << 30) ||
        (h[kRuns + i] > 0 && h[i] < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pl.len[i] = static_cast<int>(h[i]);
    pl.count[i] = static_cast<int>(h[kRuns + i]);
    steps += h[i] * h[kRuns + i];
  }
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params k = params_from(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny), vec != 0, fast_math != 0};
  if (storage == 1) {
    return launch_flat<__nv_bfloat16>(f2, n[0], n[1], pl, n[2], k, n[3], blocks, st);
  }
  return launch_flat<float>(f2, n[0], n[1], pl, n[2], k, n[3], blocks, st);
}

// What the kernel gets on the current card for storage 0 (float32) or 1
// (bf16): out[0] registers per thread, out[1] CTAs per SM, out[2] dynamic
// shared bytes per CTA, out[3] local-memory bytes per thread (stack and
// spills), out[4] the tile's rows and out[5] its columns, halos included.
// Returns 0 or a CUDA error.
extern "C" int lbm_flat_steps_info(int64_t storage, int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rows = 0, per_sm = 0;
  int64_t smem = 0;
  cudaFuncAttributes attr;
  const cudaError_t err = storage == 1
                              ? tile_info<__nv_bfloat16>(&rows, &smem, &attr, &per_sm)
                              : tile_info<float>(&rows, &smem, &attr, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = per_sm;
  out[2] = smem;
  out[3] = static_cast<int64_t>(attr.localSizeBytes);
  out[4] = rows;
  out[5] = kW;
  return 0;
}
