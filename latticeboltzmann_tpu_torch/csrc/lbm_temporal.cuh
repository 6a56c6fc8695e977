// The temporal form's tile in shared memory, its levels and its loads:
// what the three forms of csrc/lbm_temporal_step.cu and
// csrc/lbm_temporal_rdma_step.cu share. The local form (lbm_temporal_steps)
// reads its tile with periodic wrap in both axes (load_tile); a shard's
// forms read the rows beyond the shard from T-row halo blocks (load_tile_ext,
// TemporalHalo); all three run the same levels (tile_levels) on the same
// tile (lbm_tile.cuh), so a pass computes the same sites the same way in
// every form. The shard forms' CTA is another (one of 512 threads an SM,
// two tile buffers: pass_tiles) and each of their launches plans its tile
// (plan_tiles); the levels and loads take the CTA's threads as a template
// argument, whose default is the local form's. See lbm_temporal_step.cu's
// header for the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lbm_collide.cuh"
#include "lbm_tile.cuh"

namespace {

// a site's class byte: the solid class, and the forcing guard's bit
constexpr unsigned kClassBits = 0x7f;
constexpr unsigned kGuardBit = 0x80;

// bytes of dynamic shared memory of a tile of `rows` rows: the 9
// interleaved planes, then one class byte per site (a row of planes is a
// whole number of 16-byte vectors, so the class bytes stay aligned)
constexpr int64_t tile_bytes(int64_t rows, int64_t itemsize) {
  return rows * kW * (9 * itemsize + 1);
}

// bytes of one of several tile buffers side by side: tile_bytes rounded up
// to 16, so that every buffer's 16-byte copies stay aligned (a row is 8
// bytes past a multiple of 16 in float32)
__host__ __device__ constexpr int64_t buffer_bytes(int64_t rows, int64_t itemsize) {
  return (rows * kW * (9 * itemsize + 1) + 15) / 16 * 16;
}

// The guard of the column-0 sites among rows [ra, rb) and columns [ca, cb)
// of the tile, read at the current level in its layout, into the top bit
// of each one's class byte: set where the site is fluid and f6, f3 and f7
// all stay above their decrements. Every other site's bit stays 0 from
// the load. `first`: the first tile column >= ca whose global column is 0;
// the others follow every ny columns.
template <typename T, bool PUSHED, int NT = kNT>
__device__ __forceinline__ void guard_bits(const T* sm, uint8_t* cls, int ra, int rb, int first,
                                           int cb, int ny, const Params& k) {
  const int occ = first < cb ? (cb - 1 - first) / ny + 1 : 0;
  const int n = (rb - ra) * occ;
  const int o6 = slot_offset<PUSHED>(6);
  const int o3 = slot_offset<PUSHED>(3);
  const int o7 = slot_offset<PUSHED>(7);
  for (int i = threadIdx.x; i < n; i += NT) {
    const int r = ra + i / occ;
    const int c = first + (i - (i / occ) * occ) * ny;
    const T* site = sm + r * 9 * kW + c;
    const unsigned b = cls[r * kW + c];
    const bool ok = (b & kClassBits) == 0 && (load(site + o6) - k.a58 > 0.0f) &&
                    (load(site + o3) - k.a14 > 0.0f) && (load(site + o7) - k.a58 > 0.0f);
    cls[r * kW + c] = static_cast<uint8_t>(ok ? (b | kGuardBit) : (b & kClassBits));
  }
}

// One level over rows [ra, rb) x columns [ca, cb) of the tile: each site
// pulls its 9 values from shared memory, adds the forcing where the source
// has global column 0 and its guard bit is set (HAS0), collides, applies
// its class, and writes back into the slots it read (PUSHED: the source
// layout is the pushed one; the result is in the other). The last level
// (LAST) writes its sites to dst instead, tile site (r, c) at dst[out0 + r
// ny + c] of each plane. NT: the CTA's threads.
template <typename T, int GEOM, bool PUSHED, bool HAS0, bool LAST, int NT = kNT>
__device__ __forceinline__ void tile_level(T* sm, const uint8_t* cls, int ra, int rb, int ca,
                                           int cb, T* dst, int64_t out0, int ny, int64_t plane,
                                           const Params& k, int fast_math) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};

  const int n = (rb - ra) * (cb - ca);
  WalkOf<NT> at(cb - ca);
  for (int i = threadIdx.x; i < n; i += NT, at.next()) {
    const int r = ra + at.a, c = ca + at.b;
    const int g = r * kW + c;
    T* site = sm + r * 9 * kW + c;
    float p[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      // natural: f_s(x - e_s) at slot (x - e_s, s); pushed: slot (x, opp s)
      p[s] = load(site + (PUSHED ? OPP[s] * kW : (s - 9 * EX[s]) * kW - EY[s]));
    }
    if (HAS0) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        if (FORCE[s] != 0) {
          const int y = g - EX[s] * kW - EY[s];  // the source site
          if (cls[y] & kGuardBit) {
            const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
            p[s] = p[s] + (FORCE[s] > 0 ? a : -a);
          }
        }
      }
    }
    float out[9];
    collide<GEOM>(p, [&] { return GEOM == kNone ? 0 : static_cast<int>(cls[g] & kClassBits); },
                  k, fast_math, out);
    if (LAST) {
      T* o = dst + out0 + static_cast<int64_t>(r) * ny + c;
#pragma unroll
      for (int s = 0; s < 9; ++s) store(o + s * plane, out[s]);
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
template <typename T, int GEOM, bool HAS0, bool LAST, int NT = kNT>
__device__ __forceinline__ void level(bool pushed, T* sm, const uint8_t* cls, int ra, int rb,
                                      int ca, int cb, T* dst, int64_t out0, int ny,
                                      int64_t plane, const Params& k, int fast_math) {
  if (pushed) {
    tile_level<T, GEOM, true, HAS0, LAST, NT>(sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                              fast_math);
  } else {
    tile_level<T, GEOM, false, HAS0, LAST, NT>(sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                               fast_math);
  }
}

// Start the loads of a tile's rows [r0, r1) into shared memory as
// asynchronous copies: the 9 planes of each (row, 16-byte vector) item,
// and its V class bytes (the plane variant: one copy from the class plane;
// the spec variant: the spec at the sites' global indices; wall-free:
// zeros). A vector's global columns are contiguous: the tile's first column
// and NY are multiples of V.
template <typename T, int GEOM>
__device__ __forceinline__ void load_tile(T* sm, uint8_t* cls, const TileAt& a, const T* src,
                                          const uint8_t* solid, const Spec& g, int nx, int ny,
                                          int64_t plane, int r0, int r1) {
  constexpr int V = vec_columns<T>();
  const int k0 = a.lc0 / V;
  const int nb = (a.lc1 + V - 1) / V - k0;
  const int n = (r1 - r0) * nb;
  Walk at(nb);
  for (int i = threadIdx.x; i < n; i += kNT, at.next()) {
    const int lr = r0 + at.a;
    const int lc = (k0 + at.b) * V;
    const int gi = wrap(a.gr0 + lr, nx);
    const int gj = wrap(a.gc0 + lc, ny);
    const int64_t gs = static_cast<int64_t>(gi) * ny + gj;
    T* d = sm + lr * 9 * kW + lc;
#pragma unroll
    for (int s = 0; s < 9; ++s) copy16_async(d + s * kW, src + gs + s * plane);
    uint8_t* c = cls + lr * kW + lc;
    if (GEOM == kPlane) {
      copy_small_async<V>(c, solid + gs);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        c[j] = (GEOM == kSpec && spec_solid(g, gi, gj + j, nx)) ? 1 : 0;
      }
    }
  }
}

// The levels t0 .. L of a loaded tile (those before t0 have run), the last
// of which stores the output tile. NT: the CTA's threads.
template <typename T, int GEOM, int NT = kNT>
__device__ __forceinline__ void tile_levels(T* sm, uint8_t* cls, const TileAt& a, T* dst, int ny,
                                            int64_t plane, const Params& k, int fast_math,
                                            int t0 = 1) {
  // the output tile's sites at dst[out0 + r ny + c] for tile site (r, c)
  const int64_t out0 = static_cast<int64_t>(a.gr0) * ny + a.gc0;
  for (int t = t0; t <= a.L; ++t) {
    const int g = a.L - t;  // how far level t reaches beyond the output
    const int ra = a.L - g, rb = a.L + a.Re + g;
    const int ca = a.pad - g, cb = a.pad + a.Ce + g;
    const bool pushed = (t % 2) == 0;  // level 1 reads the loaded (natural) tile
    const bool last = t == a.L;
    if (a.has0) {
      const int lo = ca - 1;
      const int first = lo + wrap(a.first0 - lo, ny);
      if (pushed) {
        guard_bits<T, true, NT>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, k);
      } else {
        guard_bits<T, false, NT>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, k);
      }
      __syncthreads();
      if (last) {
        level<T, GEOM, true, true, NT>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                       fast_math);
      } else {
        level<T, GEOM, true, false, NT>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                        fast_math);
      }
    } else if (last) {
      level<T, GEOM, false, true, NT>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                      fast_math);
    } else {
      level<T, GEOM, false, false, NT>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                       fast_math);
    }
    // every read of this level before the next level's (or tile's) writes
    __syncthreads();
  }
}

// What lies beyond a shard for the ext-halo and rdma forms, and the rows a
// launch writes. A pass of L steps on a shard of nx local rows reads local
// rows [-L, nx + L): row q < 0 is row depth + q of the top block (the rows
// above local row 0, the upper neighbour's last rows), row q >= nx is row
// q - nx of the bottom block (the lower neighbour's first rows). Passed to
// the kernels by value.
template <typename T>
struct TemporalHalo {
  const T* top;              // (9, depth, ny): the rows above local row 0
  const T* bot;              // (9, depth, ny): the rows below local row nx - 1
  const uint8_t* solid_top;  // (depth, ny): their class rows (plane variant)
  const uint8_t* solid_bot;
  int depth;                 // the halos' rows
  int row0;                  // first local row the launch writes
  int rows;                  // rows it writes
  int64_t offset;            // global row of local row 0
  int64_t gnx;               // global row count
};

// The global row of local row q (a halo row included), periodic in gnx:
// the channel walls are global rows 0 and gnx - 1, and the row above
// shard 0 is global row gnx - 1.
__device__ __forceinline__ int64_t global_row(int64_t offset, int q, int64_t gnx) {
  int64_t gi = offset + q;
  if (gi < 0 || gi >= gnx) {
    gi %= gnx;
    if (gi < 0) gi += gnx;
  }
  return gi;
}

// load_tile for a shard: tile row lr is local row q = h.row0 + a.gr0 + lr,
// read from the shard (nx rows, plane = nx ny) or, beyond it, from the
// halo block of its side, planes depth ny apart; the class bytes of a halo
// row from that side's class rows (plane variant) or the wall spec at the
// row's global row (spec variant). Columns wrap modulo ny as in the local
// form. NT: the CTA's threads.
template <typename T, int GEOM, int NT = kNT>
__device__ __forceinline__ void load_tile_ext(T* sm, uint8_t* cls, const TileAt& a,
                                              const T* src, const uint8_t* solid,
                                              const Spec& g, int nx, int ny, int64_t plane,
                                              const TemporalHalo<T>& h) {
  constexpr int V = vec_columns<T>();
  const int k0 = a.lc0 / V;
  const int nb = (a.lc1 + V - 1) / V - k0;
  const int n = a.lr1 * nb;
  WalkOf<NT> at(nb);
  for (int i = threadIdx.x; i < n; i += NT, at.next()) {
    const int lr = at.a;
    const int lc = (k0 + at.b) * V;
    const int q = h.row0 + a.gr0 + lr;
    const T* rows = src;
    const uint8_t* cl = solid;
    int64_t pl = plane;
    int qi = q;
    if (q < 0 || q >= nx) {
      const bool top = q < 0;
      rows = top ? h.top : h.bot;
      cl = top ? h.solid_top : h.solid_bot;
      pl = static_cast<int64_t>(h.depth) * ny;
      qi = top ? h.depth + q : q - nx;
    }
    const int gj = wrap(a.gc0 + lc, ny);
    const int64_t gs = static_cast<int64_t>(qi) * ny + gj;
    T* d = sm + lr * 9 * kW + lc;
#pragma unroll
    for (int s = 0; s < 9; ++s) copy16_async(d + s * kW, rows + gs + s * pl);
    uint8_t* c = cls + lr * kW + lc;
    if (GEOM == kPlane) {
      copy_small_async<V>(c, cl + gs);
    } else {
      const int64_t gi = GEOM == kSpec ? global_row(h.offset, q, h.gnx) : 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        c[j] = (GEOM == kSpec && spec_solid(g, gi, gj + j, h.gnx)) ? 1 : 0;
      }
    }
  }
}

// What the card gives a kernel of the temporal form with storage T, read
// once per card and kernel (its launcher asks at every launch): the tile's
// rows (tile_rows), the CTA's threads and tile buffers, its dynamic shared
// bytes, the kernel's attributes, its CTAs per SM and the card's SMs.
struct Info {
  int rows = 0, per_sm = 0, sms = 0, threads = kNT, buffers = 1;
  int64_t smem = 0;
  cudaFuncAttributes attr{};
};

constexpr int kMaxDevices = 64;

// threads: the kernel's CTA; buffers: the tiles a CTA holds. The tile's
// rows are tile_rows', as many as one CTA's buffers take beyond that.
template <typename T, typename Kernel>
cudaError_t card_info(Kernel kernel, Info (&cache)[kMaxDevices], bool (&known)[kMaxDevices],
                      Info* out, int threads = kNT, int buffers = 1) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[device]) {
    *out = cache[device];
    return cudaSuccess;
  }
  Info info;
  info.threads = threads;
  info.buffers = buffers;
  err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = tile_rows(tile_bytes, sizeof(T), &info.rows);
  if (err != cudaSuccess) return err;
  if (buffers > 1) {
    int per_cta = 0;
    err = cudaDeviceGetAttribute(&per_cta, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    while (info.rows > 0 && buffers * buffer_bytes(info.rows, sizeof(T)) > per_cta) --info.rows;
    if (info.rows < 1) return cudaErrorInvalidConfiguration;
  }
  info.smem = buffers > 1 ? buffers * buffer_bytes(info.rows, sizeof(T))
                          : tile_bytes(info.rows, sizeof(T));
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(info.smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&info.attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.per_sm, kernel, threads, info.smem);
  if (err != cudaSuccess) return err;
  if (info.per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[device] = info;
  known[device] = true;
  *out = info;
  return cudaSuccess;
}

// The eight values of a form's _info entry point: registers per thread,
// CTAs per SM, dynamic shared bytes per CTA, local-memory bytes per thread
// (stack and spills), the tile's rows and its columns, halos included, the
// CTA's threads and its tile buffers.
inline void info_values(const Info& info, int64_t* out) {
  out[0] = info.attr.numRegs;
  out[1] = info.per_sm;
  out[2] = info.smem;
  out[3] = static_cast<int64_t>(info.attr.localSizeBytes);
  out[4] = info.rows;
  out[5] = kW;
  out[6] = info.threads;
  out[7] = info.buffers;
}

// ---- the shard forms' tile plan and their walk over tiles ----------------
//
// A launch of a shard form lays output tiles of R rows over its rows. With
// the card's largest tile a shard's launch ends in a mostly empty last
// wave: a 200-row shard of 800x4000 at L = 3 in float32 lays 6 rows of
// tiles (five of 37 rows and one of 15) x 63 columns. So each launch plans
// its own R <= rows - 2 L (plan_tiles): the one that minimises the
// launch's estimated time, the tiles its busiest CTA walks ("waves") times
// one tile's cost, tile_cost: the larger of its bytes (the tile's source
// sites, 9 values and a class byte each, read; its output sites written)
// at one SM's share of the card's copy rate and its site updates at one
// SM's rate of them, the rates measured on an H100 (PERF.md, PR 19). The
// cost is the larger of the two because a CTA's next tile loads under its
// current tile's levels (pass_tiles).

// ns per byte of a tile's traffic on one SM (the SM's share of the copy
// kernel's 2.94 TB/s; a pass of loads and stores without levels ran at it,
// PERF.md, PR 19), and per site update of its levels on one SM by storage
// (float32, bf16: the levels of a pass without loads, on one 800-row shard
// of 800x4000 at full waves, PERF.md, PR 19)
constexpr double kTileNsPerByte = 0.0449;
template <typename T>
constexpr double tile_ns_per_site() {
  return sizeof(T) == 4 ? 1.0 : 1.28;
}

// The estimated time of one tile of R output rows in a pass of L steps of
// storage T (ns on one SM).
template <typename T>
inline double tile_cost(int R, int L) {
  const int V = vec_columns<T>();
  const int pad = column_halo<T>(L);
  const int C = kW - 2 * pad;
  const int64_t cols = ((pad + C + L + V - 1) / V - (pad - L) / V) * V;
  const int64_t site = 9 * static_cast<int64_t>(sizeof(T));
  const double bytes = static_cast<double>(R + 2 * L) * cols * (site + 1) +
                       static_cast<double>(R) * C * site;
  double updates = 0;
  for (int g = 0; g < L; ++g) updates += static_cast<double>(R + 2 * g) * (C + 2 * g);
  return std::max(kTileNsPerByte * bytes, tile_ns_per_site<T>() * updates);
}

// A launch's plan: the tile's rows (halos included), its output tiles, the
// CTAs that compute them, the tiles its busiest CTA walks, and the
// estimated time (waves x tile_cost, ns).
struct Plan {
  int rows = 0;
  int64_t tiles = 0, ctas = 0, waves = 0;
  double cost = 0;
};

// The plan of a pass of L steps whose tile holds at most max_rows rows:
// over every R in [1, max_rows - 2 L], lay(R, &plan) fills the plan's
// tiles, ctas and waves (false: no launch at R); the R of the least cost
// wins, the larger R on a tie. tile_rows > 0 takes the tile of that many
// rows instead (the caller checks it against max_rows). False when no R
// gives a launch.
template <typename T, typename Lay>
inline bool plan_tiles(int max_rows, int L, Lay lay, Plan* out, int tile_rows = 0) {
  bool found = false;
  for (int R = max_rows - 2 * L; R >= 1; --R) {
    if (tile_rows > 0 && R != tile_rows - 2 * L) continue;
    Plan p;
    if (!lay(R, &p)) continue;
    p.rows = R + 2 * L;
    p.cost = static_cast<double>(p.waves) * tile_cost<T>(R, L);
    if (!found || p.cost < out->cost) *out = p;
    found = true;
  }
  return found;
}

// The shard forms' CTA: kShardThreads threads and kShardBuffers tile
// buffers, one CTA an SM (the SM keeps the local form's 16 warps and its
// tile of `rows` rows), so that a CTA's next tile loads while it runs the
// levels of the current one (pass_tiles).
constexpr int kShardThreads = 2 * kNT;
constexpr int kShardBuffers = 2;

// the next copies this thread starts form a group of their own
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until every group of copies this thread committed but the newest has
// landed
__device__ __forceinline__ void copies_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A CTA's tiles in a grid-stride loop: blockIdx.x, + gridDim.x, ... below
// count; -1 after the last. Every thread of the CTA calls it together.
struct StrideTiles {
  int j, count;
  __device__ __forceinline__ explicit StrideTiles(int count_)
      : j(static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x)), count(count_) {}
  __device__ __forceinline__ int operator()() {
    j += static_cast<int>(gridDim.x);
    return j < count ? j : -1;
  }
};

// One CTA's walk over the output tiles that next() hands it, in order
// (tile indices row-major over the launch's tiles, -1 when none is left;
// next is called by every thread together), of a shard's pass of L steps:
// tiles laid over out_rows rows from dst, output tiles of R x C sites, R =
// rows - 2 L, each tile's source rows from the shard or h (load_tile_ext).
// The tiles alternate between the CTA's two buffers of `rows` rows, and
// the copies of the next tile start, as a group of their own, before the
// levels of the current one, which wait only for their own group and a
// barrier. A tile's levels end with a barrier, so the buffer they read is
// free for the next copies.
template <typename T, int GEOM, typename Next>
__device__ __forceinline__ void pass_tiles(Next& next, int rows, int out_rows, const T* src,
                                           T* dst, const uint8_t* solid, const Spec& g, int nx,
                                           int ny, int L, const Params& k, int fast_math,
                                           const TemporalHalo<T>& h) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t buffer = buffer_bytes(rows, sizeof(T));
  const int64_t planes = static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;  // plane offsets in 64 bits
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  int cur = next();
  if (cur >= 0) {
    const TileAt a(cur, tiles_y, R, C, out_rows, ny, L, pad);
    load_tile_ext<T, GEOM, kShardThreads>(reinterpret_cast<T*>(smem), smem + planes, a, src,
                                          solid, g, nx, ny, plane, h);
  }
  copies_commit();
  for (int b = 0; cur >= 0; b ^= 1) {
    const int nxt = next();
    if (nxt >= 0) {
      unsigned char* buf = smem + (b ^ 1) * buffer;
      const TileAt a(nxt, tiles_y, R, C, out_rows, ny, L, pad);
      load_tile_ext<T, GEOM, kShardThreads>(reinterpret_cast<T*>(buf), buf + planes, a, src,
                                            solid, g, nx, ny, plane, h);
    }
    copies_commit();
    copies_wait_but_newest();
    __syncthreads();
    unsigned char* buf = smem + b * buffer;
    const TileAt a(cur, tiles_y, R, C, out_rows, ny, L, pad);
    tile_levels<T, GEOM, kShardThreads>(reinterpret_cast<T*>(buf), buf + planes, a, dst, ny,
                                        plane, k, fast_math);
    cur = nxt;
  }
}

inline bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace
