// The pair-DP path's temporal blocking for Hopper (sm_90a): L fused D2Q9
// lattice-Boltzmann steps in double-single (f32-pair) arithmetic (channel
// forcing with the all-or-nothing pair guard, periodic pull, BGK collision
// at the fast or exact tier, masked bounce-back) in one pass through
// device memory, from a (hi, lo) pair of (9, NX, NY) float32 planes to
// another.
//
// Replaces latticeboltzmann_tpu/ops/fused_ds_kernel.py::_make_ds_pass as
// launched by its pl.pallas_call (ops/fused_ds_kernel.py:272) at
// temporal = DS_TEMPORAL = 4, the depth run_steps gives every pass of
// pallas-ds64 (:354-376): 4 pair steps per HBM pass over a row window in
// VMEM, the window shrinking one row a side per step (the trapezoid loop
// at :233-236). Here one launch is one pass of L steps between the
// session's two distinct pairs, so no pass writes what another CTA still
// reads. The TPU kernel's mirror-pad lanes, pad re-mirroring, 8-row halo
// blocks and static forcing sub-blocks are staging and have no
// counterpart.
//
// What bounds it. A site holds 72 B (9 hi and 9 lo floats). At 800x4000
// and L = 4, with the tile of two CTAs an SM (22 rows x 72 columns on an
// H100: output tiles of 14 x 64 sites), a pass reads 1.77 times the state
// (the halos) and writes it once: about 650 MB, 163 MB a step, where one
// step a launch moves 464 MB: 49 us a step at the published 3.35 TB/s.
// The levels recompute the halos: summed over the 4 levels they update
// 1.28 times the output sites, so the fast tier's issue floor of the
// one-step kernel (640 FP32 instructions a site along its SASS, 61 us a
// step at 1.98 GHz on 132 SMs) becomes about 78 us a step, and the exact
// tier's (1,606) about 196: issue, not bytes, bounds this form. A tile of
// one CTA of 512 threads an SM (44 rows) cuts the recompute to 1.14 and
// the reads to about 1.4, but leaves 16 warps an SM, against 32, to hide
// the pair chains' latency: measured on an H100 it tied with this tile at
// 800x4000 and lost at 400x4000 in the fast tier (PERF.md, row 3-T), so
// the tile is the float32 forms' shape.
//
// The design is lbm_temporal_step.cu's with a pair per slot:
// - a persistent grid of as many CTAs as the card holds at once, each
//   walking the output tiles (R rows x C columns) of the pass in a
//   grid-stride loop, a plain launch; kCtasPerSm = 2 CTAs of kNT = 256
//   threads an SM (at most 128 registers a thread);
// - a tile of `rows` x kW sites in shared memory (kW = 72 columns; rows:
//   what the CTAs an SM leave, read from the card): a tile row is the 9 hi
//   planes, then the 9 lo planes, kW floats each, so that every pull's
//   offset, hi and lo, is a compile-time constant. Per output tile the
//   (R + 2L) x (C + 2L) source sites of all 18 planes are loaded with
//   periodic wrap in both axes by modulo indices, each as 16-byte cp.async
//   copies from its own global plane (NY a multiple of 4, 16-byte aligned
//   buffers). While one CTA waits on its copies, the SM's other CTA runs
//   its levels; a second buffer to load into would halve the rows again;
// - one byte per tile site beside the planes: its class (0 fluid, 1
//   bounce-back) loaded once per tile by 4-byte cp.async copies of the
//   uint8 solid plane (wall-free: 0), and in its top bit the forcing guard
//   of a site of GLOBAL column 0 at the level being read, written before
//   the level by a pass over those sites (f6, f3 and f7 against a58, a14,
//   a58 by full pair sub and gt_zero, as lbm_ds_step.cu's forced_at), then
//   a barrier, as lbm_temporal_step.cu's guard_bits does;
// - L levels in place, the region shrinking by one site a level on each
//   side, in the two alternating layouts (natural: slot (x, s) holds
//   f_s(x); pushed: slot (x + e_s, opp s) holds f_s(x)): a site writes its
//   9 results, hi and lo, into the 9 slots it read. A forced pull adds the
//   delta by the full pair add, as the one-step kernel does. One barrier a
//   level;
// - the last level writes the output tile from registers to the dst pair,
//   one site a thread along rows.
//
// Every f32 op is an _rn intrinsic of lbm_ds.cuh in ops/df64.py's order,
// and every level is one step of the plain version on its sites, so the
// kernel equals L chained fused_ds_kernel.step_reference calls bit for bit
// (fused_ds_kernel.temporal_reference in the port, whose tiled form
// fused_ds_kernel.temporal_reference_blocked follows this kernel's tiles),
// at any L the tile takes and at either tier. No --use_fast_math.
//
// The ext-halo form (lbm_ds_temporal_steps_ext, launched by
// lbm_ds_temporal_steps_ext_launch) replaces the same pl.pallas_call
// (_make_ds_pass at ops/fused_ds_kernel.py:272) with ext_halo=True at
// temporal = DS_TEMPORAL, as _get_sharded_runner (:385-472) drives it per
// shard: each pass of the TPU runner ppermutes T rows of both pair
// components from each ring neighbour (`extend`, :435-438) and runs T
// steps on the shard's extended rows. Here one launch is one pass of L <=
// Td steps on a shard's (9, Ls, NY) pair, writing the local rows [row0,
// row0 + rows), so that a caller can run the rows that take no halo while
// the halos are copied, and the rest after. It is this kernel with two
// changes and nothing else:
// - where the rows come from (load_pair_tile<.., EXT>): tile row lr of a
//   tile reads the shard's local row q; q < 0 reads row Td + q of the top
//   halo (9, Td, NY) and q >= Ls row q - Ls of the bottom one, hi and lo
//   each, and a class byte from the halo's static (Td, NY) class rows. No
//   x wrap: the ring of shards outside is the x periodicity. Columns wrap
//   modulo NY as in the local form, and the forcing at GLOBAL column 0 is
//   unchanged, since the mesh splits rows only; a halo row's column-0
//   site is forced at every level from its own pairs and class, as in the
//   TPU window;
// - where the output goes: tiles are laid from row0 over `rows` rows and
//   written there.
// Every load is a 16-byte cp.async from its own plane (whole allocations,
// NY % 4 == 0); the launcher refuses a pass deeper than the halos (L >
// Td) and one whose reads would leave [-Td, Ls + Td).
//
// What bounds the ext-halo form. A pass of 4 steps on a 200-row shard of
// 800x4000 (4 shards) lays 15 rows of tiles (14 full, one of 4 rows) and
// 63 columns; it reads the rows of its tiles with their halos, 1.6 times
// the shard's rows (a ragged 4-row tile reads 12), and 1.13 times its
// columns, 73 B a site: about 105 MB, and writes 58 MB: 163 MB a pass per
// shard, 652 MB for the four, 49 us a step at 3.35 TB/s, as the local
// form. The levels recompute about 1.3 times the output sites (1.28 for
// the local form), so the fast tier's issue floor becomes about 79 us a
// step. The halo copies add 4 x 9 x 4 x NY x 4 B a shard a pass (2.3 MB
// for 4 shards, 0.4% of the pass). Issue, not bytes, bounds it, as the
// local form: the design adds no work to the levels and keeps the tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lbm_ds.cuh"
#include "lbm_tile.cuh"

namespace {

// a tile row: the 9 hi planes, then the 9 lo planes, kW floats each
constexpr int kPlanes = 18;
constexpr int kRowFloats = kPlanes * kW;
// a speed's lo slot from its hi slot
constexpr int kLo = 9 * kW;
// a site's class byte: the class, and the forcing guard's bit
constexpr unsigned kClassBits = 0x7f;
constexpr unsigned kGuardBit = 0x80;
// the pairs a14 and a58 sit after the other constants of each tier
__host__ __device__ constexpr int a14_at(bool exact) { return exact ? 16 : 14; }
__host__ __device__ constexpr int a58_at(bool exact) { return exact ? 18 : 16; }

// bytes of dynamic shared memory of a tile of `rows` rows: per site 9
// pairs of pair_bytes (8) and a class byte (a tile row of planes is a
// whole number of 16-byte vectors, so the class bytes stay aligned)
constexpr int64_t ds_tile_bytes(int64_t rows, int64_t pair_bytes) {
  return rows * kW * (9 * pair_bytes + 1);
}

// The ext-halo form's shard: what lies beyond its rows, and the rows a
// launch writes. Unused (zero) in the local form.
struct Halo {
  const float* top_hi = nullptr;       // (9, depth, ny): the rows above local row 0
  const float* top_lo = nullptr;
  const float* bot_hi = nullptr;       // (9, depth, ny): the rows below local row nx - 1
  const float* bot_lo = nullptr;
  const uint8_t* solid_top = nullptr;  // (depth, ny): their class rows (masked variant)
  const uint8_t* solid_bot = nullptr;
  int depth = 0;                       // the halos' rows
  int row0 = 0;                        // first local row the launch writes
  int rows = 0;                        // rows it writes
};

// offset of the hi slot that holds f_s of the site at offset 0: natural
// f_s(x) at (x, s); pushed at (x + e_s, opp s). Called with constant s.
template <bool PUSHED>
__device__ __forceinline__ int pair_slot(int s) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  return PUSHED ? (kPlanes * EX[s] + OPP[s]) * kW + EY[s] : s * kW;
}

// The guard of the column-0 sites among rows [ra, rb) and columns
// [first, cb) of the tile, read at the current level in its layout, into
// the top bit of each one's class byte: set where the site is fluid and
// f6 - a58, f3 - a14 and f7 - a58 are all above zero at pair precision.
// Every other site's bit stays 0 from the load. `first`: the first tile
// column >= the range's whose global column is 0; the others follow every
// ny columns.
template <bool PUSHED>
__device__ __forceinline__ void pair_guard_bits(const float* sm, uint8_t* cls, int ra, int rb,
                                                int first, int cb, int ny, ds a14, ds a58) {
  const int occ = first < cb ? (cb - 1 - first) / ny + 1 : 0;
  const int n = (rb - ra) * occ;
  const int o6 = pair_slot<PUSHED>(6);
  const int o3 = pair_slot<PUSHED>(3);
  const int o7 = pair_slot<PUSHED>(7);
  for (int i = threadIdx.x; i < n; i += kNT) {
    const int r = ra + i / occ;
    const int c = first + (i - (i / occ) * occ) * ny;
    const float* site = sm + r * kRowFloats + c;
    const unsigned b = cls[r * kW + c];
    const ds f6 = {site[o6], site[o6 + kLo]};
    const ds f3 = {site[o3], site[o3 + kLo]};
    const ds f7 = {site[o7], site[o7 + kLo]};
    const bool ok = (b & kClassBits) == 0 && gt_zero(sub(f6, a58)) && gt_zero(sub(f3, a14)) &&
                    gt_zero(sub(f7, a58));
    cls[r * kW + c] = static_cast<uint8_t>(ok ? (b | kGuardBit) : (b & kClassBits));
  }
}

// One level over rows [ra, rb) x columns [ca, cb) of the tile: each site
// pulls its 9 pairs from shared memory, adds the forcing where the source
// has global column 0 and its guard bit is set (has0: the tile holds such
// a site), collides at the tier, bounces back where its class is 1, and
// writes back into the slots it read (PUSHED: the source layout is the
// pushed one; the result is in the other). The last level (last) writes
// its sites to the dst pair instead, tile site (r, c) at dst[out0 + r ny +
// c] of each plane.
template <bool HAS_WALLS, bool EXACT, bool PUSHED>
__device__ __forceinline__ void pair_level(float* sm, const uint8_t* cls, int ra, int rb, int ca,
                                           int cb, bool has0, bool last,
                                           float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                                           int64_t out0, int ny, int64_t plane,
                                           const Params& k) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  const ds a14 = pair(k, a14_at(EXACT));
  const ds a58 = pair(k, a58_at(EXACT));
  const int n = (rb - ra) * (cb - ca);
  Walk at(cb - ca);
  for (int i = threadIdx.x; i < n; i += kNT, at.next()) {
    const int r = ra + at.a, c = ca + at.b;
    const int g = r * kW + c;
    float* site = sm + r * kRowFloats + c;
    ds p[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      // natural: f_s(x - e_s) at slot (x - e_s, s); pushed: slot (x, opp s)
      const int o = PUSHED ? OPP[s] * kW : (s - kPlanes * EX[s]) * kW - EY[s];
      p[s] = {site[o], site[o + kLo]};
    }
    if (has0) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        // the source site's guard bit
        if (FORCE[s] != 0 && (cls[g - EX[s] * kW - EY[s]] & kGuardBit)) {
          const ds a = (s == 1 || s == 3) ? a14 : a58;
          p[s] = add(p[s], FORCE[s] > 0 ? a : neg(a));
        }
      }
    }
    ds out[9];
    if constexpr (EXACT) {
      collide_exact(p, out, k);
    } else {
      collide_fast(p, out, k);
    }
    if (HAS_WALLS && (cls[g] & kClassBits) != 0) {
      // bounce-back; OPP[0] == 0 passes the site's own f0 through
#pragma unroll
      for (int s = 0; s < 9; ++s) out[s] = p[OPP[s]];
    }
    if (last) {
      const int64_t o = out0 + static_cast<int64_t>(r) * ny + c;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        dst_hi[o + s * plane] = out[s].hi;
        dst_lo[o + s * plane] = out[s].lo;
      }
    } else {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        // natural source: into slot (x + e_s, opp s), where p[opp s] was
        // read; pushed source: into slot (x, s)
        const int o = PUSHED ? s * kW : (kPlanes * EX[s] + OPP[s]) * kW + EY[s];
        site[o] = out[s].hi;
        site[o + kLo] = out[s].lo;
      }
    }
  }
}

// Start a tile's loads into shared memory as asynchronous copies: the 9
// hi and 9 lo planes of each (row, 16-byte vector) item, and its 4 class
// bytes (masked: one copy from the solid plane; wall-free: zeros). A
// vector's global columns are contiguous: the tile's first column and NY
// are multiples of 4. Local form: rows wrap modulo nx. Ext-halo form
// (EXT): tile row lr is the shard's local row q = h.row0 + a.gr0 + lr,
// read from the top halo's row depth + q where q < 0 and from the bottom
// halo's row q - nx where q >= nx.
template <bool HAS_WALLS, bool EXT>
__device__ __forceinline__ void load_pair_tile(float* sm, uint8_t* cls, const TileAt& a,
                                               const float* __restrict__ src_hi,
                                               const float* __restrict__ src_lo,
                                               const uint8_t* __restrict__ solid, int nx, int ny,
                                               int64_t plane, const Halo& h) {
  constexpr int V = vec_columns<float>();
  const int k0 = a.lc0 / V;
  const int nb = (a.lc1 + V - 1) / V - k0;
  const int n = a.lr1 * nb;
  Walk at(nb);
  for (int i = threadIdx.x; i < n; i += kNT, at.next()) {
    const int lr = at.a;
    const int lc = (k0 + at.b) * V;
    if constexpr (EXT) {
      int gi = h.row0 + a.gr0 + lr;
      const float* hi = src_hi;
      const float* lo = src_lo;
      const uint8_t* cl = solid;
      int64_t pl = plane;
      if (gi < 0 || gi >= nx) {
        const bool top = gi < 0;
        hi = top ? h.top_hi : h.bot_hi;
        lo = top ? h.top_lo : h.bot_lo;
        cl = top ? h.solid_top : h.solid_bot;
        pl = static_cast<int64_t>(h.depth) * ny;
        gi = top ? h.depth + gi : gi - nx;
      }
      const int gj = wrap(a.gc0 + lc, ny);
      const int64_t gs = static_cast<int64_t>(gi) * ny + gj;
      float* d = sm + lr * kRowFloats + lc;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        copy16_async(d + s * kW, hi + gs + s * pl);
        copy16_async(d + kLo + s * kW, lo + gs + s * pl);
      }
      uint8_t* c = cls + lr * kW + lc;
      if (HAS_WALLS) {
        copy_small_async<V>(c, cl + gs);
      } else {
        *reinterpret_cast<uint32_t*>(c) = 0u;
      }
    } else {
      const int gi = wrap(a.gr0 + lr, nx);
      const int gj = wrap(a.gc0 + lc, ny);
      const int64_t gs = static_cast<int64_t>(gi) * ny + gj;
      float* d = sm + lr * kRowFloats + lc;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        copy16_async(d + s * kW, src_hi + gs + s * plane);
        copy16_async(d + kLo + s * kW, src_lo + gs + s * plane);
      }
      uint8_t* c = cls + lr * kW + lc;
      if (HAS_WALLS) {
        copy_small_async<V>(c, solid + gs);
      } else {
        *reinterpret_cast<uint32_t*>(c) = 0u;
      }
    }
  }
}

// The pass of both forms, src -> dst, L steps: four distinct (9, nx, ny)
// planes (EXT: a shard's blocks, nx its rows; the output rows [h.row0,
// h.row0 + h.rows)). rows: the tile's rows; a pass of L steps writes
// output tiles of (rows - 2 L) x (kW - 2 column_halo(L)) sites. solid:
// the uint8 class plane (HAS_WALLS).
template <bool HAS_WALLS, bool EXACT, bool EXT>
__device__ __forceinline__ void pass_tiles(const float* __restrict__ src_hi,
                                           const float* __restrict__ src_lo,
                                           float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                                           const uint8_t* __restrict__ solid, int nx, int ny,
                                           int rows, int L, Params k, Halo h) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  uint8_t* cls = smem + static_cast<int64_t>(rows) * kRowFloats * sizeof(float);
  const int64_t plane = static_cast<int64_t>(nx) * ny;  // plane offsets in 64 bits
  const int pad = column_halo<float>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int out_rows = EXT ? h.rows : nx;
  const int tiles_y = (ny + C - 1) / C;
  const int tiles = ((out_rows + R - 1) / R) * tiles_y;
  const ds a14 = pair(k, a14_at(EXACT));
  const ds a58 = pair(k, a58_at(EXACT));
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt a(tile, tiles_y, R, C, out_rows, ny, L, pad);
    // the previous tile's last level has read the shared tile (its closing
    // barrier) before these loads overwrite it
    load_pair_tile<HAS_WALLS, EXT>(sm, cls, a, src_hi, src_lo, solid, nx, ny, plane, h);
    copies_wait();
    __syncthreads();
    // the output tile's sites at dst[out0 + r ny + c] for tile site (r, c)
    const int64_t out0 = static_cast<int64_t>((EXT ? h.row0 : 0) + a.gr0) * ny + a.gc0;
    for (int t = 1; t <= L; ++t) {
      const int g = L - t;  // how far level t reaches beyond the output
      const int ra = L - g, rb = L + a.Re + g;
      const int ca = pad - g, cb = pad + a.Ce + g;
      const bool pushed = (t % 2) == 0;  // level 1 reads the loaded (natural) tile
      const bool last = t == L;
      if (a.has0) {
        const int lo = ca - 1;
        const int first = lo + wrap(a.first0 - lo, ny);
        if (pushed) {
          pair_guard_bits<true>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, a14, a58);
        } else {
          pair_guard_bits<false>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, a14, a58);
        }
        __syncthreads();
      }
      if (pushed) {
        pair_level<HAS_WALLS, EXACT, true>(sm, cls, ra, rb, ca, cb, a.has0, last, dst_hi, dst_lo,
                                           out0, ny, plane, k);
      } else {
        pair_level<HAS_WALLS, EXACT, false>(sm, cls, ra, rb, ca, cb, a.has0, last, dst_hi, dst_lo,
                                            out0, ny, plane, k);
      }
      // every read of this level before the next level's (or tile's) writes
      __syncthreads();
    }
  }
}

// The local form: the whole lattice, periodic in both axes.
template <bool HAS_WALLS, bool EXACT>
__global__ void __launch_bounds__(kNT, kCtasPerSm)
lbm_ds_temporal_steps(const float* __restrict__ src_hi, const float* __restrict__ src_lo,
                      float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                      const uint8_t* __restrict__ solid, int nx, int ny, int rows, int L,
                      Params k) {
  pass_tiles<HAS_WALLS, EXACT, false>(src_hi, src_lo, dst_hi, dst_lo, solid, nx, ny, rows, L, k,
                                      Halo{});
}

// The ext-halo form: a shard of nx rows, the rows beyond it from h's halos.
template <bool HAS_WALLS, bool EXACT>
__global__ void __launch_bounds__(kNT, kCtasPerSm)
lbm_ds_temporal_steps_ext(const float* __restrict__ src_hi, const float* __restrict__ src_lo,
                          float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                          const uint8_t* __restrict__ solid, int nx, int ny, int rows, int L,
                          Params k, Halo h) {
  pass_tiles<HAS_WALLS, EXACT, true>(src_hi, src_lo, dst_hi, dst_lo, solid, nx, ny, rows, L, k, h);
}

// What the card gives the kernel at a tier and a variant, read once per
// card (each launch asks): the tile's rows (tile_rows), its dynamic shared
// bytes, the kernel's attributes, its CTAs per SM and the card's SMs.
struct Info {
  int rows = 0, per_sm = 0, sms = 0;
  int64_t smem = 0;
  cudaFuncAttributes attr{};
};

constexpr int kMaxDevices = 64;

// the kernel of a form, at a tier and a variant
template <bool HAS_WALLS, bool EXACT, bool EXT>
auto kernel_of() {
  if constexpr (EXT) {
    return lbm_ds_temporal_steps_ext<HAS_WALLS, EXACT>;
  } else {
    return lbm_ds_temporal_steps<HAS_WALLS, EXACT>;
  }
}

template <bool HAS_WALLS, bool EXACT, bool EXT>
cudaError_t pair_tile_info(Info* out) {
  static Info cache[kMaxDevices];
  static bool known[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[device]) {
    *out = cache[device];
    return cudaSuccess;
  }
  Info info;
  err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // a pair is two floats: 8 bytes a speed
  err = tile_rows(ds_tile_bytes, 2 * sizeof(float), &info.rows);
  if (err != cudaSuccess) return err;
  info.smem = ds_tile_bytes(info.rows, 2 * sizeof(float));
  auto kernel = kernel_of<HAS_WALLS, EXACT, EXT>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(info.smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&info.attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info.per_sm, kernel, kNT, info.smem);
  if (err != cudaSuccess) return err;
  if (info.per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[device] = info;
  known[device] = true;
  *out = info;
  return cudaSuccess;
}

template <bool EXT>
cudaError_t pair_info(int64_t has_walls, int64_t exact, Info* out) {
  if (has_walls) {
    return exact ? pair_tile_info<true, true, EXT>(out) : pair_tile_info<true, false, EXT>(out);
  }
  return exact ? pair_tile_info<false, true, EXT>(out) : pair_tile_info<false, false, EXT>(out);
}

// The launch constants from their host floats: 20 (exact) or 18 (fast).
Params params_from(const void* params, int64_t exact) {
  Params k{};
  const float* h = static_cast<const float*>(params);
  for (int q = 0; q < (exact ? 20 : 18); ++q) k.v[q] = h[q];
  return k;
}

// The co-resident grid of a pass over `rows` output rows at the tile of
// `info`, no larger than the work; 0 when the pass leaves no output tile
// or the tile count reaches 2^30 (32-bit tile arithmetic).
int64_t pass_grid(const Info& info, int64_t rows, int64_t ny, int L) {
  const int64_t R = info.rows - 2 * L, C = kW - 2 * column_halo<float>(L);
  if (R < 1 || C < 1) return 0;
  const int64_t tiles = ((rows + R - 1) / R) * ((ny + C - 1) / C);
  if (tiles >= (1LL << 30)) return 0;
  return std::min<int64_t>(tiles, static_cast<int64_t>(info.per_sm) * info.sms);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// One pass of `steps` pair steps (src_hi, src_lo) -> (dst_hi, dst_lo) on
// `stream`. All four: (9, nx, ny) float32, device, contiguous, distinct,
// 16-byte aligned; ny a multiple of 4. solid: the (nx, ny) uint8 codes 0
// fluid / 1 bounce-back, 16-byte aligned (read only when has_walls != 0).
// exact selects the collision tier. steps: at least 1, and a pass that
// leaves an output tile (lbm_ds_temporal_steps_info gives the tile).
// params: 20 (exact) or 18 (fast) host floats in Params order. Returns 0,
// or the CUDA error of the refused launch.
extern "C" int lbm_ds_temporal_steps_launch(const void* src_hi, const void* src_lo,
                                            void* dst_hi, void* dst_lo, const void* solid,
                                            int64_t nx, int64_t ny, int64_t has_walls,
                                            int64_t exact, int64_t steps, const void* params,
                                            void* stream) {
  const void* bufs[] = {src_hi, src_lo, dst_hi, dst_lo};
  for (int i = 0; i < 4; ++i) {
    if (bufs[i] == nullptr || misaligned(bufs[i])) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < i; ++j) {
      if (bufs[i] == bufs[j]) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
      ny % vec_columns<float>() != 0 || (has_walls && (solid == nullptr || misaligned(solid))) ||
      steps < 1 || steps > 64 || params == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = pair_info<false>(has_walls, exact, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = static_cast<int>(steps);
  const int64_t n_blocks = pass_grid(info, nx, ny, L);
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params k = params_from(params, exact);
  const auto* sh = static_cast<const float*>(src_hi);
  const auto* sl = static_cast<const float*>(src_lo);
  auto* dh = static_cast<float*>(dst_hi);
  auto* dl = static_cast<float*>(dst_lo);
  const auto* w = static_cast<const uint8_t*>(solid);
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny), info.rows};
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const dim3 block(kNT);
  const size_t shared = static_cast<size_t>(info.smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_walls) {
    if (exact) {
      lbm_ds_temporal_steps<true, true><<<grid, block, shared, st>>>(sh, sl, dh, dl, w, n[0], n[1],
                                                                     n[2], L, k);
    } else {
      lbm_ds_temporal_steps<true, false><<<grid, block, shared, st>>>(sh, sl, dh, dl, w, n[0], n[1],
                                                                      n[2], L, k);
    }
  } else {
    if (exact) {
      lbm_ds_temporal_steps<false, true><<<grid, block, shared, st>>>(sh, sl, dh, dl, nullptr,
                                                                      n[0], n[1], n[2], L, k);
    } else {
      lbm_ds_temporal_steps<false, false><<<grid, block, shared, st>>>(sh, sl, dh, dl, nullptr,
                                                                       n[0], n[1], n[2], L, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// What the kernel gets on the current card at a tier (exact) and a variant
// (has_walls): out[0] registers per thread, out[1] CTAs per SM, out[2]
// dynamic shared bytes per CTA, out[3] local-memory bytes per thread
// (stack and spills), out[4] the tile's rows and out[5] its columns, halos
// included. Returns 0 or a CUDA error.
extern "C" int lbm_ds_temporal_steps_info(int64_t exact, int64_t has_walls, int64_t* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Info info;
  const cudaError_t err = pair_info<false>(has_walls, exact, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = info.attr.numRegs;
  out[1] = info.per_sm;
  out[2] = info.smem;
  out[3] = static_cast<int64_t>(info.attr.localSizeBytes);
  out[4] = info.rows;
  out[5] = kW;
  return 0;
}

// The ext-halo form: one pass of `steps` pair steps of the local rows
// [row0, row0 + rows) of a shard's (9, nx, ny) blocks (src_hi, src_lo) ->
// (dst_hi, dst_lo) on `stream`, all four float32, device, contiguous,
// distinct, 16-byte aligned, ny a multiple of 4. top_hi/top_lo and
// bot_hi/bot_lo: (9, depth, ny) float32 device blocks, the depth rows above
// local row 0 and below local row nx - 1, all 9 speed planes of both
// components, 16-byte aligned; solid_top, solid_bot: their (depth, ny)
// uint8 class rows (masked variant). A pass reads `steps` rows beyond
// each side of its output: where those leave the shard, the halo of that
// side is required and depth >= steps; never read otherwise (depth 0 and
// null pointers allowed). With halos, steps > depth is refused. solid:
// the shard's (nx, ny) uint8 codes 0 fluid / 1 bounce-back (read only
// when has_walls != 0). exact, steps, params and the return as
// lbm_ds_temporal_steps_launch's.
extern "C" int lbm_ds_temporal_steps_ext_launch(
    const void* src_hi, const void* src_lo, void* dst_hi, void* dst_lo, const void* top_hi,
    const void* top_lo, const void* bot_hi, const void* bot_lo, const void* solid,
    const void* solid_top, const void* solid_bot, int64_t nx, int64_t ny, int64_t depth,
    int64_t row0, int64_t rows, int64_t has_walls, int64_t exact, int64_t steps,
    const void* params, void* stream) {
  const void* bufs[] = {src_hi, src_lo, dst_hi, dst_lo};
  for (int i = 0; i < 4; ++i) {
    if (bufs[i] == nullptr || misaligned(bufs[i])) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < i; ++j) {
      if (bufs[i] == bufs[j]) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
      ny % vec_columns<float>() != 0 || (has_walls && (solid == nullptr || misaligned(solid))) ||
      steps < 1 || steps > 64 || params == nullptr || depth < 0 || depth >= (1LL << 30) ||
      row0 < 0 || rows < 1 || row0 + rows > nx || (depth > 0 && steps > depth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each side the pass reads beyond the shard needs its halo, deep enough
  const void* sides[2][3] = {{top_hi, top_lo, solid_top}, {bot_hi, bot_lo, solid_bot}};
  const bool needs[2] = {row0 - steps < 0, row0 + rows + steps > nx};
  for (int side = 0; side < 2; ++side) {
    if (!needs[side]) continue;
    if (steps > depth) return static_cast<int>(cudaErrorInvalidValue);
    for (int b = 0; b < (has_walls ? 3 : 2); ++b) {
      const void* q = sides[side][b];
      if (q == nullptr || misaligned(q)) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Info info;
  const cudaError_t err = pair_info<true>(has_walls, exact, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = static_cast<int>(steps);
  const int64_t n_blocks = pass_grid(info, rows, ny, L);
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params k = params_from(params, exact);
  Halo h;
  h.top_hi = static_cast<const float*>(top_hi);
  h.top_lo = static_cast<const float*>(top_lo);
  h.bot_hi = static_cast<const float*>(bot_hi);
  h.bot_lo = static_cast<const float*>(bot_lo);
  h.solid_top = static_cast<const uint8_t*>(solid_top);
  h.solid_bot = static_cast<const uint8_t*>(solid_bot);
  h.depth = static_cast<int>(depth);
  h.row0 = static_cast<int>(row0);
  h.rows = static_cast<int>(rows);
  const auto* sh = static_cast<const float*>(src_hi);
  const auto* sl = static_cast<const float*>(src_lo);
  auto* dh = static_cast<float*>(dst_hi);
  auto* dl = static_cast<float*>(dst_lo);
  const auto* w = static_cast<const uint8_t*>(solid);
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny), info.rows};
  const dim3 grid(static_cast<unsigned>(n_blocks));
  const dim3 block(kNT);
  const size_t shared = static_cast<size_t>(info.smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_walls) {
    if (exact) {
      lbm_ds_temporal_steps_ext<true, true><<<grid, block, shared, st>>>(sh, sl, dh, dl, w, n[0],
                                                                         n[1], n[2], L, k, h);
    } else {
      lbm_ds_temporal_steps_ext<true, false><<<grid, block, shared, st>>>(sh, sl, dh, dl, w, n[0],
                                                                          n[1], n[2], L, k, h);
    }
  } else {
    if (exact) {
      lbm_ds_temporal_steps_ext<false, true><<<grid, block, shared, st>>>(
          sh, sl, dh, dl, nullptr, n[0], n[1], n[2], L, k, h);
    } else {
      lbm_ds_temporal_steps_ext<false, false><<<grid, block, shared, st>>>(
          sh, sl, dh, dl, nullptr, n[0], n[1], n[2], L, k, h);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// lbm_ds_temporal_steps_info for the ext-halo form: the same six values.
extern "C" int lbm_ds_temporal_steps_ext_info(int64_t exact, int64_t has_walls, int64_t* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Info info;
  const cudaError_t err = pair_info<true>(has_walls, exact, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = info.attr.numRegs;
  out[1] = info.per_sm;
  out[2] = info.smem;
  out[3] = static_cast<int64_t>(info.attr.localSizeBytes);
  out[4] = info.rows;
  out[5] = kW;
  return 0;
}
