// The main path's temporal blocking for Hopper (sm_90a): L D2Q9
// lattice-Boltzmann steps with walls (channel forcing with the
// all-or-nothing guard, periodic pull, BGK collision, bounce-back and
// free-slip classes) in one pass through device memory, src -> dst.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757) at
// temporal = T > 1 (:270-275): T fused steps per HBM pass over a row window
// held in VMEM, masked and wall-spec variants included, run in pairs of
// passes by Session.advance (:2845-2870). Here one launch is one pass of L
// steps between the session's two distinct (9, NX, NY) buffers, so no pass
// writes what another CTA still reads: no grid-wide sync, and the flat
// kernel's parity contract (lbm_flat_step.cu) does not arise. The TPU
// kernel's row windows, mirror pads, DMA slots and its bf16 rounding every
// T steps are staging and have no counterpart; a level rounds to storage
// as every step of the plain version does.
//
// What bounds it. Through device memory one step moves 72 B a site in
// float32 (36 B in bf16), plus a class byte in the plane variant; a pass
// of L steps held in shared memory reads its tile, halos included, once
// and writes the tile's interior once, so its bytes per site-step fall
// about as 1/L. What it pays instead is the halos: each tile reads 1.2-1.8
// times its output sites and computes the shrinking halo levels again,
// with IEEE division and no fused multiply-add, through shared memory. The
// flat kernel measured a pass at about one step through device memory and
// each further level at about a fourth of that (PERF.md).
//
// The design is the flat kernel's tile (lbm_flat_step.cu) with a class per
// site:
// - a persistent grid of as many CTAs as the card holds at once (two CTAs
//   of 256 threads per SM), each walking the output tiles (R rows x C
//   columns) of the pass in a grid-stride loop, a plain launch;
// - a tile of `rows` x kW sites in shared memory (kW = 72 columns; rows:
//   what two CTAs per SM leave, read from the card), from which a pass of
//   L steps writes output tiles of (rows - 2L) x (kW - 2 PAD) sites, PAD =
//   L rounded up to a 16-byte vector's columns: per output tile, the
//   (R + 2L) x (C + 2L) source sites of all 9 planes, in the storage type,
//   loaded with periodic wrap in both axes by modulo indices as 16-byte
//   cp.async copies, as rows of the 9 planes interleaved ([row][plane]
//   [column]), so that every pull's offset is a compile-time constant;
// - one byte per tile site beside the planes: its solid class in the low
//   bits (0 fluid, 1 bounce-back, 2 slip_x, 3 slip_y), loaded once per
//   tile with the planes (the plane variant: 4- or 8-byte cp.async copies
//   of the uint8 class plane; the spec variant: spec_solid evaluated at the
//   site's global indices; wall-free: 0), and in its top bit the forcing
//   guard of a column-0 site at the level being read;
// - L levels in place, the region shrinking by one site a level on each
//   side, in the flat kernel's two alternating layouts (natural: slot
//   (x, s) holds f_s(x); pushed: slot (x + e_s, opp s) holds f_s(x)): a
//   site writes its 9 results into the 9 slots it read. Bounce-back and the
//   slip reflections are maps from a site's 9 pulled values to its 9
//   outputs, so they fit the scheme as the collision does: a level needs
//   one barrier and no copy of the tile;
// - forcing at source sites of GLOBAL column 0 whose class is 0, decided
//   by the guard at the level being read: a tile that holds column 0 first
//   writes the guard of each such site into its class byte (the level's
//   writes would otherwise race with other sites' guard reads), then a
//   barrier;
// - the last level writes the output tile from registers to dst, one site
//   per thread along rows;
// - a tile's rows load as two groups of copies, the top half and the
//   bottom half, and its first level runs on the rows whose sources are in
//   the top half while the bottom half lands, then on the rest (a tile
//   that holds global column 0 waits for all its rows: its guard bits read
//   them first). A CTA that waits for its tile leaves the SM to the other
//   CTA's levels alone; this shortens the wait.
// Taken apart on an H100 (scripts/temporal_parts.py; PERF.md), a pass of
// 6 is its levels' time (its levels alone 0.95 of it in float32, 0.96 in
// bf16), and neither more warps an SM nor two sites a thread run them
// faster; one CTA an SM with two tile buffers, its next tile loading under
// its levels, ran them 13% slower (a level's barrier then stops the whole
// SM) and lost at 6 steps, and a tile height planned per launch lost there
// too.
// It takes NY a multiple of a 16-byte vector's columns and 16-byte
// aligned buffers (the wrapper refuses every other shape), and a pass as
// deep as leaves an output tile (lbm_temporal_steps_info gives the tile).
//
// A site's update is the step kernel's through the shared collision of
// lbm_collide.cuh, and every level rounds to storage (bf16 to nearest
// even) as the plain version rounds after every step, so with -fmad=false
// the kernel rounds exactly like L chained steps of the plain PyTorch
// version (fused_kernel.temporal_reference in the port, whose tiled form
// fused_kernel.temporal_reference_blocked follows this kernel's tiles):
// bitwise, for any L. fast_math (rcp.approx.f32) has no bitwise
// reference.
//
// The ext-halo form (lbm_temporal_steps_ext, launched by
// lbm_temporal_steps_ext_launch) replaces the same pl.pallas_call
// (ops/fused_kernel.py:1757) with external_halo=True at temporal = T, as
// latticeboltzmann_tpu/parallel/sharded.py::make_pallas_run_steps drives it
// per shard (its one_pass, :426-463 there): each pass ppermutes T rows of f
// from each ring neighbour and runs T steps on the shard's extended rows,
// T = 3 in float32 and 2 in bf16 (:264-286). Here one launch is one pass of
// L <= Td steps on a shard's (9, Ls, NY) block, writing the local rows
// [row0, row0 + rows), so that a caller can run the rows that take no halo
// while the halos are copied, and the rest after. It computes what this
// kernel computes with two changes to what it reads and writes (and its own
// CTA and tile plan, below):
// - where the rows come from (load_tile_ext, lbm_temporal.cuh): tile row lr
//   of a tile reads the shard's local row q; q < 0 reads row Td + q of the
//   top halo (9, Td, NY) and q >= Ls row q - Ls of the bottom one, each with
//   all 9 planes, and a class byte from the halo's static (Td, NY) class rows
//   (codes 0-3: the slip classes cross a shard boundary too) or, in the spec
//   variant, spec_solid at the global row wrap(row_offset + q, gnx), halo
//   rows included, as lbm_wide_ext_step.cu evaluates it. No x wrap: the ring
//   of shards outside is the x periodicity. Columns wrap modulo NY as in the
//   local form, and the forcing at GLOBAL column 0 is unchanged, since the
//   mesh splits rows only: a halo row's column-0 site is forced at every
//   level from its own values and class, as in the TPU window;
// - where the output goes: tiles are laid from row0 over `rows` rows and
//   written there.
// The tile, its loads as whole 16-byte vectors, the levels and their
// barriers are the local form's (tile_levels and the rest of
// lbm_temporal.cuh), and the local form keeps its own load path. The
// launcher refuses a pass deeper than the halos (L > Td), one whose reads
// would leave [-Td, Ls + Td), NY of no whole vectors, misaligned buffers and
// a pass that leaves no output tile. fast_math is the same run-time flag.
//
// What bounds the ext-halo form. A pass of 3 steps in float32 on a 200-row
// shard of 800x4000 (4 shards) reads the shard's rows grown by its tiles'
// halos, 73 B a site, and writes it once, as the local form's tiles do;
// the halo blocks add 2 x 9 x 3 x NY x 4 B a shard a pass (0.9 MB for 4
// shards). At the card's largest tile (43 rows) a shard's launch lays 6
// rows of tiles (five of 37 output rows and one of 15) x 63 columns, 378
// tiles, 1.4 waves of the 264 co-resident CTAs of the local form's shape,
// where the whole lattice's 1,386 make 5.3: the last partial wave of each
// launch is what 4 shards lost against one lattice (PERF.md, PR 17). And
// a CTA of that shape loads its tile, waits, runs the levels and stores:
// only the SM's other CTA runs while it waits.
//
// So the shard forms run their passes differently from the local form
// (PERF.md, PR 19), both parts in lbm_temporal.cuh:
// - each launch plans its own tile (plan_tiles): the output tile height R
//   <= rows - 2 L whose waves (the tiles the busiest CTA walks) times one
//   tile's cost (tile_cost, from the bytes and site updates measured on an
//   H100) is least; lbm_temporal_steps_ext_plan reports it;
// - one CTA of kShardThreads = 512 threads an SM holds two tile buffers of
//   the card's tile rows (229,120 B in float32, 229,824 B in bf16) and
//   walks its tiles in a grid-stride loop (pass_tiles): the copies of its
//   next tile start as a cp.async group of their own before the levels of
//   the current one, which wait only for their own group
//   (cp.async.wait_group 1) and a barrier.
// A site's arithmetic, the tile's layout and the levels are the local
// form's, so every tiling gives the same bits.
// The row-sharded rdma form of the same pass is
// csrc/lbm_temporal_rdma_step.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lbm_temporal.cuh"

namespace {

// Level 1 of a tile that holds no site of global column 0, over its rows
// [r0, r1) only (the level's rows are [1, lr1 - 1)): the last level when L
// is 1.
template <typename T, int GEOM>
__device__ __forceinline__ void first_level_rows(T* sm, const uint8_t* cls, const TileAt& a,
                                                 int r0, int r1, T* dst, int ny, int64_t plane,
                                                 const Params& k, int fast_math) {
  if (r1 <= r0) return;
  const int64_t out0 = static_cast<int64_t>(a.gr0) * ny + a.gc0;
  const int ca = a.pad - (a.L - 1), cb = a.pad + a.Ce + a.L - 1;
  if (a.L == 1) {
    tile_level<T, GEOM, false, false, true>(sm, cls, r0, r1, ca, cb, dst, out0, ny, plane, k,
                                            fast_math);
  } else {
    tile_level<T, GEOM, false, false, false>(sm, cls, r0, r1, ca, cb, dst, out0, ny, plane, k,
                                             fast_math);
  }
}

// src -> dst, L steps: (9, nx, ny) each, distinct. rows: the tile's rows; a
// pass of L steps writes output tiles of (rows - 2 L) x (kW - 2
// column_halo(L)) sites. solid: the uint8 class plane (GEOM kPlane).
template <typename T, int GEOM>
__global__ void __launch_bounds__(kNT, kCtasPerSm)
lbm_temporal_steps(const T* __restrict__ src, T* __restrict__ dst,
                   const uint8_t* __restrict__ solid, Spec g, int nx, int ny, int rows, int L,
                   Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  uint8_t* cls = smem + static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;  // plane offsets in 64 bits
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  const int tiles = ((nx + R - 1) / R) * tiles_y;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt a(tile, tiles_y, R, C, nx, ny, L, pad);
    // the previous tile's last level has read the shared tile (its closing
    // barrier) before these loads overwrite it: its top and bottom rows, two
    // groups of copies
    const int mid = a.lr1 / 2;
    load_tile<T, GEOM>(sm, cls, a, src, solid, g, nx, ny, plane, 0, mid);
    copies_commit();
    load_tile<T, GEOM>(sm, cls, a, src, solid, g, nx, ny, plane, mid, a.lr1);
    copies_commit();
    if (a.has0) {
      // a column-0 tile's guard bits read every row first
      copies_wait();
      __syncthreads();
      tile_levels<T, GEOM>(sm, cls, a, dst, ny, plane, k, fast_math);
      continue;
    }
    // level 1, row r reading rows r - 1 .. r + 1: the rows above mid - 1
    // while the bottom rows land, then the rest
    copies_wait_but_newest();
    __syncthreads();
    first_level_rows<T, GEOM>(sm, cls, a, 1, mid - 1, dst, ny, plane, k, fast_math);
    copies_wait();
    __syncthreads();
    first_level_rows<T, GEOM>(sm, cls, a, max(1, mid - 1), a.lr1 - 1, dst, ny, plane, k,
                              fast_math);
    __syncthreads();
    tile_levels<T, GEOM>(sm, cls, a, dst, ny, plane, k, fast_math, 2);
  }
}

// The ext-halo form: a pass of L steps on a shard of nx rows, writing its
// local rows [h.row0, h.row0 + h.rows), the rows beyond it from h. The
// output tiles are laid from h.row0 at the launch's planned tile of `rows`
// rows and written through dst shifted to that row; each CTA walks them in
// a grid-stride loop, its next tile loading under its current tile's
// levels (pass_tiles, lbm_temporal.cuh).
template <typename T, int GEOM>
__global__ void __launch_bounds__(kShardThreads, 1)
lbm_temporal_steps_ext(const T* __restrict__ src, T* __restrict__ dst,
                       const uint8_t* __restrict__ solid, Spec g, int nx, int ny, int rows, int L,
                       Params k, int fast_math, TemporalHalo<T> h) {
  const int C = kW - 2 * column_halo<T>(L);
  const int R = rows - 2 * L;
  StrideTiles next(((h.rows + R - 1) / R) * ((ny + C - 1) / C));
  pass_tiles<T, GEOM>(next, rows, h.rows, src, dst + static_cast<int64_t>(h.row0) * ny, solid, g,
                      nx, ny, L, k, fast_math, h);
}

// the kernel of a form (EXT: the ext-halo one) for storage T and geometry
template <typename T, int GEOM, bool EXT>
auto kernel_of() {
  if constexpr (EXT) {
    return lbm_temporal_steps_ext<T, GEOM>;
  } else {
    return lbm_temporal_steps<T, GEOM>;
  }
}

template <typename T, int GEOM, bool EXT>
cudaError_t tile_info(Info* out) {
  static Info cache[kMaxDevices];
  static bool known[kMaxDevices] = {};
  if constexpr (EXT) {
    return card_info<T>(kernel_of<T, GEOM, EXT>(), cache, known, out, kShardThreads,
                        kShardBuffers);
  } else {
    return card_info<T>(kernel_of<T, GEOM, EXT>(), cache, known, out);
  }
}

template <typename T, bool EXT>
cudaError_t info_geometry(int64_t geometry, Info* out) {
  switch (geometry) {
    case kPlane:
      return tile_info<T, kPlane, EXT>(out);
    case kSpec:
      return tile_info<T, kSpec, EXT>(out);
    default:
      return tile_info<T, kNone, EXT>(out);
  }
}

// The co-resident grid of a pass over `rows` output rows at the tile of
// `info`, no larger than the work; 0 when the pass leaves no output tile
// or the tile count reaches 2^30 (32-bit tile arithmetic).
template <typename T>
int64_t pass_grid(const Info& info, int64_t rows, int64_t ny, int L) {
  const int64_t R = info.rows - 2 * L, C = kW - 2 * column_halo<T>(L);
  if (R < 1 || C < 1) return 0;
  const int64_t tiles = ((rows + R - 1) / R) * ((ny + C - 1) / C);
  if (tiles >= (1LL << 30)) return 0;
  return std::min<int64_t>(tiles, static_cast<int64_t>(info.per_sm) * info.sms);
}

template <typename T, int GEOM>
int launch_temporal(const void* src, void* dst, const uint8_t* solid, const Spec& g, int nx,
                    int ny, int L, const Params& k, int fast_math, cudaStream_t st) {
  if (ny % vec_columns<T>() != 0) return static_cast<int>(cudaErrorInvalidValue);
  Info info;
  const cudaError_t err = tile_info<T, GEOM, false>(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_blocks = pass_grid<T>(info, nx, ny, L);
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  lbm_temporal_steps<T, GEOM><<<static_cast<unsigned>(n_blocks), kNT,
                                static_cast<size_t>(info.smem), st>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), solid, g, nx, ny, info.rows, L, k,
      fast_math);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_geometry(const void* src, void* dst, const uint8_t* solid, const Spec& g,
                    int64_t geometry, int nx, int ny, int L, const Params& k, int fast_math,
                    cudaStream_t st) {
  switch (geometry) {
    case kPlane:
      return launch_temporal<T, kPlane>(src, dst, solid, g, nx, ny, L, k, fast_math, st);
    case kSpec:
      return launch_temporal<T, kSpec>(src, dst, solid, g, nx, ny, L, k, fast_math, st);
    default:
      return launch_temporal<T, kNone>(src, dst, solid, g, nx, ny, L, k, fast_math, st);
  }
}

// The ext-halo form's plan of a launch over `rows` output rows at the card
// of `info` (plan_tiles; tile_rows > 0: that tile): one CTA an SM slot, no
// more than the tiles; false when no tile leaves an output row or the tile
// count reaches 2^30.
template <typename T>
bool ext_plan(const Info& info, int64_t rows, int64_t ny, int L, Plan* out, int tile_rows = 0) {
  const int64_t C = kW - 2 * column_halo<T>(L);
  if (C < 1) return false;
  const int64_t slots = static_cast<int64_t>(info.per_sm) * info.sms;
  const auto lay = [&](int R, Plan* p) {
    p->tiles = ((rows + R - 1) / R) * ((ny + C - 1) / C);
    if (p->tiles >= (1LL << 30)) return false;
    p->ctas = std::min<int64_t>(p->tiles, slots);
    p->waves = (p->tiles + p->ctas - 1) / p->ctas;
    return true;
  };
  return plan_tiles<T>(info.rows, L, lay, out, tile_rows);
}

template <typename T, int GEOM>
int launch_ext(const void* src, void* dst, const uint8_t* solid, const Spec& g, int nx, int ny,
               int L, const Params& k, int fast_math, const TemporalHalo<T>& h, int tile_rows,
               cudaStream_t st) {
  Info info;
  const cudaError_t err = tile_info<T, GEOM, true>(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  if (tile_rows > info.rows || !ext_plan<T>(info, h.rows, ny, L, &plan, tile_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lbm_temporal_steps_ext<T, GEOM><<<static_cast<unsigned>(plan.ctas), kShardThreads,
                                    static_cast<size_t>(info.smem), st>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), solid, g, nx, ny, plan.rows, L, k,
      fast_math, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ext_geometry(const void* src, void* dst, const uint8_t* solid, const Spec& g,
                        int64_t geometry, int nx, int ny, int L, const Params& k, int fast_math,
                        const TemporalHalo<T>& h, int tile_rows, cudaStream_t st) {
  switch (geometry) {
    case kPlane:
      return launch_ext<T, kPlane>(src, dst, solid, g, nx, ny, L, k, fast_math, h, tile_rows, st);
    case kSpec:
      return launch_ext<T, kSpec>(src, dst, solid, g, nx, ny, L, k, fast_math, h, tile_rows, st);
    default:
      return launch_ext<T, kNone>(src, dst, solid, g, nx, ny, L, k, fast_math, h, tile_rows, st);
  }
}

template <typename T>
TemporalHalo<T> halo_of(const void* top, const void* bot, const void* solid_top,
                        const void* solid_bot, int64_t depth, int64_t row0, int64_t rows,
                        int64_t offset, int64_t gnx) {
  return TemporalHalo<T>{static_cast<const T*>(top), static_cast<const T*>(bot),
                         static_cast<const uint8_t*>(solid_top),
                         static_cast<const uint8_t*>(solid_bot), static_cast<int>(depth),
                         static_cast<int>(row0), static_cast<int>(rows), offset, gnx};
}

}  // namespace

// One pass of `steps` steps src -> dst on `stream`. src, dst: (9, nx, ny),
// device, contiguous, distinct, 16-byte aligned, float32 (storage 0) or
// bf16 (storage 1); ny a multiple of a 16-byte vector's columns (4 or 8).
// geometry 0 (wall-free), 1 (solid: the uint8 (nx, ny) class plane, codes
// 0-3, 16-byte aligned) or 2 (spec: 10 host int64, the kernel's Spec
// order). steps: at least 1, and a pass that leaves an output tile
// (lbm_temporal_steps_info gives the tile). params: 9 host floats in Params
// order. Returns 0, or the CUDA error of the refused launch.
extern "C" int lbm_temporal_steps_launch(const void* src, void* dst, const void* solid,
                                         const void* spec, int64_t nx, int64_t ny,
                                         int64_t storage, int64_t geometry, int64_t fast_math,
                                         int64_t steps, const void* params, void* stream) {
  if (src == nullptr || dst == nullptr || src == dst || nx < 1 || ny < 1 || nx >= (1LL << 30) ||
      ny >= (1LL << 30) || storage < 0 || storage > 1 || geometry < kNone ||
      geometry > kSpec || (geometry == kPlane && solid == nullptr) ||
      (geometry == kSpec && spec == nullptr) || steps < 1 || steps > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const uint8_t* plane = geometry == kPlane ? static_cast<const uint8_t*>(solid) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny), static_cast<int>(steps),
                   fast_math != 0};
  if (storage == 1) {
    return launch_geometry<__nv_bfloat16>(src, dst, plane, g, geometry, n[0], n[1], n[2], k, n[3],
                                          st);
  }
  return launch_geometry<float>(src, dst, plane, g, geometry, n[0], n[1], n[2], k, n[3], st);
}

// What the kernel gets on the current card for storage 0 (float32) or 1
// (bf16) and geometry 0-2: out[0] registers per thread, out[1] CTAs per SM,
// out[2] dynamic shared bytes per CTA, out[3] local-memory bytes per thread
// (stack and spills), out[4] the tile's rows and out[5] its columns, halos
// included, out[6] the CTA's threads, out[7] its tile buffers. Returns 0 or
// a CUDA error.
extern "C" int lbm_temporal_steps_info(int64_t storage, int64_t geometry, int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1 || geometry < kNone || geometry > kSpec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = storage == 1 ? info_geometry<__nv_bfloat16, false>(geometry, &info)
                                       : info_geometry<float, false>(geometry, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  info_values(info, out);
  return 0;
}

// The ext-halo form: one pass of `steps` steps of the local rows [row0,
// row0 + rows) of a shard's (9, nx, ny) block src -> dst on `stream`, src
// and dst as lbm_temporal_steps_launch's; local row 0 is global row offset
// of a gnx-row lattice. top, bot: (9, depth, ny) blocks of src's storage,
// the depth rows above local row 0 and below local row nx - 1, all 9
// planes, 16-byte aligned; solid_top, solid_bot: their (depth, ny) uint8
// class rows (geometry 1, 16-byte aligned). A pass reads `steps` rows beyond
// each side of its output: where those leave the shard, that side's halo
// is required and depth >= steps; it is never read otherwise (depth 0 and
// null pointers allowed). With halos, steps > depth is refused. solid: the
// shard's (nx, ny) class plane (geometry 1); spec (geometry 2): evaluated
// at global rows, periodic in gnx. tile_rows: 0 lays the tiles of the
// launch's plan (lbm_temporal_steps_ext_plan); else the tile's rows, halos
// included, at most the card's (lbm_temporal_steps_ext_info). The other
// arguments and the return as lbm_temporal_steps_launch's.
extern "C" int lbm_temporal_steps_ext_launch(
    const void* src, void* dst, const void* top, const void* bot, const void* solid,
    const void* solid_top, const void* solid_bot, const void* spec, int64_t nx, int64_t ny,
    int64_t depth, int64_t row0, int64_t rows, int64_t offset, int64_t gnx, int64_t storage,
    int64_t geometry, int64_t fast_math, int64_t steps, const void* params, int64_t tile_rows,
    void* stream) {
  const bool plane = geometry == kPlane;
  if (src == nullptr || dst == nullptr || src == dst || misaligned(src) || misaligned(dst) ||
      nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) || storage < 0 ||
      storage > 1 || ny % (storage == 1 ? vec_columns<__nv_bfloat16>() : vec_columns<float>()) ||
      geometry < kNone || geometry > kSpec || (plane && (solid == nullptr || misaligned(solid))) ||
      (geometry == kSpec && spec == nullptr) || steps < 1 || steps > 64 || params == nullptr ||
      depth < 0 || depth >= (1LL << 30) || row0 < 0 || rows < 1 || row0 + rows > nx ||
      (depth > 0 && steps > depth) || offset < 0 || gnx >= (1LL << 62) || offset + nx > gnx ||
      tile_rows < 0 || tile_rows >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // each side the pass reads beyond the shard needs its halo, deep enough
  const void* sides[2][2] = {{top, solid_top}, {bot, solid_bot}};
  const bool needs[2] = {row0 - steps < 0, row0 + rows + steps > nx};
  for (int side = 0; side < 2; ++side) {
    if (!needs[side]) continue;
    if (steps > depth) return static_cast<int>(cudaErrorInvalidValue);
    for (int b = 0; b < (plane ? 2 : 1); ++b) {
      const void* q = sides[side][b];
      if (q == nullptr || misaligned(q)) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const uint8_t* w = plane ? static_cast<const uint8_t*>(solid) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny), static_cast<int>(steps),
                   fast_math != 0};
  if (storage == 1) {
    using B = __nv_bfloat16;
    return launch_ext_geometry<B>(
        src, dst, w, g, geometry, n[0], n[1], n[2], k, n[3],
        halo_of<B>(top, bot, solid_top, solid_bot, depth, row0, rows, offset, gnx),
        static_cast<int>(tile_rows), st);
  }
  return launch_ext_geometry<float>(
      src, dst, w, g, geometry, n[0], n[1], n[2], k, n[3],
      halo_of<float>(top, bot, solid_top, solid_bot, depth, row0, rows, offset, gnx),
      static_cast<int>(tile_rows), st);
}

// lbm_temporal_steps_info for the ext-halo form: the same eight values, the
// card's largest tile (a launch plans its own, lbm_temporal_steps_ext_plan).
extern "C" int lbm_temporal_steps_ext_info(int64_t storage, int64_t geometry, int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1 || geometry < kNone || geometry > kSpec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = storage == 1 ? info_geometry<__nv_bfloat16, true>(geometry, &info)
                                       : info_geometry<float, true>(geometry, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  info_values(info, out);
  return 0;
}

// The plan of one launch of the ext-halo form over `rows` output rows of
// NY columns, a pass of `steps` steps, on the current card (tile_rows as
// the launch's): out[0] the tile's rows, halos included, out[1] the output
// tiles, out[2] the CTAs launched, out[3] the tiles the busiest CTA walks.
// Returns 0, or cudaErrorInvalidValue where the launch would be refused.
extern "C" int lbm_temporal_steps_ext_plan(int64_t storage, int64_t geometry, int64_t rows,
                                           int64_t ny, int64_t steps, int64_t tile_rows,
                                           int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1 || geometry < kNone || geometry > kSpec ||
      rows < 1 || ny < 1 || rows >= (1LL << 30) || ny >= (1LL << 30) || steps < 1 || steps > 64 ||
      tile_rows < 0 || tile_rows >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = storage == 1 ? info_geometry<__nv_bfloat16, true>(geometry, &info)
                                       : info_geometry<float, true>(geometry, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  const int L = static_cast<int>(steps);
  const int t = static_cast<int>(tile_rows);
  const bool ok = t <= info.rows && (storage == 1 ? ext_plan<__nv_bfloat16>(info, rows, ny, L, &plan, t)
                                                  : ext_plan<float>(info, rows, ny, L, &plan, t));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = plan.rows;
  out[1] = plan.tiles;
  out[2] = plan.ctas;
  out[3] = plan.waves;
  return 0;
}
