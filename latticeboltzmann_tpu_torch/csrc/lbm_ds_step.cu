// One fused D2Q9 lattice-Boltzmann step in double-single (f32-pair)
// arithmetic for Hopper (sm_90a): channel forcing at pair precision,
// periodic pull stream, BGK collision at pair precision and bounce-back.
//
// Replaces latticeboltzmann_tpu/ops/fused_ds_kernel.py::_make_ds_pass as
// launched by its pl.pallas_call (ops/fused_ds_kernel.py:272), one time
// step per launch, in two forms: the local form
// (lbm_stream_collide_ds_launch, the whole lattice, periodic in both
// axes) and the ext-halo form (lbm_stream_collide_ds_ext_launch, the
// ext_halo=True variant at :242-254 as _get_sharded_runner :385-472 drives
// it per shard): a shard's local block, of which one launch writes a row
// range, with the rows beyond the block taken from two halo rows of each
// pair component instead of the x wrap. Template parameters: HAS_WALLS
// selects the masked or wall-free variant, EXACT the collision tier:
// ds_engine.collide_planes (exact) or ds_engine.collide_planes_fast (fast,
// the default). The two
// forms are two kernels that share what follows the pull (collide_store);
// the local kernel keeps its own row indexing, as in the stream-collide
// kernel (csrc/lbm_step.cu).
//
// Bound: a site update moves 145 B (9 hi and 9 lo floats read and written,
// plus the mask byte): 36 streams, twice the 18 of a float32 step. Its f32
// instructions are mostly pair adds, which no FMA can fuse, so they issue
// at one a lane and clock. Along an ordinary site's path in the SASS
// (chip_smoke.py counts them) the fast tier has about 640 FP32
// instructions (1,000 in all) and the exact tier about 1,600 (2,000): on an
// H100 at 1.98 GHz and 800x4000, 61 and 154 us of issue against 139 us of
// bytes at the published 3.35 TB/s (158 at the copy kernel's rate). The
// fast tier is bound by bytes, the exact one by issue. The design keeps
// what the card rewards and drops what the TPU needed:
// - one thread per site, threads along y (the contiguous axis), so each
//   plane's loads and stores of a warp coalesce; hi and lo are two
//   separate (9, NX, NY) planes (the JAX DS layout), so both components'
//   loads coalesce too. The step is out of place: the pull never reads the
//   buffers it writes;
// - a CTA is 128 lanes of one row, and consecutive CTAs take consecutive
//   column tiles of one row (a 1-D grid, as in lbm_wide_step.cu), so the
//   CTAs in flight sweep each of the 36 planes front to back, as a copy
//   does; rows first, they walked down one tile's column of every plane.
//   At 56 registers a thread, 128-lane CTAs keep 36 warps on an SM where
//   256-lane ones keep 32;
// - the error of a product is one FMA (two_prod, mul_c in lbm_ds.cuh) where the
//   TPU kernel, on a VPU without f32 FMA, split both operands (Dekker's
//   TwoProd, 17 ops).
//
// The pair arithmetic and the two tiers live in lbm_ds.cuh, shared with
// the temporal form: every f32 op an _rn intrinsic in ops/df64.py's order,
// so the kernel equals the plain PyTorch version
// (fused_ds_kernel.step_reference in the port) bit for bit.
//
// The product's error. df64.two_prod (the plain version) splits a and b
// into 12-bit halves and sums the four partial products; here
// e = fma(a, b, -p), p = fl(a * b). Both are the exact error a * b - p,
// so the same float, wherever it is representable: the exponents ea, eb
// of the operands' leading bits sum to at least -103 (the error's last
// bit, 2^(ea + eb - 46), is then at or above 2^-149), and neither operand
// reaches 2^115 (Dekker's split multiplies by 4097 and would overflow).
// Down to a sum of -113 they still agree: there only Dekker's last
// partial products round, onto the 2^-149 grid on which the rest of its
// sum lies at even multiples, so they round as the FMA's one rounding
// does, ties included. The first sums at which the two differ are -114
// (a subnormal operand) and -115 (normal operands); tests/test_torch_
// df64.py shows all of this on random operands and on the kernel's
// constants. In the kernel only products of velocities near rest come
// near the edge; chip_smoke.py holds 100 fast and 50 exact steps from rest
// at 800x4000, on the barrier, a symmetric channel and an empty box,
// bitwise against step_reference.
//
// Not carried over from the TPU kernel: the mirror-pad lanes (the y wrap
// is an index wrap here), row blocks and their halo rows and pad
// re-mirroring. Its temporal blocking, several steps per pass, is the
// temporal form (lbm_ds_temporal_step.cu); this kernel runs the passes of
// one step and the shapes that form does not take.
//
// Forcing: the TPU kernel forces column 0 of its window before the pull.
// Here each forced speed whose source site lies in column 0 re-evaluates
// the pair guard at that source site (6 extra loads: f6, f3, f7, both
// components). Every forced speed has e_y != 0, so only destination
// columns 1 and NY-1 take this branch. The forcing uses the full pair add
// and sub (not the fast tier's add_s), as the TPU kernel does.
//
// Forcing in the halo rows (ext-halo form): an edge row pulls from a halo
// row, and the pair guard of that row's column-0 site reads f6, f3 and f7,
// both components of each, there. Each halo row therefore carries all 9
// speed planes of both components of the neighbour's boundary row, as the
// JAX sharded runner ships them (fused_ds_kernel.py:436-437 there), and
// the guard is evaluated here from them; the halo's class row (the
// neighbour's, static) is exchanged once per run. Cost: 4 x 9 x NY x 4 B
// of halo per shard per step (576 KB at NY = 4000, 0.5% of a 200-row
// shard's 115 MB step), against 3 planes of each component plus a guard
// bit that the sender would compute in a launch of its own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_ds.cuh"

namespace {

// A CTA: kTile lanes along y in one row
constexpr int kTile = 128;

// --- the step --------------------------------------------------------------

// Where a shard's local block sits and what lies beyond it (ext-halo
// form).
struct Ext {
  const float* top_hi;       // (9, ny): the row above local row 0, hi and lo
  const float* top_lo;
  const float* bot_hi;       // (9, ny): the row below local row nx - 1
  const float* bot_lo;
  const uint8_t* solid_top;  // (ny): the halo rows' class rows (masked variant)
  const uint8_t* solid_bot;
  int64_t row0;              // first local row this launch writes
  int64_t rows;              // rows it writes
};

// Forcing guard of the column-0 site in row `row`, at pair precision:
// fluid, and f6 - a58, f3 - a14, f7 - a58 all > 0
// (src/latticeboltzmann.c:500-513, fused_ds_kernel.py:179-185).
template <bool HAS_WALLS>
__device__ __forceinline__ bool forced_at(const float* __restrict__ hi,
                                          const float* __restrict__ lo,
                                          const uint8_t* __restrict__ solid,
                                          int64_t row, int64_t ny, int64_t plane,
                                          ds a14, ds a58) {
  const int64_t site = row * ny;  // column 0
  if (HAS_WALLS && solid[site] != 0) return false;
  const ds f6 = {hi[6 * plane + site], lo[6 * plane + site]};
  const ds f3 = {hi[3 * plane + site], lo[3 * plane + site]};
  const ds f7 = {hi[7 * plane + site], lo[7 * plane + site]};
  return gt_zero(sub(f6, a58)) && gt_zero(sub(f3, a14)) && gt_zero(sub(f7, a58));
}

// What follows the pull in both forms: the collision at the tier, then
// bounce-back when solid_site() (called after the collision, where the
// local kernel always read the mask), stored at offset `site` of each of
// the dst planes.
template <bool EXACT, typename SolidSite>
__device__ __forceinline__ void collide_store(const ds (&p)[9], SolidSite solid_site,
                                              float* __restrict__ dst_hi,
                                              float* __restrict__ dst_lo, int64_t plane,
                                              int64_t site, const Params& k) {
  // the opposite speed, as in core/spec.py
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  ds out[9];
  if constexpr (EXACT) {
    collide_exact(p, out, k);
  } else {
    collide_fast(p, out, k);
  }
  if (solid_site()) {
    // bounce-back; OPP[0] == 0 passes the site's own f0 through
#pragma unroll
    for (int s = 0; s < 9; ++s) out[s] = p[OPP[s]];
  }
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    dst_hi[s * plane + site] = out[s].hi;
    dst_lo[s * plane + site] = out[s].lo;
  }
}

// A thread's site: row i of the rows the launch writes, column j. The 1-D
// grid holds each row's column tiles of kTile in turn.
struct Site {
  int i, j;
};

__device__ __forceinline__ Site site_of(int nyi) {
  const unsigned tiles = (static_cast<unsigned>(nyi) + kTile - 1) / kTile;
  return {static_cast<int>(blockIdx.x / tiles),
          static_cast<int>((blockIdx.x % tiles) * kTile + threadIdx.x)};
}

// The local form: every row of the lattice, periodic in both axes.
template <bool HAS_WALLS, bool EXACT>
__global__ void __launch_bounds__(kTile)
lbm_stream_collide_ds(const float* __restrict__ src_hi, const float* __restrict__ src_lo,
                      float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                      const uint8_t* __restrict__ solid, int64_t nx, int64_t ny,
                      Params k) {
  // e_s = (e_x, e_y) and the forcing increment sign (+1 speeds gain, -1
  // speeds lose), as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  // the pairs a14 and a58 sit after the other constants of each tier
  constexpr int A14 = EXACT ? 16 : 14;
  constexpr int A58 = EXACT ? 18 : 16;

  // index arithmetic in 32 bits (the launcher bounds nx and ny), plane
  // offsets in 64
  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  const Site c = site_of(nyi);
  const int i = c.i;
  const int j = c.j;
  if (i >= nxi || j >= nyi) return;
  const int64_t plane = nx * ny;
  const int rows[3] = {(i + 1) % nxi, i, (i - 1 + nxi) % nxi};
  const int cols[3] = {(j + 1) % nyi, j, (j - 1 + nyi) % nyi};
  const ds a14 = pair(k, A14);
  const ds a58 = pair(k, A58);

  // pull: p_s(i, j) = f_s(i - e_x, j - e_y), periodic in both axes, with
  // the source site's forcing applied first
  ds p[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int64_t si = rows[EX[s] + 1];
    const int64_t sj = cols[EY[s] + 1];
    const int64_t idx = s * plane + si * ny + sj;
    ds v = {src_hi[idx], src_lo[idx]};
    if (FORCE[s] != 0 && sj == 0 &&
        forced_at<HAS_WALLS>(src_hi, src_lo, solid, si, ny, plane, a14, a58)) {
      const ds a = (s == 1 || s == 3) ? a14 : a58;
      v = add(v, FORCE[s] > 0 ? a : neg(a));
    }
    p[s] = v;
  }

  const int64_t site = static_cast<int64_t>(i) * ny + j;
  collide_store<EXACT>(p, [&] { return HAS_WALLS && solid[site] != 0; }, dst_hi, dst_lo, plane,
                       site, k);
}

// The ext-halo form's forced_at, for a row that may be a halo row: hi and
// lo are the row's column-0 values of speed 0, stride the distance between
// its speed planes, cls_row its class row.
template <bool HAS_WALLS>
__device__ __forceinline__ bool forced_row(const float* __restrict__ hi,
                                           const float* __restrict__ lo,
                                           const uint8_t* __restrict__ cls_row,
                                           int64_t stride, ds a14, ds a58) {
  if (HAS_WALLS && cls_row[0] != 0) return false;
  const ds f6 = {hi[6 * stride], lo[6 * stride]};
  const ds f3 = {hi[3 * stride], lo[3 * stride]};
  const ds f7 = {hi[7 * stride], lo[7 * stride]};
  return gt_zero(sub(f6, a58)) && gt_zero(sub(f3, a14)) && gt_zero(sub(f7, a58));
}

// The ext-halo form: local rows [e.row0, e.row0 + e.rows) of a shard's
// (9, nx, ny) pair of blocks, periodic in y; the source rows past the
// block are the halo rows, each read through its column-0 addresses, the
// stride between its speed planes and its class row.
template <bool HAS_WALLS, bool EXACT>
__global__ void __launch_bounds__(kTile)
lbm_stream_collide_ds_ext(const float* __restrict__ src_hi, const float* __restrict__ src_lo,
                          float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                          const uint8_t* __restrict__ solid, Ext e, int64_t nx, int64_t ny,
                          Params k) {
  // e_s = (e_x, e_y) and the forcing increment sign, as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int A14 = EXACT ? 16 : 14;
  constexpr int A58 = EXACT ? 18 : 16;

  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  const Site c = site_of(nyi);
  const int i = static_cast<int>(e.row0) + c.i;
  const int j = c.j;
  if (c.i >= static_cast<int>(e.rows) || j >= nyi) return;
  const int64_t plane = nx * ny;
  const int cols[3] = {(j + 1) % nyi, j, (j - 1 + nyi) % nyi};
  const ds a14 = pair(k, A14);
  const ds a58 = pair(k, A58);

  // source rows i - e_x, indexed by e_x + 1 (rows i + 1, i, i - 1)
  const float* row_hi[3];
  const float* row_lo[3];
  int64_t stride[3];
  const uint8_t* cls_row[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int li = i + 1 - r;
    if (li < 0 || li >= nxi) {
      row_hi[r] = li < 0 ? e.top_hi : e.bot_hi;
      row_lo[r] = li < 0 ? e.top_lo : e.bot_lo;
      stride[r] = ny;
      cls_row[r] = li < 0 ? e.solid_top : e.solid_bot;
    } else {
      const int64_t off = static_cast<int64_t>(li) * ny;
      row_hi[r] = src_hi + off;
      row_lo[r] = src_lo + off;
      stride[r] = plane;
      cls_row[r] = HAS_WALLS ? solid + off : nullptr;
    }
  }

  // pull: p_s(i, j) = f_s(i - e_x, j - e_y), with the source site's
  // forcing applied first
  ds p[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int r = EX[s] + 1;
    const int64_t sj = cols[EY[s] + 1];
    const int64_t idx = s * stride[r] + sj;
    ds v = {row_hi[r][idx], row_lo[r][idx]};
    if (FORCE[s] != 0 && sj == 0 &&
        forced_row<HAS_WALLS>(row_hi[r], row_lo[r], cls_row[r], stride[r], a14, a58)) {
      const ds a = (s == 1 || s == 3) ? a14 : a58;
      v = add(v, FORCE[s] > 0 ? a : neg(a));
    }
    p[s] = v;
  }

  collide_store<EXACT>(p, [&] { return HAS_WALLS && cls_row[1][j] != 0; }, dst_hi, dst_lo,
                       plane, static_cast<int64_t>(i) * ny + j, k);
}

// One CTA per row and column tile of the rows a launch writes.
int64_t ctas(int64_t rows, int64_t ny) { return rows * ((ny + kTile - 1) / kTile); }

// The checks both entry points share; true when the launch is refused.
// The 1-D grid holds at most 2^31 - 1 CTAs; the kernel's 32-bit index
// arithmetic needs nx, ny < 2^30
bool refused(int64_t nx, int64_t ny) {
  return nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
         ctas(nx, ny) > 0x7fffffffLL;
}

// The launch constants from their host floats: 20 (exact) or 18 (fast).
Params params_from(const void* params, int64_t exact) {
  Params k{};
  const float* h = static_cast<const float*>(params);
  const int n = exact ? 20 : 18;
  for (int q = 0; q < n; ++q) k.v[q] = h[q];
  return k;
}


}  // namespace

// One pair step (src_hi, src_lo) -> (dst_hi, dst_lo) on `stream`. All four:
// (9, nx, ny) float32, device, contiguous, distinct. solid: (nx, ny) uint8
// codes 0 fluid / 1 bounce-back (read only when has_walls != 0). exact
// selects the collision tier. params: 20 (exact) or 18 (fast) host floats
// in Params order. Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_ds_launch(const void* src_hi, const void* src_lo,
                                            void* dst_hi, void* dst_lo,
                                            const void* solid, int64_t nx, int64_t ny,
                                            int64_t has_walls, int64_t exact,
                                            const void* params, void* stream) {
  if (refused(nx, ny)) return static_cast<int>(cudaErrorInvalidValue);
  const Params k = params_from(params, exact);
  const dim3 grid(static_cast<unsigned>(ctas(nx, ny)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sh = static_cast<const float*>(src_hi);
  const float* sl = static_cast<const float*>(src_lo);
  float* dh = static_cast<float*>(dst_hi);
  float* dl = static_cast<float*>(dst_lo);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  if (has_walls) {
    if (exact) {
      lbm_stream_collide_ds<true, true><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, nx, ny, k);
    } else {
      lbm_stream_collide_ds<true, false><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, nx, ny, k);
    }
  } else {
    if (exact) {
      lbm_stream_collide_ds<false, true><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, nx, ny, k);
    } else {
      lbm_stream_collide_ds<false, false><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, nx, ny, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The ext-halo form: one pair step of the local rows [row0, row0 + rows)
// of a shard's (9, nx, ny) blocks, as the local form but for the rows
// beyond the block. top_hi/top_lo and bot_hi/bot_lo: (9, ny) float32
// device rows, the row above local row 0 and the row below local row
// nx - 1, all 9 speed planes of both components; required when the range
// touches row 0 (top) or row nx - 1 (bot), never read otherwise.
// solid_top, solid_bot: their (ny) uint8 class rows, required with them
// in the masked variant. Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_ds_ext_launch(
    const void* src_hi, const void* src_lo, void* dst_hi, void* dst_lo, const void* top_hi,
    const void* top_lo, const void* bot_hi, const void* bot_lo, const void* solid,
    const void* solid_top, const void* solid_bot, int64_t nx, int64_t ny, int64_t row0,
    int64_t rows, int64_t has_walls, int64_t exact, const void* params, void* stream) {
  const bool top = top_hi != nullptr && top_lo != nullptr &&
                   (!has_walls || solid_top != nullptr);
  const bool bot = bot_hi != nullptr && bot_lo != nullptr &&
                   (!has_walls || solid_bot != nullptr);
  if (refused(nx, ny) || (has_walls && solid == nullptr) || row0 < 0 || rows < 1 ||
      row0 + rows > nx || (row0 == 0 && !top) || (row0 + rows == nx && !bot)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params, exact);
  const dim3 grid(static_cast<unsigned>(ctas(rows, ny)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Ext e{static_cast<const float*>(top_hi), static_cast<const float*>(top_lo),
              static_cast<const float*>(bot_hi), static_cast<const float*>(bot_lo),
              static_cast<const uint8_t*>(solid_top), static_cast<const uint8_t*>(solid_bot),
              row0, rows};
  const float* sh = static_cast<const float*>(src_hi);
  const float* sl = static_cast<const float*>(src_lo);
  float* dh = static_cast<float*>(dst_hi);
  float* dl = static_cast<float*>(dst_lo);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  if (has_walls) {
    if (exact) {
      lbm_stream_collide_ds_ext<true, true><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, e, nx, ny, k);
    } else {
      lbm_stream_collide_ds_ext<true, false><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, e, nx, ny, k);
    }
  } else {
    if (exact) {
      lbm_stream_collide_ds_ext<false, true><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, e, nx, ny, k);
    } else {
      lbm_stream_collide_ds_ext<false, false><<<grid, kTile, 0, st>>>(sh, sl, dh, dl, w, e, nx, ny, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
