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
//   per thread along rows.
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

// The guard of the column-0 sites among rows [ra, rb) and columns [ca, cb)
// of the tile, read at the current level in its layout, into the top bit
// of each one's class byte: set where the site is fluid and f6, f3 and f7
// all stay above their decrements. Every other site's bit stays 0 from
// the load. `first`: the first tile column >= ca whose global column is 0;
// the others follow every ny columns.
template <typename T, bool PUSHED>
__device__ __forceinline__ void guard_bits(const T* sm, uint8_t* cls, int ra, int rb, int first,
                                           int cb, int ny, const Params& k) {
  const int occ = first < cb ? (cb - 1 - first) / ny + 1 : 0;
  const int n = (rb - ra) * occ;
  const int o6 = slot_offset<PUSHED>(6);
  const int o3 = slot_offset<PUSHED>(3);
  const int o7 = slot_offset<PUSHED>(7);
  for (int i = threadIdx.x; i < n; i += kNT) {
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
// ny + c] of each plane.
template <typename T, int GEOM, bool PUSHED, bool HAS0, bool LAST>
__device__ __forceinline__ void tile_level(T* sm, const uint8_t* cls, int ra, int rb, int ca,
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
template <typename T, int GEOM, bool HAS0, bool LAST>
__device__ __forceinline__ void level(bool pushed, T* sm, const uint8_t* cls, int ra, int rb,
                                      int ca, int cb, T* dst, int64_t out0, int ny,
                                      int64_t plane, const Params& k, int fast_math) {
  if (pushed) {
    tile_level<T, GEOM, true, HAS0, LAST>(sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                          fast_math);
  } else {
    tile_level<T, GEOM, false, HAS0, LAST>(sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                           fast_math);
  }
}

// Start a tile's loads into shared memory as asynchronous copies: the 9
// planes of each (row, 16-byte vector) item, and its V class bytes (the
// plane variant: one copy from the class plane; the spec variant: the
// spec at the sites' global indices; wall-free: zeros). A vector's global
// columns are contiguous: the tile's first column and NY are multiples of
// V.
template <typename T, int GEOM>
__device__ __forceinline__ void load_tile(T* sm, uint8_t* cls, const TileAt& a, const T* src,
                                          const uint8_t* solid, const Spec& g, int nx, int ny,
                                          int64_t plane) {
  constexpr int V = vec_columns<T>();
  const int k0 = a.lc0 / V;
  const int nb = (a.lc1 + V - 1) / V - k0;
  const int n = a.lr1 * nb;
  Walk at(nb);
  for (int i = threadIdx.x; i < n; i += kNT, at.next()) {
    const int lr = at.a;
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

// The L levels of a loaded tile, the last of which stores the output tile.
template <typename T, int GEOM>
__device__ __forceinline__ void tile_levels(T* sm, uint8_t* cls, const TileAt& a, T* dst, int ny,
                                            int64_t plane, const Params& k, int fast_math) {
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
        guard_bits<T, true>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, k);
      } else {
        guard_bits<T, false>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, k);
      }
      __syncthreads();
      if (last) {
        level<T, GEOM, true, true>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                   fast_math);
      } else {
        level<T, GEOM, true, false>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                    fast_math);
      }
    } else if (last) {
      level<T, GEOM, false, true>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                  fast_math);
    } else {
      level<T, GEOM, false, false>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                   fast_math);
    }
    // every read of this level before the next level's (or tile's) writes
    __syncthreads();
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
    // barrier) before these loads overwrite it
    load_tile<T, GEOM>(sm, cls, a, src, solid, g, nx, ny, plane);
    copies_wait();
    __syncthreads();
    tile_levels<T, GEOM>(sm, cls, a, dst, ny, plane, k, fast_math);
  }
}

// What the card gives the kernel for storage T and geometry GEOM, read once
// per card (launch_temporal asks at every launch): the tile's rows
// (tile_rows), its dynamic shared bytes, the kernel's attributes, its CTAs
// per SM and the card's SMs.
struct Info {
  int rows = 0, per_sm = 0, sms = 0;
  int64_t smem = 0;
  cudaFuncAttributes attr{};
};

constexpr int kMaxDevices = 64;

template <typename T, int GEOM>
cudaError_t tile_info(Info* out) {
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
  err = tile_rows(tile_bytes, sizeof(T), &info.rows);
  if (err != cudaSuccess) return err;
  info.smem = tile_bytes(info.rows, sizeof(T));
  auto kernel = lbm_temporal_steps<T, GEOM>;
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

template <typename T, int GEOM>
int launch_temporal(const void* src, void* dst, const uint8_t* solid, const Spec& g, int nx,
                    int ny, int L, const Params& k, int fast_math, cudaStream_t st) {
  if (ny % vec_columns<T>() != 0) return static_cast<int>(cudaErrorInvalidValue);
  Info info;
  const cudaError_t err = tile_info<T, GEOM>(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the pass leaves an output tile, and the tile count stays under 2^30
  // (32-bit tile arithmetic)
  const int64_t R = info.rows - 2 * L, C = kW - 2 * column_halo<T>(L);
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = ((nx + R - 1) / R) * ((ny + C - 1) / C);
  if (tiles >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  // the co-resident grid, no larger than the work
  const int64_t n_blocks = std::min<int64_t>(tiles, static_cast<int64_t>(info.per_sm) * info.sms);
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

template <typename T>
cudaError_t info_geometry(int64_t geometry, Info* out) {
  switch (geometry) {
    case kPlane:
      return tile_info<T, kPlane>(out);
    case kSpec:
      return tile_info<T, kSpec>(out);
    default:
      return tile_info<T, kNone>(out);
  }
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
// included. Returns 0 or a CUDA error.
extern "C" int lbm_temporal_steps_info(int64_t storage, int64_t geometry, int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1 || geometry < kNone || geometry > kSpec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = storage == 1 ? info_geometry<__nv_bfloat16>(geometry, &info)
                                       : info_geometry<float>(geometry, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = info.attr.numRegs;
  out[1] = info.per_sm;
  out[2] = info.smem;
  out[3] = static_cast<int64_t>(info.attr.localSizeBytes);
  out[4] = info.rows;
  out[5] = kW;
  return 0;
}
