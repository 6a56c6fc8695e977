// The tile of the kernels that run several steps per pass through device
// memory in shared memory: the flat kernel (lbm_flat_step.cu, wall-free,
// a stacked ping-pong pair), the temporal form (lbm_temporal_step.cu,
// with walls, src -> dst) and the pair-DP temporal form
// (lbm_ds_temporal_step.cu, 9 hi and 9 lo planes a row). What they share
// is the tile's shape, its interleaved layout and the walk over it: the
// slots of the natural and pushed layouts, the CTA's walk over items, the
// column halo of a pass and where an output tile lies. Each kernel keeps
// its own loads, levels and forcing guard.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The tile's columns, halos included (a pass of L steps writes kW - 2
// column_halo(L) of them), the threads of a CTA, and the CTAs that share
// an SM, so that one CTA's loads run under the other's levels: the shape
// the measurements chose (PERF.md). The rows are what the card's shared
// memory holds (tile_rows).
constexpr int kW = 72;
constexpr int kNT = 256;
constexpr int kCtasPerSm = 2;

// The rows of a kernel's tile on the current card, a tile of r rows taking
// bytes(r, itemsize) bytes of dynamic shared memory, the 9 interleaved
// planes and whatever the kernel keeps beside them: as many as leave
// kCtasPerSm tiles, each with what the card keeps back per CTA, in an SM's
// shared memory, and no more than one CTA may have.
inline cudaError_t tile_rows(int64_t (*bytes)(int64_t, int64_t), int64_t itemsize, int* rows) {
  int device = 0, per_sm_bytes = 0, per_cta = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&per_sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&per_cta, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err != cudaSuccess) return err;
  const int64_t budget = std::min<int64_t>(per_cta, per_sm_bytes / kCtasPerSm - reserved);
  // the planes alone bound the rows from above
  int r = static_cast<int>(budget / (9 * kW * itemsize));
  while (r > 0 && bytes(r, itemsize) > budget) --r;
  if (r < 1) return cudaErrorInvalidConfiguration;
  *rows = r;
  return cudaSuccess;
}

// columns of one 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_columns() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ int wrap(int i, int n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

// an asynchronous copy of N = 4 or 8 bytes (a vector's class bytes)
template <int N>
__device__ __forceinline__ void copy_small_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem)), "n"(N)
               : "memory");
}

// until every copy this thread started has landed
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// offset of the slot that holds f_s of the site at (row, column) offset 0
// in the interleaved tile: natural f_s(x) at (x, s); pushed at (x + e_s,
// opp s). Called with constant s only, so that it folds to a constant.
template <bool PUSHED>
__device__ __forceinline__ int slot_offset(int s) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  return PUSHED ? (9 * EX[s] + OPP[s]) * kW + EY[s] : s * kW;
}

// A CTA's walk over an (a, b) grid of items with b < nb fastest: item i of
// the CTA's threads' stride. Each step moves every thread NT items on (NT:
// the CTA's threads).
template <int NT>
struct WalkOf {
  int a, b;
  const int nb, da, db;
  __device__ __forceinline__ explicit WalkOf(int nb_)
      : a(static_cast<int>(threadIdx.x) / nb_), b(static_cast<int>(threadIdx.x) % nb_), nb(nb_),
        da(NT / nb_), db(NT % nb_) {}
  __device__ __forceinline__ void next() {
    a += da;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++a;
    }
  }
};
using Walk = WalkOf<kNT>;

// The halo in columns of a pass of L steps: L rounded up to a 16-byte
// vector's columns, so that a tile's loads are whole vectors
template <typename T>
__host__ __device__ constexpr int column_halo(int L) {
  return (L + vec_columns<T>() - 1) / vec_columns<T>() * vec_columns<T>();
}

// One output tile of a pass of L steps (tile index `tile`, row-major over
// tiles_y tile columns; R x C output sites) and what the pass reads around
// it: the tile holds rows [0, Re + 2L) and columns [0, W), the output at
// rows [L, L + Re) and columns [pad, pad + Ce).
struct TileAt {
  int L, pad;              // halo rows and columns
  int r0, c0, Re, Ce;      // the output: rows [r0, r0 + Re), columns [c0, c0 + Ce)
  int gr0, gc0;            // global row and column of tile row and column 0
  int lr1, lc0, lc1;       // the tile reads rows [0, lr1), columns [lc0, lc1)
  int first0;              // the first tile column >= lc0 whose global column is 0
  bool has0;               // the tile holds a site of global column 0
  __device__ __forceinline__ TileAt(int tile, int tiles_y, int R, int C, int nx, int ny, int L_,
                                    int pad_)
      : L(L_), pad(pad_) {
    const int ti = tile / tiles_y;
    r0 = ti * R;
    c0 = (tile - ti * tiles_y) * C;
    Re = min(R, nx - r0);
    Ce = min(C, ny - c0);
    gr0 = r0 - L;
    gc0 = c0 - pad;
    lr1 = Re + 2 * L;
    lc0 = pad - L;
    lc1 = pad + Ce + L;
    first0 = lc0 + wrap(wrap(-gc0, ny) - lc0, ny);
    has0 = first0 < lc1;
  }
};

}  // namespace
