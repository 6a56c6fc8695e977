// The single-chip D2Q9 stream-collide step for Hopper (sm_90a) with V
// consecutive columns per thread, so that every access to device memory is
// one 16-byte vector: the wide form of lbm_step.cu's lbm_stream_collide.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757), local
// form, one time step per launch, for float32 and bf16 storage and every
// geometry source (none, class plane with slip codes, wall spec; fast math
// as a run-time flag), wherever ny is a multiple of V and the buffers are
// 16-byte aligned. Every other shape keeps the one-site-per-thread kernel
// of lbm_step.cu; the host picks by shape and pointer
// (fused_kernel.kernel_form), never by a failed launch.
//
// Bound: device-memory bytes, as the narrow form (72 B per site update in
// float32, 36 B in bf16, against 124 FLOP). What the narrow form leaves on
// the table is the width of its accesses: one thread, one site, 18 loads
// and stores of 4 or 2 bytes, so a warp's request moves 128 or 64 bytes. A
// copy kernel whose threads move one 16-byte vector each reaches the card's
// copy rate in both storage types; the narrow bf16 step reaches 0.6 of it.
// Here a thread owns columns [j0, j0 + V) of one row, j0 % V == 0, V = 4
// in float32 and 8 in bf16:
// - the three speeds with e_y = 0 take their source columns from one
//   aligned vector of row i, i - 1 or i + 1;
// - the three speeds with e_y = +1 need columns [j0 - 1, j0 + V - 1): the
//   thread's own vector of the source row gives V - 1 of them, and the
//   missing one is the last element of the left neighbour lane's vector
//   (__shfl_up_sync), or one scalar load where the lane has no left
//   neighbour in its warp (lane 0; at j0 == 0 it is the y wrap, column
//   ny - 1);
// - e_y = -1 mirrors it (__shfl_down_sync; lane 31 and the row's last
//   owner load column j0 + V, or 0 at the wrap);
// - the collision runs site by site on unpacked floats through the
//   arithmetic every step kernel shares (collide, lbm_collide.cuh), the
//   results are packed V per plane and leave in 9 aligned vector stores.
// A CTA is kWideX lanes along y by kWideRows rows, whole warps along y, so
// the shuffles never leave a row. Lanes past the row's end stay for the
// shuffles and skip their loads, their collision and their stores.
// Consecutive CTAs take consecutive column tiles of one row group: a step
// reads 9 planes and writes 9, and on an H100 the order in which the CTAs
// in flight sweep those 18 streams weighs more than the width of an access
// (at 800x4000, with the narrow form's order, rows first, the float32 wide
// form takes 88.3 us against the narrow form's 89.9; tiles first, 85.0).
//
// Forcing keeps the narrow form's rule: a forced speed whose source site
// lies in column 0 re-evaluates the forcing guard at that source site.
// Only two threads of a row ever do: the owner of columns [0, V)
// (destination column 1, speeds 1, 5, 8, whose source is its own element
// 0) and the owner of the last V columns (destination ny - 1, speeds 3, 6,
// 7, through the wrap load). With ny == V they are one thread.
//
// Arithmetic: loads unpack exactly (a bf16 value is the upper half of its
// float), the forced column stays float through the pull, and each result
// is rounded once with __float2bfloat16_rn before it is packed, as the
// narrow form does. Built with -fmad=false and IEEE division it equals
// fused_kernel.step_reference (and step_reference_wide, the plain version
// that assembles the pull the same way) bit for bit; fast math within
// fused_kernel.FAST_MATH_RTOL. What this kernel shares with the wide
// ext-halo and rdma forms (lbm_wide_ext_step.cu) is in lbm_wide.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_collide.cuh"
#include "lbm_wide.cuh"

namespace {

template <typename T, int GEOM, int V>
__global__ void __launch_bounds__(kWideX * kWideRows)
lbm_stream_collide_wide(const T* __restrict__ src, T* __restrict__ dst,
                        const uint8_t* __restrict__ solid, Spec g, int64_t nx,
                        int64_t ny, Params k, int fast_math) {
  // e_s = (e_x, e_y); the forcing increment's sign is e_y (speeds with
  // e_y = +1 gain, with e_y = -1 lose), as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int N = V * static_cast<int>(sizeof(T)) / 4;  // words of a thread's vector
  constexpr unsigned kWarp = 0xffffffffu;

  // index arithmetic in 32 bits (the launcher bounds nx and ny), plane
  // offsets in 64: at 4000 x 16000, 9 * nx * ny is about 5.8e8
  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  // consecutive CTAs take consecutive column tiles of one row group, so the
  // CTAs in flight sweep each plane front to back, as a copy does
  const unsigned tiles = (static_cast<unsigned>(nyi / V) + kWideX - 1) / kWideX;
  const unsigned group = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int i = group * kWideRows + threadIdx.y;
  if (i >= nxi) return;  // whole warps: a warp lies in one row
  const int j0 = (tile * kWideX + threadIdx.x) * V;
  // a lane past the row's end leaves only after the last shuffle
  const bool active = j0 < nyi;
  const unsigned lane = threadIdx.x & 31;
  const int64_t plane = nx * ny;
  // source rows i - e_x, indexed by e_x + 1; the operands of % are never
  // negative
  const int rows[3] = {(i + 1) % nxi, i, (i - 1 + nxi) % nxi};
  // the columns beside the thread's own, periodic, and whether a neighbour
  // lane holds them: the warp's first lane has none to its left, its last
  // lane and the row's last owner none to their right
  const int left = j0 == 0 ? nyi - 1 : j0 - 1;
  const int right = j0 + V == nyi ? 0 : j0 + V;
  const bool load_left = active && lane == 0;
  const bool load_right = active && (lane == 31 || j0 + V >= nyi);

  // the sites' classes, asked for before the pull's loads: behind the
  // shuffles the load would wait alone (5.7 of the 52.2 us of a bf16 step
  // at 800x4000 on an H100)
  const int64_t site0 = static_cast<int64_t>(i) * ny + j0;
  uint64_t classes = 0;
  if (GEOM == kPlane && active) classes = load_classes<V>(solid + site0);

  // pull, by vectors: own[s] holds columns [j0, j0 + V) of f_s's source
  // row, side[s] the one column of it that the vector lacks
  uint32_t own[9][N];
  float side[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const T* row = src + s * plane + static_cast<int64_t>(rows[EX[s] + 1]) * ny;
    if (active) {
      load_words<N>(row + j0, own[s]);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) own[s][n] = 0;
    }
    if (EY[s] == 1) {
      const float edge = load_left ? load(row + left) : 0.0f;
      const float lent = __shfl_up_sync(kWarp, element<T, N>(own[s], V - 1), 1);
      side[s] = load_left ? edge : lent;
    } else if (EY[s] == -1) {
      const float edge = load_right ? load(row + right) : 0.0f;
      const float lent = __shfl_down_sync(kWarp, element<T, N>(own[s], 0), 1);
      side[s] = load_right ? edge : lent;
    } else {
      side[s] = 0.0f;
    }
  }
  if (!active) return;

  // forcing: the guards of the three source rows' column-0 sites, in the
  // two threads of a row that pull from column 0
  const bool first = j0 == 0;        // site 1 pulls speeds 1, 5, 8 from column 0
  const bool last = j0 + V == nyi;   // site V - 1 pulls speeds 3, 6, 7 from it
  bool forced[3] = {false, false, false};
  if (first || last) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      forced[r] = forced_at<T, GEOM>(src, solid, g, rows[r], nx, ny, plane, k);
    }
  }

  SpecRow spec{};
  if (GEOM == kSpec) spec = spec_row(g, i, nx);

  uint32_t packed[9][N];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
#pragma unroll
    for (int n = 0; n < N; ++n) packed[s][n] = 0;
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // p_s(i, j0 + v) = f_s(i - e_x, j0 + v - e_y)
    float p[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (EY[s] == 0) {
        p[s] = element<T, N>(own[s], v);
        continue;
      }
      const int u = v - EY[s];
      float x = (u < 0 || u >= V) ? side[s] : element<T, N>(own[s], u);
      // the source site lies in column 0
      const bool column0 = EY[s] == 1 ? (first && v == 1) : (last && v == V - 1);
      if (column0 && forced[EX[s] + 1]) {
        const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
        x = x + (EY[s] > 0 ? a : -a);
      }
      p[s] = x;
    }
    float out[9];
    collide<GEOM>(
        p,
        [&]() -> int {
          if (GEOM == kPlane) return static_cast<int>((classes >> (8 * v)) & 0xff);
          if (GEOM == kSpec) return spec_column(g, spec, j0 + v) ? 1 : 0;
          return 0;
        },
        k, fast_math, out);
#pragma unroll
    for (int s = 0; s < 9; ++s) pack<T, N>(packed[s], v, out[s]);
  }
#pragma unroll
  for (int s = 0; s < 9; ++s) store_words<N>(dst + s * plane + site0, packed[s]);
}

template <typename T>
void launch_wide(const dim3& grid, cudaStream_t st, const void* src, void* dst,
                 const uint8_t* solid, const Spec& g, int64_t nx, int64_t ny,
                 const Params& k, int fast_math, int64_t geometry) {
  constexpr int V = WideColumns<T>::v;
  const dim3 block(kWideX, kWideRows);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (geometry == kPlane) {
    lbm_stream_collide_wide<T, kPlane, V><<<grid, block, 0, st>>>(s, d, solid, g, nx, ny, k, fast_math);
  } else if (geometry == kSpec) {
    lbm_stream_collide_wide<T, kSpec, V><<<grid, block, 0, st>>>(s, d, solid, g, nx, ny, k, fast_math);
  } else {
    lbm_stream_collide_wide<T, kNone, V><<<grid, block, 0, st>>>(s, d, solid, g, nx, ny, k, fast_math);
  }
}

}  // namespace

// Columns per thread of the wide form for a storage code (0 float32, 1
// bf16), else 0: what fused_kernel.WIDE_COLUMNS must restate.
extern "C" int64_t lbm_wide_columns(int64_t storage) {
  if (storage == 0) return WideColumns<float>::v;
  if (storage == 1) return WideColumns<__nv_bfloat16>::v;
  return 0;
}

// One step src -> dst on `stream`, the wide form: the arguments of
// lbm_stream_collide_launch (lbm_step.cu), and the same result. It takes
// only what the form applies to: ny a multiple of lbm_wide_columns(storage),
// and src, dst and (geometry 1) solid aligned to 16 bytes; anything else is
// refused with cudaErrorInvalidValue and nothing is launched. Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_wide_launch(const void* src, void* dst,
                                              const void* solid, const void* spec,
                                              int64_t nx, int64_t ny,
                                              int64_t storage, int64_t geometry,
                                              int64_t fast_math, const void* params,
                                              void* stream) {
  const int64_t v = lbm_wide_columns(storage);
  if (v == 0 || nx < 1 || ny < 1 || ny % v != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (nx + kWideRows - 1) / kWideRows;
  const int64_t tiles = (ny / v + kWideX - 1) / kWideX;
  // one CTA per row group and column tile on a 1-D grid (at most 2^31 - 1
  // CTAs); the kernel's 32-bit index arithmetic needs nx, ny < 2^30
  if (nx >= (1LL << 30) || ny >= (1LL << 30) || groups * tiles > 0x7fffffffLL ||
      geometry < kNone || geometry > kSpec ||
      (geometry == kPlane && solid == nullptr) ||
      (geometry == kSpec && spec == nullptr) || !aligned16(src) || !aligned16(dst) ||
      (geometry == kPlane && !aligned16(solid))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const dim3 grid(static_cast<unsigned>(groups * tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  const int fast = fast_math != 0;
  if (storage == 1) {
    launch_wide<__nv_bfloat16>(grid, st, src, dst, w, g, nx, ny, k, fast, geometry);
  } else {
    launch_wide<float>(grid, st, src, dst, w, g, nx, ny, k, fast, geometry);
  }
  return static_cast<int>(cudaGetLastError());
}
