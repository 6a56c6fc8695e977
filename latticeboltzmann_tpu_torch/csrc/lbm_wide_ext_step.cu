// The row-sharded D2Q9 stream-collide step for Hopper (sm_90a) with V
// consecutive columns per thread, so that every access to a plane of device
// memory is one 16-byte vector: the wide forms of lbm_step.cu's ext-halo and
// rdma kernels (lbm_stream_collide_ext, lbm_stream_collide_rdma), as
// lbm_wide_step.cu is the wide form of its single-chip kernel.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757) in its
// external_halo=True (:1676-1696) and rdma=True (:309-318, rdma_schedule
// :137-179) variants, one time step per launch, for float32 and bf16
// storage and every geometry source (none, class plane with slip codes,
// wall spec; fast math as a run-time flag), wherever ny is a multiple of V
// and every buffer the kernel reads or writes by vectors is 16-byte
// aligned. Every other shape keeps the narrow kernels of lbm_step.cu; the
// host picks by shape and pointer (fused_kernel.kernel_form), never by a
// failed launch.
//
// Bound: device-memory bytes, as the single-chip form (72 B per site update
// in float32, 36 B in bf16, against 124 FLOP), plus the halo rows. The
// narrow forms keep what the single-chip kernel left behind in its wide
// form: one site per thread with 4- or 2-byte accesses, and a rows-first CTA
// order. Here, as in lbm_wide_step.cu (whose header gives the pull by
// vectors, shuffles and edge loads in full):
// - a thread owns columns [j0, j0 + V) of one local row, V = 4 in float32
//   and 8 in bf16; a speed's source row is read as one aligned vector, the
//   missing +-1 column comes from the neighbour lane by a shuffle or, in a
//   warp's edge lanes and at the y wrap, by one scalar load;
// - CTAs of kWideX lanes x kWideRows rows (a launch of one row: kWideX *
//   kWideRows lanes x 1 row, so that no warp idles) on a 1-D grid,
//   consecutive CTAs on consecutive column tiles of one row group (rows
//   first measured 2-3 us slower on an H100; one-row CTAs of 32 or 64
//   lanes no faster than 128).
// What differs from the single-chip form is where a source row lies. Each
// of a site's three source rows i + 1, i, i - 1 carries its column-0
// address, the stride between its speed planes (nx * ny for a local row, ny
// for a (9, ny) halo row), its class row and its global row, wrapped at gnx.
// The vector at row + s * stride + j0 is aligned wherever ny % V == 0 and
// the base pointers are. The rdma form's comm rows are written by another
// kernel while this one runs, so they are never read through the read-only
// path: a warp whose row has a halo row among its sources reads all three
// rows by plain, coherent loads after the edge CTA's acquire and barrier
// (load_words_coherent), every other warp through __ldg, one path per warp
// (pull_wide). The ext-halo form reads every row by plain loads, which
// measured faster there. The forcing guard is evaluated in the two owners
// that pull from column 0 on each source row, halo rows included, with
// their class rows and global rows; the spec variant evaluates the wall
// spec at the global row, periodic in gnx (the channel walls are global
// rows 0 and gnx - 1, and the row above shard 0 is global row gnx - 1).
//
// The rdma form keeps the narrow form's protocol (lbm_step.cu, "The rdma
// form") and its ticket order: the kSendCtas send CTAs first (each with
// several vectors in flight per thread: send_row_wide), then the
// interior rows [1, nx - 1) in row groups, tiles first, then the edge CTAs
// last. An edge CTA holds row 0 in its first row of lanes and row nx - 1 in
// its second, of one column tile, and thread 0 waits for both flags: an
// edge CTA holds no interior row, an interior CTA no edge row, no lane
// idles, and at most `tiles` CTAs of a launch spin (the narrow form: 2 x its
// tiles of 256 columns). Every spin stays bounded by %globaltimer.
//
// Arithmetic: the single-chip wide form's (exact loads and unpacking, the
// forced column float through the pull, one rounding per bf16 result).
// Built with -fmad=false and IEEE division it equals
// fused_kernel.step_reference_ext / step_reference_rdma, their wide plain
// versions (step_reference_ext_wide) and the narrow forms bit for bit; fast
// math within fused_kernel.FAST_MATH_RTOL.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_collide.cuh"
#include "lbm_ext.cuh"
#include "lbm_wide.cuh"

namespace {

// threads of one CTA, whatever its shape
constexpr int kWideThreads = kWideX * kWideRows;
static_assert(kWideRows == 2, "an rdma edge CTA holds row 0 and row nx - 1");

// The pull of a thread's columns [j0, j0 + V) from its three source rows
// (row[r] at column 0, stride[r] between speed planes): own[s] holds the
// vector of f_s's source row, side[s] the one column of it that the vector
// lacks (a neighbour lane's element by a shuffle, or one scalar load in a
// warp's edge lanes and at the y wrap). COHERENT: every load is a plain,
// coherent one (a row of the three may be a comm row that another kernel
// writes while this one runs); else every vector goes through the
// read-only path. One path per call, without a branch between the loads,
// so that all of a thread's loads are in flight before the shuffles wait
// on them.
template <typename T, int V, bool COHERENT, int N>
__device__ __forceinline__ void pull_wide(const T* const (&row)[3], const int64_t (&stride)[3],
                                          int j0, int nyi, bool active, unsigned lane,
                                          uint32_t (&own)[9][N], float (&side)[9]) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr unsigned kWarp = 0xffffffffu;
  // the columns beside the thread's own, periodic, and whether a neighbour
  // lane holds them
  const int left = j0 == 0 ? nyi - 1 : j0 - 1;
  const int right = j0 + V == nyi ? 0 : j0 + V;
  const bool load_left = active && lane == 0;
  const bool load_right = active && (lane == 31 || j0 + V >= nyi);
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const T* p = row[EX[s] + 1] + s * stride[EX[s] + 1];
    if (!active) {
#pragma unroll
      for (int n = 0; n < N; ++n) own[s][n] = 0;
    } else if (COHERENT) {
      load_words_coherent<N>(p + j0, own[s]);
    } else {
      load_words<N>(p + j0, own[s]);
    }
    if (EY[s] == 1) {
      const float edge = load_left ? load(p + left) : 0.0f;
      const float lent = __shfl_up_sync(kWarp, element<T, N>(own[s], V - 1), 1);
      side[s] = load_left ? edge : lent;
    } else if (EY[s] == -1) {
      const float edge = load_right ? load(p + right) : 0.0f;
      const float lent = __shfl_down_sync(kWarp, element<T, N>(own[s], 0), 1);
      side[s] = load_right ? edge : lent;
    } else {
      side[s] = 0.0f;
    }
  }
}

// Columns [j0, j0 + V) of local row i of a shard's (9, nx, ny) block,
// periodic in y; the source rows past the block are the halo rows e.top and
// e.bot. Every lane of a warp calls it (the warp lies in one row): a lane
// past the row's end (j0 >= ny) stays for the shuffles and returns before
// its collision. LDG: a warp whose three source rows are local reads them
// through the read-only path (the rdma form; 4 us faster in float32 at
// 800x4000 over 4 virtual shards on an H100), and a warp next to a halo
// row reads coherently; else every warp reads by plain loads (the ext-halo
// form, where they measured 2-7 us faster than __ldg).
template <typename T, int GEOM, int V, bool LDG>
__device__ __forceinline__ void ext_site_wide(const T* __restrict__ src, T* __restrict__ dst,
                                              const uint8_t* __restrict__ solid, const Spec& g,
                                              const Ext<T>& e, int64_t nx, int64_t ny,
                                              const Params& k, int fast_math, int i, int j0) {
  // e_s = (e_x, e_y); the forcing increment's sign is e_y, as in
  // core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int N = V * static_cast<int>(sizeof(T)) / 4;  // words of a thread's vector

  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  const bool active = j0 < nyi;
  const unsigned lane = threadIdx.x & 31;
  const int64_t plane = nx * ny;

  // source rows i - e_x, indexed by e_x + 1 (rows i + 1, i, i - 1); the
  // global rows wrap at gnx
  const T* row[3];
  int64_t stride[3];
  const uint8_t* cls_row[3];
  int64_t grow[3];
  bool halo[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int li = i + 1 - r;
    halo[r] = li < 0 || li >= nxi;
    if (halo[r]) {
      row[r] = li < 0 ? e.top : e.bot;
      stride[r] = ny;
      cls_row[r] = li < 0 ? e.solid_top : e.solid_bot;
    } else {
      row[r] = src + static_cast<int64_t>(li) * ny;
      stride[r] = plane;
      cls_row[r] = GEOM == kPlane ? solid + static_cast<int64_t>(li) * ny : nullptr;
    }
    const int64_t gi = e.offset + li;
    grow[r] = gi < 0 ? gi + e.gnx : (gi >= e.gnx ? gi - e.gnx : gi);
  }
  // the sites' classes (row i is local), asked for before the pull's loads
  const int64_t site0 = static_cast<int64_t>(i) * ny + j0;
  uint64_t classes = 0;
  if (GEOM == kPlane && active) classes = load_classes<V>(solid + site0);

  // pull, by vectors; the choice of loads is one per warp (a warp lies in
  // one row)
  uint32_t own[9][N];
  float side[9];
  if (LDG && !halo[0] && !halo[2]) {
    pull_wide<T, V, false>(row, stride, j0, nyi, active, lane, own, side);
  } else {
    pull_wide<T, V, true>(row, stride, j0, nyi, active, lane, own, side);
  }
  if (!active) return;

  // forcing: the guards of the three source rows' column-0 sites, in the
  // two threads of a row that pull from column 0
  const bool first = j0 == 0;       // site 1 pulls speeds 1, 5, 8 from column 0
  const bool last = j0 + V == nyi;  // site V - 1 pulls speeds 3, 6, 7 from it
  bool forced[3] = {false, false, false};
  if (first || last) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      forced[r] = forced_row<T, GEOM>(row[r], stride[r], cls_row[r], g, grow[r], e.gnx, k);
    }
  }

  SpecRow spec{};
  if (GEOM == kSpec) spec = spec_row(g, grow[1], e.gnx);

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

// The send role of the rdma form: one row of src (all 9 planes, as bits)
// into a neighbour's (9, ny) comm rows, thread tid of kWideThreads, with
// kSendBatch 16-byte vectors in flight per thread. The neighbour's edge rows
// wait for this copy, and in float32 at ny = 4000 it moves 144 KB: one
// vector at a time, the latency of its loads, not its bytes, would set the
// wait. The wide form's alignment makes every row whole vectors.
constexpr int kSendBatch = 8;

template <typename T>
__device__ __forceinline__ void send_row_wide(const T* __restrict__ row, int64_t plane, T* out,
                                              int64_t ny, int tid) {
  const int per_plane = static_cast<int>(ny * static_cast<int64_t>(sizeof(T)) / 16);
  const int total = 9 * per_plane;
  for (int v0 = tid; v0 < total; v0 += kWideThreads * kSendBatch) {
    uint4 buf[kSendBatch];
#pragma unroll
    for (int b = 0; b < kSendBatch; ++b) {
      const int v = v0 + b * kWideThreads;
      if (v < total) {
        const int s = v / per_plane;
        buf[b] = __ldg(reinterpret_cast<const uint4*>(row + s * plane) + (v - s * per_plane));
      }
    }
#pragma unroll
    for (int b = 0; b < kSendBatch; ++b) {
      const int v = v0 + b * kWideThreads;
      if (v < total) {
        const int s = v / per_plane;
        reinterpret_cast<uint4*>(out + s * ny)[v - s * per_plane] = buf[b];
      }
    }
  }
}

// The ext-halo form: local rows [e.row0, e.row0 + rows) of a shard's (9,
// nx, ny) block, ROWS rows of kWideThreads / ROWS lanes per CTA, tiles
// first.
template <typename T, int GEOM, int V, int ROWS>
__global__ void __launch_bounds__(kWideThreads)
lbm_stream_collide_ext_wide(const T* __restrict__ src, T* __restrict__ dst,
                            const uint8_t* __restrict__ solid, Spec g, Ext<T> e, int64_t rows,
                            int64_t nx, int64_t ny, Params k, int fast_math) {
  constexpr int kLanes = kWideThreads / ROWS;
  static_assert(kLanes % 32 == 0, "whole warps along y");
  // index arithmetic in 32 bits (the launcher bounds nx and ny)
  const unsigned tiles = (static_cast<unsigned>(ny / V) + kLanes - 1) / kLanes;
  const unsigned group = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int r = static_cast<int>(group) * ROWS + static_cast<int>(threadIdx.y);
  if (r >= static_cast<int>(rows)) return;  // whole warps: a warp lies in one row
  const int j0 = (static_cast<int>(tile) * kLanes + static_cast<int>(threadIdx.x)) * V;
  ext_site_wide<T, GEOM, V, false>(src, dst, solid, g, e, nx, ny, k, fast_math,
                                   static_cast<int>(e.row0) + r, j0);
}

// The rdma form: every row of a shard's (9, nx, ny) block, nx >= 3, on a
// 1-D grid of kSendCtas + (interior row groups + 1) x tiles CTAs of
// kWideX x kWideRows threads, whose roles follow their arrival.
template <typename T, int GEOM, int V>
__global__ void __launch_bounds__(kWideThreads)
lbm_stream_collide_rdma_wide(const T* __restrict__ src, T* __restrict__ dst,
                             const uint8_t* __restrict__ solid, Spec g, Ext<T> e, Rdma<T> r,
                             int64_t nx, int64_t ny, Params k, int fast_math) {
  __shared__ unsigned ticket;
  __shared__ int rows_arrived;
  const int tid = static_cast<int>(threadIdx.y) * kWideX + static_cast<int>(threadIdx.x);
  // role arithmetic in 32 bits: the launcher bounds the grid by 2^31 - 1
  const unsigned rows = static_cast<unsigned>(nx);
  const unsigned tiles = (static_cast<unsigned>(ny / V) + kWideX - 1) / kWideX;
  // the launch's tickets start at (step - 1) * gridDim.x (lbm_step.cu)
  if (tid == 0) {
    ticket = static_cast<unsigned>(atomicAdd(r.work, 1ULL) - (r.step - 1) * gridDim.x);
  }
  __syncthreads();
  const unsigned u = ticket;

  if (u < kSendCtas) {
    const int64_t plane = nx * ny;
    if (u == 0) {
      send_row_wide<T>(src, plane, r.up_bot, ny, tid);
    } else {
      send_row_wide<T>(src + (nx - 1) * ny, plane, r.down_top, ny, tid);
    }
    // every thread's rows are visible system-wide before the flag is
    __threadfence_system();
    __syncthreads();
    if (tid == 0) store_release_sys(u == 0 ? r.up_flag : r.down_flag, r.step);
    return;
  }

  const unsigned v = u - kSendCtas;
  const unsigned interior = (rows - 2 + kWideRows - 1) / kWideRows * tiles;
  int i;
  unsigned tile;
  if (v < interior) {
    // consecutive tickets take consecutive column tiles of one row group
    tile = v % tiles;
    i = 1 + static_cast<int>(v / tiles) * kWideRows + static_cast<int>(threadIdx.y);
    if (i >= static_cast<int>(rows) - 1) return;  // whole warps
  } else {
    tile = v - interior;
    if (tid == 0) {
      rows_arrived = wait_for_rows(r.flags, r.work + 1, r.step, r.timeout_ns) &&
                     wait_for_rows(r.flags + 1, r.work + 1, r.step, r.timeout_ns);
    }
    __syncthreads();  // orders every thread's halo loads after thread 0's acquires
    if (!rows_arrived) return;
    i = threadIdx.y == 0 ? 0 : static_cast<int>(rows) - 1;
  }
  const int j0 = (static_cast<int>(tile) * kWideX + static_cast<int>(threadIdx.x)) * V;
  ext_site_wide<T, GEOM, V, true>(src, dst, solid, g, e, nx, ny, k, fast_math, i, j0);
}

template <typename T, int ROWS>
void launch_ext_wide(unsigned grid, cudaStream_t st, const void* src, void* dst,
                     const uint8_t* solid, const Spec& g, const Ext<T>& e, int64_t rows,
                     int64_t nx, int64_t ny, const Params& k, int fast_math, int64_t geometry) {
  constexpr int V = WideColumns<T>::v;
  const dim3 block(kWideThreads / ROWS, ROWS);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (geometry == kPlane) {
    lbm_stream_collide_ext_wide<T, kPlane, V, ROWS><<<grid, block, 0, st>>>(s, d, solid, g, e, rows, nx, ny, k, fast_math);
  } else if (geometry == kSpec) {
    lbm_stream_collide_ext_wide<T, kSpec, V, ROWS><<<grid, block, 0, st>>>(s, d, solid, g, e, rows, nx, ny, k, fast_math);
  } else {
    lbm_stream_collide_ext_wide<T, kNone, V, ROWS><<<grid, block, 0, st>>>(s, d, solid, g, e, rows, nx, ny, k, fast_math);
  }
}

// A launch of rows [row0, row0 + rows): rows of kWideThreads lanes for a
// launch of one row, else row groups of kWideRows.
template <typename T>
void launch_ext_typed(cudaStream_t st, const void* src, void* dst, const void* top,
                      const void* bot, const uint8_t* solid, const uint8_t* solid_top,
                      const uint8_t* solid_bot, const Spec& g, int64_t nx, int64_t ny,
                      int64_t row0, int64_t rows, int64_t offset, int64_t gnx, const Params& k,
                      int fast_math, int64_t geometry) {
  constexpr int V = WideColumns<T>::v;
  const Ext<T> e{static_cast<const T*>(top), static_cast<const T*>(bot), solid_top, solid_bot,
                 row0, offset, gnx};
  if (rows == 1) {
    const unsigned tiles = static_cast<unsigned>((ny / V + kWideThreads - 1) / kWideThreads);
    launch_ext_wide<T, 1>(tiles, st, src, dst, solid, g, e, rows, nx, ny, k, fast_math, geometry);
  } else {
    const int64_t tiles = (ny / V + kWideX - 1) / kWideX;
    const unsigned grid = static_cast<unsigned>((rows + kWideRows - 1) / kWideRows * tiles);
    launch_ext_wide<T, kWideRows>(grid, st, src, dst, solid, g, e, rows, nx, ny, k, fast_math,
                                  geometry);
  }
}

template <typename T>
void launch_rdma_wide(unsigned grid, cudaStream_t st, const void* src, void* dst,
                      const uint8_t* solid, const Spec& g, const Ext<T>& e, const Rdma<T>& r,
                      int64_t nx, int64_t ny, const Params& k, int fast_math, int64_t geometry) {
  constexpr int V = WideColumns<T>::v;
  const dim3 block(kWideX, kWideRows);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (geometry == kPlane) {
    lbm_stream_collide_rdma_wide<T, kPlane, V><<<grid, block, 0, st>>>(s, d, solid, g, e, r, nx, ny, k, fast_math);
  } else if (geometry == kSpec) {
    lbm_stream_collide_rdma_wide<T, kSpec, V><<<grid, block, 0, st>>>(s, d, solid, g, e, r, nx, ny, k, fast_math);
  } else {
    lbm_stream_collide_rdma_wide<T, kNone, V><<<grid, block, 0, st>>>(s, d, solid, g, e, r, nx, ny, k, fast_math);
  }
}

// The checks both entry points share: what the wide form applies to and
// what the kernels' index arithmetic needs; true when the launch is
// refused. CTAs of the largest grid: (nx / kWideRows + 1) x tiles + 2.
bool wide_refused(const void* src, const void* dst, const void* solid, const void* spec,
                  int64_t nx, int64_t ny, int64_t offset, int64_t gnx, int64_t storage,
                  int64_t geometry) {
  const int64_t v = storage == 0 ? WideColumns<float>::v
                                 : (storage == 1 ? WideColumns<__nv_bfloat16>::v : 0);
  if (v == 0 || nx < 1 || ny < 1 || ny % v != 0) return true;
  const int64_t tiles = (ny / v + kWideX - 1) / kWideX;
  return nx >= (1LL << 30) || ny >= (1LL << 30) ||
         (nx / kWideRows + 1) * tiles + kSendCtas > 0x7fffffffLL || offset < 0 ||
         gnx >= (1LL << 62) || offset + nx > gnx || geometry < kNone || geometry > kSpec ||
         (geometry == kPlane && solid == nullptr) || (geometry == kSpec && spec == nullptr) ||
         !aligned16(src) || !aligned16(dst) || (geometry == kPlane && !aligned16(solid));
}

}  // namespace

// The ext-halo form's wide kernel: the arguments of
// lbm_stream_collide_ext_launch (lbm_step.cu), and the same result. It takes
// only what the form applies to: ny a multiple of lbm_wide_columns(storage),
// and src, dst, the halo rows it reads (top, bot) and (geometry 1) solid
// aligned to 16 bytes; anything else is refused with cudaErrorInvalidValue
// and nothing is launched. Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_ext_wide_launch(
    const void* src, void* dst, const void* top, const void* bot, const void* solid,
    const void* solid_top, const void* solid_bot, const void* spec, int64_t nx, int64_t ny,
    int64_t row0, int64_t rows, int64_t offset, int64_t gnx, int64_t storage,
    int64_t geometry, int64_t fast_math, const void* params, void* stream) {
  const bool plane = geometry == kPlane;
  const bool reads_top = row0 == 0, reads_bot = row0 + rows == nx;
  if (wide_refused(src, dst, solid, spec, nx, ny, offset, gnx, storage, geometry) || row0 < 0 ||
      rows < 1 || row0 + rows > nx ||
      (reads_top && (top == nullptr || !aligned16(top) || (plane && solid_top == nullptr))) ||
      (reads_bot && (bot == nullptr || !aligned16(bot) || (plane && solid_bot == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  const uint8_t* wt = static_cast<const uint8_t*>(solid_top);
  const uint8_t* wb = static_cast<const uint8_t*>(solid_bot);
  const int fast = fast_math != 0;
  if (storage == 1) {
    launch_ext_typed<__nv_bfloat16>(st, src, dst, top, bot, w, wt, wb, g, nx, ny, row0, rows,
                                    offset, gnx, k, fast, geometry);
  } else {
    launch_ext_typed<float>(st, src, dst, top, bot, w, wt, wb, g, nx, ny, row0, rows, offset,
                            gnx, k, fast, geometry);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rdma form's wide kernel: the arguments of
// lbm_stream_collide_rdma_launch (lbm_step.cu), and the same result,
// comm rows and flags included. It takes only what the form applies to: ny
// a multiple of lbm_wide_columns(storage), and src, dst, the comm buffers
// top, bot, up_bot, down_top and (geometry 1) solid aligned to 16 bytes (a
// parity's (9, ny) rows then are too); anything else is refused with
// cudaErrorInvalidValue and nothing is launched. Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_rdma_wide_launch(
    const void* src, void* dst, void* top, void* bot, void* up_bot, void* down_top,
    void* flags, void* up_flag, void* down_flag, void* work, const void* solid,
    const void* solid_top, const void* solid_bot, const void* spec, int64_t nx, int64_t ny,
    int64_t offset, int64_t gnx, int64_t storage, int64_t geometry, int64_t fast_math,
    const void* params, int64_t step, int64_t timeout_ns, void* stream) {
  const bool plane = geometry == kPlane;
  if (wide_refused(src, dst, solid, spec, nx, ny, offset, gnx, storage, geometry) || nx < 3 ||
      step < 1 || timeout_ns < 0 || top == nullptr || bot == nullptr || up_bot == nullptr ||
      down_top == nullptr || flags == nullptr || up_flag == nullptr || down_flag == nullptr ||
      work == nullptr || !aligned16(top) || !aligned16(bot) || !aligned16(up_bot) ||
      !aligned16(down_top) || (plane && (solid_top == nullptr || solid_bot == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const int64_t v = storage == 1 ? WideColumns<__nv_bfloat16>::v : WideColumns<float>::v;
  const int64_t tiles = (ny / v + kWideX - 1) / kWideX;
  const unsigned grid =
      static_cast<unsigned>(kSendCtas + ((nx - 2 + kWideRows - 1) / kWideRows + 1) * tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  const uint8_t* wt = static_cast<const uint8_t*>(solid_top);
  const uint8_t* wb = static_cast<const uint8_t*>(solid_bot);
  const int fast = fast_math != 0;
  if (storage == 1) {
    using B = __nv_bfloat16;
    Ext<B> e;
    Rdma<B> r;
    rdma_args<B>(top, bot, up_bot, down_top, flags, up_flag, down_flag, work, wt, wb, ny, offset,
                 gnx, step, timeout_ns, &e, &r);
    launch_rdma_wide<B>(grid, st, src, dst, w, g, e, r, nx, ny, k, fast, geometry);
  } else {
    Ext<float> e;
    Rdma<float> r;
    rdma_args<float>(top, bot, up_bot, down_top, flags, up_flag, down_flag, work, wt, wb, ny,
                     offset, gnx, step, timeout_ns, &e, &r);
    launch_rdma_wide<float>(grid, st, src, dst, w, g, e, r, nx, ny, k, fast, geometry);
  }
  return static_cast<int>(cudaGetLastError());
}
