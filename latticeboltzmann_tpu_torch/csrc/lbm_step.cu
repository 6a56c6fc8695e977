// One fused D2Q9 lattice-Boltzmann step for Hopper (sm_90a): channel
// forcing, periodic pull stream, BGK collision and the solid classes
// (bounce-back, free-slip reflections).
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757), one
// time step per launch (T=1), in three forms:
// - the single-chip form (lbm_stream_collide_launch): the whole lattice,
//   periodic in both axes. This file holds its narrow form, one site per
//   thread, which takes every shape; where NY is a multiple of the wide
//   form's columns per thread and the buffers are 16-byte aligned, the host
//   launches the wide form of lbm_wide_step.cu instead (same result);
// - the ext-halo form (lbm_stream_collide_ext_launch), the pallas_call's
//   external_halo=True variant (:1676-1696) as the row-sharded path
//   launches it per shard (parallel/sharded.py:312-376 there): a local
//   block of L rows, of which one launch writes the row range [row0,
//   row0 + rows), so the interior and the two edge rows launch apart; the
//   rows above and below the block come from two halo rows instead of the
//   x wrap;
// - the rdma form (lbm_stream_collide_rdma_launch), the pallas_call's
//   rdma=True variant (:309-318, :577-653): the ext-halo step of a whole
//   shard with the halo exchange inside the kernel, one launch per shard
//   and step and no copy started by the host (see "The rdma form" below).
// The ext-halo and rdma forms here are narrow too, and serve every shape
// that their wide forms (lbm_wide_ext_step.cu, same results) do not take;
// what the two share (Ext, Rdma, the flag words and the bounded wait, the
// guard of a row that may be a halo row) is in lbm_ext.cuh.
// Two template axes select the variant at compile time:
// - the storage type T: float, or __nv_bfloat16 with float arithmetic
//   (the TPU kernel's bf16 storage, :277-280, :420-422, window cast to f32
//   at :1194-1203);
// - the geometry source GEOM: none (wall_mode=False), a uint8 class plane
//   (0 fluid, 1 bounce-back, 2 slip_x, 3 slip_y; :1062-1090 and
//   class_plane :1879), or a closed-form wall spec evaluated from the site
//   indices (:1220-1269), which reads no plane at all.
// fast_math (an approximate 1/rho, :1028-1036) is a uniform run-time flag.
// The forms are kernels of their own (lbm_stream_collide,
// lbm_stream_collide_ext, lbm_stream_collide_rdma) that share what follows
// the pull (collide_store, in lbm_collide.cuh, which the flat multi-step
// kernel of lbm_flat_step.cu shares too); the ext-halo and rdma forms also
// share one site's pull from rows that may be halo rows (ext_site). The
// single-chip kernel keeps its own row indexing: routing it through the
// ext-halo body, with per-row pointers, strides and global rows, cost the
// single-chip bf16 step 20% on an H100 (82 against 68 us at 800x4000).
//
// Bound: device-memory bytes. A site update reads 9 f values and writes 9:
// 72 B in float32, 36 B in bf16, plus 1 B of class plane in the plane
// variant and none in the spec variant, against the reference's 124 FLOP
// (1.7-3.4 FLOP/B), far below the card's f32 balance point. The design
// serves that bound: one thread per site, threads along y (the contiguous
// axis), so each plane's loads and stores of a warp coalesce; the pulls
// from rows i-1 and i+1 re-read lines that the neighbouring row blocks
// read too, and L1/L2 serve those repeats, so device memory sees each byte
// about once per step. The step is out of place (src != dst): the pull
// never reads the buffer it writes.
//
// Not carried over from the TPU kernel: the mirror-pad lanes (the y wrap
// is an index wrap here), the rotating VMEM slots, temporal blocking and
// the launch partitioner.
//
// Forcing: the TPU kernel forces column 0 of its staged window before the
// pull. A one-thread-per-site kernel cannot, so each forced speed whose
// source site lies in column 0 re-evaluates the forcing guard at that
// source site (the guard skips every solid class). Every forced speed
// (1, 3, 5, 6, 7, 8) has e_y != 0, so only destination columns 1 and NY-1
// ever take this branch.
//
// Forcing in the halo rows (ext-halo form): an edge row pulls speeds 2, 5,
// 6 (or 4, 7, 8) from a halo row, and the guard of that row's column-0
// site reads f6, f3 and f7 there and its solid class. Each halo row
// therefore carries all 9 speed planes of the neighbour's boundary row, as
// the JAX fused sharded path ships them (sharded.py:438-439 there), and
// the guard is evaluated here from them: 2 x 9 x NY x sizeof(T) bytes of
// halo per shard per step (288 KB in float32 at NY = 4000, 0.5% of a
// 200-row shard's 57.6 MB step), against 3 planes plus a guard bit that
// the sender would have to compute in a launch of its own. The class of a
// halo row is the neighbour's class row (plane variant, exchanged once per
// run: it is static) or the spec evaluated at the halo's global row.
//
// Global rows (ext-halo form): the spec variant evaluates the wall spec at
// the site's global row, offset + i, periodic in the global row count
// gnx, in 64-bit integers: the channel walls are rows 0 and gnx - 1 of the
// whole lattice, and the row above shard 0 is global row gnx - 1.
//
// The rdma form. The TPU kernel sends its edge rows to the ring neighbours
// by remote DMA at its first grid step, computes the interior blocks, waits
// on the DMA semaphores and computes the two edge blocks last
// (rdma_schedule, :137-179). What carries over is that protocol; its 8-row
// slabs, VMEM send buffers, re-mirroring and block rotation are TPU staging.
// Here every shard owns two (2, 9, ny) comm buffers (the row above its row
// 0 and the row below its last row, one per step parity), two flag words
// and a ticket counter, and its neighbours hold raw pointers to them (peer
// access between cards). The CTAs of a launch take their roles by arrival
// (an atomicAdd ticket), so the order below is a fact and not a habit of
// the block scheduler:
// - the first kSendCtas CTAs copy this shard's row 0 into the upper
//   neighbour's bot[p] and its last row into the lower neighbour's top[p]
//   (p = step mod 2; all 9 planes, raw: the receiver evaluates the forcing
//   guard on the halo itself, as the ext-halo form does), fence at system
//   scope and release-store the step number into that neighbour's flag;
// - the next (nx - 2) x tiles CTAs compute the interior rows, which read
//   no halo;
// - the last 2 x tiles CTAs acquire-spin on this shard's OWN flag words
//   (local memory) until they hold at least the step number, then compute
//   rows 0 and nx - 1 from top[p] and bot[p] with plain loads.
// A spinning CTA therefore never holds a send CTA of its own launch off
// the card, and at most 2 x tiles CTAs per launch spin while another
// shard's launch (on a stream of its own) arrives. Reuse of the comm
// buffers needs no further barrier: flags hold monotonic step numbers, and
// a neighbour can be at most one step ahead. Its step t + 1 edges wait for
// this shard's step t + 1 send, which is stream-ordered after this shard's
// whole step t, so when a neighbour overwrites parity p at step t + 2 this
// shard has finished reading it at step t; and the flag this shard waits
// on at step t can already hold t + 1, never t + 2. Every spin is bounded
// by %globaltimer: on expiry the CTA writes the step into the shard's error
// word and returns, later launches skip their waits, and the session raises
// when it next blocks. Bound: as the ext-halo form, plus 4 x 9 x ny values
// of halo traffic per shard and step.
//
// Arithmetic keeps the TPU kernel's association order (moments from the
// d56/d78/d58/d67 partial sums, the base/q +- eu pairs,
// ops/fused_kernel.py:1020-1105) with host-rounded constants; built with
// -fmad=false and IEEE division it rounds exactly like the plain PyTorch
// versions (ops/fused_kernel.py::step_reference and step_reference_ext in
// the port). bf16 loads are exact (__bfloat162float); the forced column
// stays float through the pull, and each result is rounded once, to
// nearest even (__float2bfloat16_rn, as PyTorch's .to(torch.bfloat16)).
//
// bf16 rounding schedule: this kernel rounds to bf16 after every step, as
// the JAX kernel in interpret mode (T=1) and the JAX XLA engine do. The
// JAX planner runs bf16 at T=2 on the TPU, rounding every second step, so
// a TPU bf16 state is not a reference for this kernel.
//
// fast_math uses rcp.approx.f32, which has no bitwise counterpart in
// PyTorch: that variant is held to IEEE 1/rho within
// fused_kernel.FAST_MATH_RTOL, every other variant bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_collide.cuh"
#include "lbm_ext.cuh"

namespace {

constexpr int kBlock = 256;

// The single-chip form: every row of the lattice, periodic in both axes.
template <typename T, int GEOM>
__global__ void __launch_bounds__(kBlock)
lbm_stream_collide(const T* __restrict__ src, T* __restrict__ dst,
                   const uint8_t* __restrict__ solid, Spec g, int64_t nx,
                   int64_t ny, Params k, int fast_math) {
  // e_s = (e_x, e_y) and the forcing increment sign (+1 speeds gain, -1
  // speeds lose), as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};

  // index arithmetic in 32 bits (the launcher bounds nx and ny), plane
  // offsets in 64: at 4000 x 16000, 9 * nx * ny is about 5.8e8
  const int i = blockIdx.x;
  const int j = blockIdx.y * kBlock + threadIdx.x;
  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  if (j >= nyi) return;
  const int64_t plane = nx * ny;
  // source rows i - e_x and columns j - e_y, indexed by e + 1; the
  // operands of % are never negative
  const int rows[3] = {(i + 1) % nxi, i, (i - 1 + nxi) % nxi};
  const int cols[3] = {(j + 1) % nyi, j, (j - 1 + nyi) % nyi};

  // pull: p_s(i, j) = f_s(i - e_x, j - e_y), periodic in both axes
  float p[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int64_t si = rows[EX[s] + 1];
    const int64_t sj = cols[EY[s] + 1];
    float v = load(src + s * plane + si * ny + sj);
    if (FORCE[s] != 0 && sj == 0 &&
        forced_at<T, GEOM>(src, solid, g, si, nx, ny, plane, k)) {
      const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
      v = v + (FORCE[s] > 0 ? a : -a);
    }
    p[s] = v;
  }
  collide_store<T, GEOM>(
      p, [&] { return solid_class<GEOM>(solid, g, i, j, nx, ny); }, dst, plane,
      static_cast<int64_t>(i) * ny + j, k, fast_math);
}

// One site (i, j) of a shard's (9, nx, ny) block, periodic in y, for the
// ext-halo and rdma forms: the source rows past the block are the halo
// rows e.top and e.bot. Each source row is read through its column-0
// address, the stride between its speed planes, its class row and its
// global row. The halo pointers are neither const __restrict__ nor read
// through the non-coherent path: in the rdma form another kernel wrote them
// while this one ran.
template <typename T, int GEOM>
__device__ __forceinline__ void ext_site(const T* __restrict__ src, T* __restrict__ dst,
                                         const uint8_t* __restrict__ solid, const Spec& g,
                                         const Ext<T>& e, int64_t nx, int64_t ny,
                                         const Params& k, int fast_math, int i, int j) {
  // e_s = (e_x, e_y) and the forcing increment sign (+1 speeds gain, -1
  // speeds lose), as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};

  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  const int64_t plane = nx * ny;
  const int cols[3] = {(j + 1) % nyi, j, (j - 1 + nyi) % nyi};

  // source rows i - e_x, indexed by e_x + 1 (rows i + 1, i, i - 1); the
  // global rows wrap at gnx (the row above shard 0 is row gnx - 1)
  const T* row[3];
  int64_t stride[3];
  const uint8_t* cls_row[3];
  int64_t grow[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int li = i + 1 - r;
    if (li < 0 || li >= nxi) {
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

  // pull: p_s(i, j) = f_s(i - e_x, j - e_y)
  float p[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int r = EX[s] + 1;
    const int64_t sj = cols[EY[s] + 1];
    float v = load(row[r] + s * stride[r] + sj);
    if (FORCE[s] != 0 && sj == 0 &&
        forced_row<T, GEOM>(row[r], stride[r], cls_row[r], g, grow[r], e.gnx, k)) {
      const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
      v = v + (FORCE[s] > 0 ? a : -a);
    }
    p[s] = v;
  }
  collide_store<T, GEOM>(
      p, [&] { return row_class<GEOM>(cls_row[1], g, grow[1], j, e.gnx); }, dst, plane,
      static_cast<int64_t>(i) * ny + j, k, fast_math);
}

// The ext-halo form: local rows [e.row0, e.row0 + gridDim.x) of a shard's
// (9, nx, ny) block.
template <typename T, int GEOM>
__global__ void __launch_bounds__(kBlock)
lbm_stream_collide_ext(const T* __restrict__ src, T* __restrict__ dst,
                       const uint8_t* __restrict__ solid, Spec g, Ext<T> e,
                       int64_t nx, int64_t ny, Params k, int fast_math) {
  const int i = static_cast<int>(e.row0) + static_cast<int>(blockIdx.x);
  const int j = blockIdx.y * kBlock + threadIdx.x;
  if (j >= static_cast<int>(ny)) return;
  ext_site<T, GEOM>(src, dst, solid, g, e, nx, ny, k, fast_math, i, j);
}

// Copy one row of src (all 9 planes, as bits) into a neighbour's (9, ny)
// comm rows: 16-byte vectors where the addresses and the row length allow.
template <typename T>
__device__ __forceinline__ void send_row(const T* __restrict__ row, int64_t plane, T* out,
                                         int64_t ny) {
  const int64_t bytes = ny * static_cast<int64_t>(sizeof(T));
  const bool vec = bytes % 16 == 0 && (plane * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(row) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int s = 0; s < 9; ++s) {
    const T* a = row + s * plane;
    T* b = out + s * ny;
    if (vec) {
      const uint4* a4 = reinterpret_cast<const uint4*>(a);
      uint4* b4 = reinterpret_cast<uint4*>(b);
      for (int64_t v = threadIdx.x; v < bytes / 16; v += kBlock) b4[v] = a4[v];
    } else {
      for (int64_t j = threadIdx.x; j < ny; j += kBlock) b[j] = a[j];
    }
  }
}

// The rdma form: every row of a shard's (9, nx, ny) block, nx >= 3, on a
// 1-D grid of kSendCtas + nx * tiles CTAs whose roles follow their arrival.
template <typename T, int GEOM>
__global__ void __launch_bounds__(kBlock)
lbm_stream_collide_rdma(const T* __restrict__ src, T* __restrict__ dst,
                        const uint8_t* __restrict__ solid, Spec g, Ext<T> e, Rdma<T> r,
                        int64_t nx, int64_t ny, Params k, int fast_math) {
  __shared__ unsigned ticket;
  __shared__ int rows_arrived;
  // role arithmetic in 32 bits: the launcher bounds the grid by 2^31 - 1
  const unsigned rows = static_cast<unsigned>(nx);
  const unsigned tiles = (static_cast<unsigned>(ny) + kBlock - 1) / kBlock;
  // every CTA of every launch takes one ticket, the launches of a shard
  // are stream-ordered and the counter was zeroed before step 1, so this
  // launch's tickets start at (step - 1) * gridDim.x
  if (threadIdx.x == 0) {
    ticket = static_cast<unsigned>(atomicAdd(r.work, 1ULL) - (r.step - 1) * gridDim.x);
  }
  __syncthreads();
  const unsigned u = ticket;

  if (u < kSendCtas) {
    const int64_t plane = nx * ny;
    if (u == 0) {
      send_row<T>(src, plane, r.up_bot, ny);
    } else {
      send_row<T>(src + (nx - 1) * ny, plane, r.down_top, ny);
    }
    // every thread's rows are visible system-wide before the flag is
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) store_release_sys(u == 0 ? r.up_flag : r.down_flag, r.step);
    return;
  }

  const unsigned v = u - kSendCtas;
  const unsigned interior = (rows - 2) * tiles;
  int i, tile;
  if (v < interior) {
    // consecutive tickets take consecutive rows of one column tile, as the
    // (rows, tiles) grids of the other forms do
    i = 1 + static_cast<int>(v % (rows - 2));
    tile = static_cast<int>(v / (rows - 2));
  } else {
    const unsigned w = v - interior;
    i = w < tiles ? 0 : static_cast<int>(rows) - 1;
    tile = static_cast<int>(w % tiles);
    if (threadIdx.x == 0) {
      rows_arrived = wait_for_rows(r.flags + (i == 0 ? 0 : 1), r.work + 1, r.step, r.timeout_ns);
    }
    __syncthreads();  // orders every thread's halo loads after thread 0's acquire
    if (!rows_arrived) return;
  }
  const int j = tile * kBlock + threadIdx.x;
  if (j >= static_cast<int>(ny)) return;
  ext_site<T, GEOM>(src, dst, solid, g, e, nx, ny, k, fast_math, i, j);
}

template <typename T>
void launch(const dim3& grid, cudaStream_t st, const void* src, void* dst,
            const uint8_t* solid, const Spec& g, int64_t nx, int64_t ny,
            const Params& k, int fast_math, int64_t geometry) {
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (geometry == kPlane) {
    lbm_stream_collide<T, kPlane><<<grid, kBlock, 0, st>>>(s, d, solid, g, nx, ny, k, fast_math);
  } else if (geometry == kSpec) {
    lbm_stream_collide<T, kSpec><<<grid, kBlock, 0, st>>>(s, d, solid, g, nx, ny, k, fast_math);
  } else {
    lbm_stream_collide<T, kNone><<<grid, kBlock, 0, st>>>(s, d, solid, g, nx, ny, k, fast_math);
  }
}

template <typename T>
void launch_ext(const dim3& grid, cudaStream_t st, const void* src, void* dst,
                const uint8_t* solid, const Spec& g, const Ext<T>& e, int64_t nx,
                int64_t ny, const Params& k, int fast_math, int64_t geometry) {
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (geometry == kPlane) {
    lbm_stream_collide_ext<T, kPlane><<<grid, kBlock, 0, st>>>(s, d, solid, g, e, nx, ny, k, fast_math);
  } else if (geometry == kSpec) {
    lbm_stream_collide_ext<T, kSpec><<<grid, kBlock, 0, st>>>(s, d, solid, g, e, nx, ny, k, fast_math);
  } else {
    lbm_stream_collide_ext<T, kNone><<<grid, kBlock, 0, st>>>(s, d, solid, g, e, nx, ny, k, fast_math);
  }
}

template <typename T>
void launch_rdma(unsigned grid, cudaStream_t st, const void* src, void* dst,
                 const uint8_t* solid, const Spec& g, const Ext<T>& e, const Rdma<T>& r,
                 int64_t nx, int64_t ny, const Params& k, int fast_math, int64_t geometry) {
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (geometry == kPlane) {
    lbm_stream_collide_rdma<T, kPlane><<<grid, kBlock, 0, st>>>(s, d, solid, g, e, r, nx, ny, k, fast_math);
  } else if (geometry == kSpec) {
    lbm_stream_collide_rdma<T, kSpec><<<grid, kBlock, 0, st>>>(s, d, solid, g, e, r, nx, ny, k, fast_math);
  } else {
    lbm_stream_collide_rdma<T, kNone><<<grid, kBlock, 0, st>>>(s, d, solid, g, e, r, nx, ny, k, fast_math);
  }
}

// One rdma launch from the entry point's untyped pointers.
template <typename T>
void launch_rdma_typed(unsigned grid, cudaStream_t st, const void* src, void* dst, void* top,
                       void* bot, void* up_bot, void* down_top, void* flags, void* up_flag,
                       void* down_flag, void* work, const uint8_t* solid,
                       const uint8_t* solid_top, const uint8_t* solid_bot, const Spec& g,
                       int64_t nx, int64_t ny, int64_t offset, int64_t gnx, const Params& k,
                       int fast_math, int64_t geometry, int64_t step, int64_t timeout_ns) {
  Ext<T> e;
  Rdma<T> r;
  rdma_args<T>(top, bot, up_bot, down_top, flags, up_flag, down_flag, work, solid_top, solid_bot,
               ny, offset, gnx, step, timeout_ns, &e, &r);
  launch_rdma<T>(grid, st, src, dst, solid, g, e, r, nx, ny, k, fast_math, geometry);
}

// The checks both entry points share; true when the launch is refused.
bool refused(const void* solid, const void* spec, int64_t nx, int64_t ny, int64_t storage,
             int64_t geometry) {
  // grid.x = rows (at most 2^31 - 1), grid.y = column tiles (at most
  // 65535); the kernel's 32-bit index arithmetic needs nx, ny < 2^30
  return nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
         (ny + kBlock - 1) / kBlock > 65535LL || storage < 0 || storage > 1 ||
         geometry < kNone || geometry > kSpec ||
         (geometry == kPlane && solid == nullptr) ||
         (geometry == kSpec && spec == nullptr);
}

}  // namespace

// One step src -> dst on `stream`. src, dst: (9, nx, ny), device,
// contiguous, distinct, float32 (storage 0) or bf16 (storage 1).
// geometry 0: none; 1: solid is an (nx, ny) uint8 class plane (codes
// 0-3); 2: spec points to 10 host int64 in Spec order. fast_math != 0
// takes the approximate 1/rho. params: 9 host floats in Params order.
// Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_launch(const void* src, void* dst,
                                         const void* solid, const void* spec,
                                         int64_t nx, int64_t ny,
                                         int64_t storage, int64_t geometry,
                                         int64_t fast_math, const void* params,
                                         void* stream) {
  if (refused(solid, spec, nx, ny, storage, geometry)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const dim3 grid(static_cast<unsigned>(nx),
                  static_cast<unsigned>((ny + kBlock - 1) / kBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  const int fast = fast_math != 0;
  if (storage == 1) {
    launch<__nv_bfloat16>(grid, st, src, dst, w, g, nx, ny, k, fast, geometry);
  } else {
    launch<float>(grid, st, src, dst, w, g, nx, ny, k, fast, geometry);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ext-halo form: one step of the local rows [row0, row0 + rows) of a
// shard's (9, nx, ny) block src -> dst on `stream`, as the single-chip
// form but for the rows beyond the block. top and bot: (9, ny) device rows
// of src's storage, the row above local row 0 and the row below local row
// nx - 1, each with all 9 speed planes; required when the range touches
// row 0 (top) or row nx - 1 (bot), and never read otherwise. solid_top and
// solid_bot: their (ny) uint8 class rows, required with them in the plane
// variant. offset: the global row of local row 0; gnx: the global row
// count (offset + nx <= gnx), the spec's periodicity. Returns
// cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_ext_launch(
    const void* src, void* dst, const void* top, const void* bot, const void* solid,
    const void* solid_top, const void* solid_bot, const void* spec, int64_t nx, int64_t ny,
    int64_t row0, int64_t rows, int64_t offset, int64_t gnx, int64_t storage,
    int64_t geometry, int64_t fast_math, const void* params, void* stream) {
  const bool plane = geometry == kPlane;
  if (refused(solid, spec, nx, ny, storage, geometry) || row0 < 0 || rows < 1 ||
      row0 + rows > nx || offset < 0 || gnx >= (1LL << 62) || offset + nx > gnx ||
      (row0 == 0 && (top == nullptr || (plane && solid_top == nullptr))) ||
      (row0 + rows == nx && (bot == nullptr || (plane && solid_bot == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((ny + kBlock - 1) / kBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  const uint8_t* wt = static_cast<const uint8_t*>(solid_top);
  const uint8_t* wb = static_cast<const uint8_t*>(solid_bot);
  const int fast = fast_math != 0;
  if (storage == 1) {
    using B = __nv_bfloat16;
    const Ext<B> e{static_cast<const B*>(top), static_cast<const B*>(bot), wt, wb,
                   row0, offset, gnx};
    launch_ext<B>(grid, st, src, dst, w, g, e, nx, ny, k, fast, geometry);
  } else {
    const Ext<float> e{static_cast<const float*>(top), static_cast<const float*>(bot), wt,
                       wb, row0, offset, gnx};
    launch_ext<float>(grid, st, src, dst, w, g, e, nx, ny, k, fast, geometry);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rdma form: one step of a whole shard src -> dst on `stream`, halo
// exchange included. top, bot: this shard's (2, 9, ny) comm buffers of
// src's storage (by step parity: the row above local row 0, the row below
// local row nx - 1), written by the neighbours' launches of the same step.
// up_bot, down_top: the (2, 9, ny) buffers this launch writes, the upper
// neighbour's bot and the lower neighbour's top; up_flag, down_flag: the
// flag words it then sets to `step` (the upper neighbour's bot flag, the
// lower neighbour's top flag). flags: this shard's own [top, bot] flag
// words; work: its [ticket counter, error word]; all uint64, zeroed
// together before step 1 (a launch reads its roles off the counter), on memory that this device can address (its own,
// or a peer's after lbm_enable_peer_access). step counts 1, 2, ... since
// that reset; every shard of the ring must launch the same step, each on a
// stream of its own, or the edge rows wait timeout_ns and give up, leaving
// `step` in work[1]. nx >= 3. The other arguments are the ext-halo form's.
// Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_rdma_launch(
    const void* src, void* dst, void* top, void* bot, void* up_bot, void* down_top,
    void* flags, void* up_flag, void* down_flag, void* work, const void* solid,
    const void* solid_top, const void* solid_bot, const void* spec, int64_t nx, int64_t ny,
    int64_t offset, int64_t gnx, int64_t storage, int64_t geometry, int64_t fast_math,
    const void* params, int64_t step, int64_t timeout_ns, void* stream) {
  const bool plane = geometry == kPlane;
  const int64_t tiles = (ny + kBlock - 1) / kBlock;
  if (refused(solid, spec, nx, ny, storage, geometry) || nx < 3 || offset < 0 ||
      gnx >= (1LL << 62) || offset + nx > gnx || step < 1 || timeout_ns < 0 ||
      kSendCtas + nx * tiles > 0x7fffffffLL || top == nullptr || bot == nullptr ||
      up_bot == nullptr || down_top == nullptr || flags == nullptr || up_flag == nullptr ||
      down_flag == nullptr || work == nullptr ||
      (plane && (solid_top == nullptr || solid_bot == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const unsigned grid = static_cast<unsigned>(kSendCtas + nx * tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  const uint8_t* wt = static_cast<const uint8_t*>(solid_top);
  const uint8_t* wb = static_cast<const uint8_t*>(solid_bot);
  const int fast = fast_math != 0;
  if (storage == 1) {
    launch_rdma_typed<__nv_bfloat16>(grid, st, src, dst, top, bot, up_bot, down_top, flags,
                                     up_flag, down_flag, work, w, wt, wb, g, nx, ny, offset,
                                     gnx, k, fast, geometry, step, timeout_ns);
  } else {
    launch_rdma_typed<float>(grid, st, src, dst, top, bot, up_bot, down_top, flags, up_flag,
                             down_flag, work, w, wt, wb, g, nx, ny, offset, gnx, k, fast,
                             geometry, step, timeout_ns);
  }
  return static_cast<int>(cudaGetLastError());
}

// Let kernels on `device` address the memory of `peer` (the rdma form's
// comm buffers and flags on a neighbour card). Returns 0 when the access is
// (or already was) enabled, cudaErrorPeerAccessUnsupported when the cards
// cannot reach each other, else the error.
extern "C" int lbm_enable_peer_access(int64_t device, int64_t peer) {
  if (device == peer) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, static_cast<int>(device),
                                            static_cast<int>(peer));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int before = 0;
  cudaGetDevice(&before);
  cudaSetDevice(static_cast<int>(device));
  err = cudaDeviceEnablePeerAccess(static_cast<int>(peer), 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not an error: PyTorch enables it at its first peer copy
    err = cudaSuccess;
  }
  cudaSetDevice(before);
  return static_cast<int>(err);
}
