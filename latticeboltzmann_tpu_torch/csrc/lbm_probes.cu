// The anatomy probes for Hopper (sm_90a): four small kernels that each
// isolate one piece of what a stream-collide step costs on this card.
// They replace the four Pallas probe kernels of scripts/anatomy.py in the
// JAX package; each computes what its TPU kernel computes and none is
// carried over block by block (no DMA semaphores, no lane padding).
//
// 1. lbm_copy (copy_pipeline, scripts/anatomy.py:89, pallas_call :140):
//    dst = src for a contiguous state buffer. Bound: device-memory bytes,
//    each read once and written once; its rate is the denominator of
//    every "share of the copy rate" the port reports. Two forms:
//    - direct: a grid-stride loop of 16-byte streaming loads and stores
//      over the buffer, on a grid that covers it at once (the loop then
//      runs once; on an H100 that beats a persistent grid of a few CTAs
//      per SM, which the launcher also offers so that the anatomy script
//      can show it), with a bytewise tail (and a bytewise body when a
//      pointer is not 16-byte aligned), so any NY works;
//    - staged: the Hopper form of "rotating slots with compute removed".
//      Persistent CTAs walk tiles of `rows` lattice rows (contiguous:
//      rows * NY * itemsize bytes), each tile brought into one of `stages`
//      shared-memory buffers by asynchronous 16-byte copies (cp.async
//      through __pipeline_memcpy_async), stages - 1 tiles in flight while
//      the oldest is written back from shared memory. The launcher refuses
//      a tile that is no multiple of 16 bytes.
// 2. lbm_roll_y (roll_cost, :182, pallas_call :192): n_rolls chained
//    periodic shifts by `shift` along y of a (rows, NY) float32 block held
//    on chip. A row's rolls are independent of every other row's, and a
//    (32, 4000) block does not fit one SM's shared memory, so one CTA
//    takes one row. Two mechanisms:
//    - shared memory: the row ping-pongs between two shared buffers, each
//      roll a store at the shifted index and one barrier;
//    - warp shuffles, |shift| < 32: the row lives in registers, 32
//      consecutive columns per warp and slot; a roll is one shuffle per
//      slot, and the lanes whose source lies in another warp segment (or
//      across the row's wrap) take it from a shared edge buffer that the
//      owning lanes wrote before the barrier.
//    Bound per roll: shared-memory bytes for the first (4 B read and 4 B
//    written per element), issue slots for the second.
//    The shared-memory mechanism has two forms. The narrow one above
//    (lbm_roll_y_shared) takes one SM per row: 32 of the card's 132. The
//    wide one (lbm_roll_y_cluster<R>) splits each row across a
//    thread-block cluster of kRollYCluster = 4 CTAs, so that rows * 4
//    CTAs cover the card, each CTA holding NY / 4 columns as 16-byte
//    vectors in two ping-pong buffers. A roll by s = 4q + r builds each
//    output vector from two neighbouring source vectors (r is uniform over
//    the launch: each r has a kernel of its own) and writes it where it
//    lands by st.async, which completes its 16 bytes on the owning CTA's
//    mbarrier; each CTA waits on its own mbarriers for its next roll's
//    vectors and for every CTA's word that it has read the buffer about
//    to be written, so no cluster barrier stands in a roll. It takes NY a
//    multiple of 16 and 16-byte aligned pointers; every other shape takes
//    the narrow one. On an H100 it is slower than the narrow form (about
//    270 ns of handoff latency a roll; PERF.md §6), so the wrapper runs it
//    only when asked.
// 3. lbm_align (align_cost, :211, pallas_call :224): v = a, then n_ops
//    times v = v + b, on the two windows a = x[o : R-2+o], b = x[2-o : R-o]
//    of a resident (R, NY) float32 block, offsets o = 0, 1, 2. On the TPU
//    the offset is in rows (sublanes). On this card a row offset is a
//    pointer offset and costs nothing; the misalignment that matters is
//    along y, where a warp's 32 loads leave their 128-byte line, which is
//    what the +-1-column pulls of lbm_step.cu do. So `axis` selects rows
//    (the TPU function as written) or columns (the same windows along y).
//    Each add re-reads b through L1 (an ld.global.ca whose address depends
//    on the loop counter through a run-time zero, so it stays in the loop),
//    as the step kernel's pulls read their sources, so the slope over
//    n_ops is the cost of one L1-served warp load at that offset.
//    The adds are sequential float32 adds in order.
// 4. lbm_roll_x (sublane_roll_cost, :245, pallas_call :252): n_rolls
//    chained periodic shifts by `shift` along x (rows) of an (R, NY)
//    float32 block. Columns are independent, so CTAs take column tiles.
//    Two mechanisms: the tile's rows held in shared memory (ping-pong, one
//    barrier per roll), and the rows re-read from global memory through
//    L1/L2 each roll (ping-pong between two global scratch blocks), which
//    asks whether a step's three row reads per site are served by cache.
//    The shared-memory mechanism has two forms. The narrow one
//    (lbm_roll_x_shared: 32 CTAs of 128 columns, 4-byte accesses, a
//    block barrier per roll) takes every shape. The wide one
//    (lbm_roll_x_wide) moves 16-byte vectors (a row shift never splits
//    one) on one-warp CTAs of kRollXVecs = 2 vectors, so that NY = 4000
//    fills the card (500 CTAs, about four per SM), laid out
//    [buffer][row][vector]. The warp owns its column strips through all R
//    rows, so a roll needs only a __syncwarp. It takes NY a multiple of 4
//    and 16-byte aligned pointers.
//
// n_rolls and n_ops are run-time arguments: the cost per roll or per op is
// the slope between two counts, which cancels the launch and the block's
// load and store. All four move or add float32 values exactly, so each is
// bitwise-equal to its plain PyTorch version (ops/probes.py in the port).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopyBlock = 256;
constexpr int kRollBlock = 512;   // 16 warps per row
constexpr int kRollWarps = kRollBlock / 32;
constexpr int kMaxSlots = 16;     // shuffle mechanism: NY <= 32 * 16 * 16
constexpr int kAlignBlock = 256;
constexpr int kTileCols = 128;    // x-roll: columns per CTA
constexpr int kRollXBlock = 256;
constexpr int kMaxStages = 8;
constexpr int kRollYWideBlock = 256;  // y-roll, wide form: threads per CTA
constexpr int kRollYCluster = 4;      // wide y-roll: CTAs per row
constexpr int kInFlight = 4;          // wide y-roll: 16-byte loads in flight per thread
constexpr int kRollXVecs = 2;         // wide x-roll: 16-byte vectors per one-warp CTA
// an mbarrier wait of the wide y-roll gives up (and traps) after this
// many nanoseconds: a lost signal ends the launch instead of hanging
constexpr uint64_t kWaitNs = 1000000000ull;
// dynamic shared memory a block may ask for on sm_90
constexpr int64_t kMaxShared = 232448;

// ------------------------------------------------------------------ copy

__global__ void __launch_bounds__(kCopyBlock)
lbm_copy_direct(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int64_t n_vec, int64_t n_bytes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCopyBlock;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kCopyBlock + threadIdx.x;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  // streaming loads and stores (ld.global.cs, st.global.cs): no byte is
  // touched twice, so none should displace another in L2
  for (int64_t v = first; v < n_vec; v += stride) __stcs(d + v, __ldcs(s + v));
  // the bytes past the last whole vector (all of them when n_vec is 0)
  for (int64_t b = n_vec * 16 + first; b < n_bytes; b += stride) dst[b] = src[b];
}

// wait until at most `pending` of this thread's committed copy groups are
// still in flight (the count must be an immediate)
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    case 3: __pipeline_wait_prior(3); break;
    case 4: __pipeline_wait_prior(4); break;
    case 5: __pipeline_wait_prior(5); break;
    default: __pipeline_wait_prior(6); break;
  }
}

// tile_vec: 16-byte vectors per tile; n_tiles tiles in all
__global__ void __launch_bounds__(kCopyBlock)
lbm_copy_staged(const uint4* __restrict__ src, uint4* __restrict__ dst,
                int64_t tile_vec, int64_t n_tiles, int stages) {
  extern __shared__ uint4 slots[];  // (stages, tile_vec)
  // this CTA's tiles: blockIdx.x, + gridDim.x, ...
  const int64_t mine = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  auto fetch = [&](int64_t k) {
    // tile k of this CTA into slot k % stages; an empty group past the end
    if (k < mine) {
      const uint4* s = src + (blockIdx.x + k * gridDim.x) * tile_vec;
      uint4* slot = slots + (k % stages) * tile_vec;
      for (int64_t v = threadIdx.x; v < tile_vec; v += kCopyBlock) {
        __pipeline_memcpy_async(slot + v, s + v, sizeof(uint4));
      }
    }
    __pipeline_commit();
  };

  for (int k = 0; k < stages - 1; ++k) fetch(k);
  for (int64_t k = 0; k < mine; ++k) {
    // tiles up to k + stages - 2 are committed: tile k has landed once at
    // most stages - 2 groups are pending
    wait_pending(stages - 2);
    // tile k is visible to every thread, and every thread is done with
    // slot (k - 1) % stages, which the next fetch refills
    __syncthreads();
    fetch(k + stages - 1);
    const uint4* slot = slots + (k % stages) * tile_vec;
    uint4* d = dst + (blockIdx.x + k * gridDim.x) * tile_vec;
    for (int64_t v = threadIdx.x; v < tile_vec; v += kCopyBlock) __stcs(d + v, slot[v]);
  }
  __pipeline_wait_prior(0);
}

// ---------------------------------------------------------------- y roll

// One CTA per row; the row ping-pongs between two shared buffers.
__global__ void __launch_bounds__(kRollBlock)
lbm_roll_y_shared(const float* __restrict__ x, float* __restrict__ out, int ny, int shift,
                  int n_rolls) {
  extern __shared__ float row[];  // (2, ny)
  const float* src = x + static_cast<int64_t>(blockIdx.x) * ny;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * ny;
  for (int j = threadIdx.x; j < ny; j += kRollBlock) row[j] = src[j];
  __syncthreads();
  int cur = 0;
  for (int r = 0; r < n_rolls; ++r) {
    const float* a = row + cur * ny;
    float* b = row + (cur ^ 1) * ny;
    for (int j = threadIdx.x; j < ny; j += kRollBlock) {
      int t = j + shift;  // 0 <= shift < ny
      if (t >= ny) t -= ny;
      b[t] = a[j];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int j = threadIdx.x; j < ny; j += kRollBlock) dst[j] = row[cur * ny + j];
}

// One CTA per row; the row lives in registers, slot k of warp w holding
// columns (k * kRollWarps + w) * 32 + lane. shift in (-32, 32), non-zero.
template <int SLOTS>
__global__ void __launch_bounds__(kRollBlock)
lbm_roll_y_shuffle(const float* __restrict__ x, float* __restrict__ out, int ny, int shift,
                   int n_rolls) {
  extern __shared__ float edge[];  // (2, ny): only edge columns are written
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* src = x + static_cast<int64_t>(blockIdx.x) * ny;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * ny;
  const int t = shift > 0 ? shift : -shift;

  float v[SLOTS];
  int col[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    col[k] = (k * kRollWarps + warp) * 32 + lane;
    v[k] = col[k] < ny ? src[col[k]] : 0.0f;
  }
  int cur = 0;
  for (int r = 0; r < n_rolls; ++r) {
    float* e = edge + cur * ny;
    // the columns another segment (or the wrap) will ask for: the last t
    // lanes of a segment and the last t columns of the row (right shift),
    // or the first t of each (left shift)
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = col[k];
      const bool wanted = shift > 0 ? (lane >= 32 - t || c >= ny - t) : (lane < t || c < t);
      if (c < ny && wanted) e[c] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = col[k];
      if (shift > 0) {
        // new[c] = old[c - t]
        const float s = __shfl_up_sync(0xffffffffu, v[k], t);
        if (c < ny) v[k] = (lane >= t) ? s : e[c >= t ? c - t : c - t + ny];
      } else {
        // new[c] = old[c + t]
        const float s = __shfl_down_sync(0xffffffffu, v[k], t);
        if (c < ny) v[k] = (lane + t < 32 && c + t < ny) ? s : e[c + t < ny ? c + t : c + t - ny];
      }
    }
    // the other edge buffer next: one barrier per roll
    cur ^= 1;
  }
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    if (col[k] < ny) dst[col[k]] = v[k];
  }
}

// ------------------------------------------------ y roll, cluster form

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address in the shared memory of cluster CTA `rank` of this CTA's
// shared address `local`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// a 16-byte store into the shared memory of a cluster CTA (addr, from
// map_rank) that completes its 16 bytes on that CTA's mbarrier mbar
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];"
      :
      : "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" : : "r"(addr), "r"(count) : "memory");
}

// one arrival on this CTA's mbarrier, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect_tx(uint32_t addr, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(addr), "r"(bytes)
               : "memory");
}

// one arrival on a cluster CTA's mbarrier (addr from map_rank)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" : : "r"(addr) : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// until the phase of this CTA's mbarrier of parity `parity` completes;
// traps after kWaitNs
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  if (mbar_test(addr, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_test(addr, parity)) {
    if (globaltimer() - t0 > kWaitNs) __trap();
  }
}

// the mbarriers' initialisation visible to the cluster, and every CTA of
// the cluster started, before any reaches into another
__device__ __forceinline__ void cluster_start() {
  asm volatile(
      "fence.mbarrier_init.release.cluster;\n\t"
      "barrier.cluster.arrive.relaxed.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t id;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(id));
  return id;
}

// the output vector of a roll by 4q + R from its two source vectors:
// prev holds columns 4(d - q) - 4 .. - 1, cur 4(d - q) .. + 3
template <int R>
__device__ __forceinline__ float4 compose(float4 prev, float4 cur) {
  if constexpr (R == 1) return make_float4(prev.w, cur.x, cur.y, cur.z);
  if constexpr (R == 2) return make_float4(prev.z, prev.w, cur.x, cur.y);
  if constexpr (R == 3) return make_float4(prev.y, prev.z, prev.w, cur.x);
  return cur;
}

// One cluster of C = kRollYCluster CTAs per row (cluster i takes row i);
// CTA `rank` holds the row's 16-byte vectors rank * seg .. + seg - 1 in
// two ping-pong buffers of seg + 1 slots, slot 0 a halo: the vector
// before the segment, which a roll by a shift of residue R != 0 reads.
// The shift is 4q + R columns, q = qc * seg + ql vectors (0 <= ql < seg,
// 0 <= qc < C). After the buffers, four mbarriers: full[2] (buffer b has
// received a roll's seg vectors, and its halo for R != 0: one arrival,
// the bytes counted) and empty[2] (every CTA of the cluster has read its
// buffer b: C arrivals).
template <int R>
__global__ void __launch_bounds__(kRollYWideBlock)
lbm_roll_y_cluster(const float4* __restrict__ x, float4* __restrict__ out, int nyv, int seg,
                   int qc, int ql, int n_rolls) {
  constexpr uint32_t c = kRollYCluster;
  extern __shared__ float4 ring[];  // (2, seg + 1), then full[2], empty[2]
  const uint32_t rank = cluster_rank();
  const int64_t row = static_cast<int64_t>(cluster_id()) * nyv;
  const int first = static_cast<int>(rank) * seg;
  const float4* src = x + row + first;
  const uint32_t full0 = smem_u32(ring + 2 * (seg + 1)), empty0 = full0 + 16;
  // the segment in by 16-byte vectors, a thread's loads in flight before
  // its first store, and the halo (the row wraps)
  for (int base = threadIdx.x; base < seg; base += kInFlight * kRollYWideBlock) {
    float4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (base + k * kRollYWideBlock < seg) v[k] = src[base + k * kRollYWideBlock];
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (base + k * kRollYWideBlock < seg) ring[1 + base + k * kRollYWideBlock] = v[k];
    }
  }
  if (threadIdx.x == 0) ring[0] = x[row + (first == 0 ? nyv - 1 : first - 1)];
  if (threadIdx.x == 0) {
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    mbar_init(empty0, c);
    mbar_init(empty0 + 8, c);
  }
  __syncthreads();  // the segment loaded
  cluster_start();
  // bytes a CTA receives per roll: its segment, and a halo for R != 0
  const uint32_t bytes = 16u * (seg + (R != 0 ? 1 : 0));
  int cur = 0;
  for (int r = 0; r < n_rolls; ++r) {
    const float4* a = ring + cur * (seg + 1);
    const uint32_t b0 = smem_u32(ring + (cur ^ 1) * (seg + 1));
    // this roll's source has arrived (roll r - 1 filled it), the next fill
    // of the destination is announced, and every CTA has read its
    // destination buffer (roll r - 1 read it): the mbarriers' phases
    // alternate every second roll
    const uint32_t parity = ((r - 1) >> 1) & 1;
    if (r > 0) mbar_wait(full0 + 8 * cur, parity);
    if (threadIdx.x == 0) mbar_expect_tx(full0 + 8 * (cur ^ 1), bytes);
    if (r > 0) mbar_wait(empty0 + 8 * (cur ^ 1), parity);
    // source vector `lv` of this CTA lands at vector lv + ql (carrying
    // into the next CTA) of CTA rank + qc
    const uint32_t full = full0 + 8 * (cur ^ 1);
    for (int lv = threadIdx.x; lv < seg; lv += kRollYWideBlock) {
      float4 v = a[1 + lv];
      if constexpr (R != 0) v = compose<R>(a[lv], v);
      int dl = lv + ql;
      uint32_t dr = rank + qc;
      if (dl >= seg) {
        dl -= seg;
        ++dr;
      }
      if (dr >= c) dr -= c;
      st_async(map_rank(b0 + 16u * (1 + dl), dr), v, map_rank(full, dr));
      // the last vector of a segment is also the next CTA's halo
      if (R != 0 && dl == seg - 1) {
        const uint32_t hr = dr + 1 == c ? 0 : dr + 1;
        st_async(map_rank(b0, hr), v, map_rank(full, hr));
      }
    }
    // this CTA has read its source: tell every CTA, which may then write
    // it in roll r + 1 (no CTA writes after the last roll, and none
    // signals then, so no signal reaches a CTA that has exited)
    if (r + 1 < n_rolls) {
      __syncthreads();
      if (threadIdx.x < c) mbar_arrive_remote(map_rank(empty0 + 8 * cur, threadIdx.x));
    }
    cur ^= 1;
  }
  // the last roll's vectors (and every store into this CTA) have landed
  if (n_rolls > 0) mbar_wait(full0 + 8 * cur, ((n_rolls - 1) >> 1) & 1);
  float4* dst = out + row + first;
  const float4* fin = ring + cur * (seg + 1) + 1;
  for (int lv = threadIdx.x; lv < seg; lv += kRollYWideBlock) dst[lv] = fin[lv];
}

// ----------------------------------------------------------------- align

// a load through L1 (ld.global.ca), as the step kernel's pulls take
__device__ __forceinline__ float load_l1(const float* p) {
  float v;
  asm volatile("ld.global.ca.f32 %0, [%1];"
               : "=f"(v)
               : "l"(__cvta_generic_to_global(p))
               : "memory");
  return v;
}

// out: (out_rows, out_cols); a and b: the two windows' first elements in
// x, whose rows are ld floats apart. hop is 0 at run time, which the
// compiler cannot know: add n reads b at n * hop floats past its site, so
// the load stays inside the loop (the assembler otherwise keeps one load
// for every 16 adds, and the slope then times the adds alone).
__global__ void __launch_bounds__(kAlignBlock)
lbm_align(const float* a, const float* b, float* __restrict__ out, int out_rows,
          int out_cols, int ld, int n_ops, int hop) {
  const int j = blockIdx.y * kAlignBlock + threadIdx.x;
  const int i = blockIdx.x;
  if (j >= out_cols || i >= out_rows) return;
  const int64_t at = static_cast<int64_t>(i) * ld + j;
  float v = a[at];
  const float* operand = b + at;
  for (int n = 0; n < n_ops; ++n) v = v + load_l1(operand + static_cast<int64_t>(n) * hop);
  out[static_cast<int64_t>(i) * out_cols + j] = v;
}

// ---------------------------------------------------------------- x roll

// One CTA per tile of kTileCols columns; the tile's rows ping-pong between
// two shared buffers.
__global__ void __launch_bounds__(kRollXBlock)
lbm_roll_x_shared(const float* __restrict__ x, float* __restrict__ out, int rows, int ny,
                  int shift, int n_rolls) {
  extern __shared__ float tile[];  // (2, rows, kTileCols)
  const int c = threadIdx.x % kTileCols;
  const int j = blockIdx.x * kTileCols + c;
  const int r0 = threadIdx.x / kTileCols;
  constexpr int kRowStep = kRollXBlock / kTileCols;
  const int half = rows * kTileCols;
  if (j < ny) {
    for (int i = r0; i < rows; i += kRowStep) tile[i * kTileCols + c] = x[static_cast<int64_t>(i) * ny + j];
  }
  __syncthreads();
  int cur = 0;
  for (int r = 0; r < n_rolls; ++r) {
    const float* a = tile + cur * half;
    float* b = tile + (cur ^ 1) * half;
    if (j < ny) {
      for (int i = r0; i < rows; i += kRowStep) {
        int t = i + shift;  // 0 <= shift < rows
        if (t >= rows) t -= rows;
        b[t * kTileCols + c] = a[i * kTileCols + c];
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  if (j < ny) {
    for (int i = r0; i < rows; i += kRowStep) {
      out[static_cast<int64_t>(i) * ny + j] = tile[cur * half + i * kTileCols + c];
    }
  }
}

// The same tile, re-read from global memory each roll: roll r reads x (the
// first) or a scratch block and writes the other scratch block, or out
// (the last). The buffers are plain pointers: a roll's loads must see the
// previous roll's stores of this CTA, ordered by the barrier.
__global__ void __launch_bounds__(kRollXBlock)
lbm_roll_x_global(const float* x, float* out, float* scratch0, float* scratch1, int rows,
                  int ny, int shift, int n_rolls) {
  const int c = threadIdx.x % kTileCols;
  const int j = blockIdx.x * kTileCols + c;
  const int r0 = threadIdx.x / kTileCols;
  constexpr int kRowStep = kRollXBlock / kTileCols;
  if (n_rolls == 0) {
    if (j < ny) {
      for (int i = r0; i < rows; i += kRowStep) {
        out[static_cast<int64_t>(i) * ny + j] = x[static_cast<int64_t>(i) * ny + j];
      }
    }
    return;
  }
  for (int r = 0; r < n_rolls; ++r) {
    const float* a = r == 0 ? x : ((r - 1) % 2 == 0 ? scratch0 : scratch1);
    float* b = r == n_rolls - 1 ? out : (r % 2 == 0 ? scratch0 : scratch1);
    if (j < ny) {
      for (int i = r0; i < rows; i += kRowStep) {
        int t = i + shift;  // 0 <= shift < rows
        if (t >= rows) t -= rows;
        b[static_cast<int64_t>(t) * ny + j] = a[static_cast<int64_t>(i) * ny + j];
      }
    }
    __syncthreads();
  }
}

// One warp per kRollXVecs 16-byte vectors (4 * kRollXVecs columns); lane
// t owns vector t % kRollXVecs of rows g, g + G, g + 2G, ... (g = t /
// kRollXVecs, G = 32 / kRollXVecs row groups), in chunks of kChunk rows
// whose loads are all in flight before the chunk's first store. The
// tile's rows ping-pong between two shared buffers laid out
// [buffer][row][vector]. Every slot a lane reads was written by its own
// warp, so a roll ends in a __syncwarp, not a block barrier. Vectors past
// NY's end move through shared memory like the others but are neither
// loaded nor stored.
__global__ void __launch_bounds__(32)
lbm_roll_x_wide(const float4* __restrict__ x, float4* __restrict__ out, int rows, int nyv,
                int shift, int n_rolls) {
  constexpr int kGroups = 32 / kRollXVecs;
  constexpr int kChunk = 64 / kGroups;
  extern __shared__ float4 strips[];  // (2, rows, kRollXVecs)
  const int vec = threadIdx.x % kRollXVecs;
  const int g = threadIdx.x / kRollXVecs;
  const int v = blockIdx.x * kRollXVecs + vec;
  const bool live = v < nyv;
  const int half = rows * kRollXVecs;
  for (int i0 = g; i0 < rows; i0 += kGroups * kChunk) {
    float4 t[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k * kGroups;
      if (live && i < rows) t[k] = x[static_cast<int64_t>(i) * nyv + v];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k * kGroups;
      if (live && i < rows) strips[i * kRollXVecs + vec] = t[k];
    }
  }
  __syncwarp();
  int cur = 0;
  for (int r = 0; r < n_rolls; ++r) {
    const float4* a = strips + cur * half;
    float4* b = strips + (cur ^ 1) * half;
    for (int i0 = g; i0 < rows; i0 += kGroups * kChunk) {
      float4 t[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int i = i0 + k * kGroups;
        if (i < rows) t[k] = a[i * kRollXVecs + vec];
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int i = i0 + k * kGroups;
        if (i < rows) {
          int d = i + shift;  // 0 <= shift < rows
          if (d >= rows) d -= rows;
          b[d * kRollXVecs + vec] = t[k];
        }
      }
    }
    __syncwarp();
    cur ^= 1;
  }
  const float4* fin = strips + cur * half;
  for (int i0 = g; i0 < rows; i0 += kGroups * kChunk) {
    float4 t[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k * kGroups;
      if (live && i < rows) t[k] = fin[i * kRollXVecs + vec];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k * kGroups;
      if (live && i < rows) out[static_cast<int64_t>(i) * nyv + v] = t[k];
    }
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  return sms;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dst = src, n_bytes bytes, on `stream`; src and dst device buffers that
// do not overlap. tile_bytes == 0: the direct form, one 16-byte vector per
// thread on a grid that covers the buffer (ctas_per_sm == 0), or on a
// persistent grid of ctas_per_sm CTAs per SM that walks it, for the
// anatomy script to compare. Otherwise the staged form: tiles of
// tile_bytes bytes (a multiple of 16 that divides n_bytes; both pointers
// 16-byte aligned) through `stages` (2..8) shared buffers. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the form does not take.
extern "C" int lbm_copy_launch(const void* src, void* dst, int64_t n_bytes, int64_t tile_bytes,
                               int64_t stages, int64_t ctas_per_sm, void* stream) {
  if (src == nullptr || dst == nullptr || n_bytes < 1 || tile_bytes < 0 || ctas_per_sm < 0 ||
      ctas_per_sm > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_bytes == 0) {
    const int64_t n_vec = (aligned16(src) && aligned16(dst)) ? n_bytes / 16 : 0;
    const int64_t work = n_vec > 0 ? n_vec : n_bytes;
    int64_t blocks = (work + kCopyBlock - 1) / kCopyBlock;
    if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
    if (ctas_per_sm > 0) {
      const int sms = sm_count();
      if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
      if (blocks > ctas_per_sm * sms) blocks = ctas_per_sm * sms;
    }
    lbm_copy_direct<<<static_cast<unsigned>(blocks), kCopyBlock, 0, st>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n_vec, n_bytes);
    return static_cast<int>(cudaGetLastError());
  }
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t shared = stages * tile_bytes;
  if (stages < 2 || stages > kMaxStages || tile_bytes % 16 != 0 || n_bytes % tile_bytes != 0 ||
      shared > kMaxShared || !aligned16(src) || !aligned16(dst)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(lbm_copy_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_copy_staged, kCopyBlock,
                                                      static_cast<size_t>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = n_bytes / tile_bytes;
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  if (blocks > n_tiles) blocks = n_tiles;
  lbm_copy_staged<<<static_cast<unsigned>(blocks), kCopyBlock, static_cast<size_t>(shared), st>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), tile_bytes / 16, n_tiles,
      static_cast<int>(stages));
  return static_cast<int>(cudaGetLastError());
}

// out = x rolled n_rolls times by `shift` along y. x, out: (rows, ny)
// float32, device, contiguous, distinct. shift in [0, ny). mechanism 0:
// shared memory; 1: warp shuffles, which need the shift within 31 columns
// of 0 either way (shift <= 31 or shift >= ny - 31; 0 is refused) and
// ny <= 8192.
extern "C" int lbm_roll_y_launch(const void* x, void* out, int64_t rows, int64_t ny,
                                 int64_t shift, int64_t n_rolls, int64_t mechanism,
                                 void* stream) {
  if (x == nullptr || out == nullptr || rows < 1 || rows >= (1LL << 31) || ny < 1 ||
      shift < 0 || shift >= ny || n_rolls < 0 || n_rolls >= (1LL << 31) ||
      2 * ny * 4 > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const size_t shared = static_cast<size_t>(2 * ny * 4);
  const unsigned grid = static_cast<unsigned>(rows);
  const int nyi = static_cast<int>(ny), n = static_cast<int>(n_rolls);
  cudaError_t err;
  if (mechanism == 0) {
    err = cudaFuncSetAttribute(lbm_roll_y_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    lbm_roll_y_shared<<<grid, kRollBlock, shared, st>>>(xs, os, nyi, static_cast<int>(shift), n);
    return static_cast<int>(cudaGetLastError());
  }
  if (mechanism != 1) return static_cast<int>(cudaErrorInvalidValue);
  // the signed shift nearest 0
  const int s = shift <= 31 ? static_cast<int>(shift)
                            : (ny - shift <= 31 ? -static_cast<int>(ny - shift) : 0);
  const int64_t segments = (ny + 31) / 32;
  const int64_t slots = (segments + kRollWarps - 1) / kRollWarps;
  if (s == 0 || slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
#define LBM_ROLL_Y_SHUFFLE(SLOTS)                                                          \
  do {                                                                                     \
    err = cudaFuncSetAttribute(lbm_roll_y_shuffle<SLOTS>,                                  \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,                \
                               static_cast<int>(shared));                                  \
    if (err != cudaSuccess) return static_cast<int>(err);                                  \
    lbm_roll_y_shuffle<SLOTS><<<grid, kRollBlock, shared, st>>>(xs, os, nyi, s, n);        \
  } while (0)
  if (slots <= 1) LBM_ROLL_Y_SHUFFLE(1);
  else if (slots <= 2) LBM_ROLL_Y_SHUFFLE(2);
  else if (slots <= 4) LBM_ROLL_Y_SHUFFLE(4);
  else if (slots <= 8) LBM_ROLL_Y_SHUFFLE(8);
  else LBM_ROLL_Y_SHUFFLE(16);
#undef LBM_ROLL_Y_SHUFFLE
  return static_cast<int>(cudaGetLastError());
}

namespace {

using RollYClusterKernel = void (*)(const float4*, float4*, int, int, int, int, int);

// the wide y-roll's shared memory for a segment of seg vectors: two
// buffers of seg + 1, four mbarriers
int64_t roll_y_cluster_shared(int64_t seg) { return 2 * (seg + 1) * 16 + 32; }

// the wide y-roll's kernel for a shift's residue mod 4
RollYClusterKernel roll_y_cluster_kernel(int64_t residue) {
  const RollYClusterKernel by_residue[4] = {lbm_roll_y_cluster<0>, lbm_roll_y_cluster<1>,
                                            lbm_roll_y_cluster<2>, lbm_roll_y_cluster<3>};
  return by_residue[residue];
}

// A launch configuration of the wide y-roll: `rows` clusters of
// kRollYCluster CTAs, each with the shared memory of two buffers of a
// segment; *active receives cudaOccupancyMaxActiveClusters for it.
cudaError_t roll_y_cluster_config(RollYClusterKernel fn, int64_t rows, int64_t ny,
                                  cudaStream_t st, cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr, int* active) {
  const size_t shared = static_cast<size_t>(roll_y_cluster_shared(ny / 4 / kRollYCluster));
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(rows * kRollYCluster));
  cfg->blockDim = dim3(kRollYWideBlock);
  cfg->dynamicSmemBytes = shared;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kRollYCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, fn, cfg);
}

bool roll_y_cluster_takes(int64_t rows, int64_t ny) {
  return rows >= 1 && rows * kRollYCluster < (1LL << 31) && ny < (1LL << 31) &&
         ny % (4 * kRollYCluster) == 0 && ny > 0 &&
         roll_y_cluster_shared(ny / 4 / kRollYCluster) <= kMaxShared;
}

}  // namespace

// The wide (cluster) form of the shared-memory y-roll: out = x rolled
// n_rolls times by `shift` along y, each row split across a cluster of
// kRollYCluster CTAs (NY a multiple of 4 * kRollYCluster; x and out
// 16-byte aligned). Returns the error of the occupancy query,
// cudaErrorInvalidConfiguration if no cluster of this shape fits the
// card, the launch's error, or cudaGetLastError() after it;
// cudaErrorInvalidValue for what the form does not take.
extern "C" int lbm_roll_y_wide_launch(const void* x, void* out, int64_t rows, int64_t ny,
                                      int64_t shift, int64_t n_rolls, void* stream) {
  if (x == nullptr || out == nullptr || !roll_y_cluster_takes(rows, ny) || shift < 0 ||
      shift >= ny || n_rolls < 0 || n_rolls >= (1LL << 31) || !aligned16(x) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RollYClusterKernel fn = roll_y_cluster_kernel(shift % 4);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err = roll_y_cluster_config(fn, rows, ny, static_cast<cudaStream_t>(stream), &cfg,
                                          &attr, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t seg = ny / 4 / kRollYCluster, q = shift / 4;
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const float4*>(x), static_cast<float4*>(out),
                           static_cast<int>(ny / 4), static_cast<int>(seg),
                           static_cast<int>(q / seg), static_cast<int>(q % seg),
                           static_cast<int>(n_rolls));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of the wide y-roll's launch at (rows,
// ny), into *active; returns the query's error, or cudaErrorInvalidValue
// for a shape the form does not take.
extern "C" int lbm_roll_y_wide_clusters(int64_t rows, int64_t ny, int64_t* active) {
  if (active == nullptr || !roll_y_cluster_takes(rows, ny)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  const cudaError_t err =
      roll_y_cluster_config(roll_y_cluster_kernel(1), rows, ny, nullptr, &cfg, &attr, &n);
  *active = n;
  return static_cast<int>(err);
}

// out = a, then n_ops times out = out + b, for the windows of x at offset
// o = 0, 1, 2. x: (rows, ny) float32, device, contiguous. axis 0: a =
// x[o : rows-2+o], b = x[2-o : rows-o], out (rows - 2, ny); axis 1: the
// same windows of the columns, out (rows, ny - 2).
extern "C" int lbm_align_launch(const void* x, void* out, int64_t rows, int64_t ny,
                                int64_t offset, int64_t n_ops, int64_t axis, void* stream) {
  if (x == nullptr || out == nullptr || rows < 1 || ny < 1 || rows >= (1LL << 30) ||
      ny >= (1LL << 30) || offset < 0 || offset > 2 || n_ops < 0 || n_ops >= (1LL << 31) ||
      axis < 0 || axis > 1 || (axis == 0 ? rows : ny) < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t out_rows = axis == 0 ? rows - 2 : rows;
  const int64_t out_cols = axis == 0 ? ny : ny - 2;
  const int64_t unit = axis == 0 ? ny : 1;  // floats per step along the axis
  const float* xs = static_cast<const float*>(x);
  const dim3 grid(static_cast<unsigned>(out_rows),
                  static_cast<unsigned>((out_cols + kAlignBlock - 1) / kAlignBlock));
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  lbm_align<<<grid, kAlignBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      xs + offset * unit, xs + (2 - offset) * unit, static_cast<float*>(out),
      static_cast<int>(out_rows), static_cast<int>(out_cols), static_cast<int>(ny),
      static_cast<int>(n_ops), /*hop=*/0);
  return static_cast<int>(cudaGetLastError());
}

// out = x rolled n_rolls times by `shift` along x (rows). x, out: (rows,
// ny) float32, device, contiguous, distinct. shift in [0, rows).
// mechanism 0: the rows held in shared memory; 1: re-read from global
// memory each roll, through scratch0 and scratch1, two more (rows, ny)
// device blocks distinct from x, out and each other.
extern "C" int lbm_roll_x_launch(const void* x, void* out, void* scratch0, void* scratch1,
                                 int64_t rows, int64_t ny, int64_t shift, int64_t n_rolls,
                                 int64_t mechanism, void* stream) {
  if (x == nullptr || out == nullptr || rows < 1 || ny < 1 || rows >= (1LL << 20) ||
      ny >= (1LL << 30) || shift < 0 || shift >= rows || n_rolls < 0 ||
      n_rolls >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const unsigned grid = static_cast<unsigned>((ny + kTileCols - 1) / kTileCols);
  const int r = static_cast<int>(rows), nyi = static_cast<int>(ny);
  const int s = static_cast<int>(shift), n = static_cast<int>(n_rolls);
  if (mechanism == 0) {
    const int64_t shared = 2 * rows * kTileCols * 4;
    if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(lbm_roll_x_shared,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    lbm_roll_x_shared<<<grid, kRollXBlock, static_cast<size_t>(shared), st>>>(xs, os, r, nyi, s, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (mechanism != 1 || scratch0 == nullptr || scratch1 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lbm_roll_x_global<<<grid, kRollXBlock, 0, st>>>(xs, os, static_cast<float*>(scratch0),
                                                  static_cast<float*>(scratch1), r, nyi, s, n);
  return static_cast<int>(cudaGetLastError());
}

// The wide form of the shared-memory x-roll: out = x rolled n_rolls times
// by `shift` along x (rows), on one-warp CTAs of kRollXVecs 16-byte
// vectors. x, out: (rows, ny) float32, device, contiguous, distinct,
// 16-byte aligned, ny a multiple of 4. shift in [0, rows). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the form does not take.
extern "C" int lbm_roll_x_wide_launch(const void* x, void* out, int64_t rows, int64_t ny,
                                      int64_t shift, int64_t n_rolls, void* stream) {
  const int64_t shared = 2 * rows * kRollXVecs * 16;
  if (x == nullptr || out == nullptr || rows < 1 || ny < 4 || ny % 4 != 0 || rows >= (1LL << 20) ||
      ny >= (1LL << 31) || shift < 0 || shift >= rows || n_rolls < 0 || n_rolls >= (1LL << 31) ||
      !aligned16(x) || !aligned16(out) || shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(lbm_roll_x_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nyv = ny / 4;
  const unsigned grid = static_cast<unsigned>((nyv + kRollXVecs - 1) / kRollXVecs);
  lbm_roll_x_wide<<<grid, 32, static_cast<size_t>(shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), static_cast<int>(rows),
      static_cast<int>(nyv), static_cast<int>(shift), static_cast<int>(n_rolls));
  return static_cast<int>(cudaGetLastError());
}
