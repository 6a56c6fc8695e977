// The row-sharded temporal pass with the halo exchange inside the kernel
// for Hopper (sm_90a): a pass of L walled D2Q9 steps on one shard, each
// shard sending its edge rows into its ring neighbours' comm blocks while
// it computes its interior, one launch per shard and pass, no copy started
// by the host.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757) with
// rdma=True at temporal = T (make_pallas_run_steps(rdma=True),
// parallel/sharded.py:221, 264-286, 351-352, 426-439 there): at the first
// grid step the TPU kernel DMAs the shard's edge slabs to the ring
// neighbours, computes the interior blocks, waits on the DMA semaphores,
// and computes the edge blocks from the last T rows of the received slabs
// (rdma_schedule, ops/fused_kernel.py:137-179; top_halo_rows = (hr - T,
// hr)). What carries over is that protocol at depth T; the 8-row slabs
// (RDMA_HR), VMEM send buffers and re-mirroring are TPU staging.
//
// It is the ext-halo temporal form of lbm_temporal_step.cu (the same tile,
// loads and levels, lbm_temporal.cuh) with the one-step rdma form's
// protocol (lbm_step.cu, "The rdma form"; lbm_ext.cuh: Rdma, the flag words,
// the bounded wait), at depth T:
// - every shard owns two comm blocks, top and bot, each (2 parities, 9, Td,
//   NY): the Td rows above its local row 0 and below its last row, one
//   block per pass parity; two flag words; and its launch words (ticket
//   counter, error word, finished counter, sent counters). A pass of L <=
//   Td steps reads rows [Td - L, Td) of top and [0, L) of bot;
// - the CTAs of a launch take their roles by arrival, an atomicAdd ticket,
//   so the order is a fact and not a habit of the block scheduler. The
//   first kSenders tickets send: kSendersPerSide CTAs a direction copy the
//   shard's first L rows (all 9 planes, raw) into the upper neighbour's
//   bot[p] rows [0, L) and its last L rows into the lower neighbour's
//   top[p] rows [Td - L, Td) (p = pass mod 2), each CTA its share with
//   kRdmaSendBatch 16-byte vectors in flight a thread (in float32 at NY =
//   4000 and L = 3 a direction moves 432 KB, 3 times the one-step send).
//   Each sender fences at system scope and counts itself; the last of a
//   direction fences again and release-stores the pass number into that
//   neighbour's flag;
// - then every CTA, the senders too, walks the output tiles that the
//   launch's tile counter hands out (CounterTiles): first the interior
//   tiles, those whose source rows [r0 - L, r1 + L) lie inside the shard
//   (no comm row, no wait), then the edge tiles, those that read a halo
//   row. Before a CTA's first edge tile, thread 0 acquire-spins on the
//   shard's OWN two flag words until they hold the pass number
//   (wait_for_rows, bounded by %globaltimer) and a barrier follows; the
//   comm rows load by cp.async.cg (through L2, never the non-coherent L1
//   path: another kernel wrote them while this one ran). Handing the edge
//   tiles out last gives the neighbours' sends the whole interior to
//   arrive in, and a CTA that finishes early takes the next tile, so the
//   roles need no split of the CTAs;
// - the walk is pass_tiles' (lbm_temporal.cuh): one CTA of 512 threads an
//   SM, two tile buffers, the next tile's copies under the current tile's
//   levels, at the tile the launch plans (rdma_plan: plan_tiles over
//   rdma_grid_at);
// - the last CTA of the launch to finish zeroes the ticket, finished, sent
//   and tile counters, so that the next launch of the shard, stream-ordered
//   after this one, takes its tickets and tiles from 0 whatever its grid (a
//   pass of fewer steps lays other tiles).
// Reuse of the comm blocks needs no barrier, as in the one-step form: flags
// hold monotonic pass numbers, and a neighbour is at most one pass ahead
// (its pass t + 1 edges wait for this shard's pass t + 1 send, which is
// stream-ordered after this shard's whole pass t), so parity t mod 2 is
// overwritten (at pass t + 2) only after this shard read it at pass t. On
// expiry of a wait the CTA writes the pass into the shard's error word and
// skips its tiles; later launches skip their waits at once, and the session
// raises when it next blocks.
//
// Deadlock. Virtual shards put every shard's launch on one card, each on a
// stream of its own, and a CTA that spins holds its slot. A launch whose
// send CTAs have not started blocks only its neighbours' CTAs that reached
// an edge tile, and a launch's first CTAs to run are its senders. So the
// ring can hang only if spinning CTAs fill every co-resident slot while
// some launch has not started. Any CTA of a launch may spin, so the
// launcher takes at most (slots - 1) / card_shards CTAs a launch,
// card_shards being the ring's launches that share the card: all of them
// spinning at once hold at most slots - 1 of the slots, and a freed slot
// takes the next CTA of a launch that has not started, whose first ticket
// sends. At 800x4000 on 4 virtual shards of an H100 (132 slots of one CTA
// an SM) a launch takes 32 CTAs, 128 in all; on a card of its own, 131.
//
// What bounds it: the ext-halo temporal form's bytes and levels (its
// header, lbm_temporal_step.cu), plus 2 x 9 x L x NY values sent a shard
// and pass; the sends, the interior and the edges overlap inside one
// launch. Arithmetic: the local form's levels, so the kernel equals L
// chained fused_kernel.step_reference calls on the halo-extended block bit
// for bit (fused_kernel.temporal_reference_rdma over a ring), fast math
// within fused_kernel.FAST_MATH_RTOL.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "lbm_ext.cuh"
#include "lbm_temporal.cuh"

namespace {

// CTAs that send each direction, and the 16-byte vectors each thread keeps
// in flight
constexpr int kSendersPerSide = 4;
constexpr int kSenders = 2 * kSendersPerSide;
constexpr int kRdmaSendBatch = 8;
// a shard's launch words (int64 each): the ticket counter, the error word
// (the pass whose wait gave up), CTAs finished, senders done by direction,
// tiles handed out
constexpr int kTicket = 0;
constexpr int kError = 1;
constexpr int kFinished = 2;
constexpr int kSent = 3;  // kSent + 0: up, kSent + 1: down
constexpr int kTiles = 5;
constexpr int kWorkWords = 6;

// The rows of tiles of a pass of L steps on a shard of nx rows, output
// tiles of R rows laid from row 0: blocks [0, i0) read the top halo,
// [i1, nb) the bottom one, [i0, i1) only the shard's rows (block i reads
// rows [i R - L, min((i + 1) R, nx) + L)).
struct Blocks {
  int nb, i0, i1;
  __host__ __device__ Blocks(int nx, int R, int L) {
    nb = (nx + R - 1) / R;
    const int first = (L + R - 1) / R;
    i0 = first < nb ? first : nb;
    const int last = nx >= L ? (nx - L) / R : 0;  // blocks whose rows end by nx - L
    const int end = last < nb - 1 ? last : nb - 1;
    i1 = end > i0 ? end : i0;
  }
  __host__ __device__ int interior() const { return i1 - i0; }
  __host__ __device__ int edge() const { return nb - (i1 - i0); }
  // the e-th edge block
  __host__ __device__ int edge_block(int e) const { return e < i0 ? e : i1 + (e - i0); }
};

// A sender's share of one direction: `per` 16-byte vectors of each of the
// 9 planes, contiguous rows from `from` (planes `plane` apart) to `to`
// (planes to_plane apart); CTA `part` of kSendersPerSide.
template <typename T>
__device__ __forceinline__ void send_rows(const T* __restrict__ from, int64_t plane, T* to,
                                          int64_t to_plane, int per, int part) {
  const int total = 9 * per;
  const int stride = kShardThreads * kSendersPerSide;
  for (int v0 = part * kShardThreads + static_cast<int>(threadIdx.x); v0 < total;
       v0 += stride * kRdmaSendBatch) {
    uint4 buf[kRdmaSendBatch];
#pragma unroll
    for (int b = 0; b < kRdmaSendBatch; ++b) {
      const int v = v0 + b * stride;
      if (v < total) {
        const int s = v / per;
        buf[b] = __ldg(reinterpret_cast<const uint4*>(from + s * plane) + (v - s * per));
      }
    }
#pragma unroll
    for (int b = 0; b < kRdmaSendBatch; ++b) {
      const int v = v0 + b * stride;
      if (v < total) {
        const int s = v / per;
        reinterpret_cast<uint4*>(to + s * to_plane)[v - s * per] = buf[b];
      }
    }
  }
}

// A CTA's tiles as the launch's tile counter hands them out (every thread
// calls it together): counter value t < interior is the t-th interior tile
// (row blocks [i0, i1), tiles_y a block), t < interior + edge the (t -
// interior)-th edge tile (blocks [0, i0), then [i1, nb)); -1 when the
// counter has passed them all. Before its first edge tile, thread 0
// acquire-waits for both of the shard's flags (wait_for_rows); if the wait
// gives up, the CTA takes no edge tile. The barrier that publishes the
// tile also orders every thread's halo loads after thread 0's acquires.
// Two slots, used in turn: a slot is written again only after a barrier
// that every thread meets after reading it.
template <typename T>
struct CounterTiles {
  const Rdma<T>* r;
  int interior, total, i0, i1, tiles_y;
  int* slots;
  int n = 0;
  bool waited = false, arrived = false;
  __device__ __forceinline__ int operator()() {
    int* slot = slots + (n++ & 1);
    if (threadIdx.x == 0) {
      const int t = static_cast<int>(atomicAdd(r->work + kTiles, 1ULL));
      if (t >= interior && t < total && !waited) {
        waited = true;
        arrived = wait_for_rows(r->flags, r->work + kError, r->step, r->timeout_ns) &&
                  wait_for_rows(r->flags + 1, r->work + kError, r->step, r->timeout_ns);
      }
      int tile = -1;
      if (t < interior) {
        tile = i0 * tiles_y + t;
      } else if (t < total && arrived) {
        const int e = (t - interior) / tiles_y;
        tile = (e < i0 ? e : i1 + (e - i0)) * tiles_y + (t - interior - e * tiles_y);
      }
      *slot = tile;
    }
    __syncthreads();
    return *slot;
  }
};

// The send role of ticket u < kSenders: its share of one direction's rows,
// then the direction's flag from its last sender. Every thread of the CTA
// calls it and leaves it together.
template <typename T>
__device__ __forceinline__ void send_role(unsigned u, const T* __restrict__ src, int nx, int ny,
                                          int L, const TemporalHalo<T>& h, const Rdma<T>& r) {
  const int64_t plane = static_cast<int64_t>(nx) * ny;  // plane offsets in 64 bits
  const int side = static_cast<int>(u) / kSendersPerSide;  // 0: up, 1: down
  const int per = static_cast<int>(static_cast<int64_t>(L) * ny * sizeof(T) / 16);
  const T* from = src + (side == 0 ? 0 : static_cast<int64_t>(nx - L) * ny);
  T* to = side == 0 ? r.up_bot : r.down_top + static_cast<int64_t>(h.depth - L) * ny;
  send_rows<T>(from, plane, to, static_cast<int64_t>(h.depth) * ny, per,
               static_cast<int>(u) % kSendersPerSide);
  // this CTA's rows are visible system-wide before it counts itself
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(r.work + kSent + side, 1ULL) == kSendersPerSide - 1) {
    // the direction's last sender: every sender's fence precedes its
    // count, which this one has seen
    __threadfence_system();
    store_release_sys(side == 0 ? r.up_flag : r.down_flag, r.step);
  }
}

// A pass of L steps of a whole shard of nx rows src -> dst at the launch's
// planned tile of `rows` rows, its halo rows exchanged through h (its own
// comm rows of this parity) and r. Every CTA takes a ticket; the first
// kSenders send their share of the edge rows; then every CTA walks the
// tiles the launch's tile counter hands out (CounterTiles, pass_tiles).
template <typename T, int GEOM>
__global__ void __launch_bounds__(kShardThreads, 1)
lbm_temporal_steps_rdma(const T* __restrict__ src, T* __restrict__ dst,
                        const uint8_t* __restrict__ solid, Spec g, int nx, int ny, int rows, int L,
                        Params k, int fast_math, TemporalHalo<T> h, Rdma<T> r) {
  __shared__ unsigned ticket;
  __shared__ int slots[2];
  if (threadIdx.x == 0) ticket = static_cast<unsigned>(atomicAdd(r.work + kTicket, 1ULL));
  __syncthreads();
  if (ticket < kSenders) send_role<T>(ticket, src, nx, ny, L, h, r);
  const int C = kW - 2 * column_halo<T>(L);
  const int tiles_y = (ny + C - 1) / C;
  const Blocks b(nx, rows - 2 * L, L);
  const int interior = b.interior() * tiles_y;
  CounterTiles<T> next{&r, interior, interior + b.edge() * tiles_y, b.i0, b.i1, tiles_y, slots};
  pass_tiles<T, GEOM>(next, rows, nx, src, dst, solid, g, nx, ny, L, k, fast_math, h);
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(r.work + kFinished, 1ULL) == gridDim.x - 1) {
    // the launch's last CTA: every CTA took its ticket and its last tile,
    // and every sender counted itself; the next launch of the shard starts
    // from zero
    r.work[kTicket] = 0;
    r.work[kFinished] = 0;
    r.work[kSent] = 0;
    r.work[kSent + 1] = 0;
    r.work[kTiles] = 0;
  }
}

template <typename T, int GEOM>
cudaError_t tile_info(Info* out) {
  static Info cache[kMaxDevices];
  static bool known[kMaxDevices] = {};
  return card_info<T>(lbm_temporal_steps_rdma<T, GEOM>, cache, known, out, kShardThreads,
                      kShardBuffers);
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

// A launch's grid at output tiles of R rows: its interior and edge tiles
// and the CTAs it launches.
struct RdmaGrid {
  int64_t interior = 0, edge = 0, ctas = 0;
};

// The grid of a pass of L steps on a shard of nx rows at output tiles of R
// rows, on a card of `slots` co-resident CTAs that card_shards launches of
// the ring share: every CTA may spin, so a launch takes at most (slots -
// 1) / card_shards of them (the header's deadlock rule), and no more than
// its senders and tiles. False when the pass leaves no output tile, the
// tile count reaches 2^30, or the slots cannot hold the senders of
// card_shards launches with one to spare.
template <typename T>
bool rdma_grid_at(int R, int64_t nx, int64_t ny, int L, int64_t slots, int64_t card_shards,
                  RdmaGrid* out) {
  const int64_t C = kW - 2 * column_halo<T>(L);
  if (R < 1 || C < 1) return false;
  const int64_t tiles_y = (ny + C - 1) / C;
  const Blocks b(static_cast<int>(nx), R, L);
  if (static_cast<int64_t>(b.nb) * tiles_y >= (1LL << 30)) return false;
  const int64_t most = (slots - 1) / card_shards;
  if (most < kSenders) return false;
  RdmaGrid g;
  g.interior = b.interior() * tiles_y;
  g.edge = b.edge() * tiles_y;
  g.ctas = std::min<int64_t>(most, kSenders + g.interior + g.edge);
  *out = g;
  return true;
}

// The launch's plan (plan_tiles over rdma_grid_at: every CTA walks about
// tiles / ctas of them; tile_rows > 0: that tile) and its grid at the
// planned tile; false where no tile gives a launch.
template <typename T>
bool rdma_plan(const Info& info, int64_t nx, int64_t ny, int L, int64_t card_shards, Plan* plan,
               RdmaGrid* grid, int tile_rows = 0) {
  const int64_t slots = static_cast<int64_t>(info.per_sm) * info.sms;
  const auto lay = [&](int R, Plan* p) {
    RdmaGrid g;
    if (!rdma_grid_at<T>(R, nx, ny, L, slots, card_shards, &g)) return false;
    p->tiles = g.interior + g.edge;
    p->ctas = g.ctas;
    p->waves = (p->tiles + g.ctas - 1) / g.ctas;
    return true;
  };
  if (tile_rows > info.rows || !plan_tiles<T>(info.rows, L, lay, plan, tile_rows)) return false;
  return rdma_grid_at<T>(plan->rows - 2 * L, nx, ny, L, slots, card_shards, grid);
}

template <typename T, int GEOM>
int launch_rdma(const void* src, void* dst, const uint8_t* solid, const Spec& g, int nx, int ny,
                int L, const Params& k, int fast_math, const TemporalHalo<T>& h,
                const Rdma<T>& r, int64_t card_shards, int tile_rows, cudaStream_t st) {
  Info info;
  const cudaError_t err = tile_info<T, GEOM>(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  RdmaGrid grid;
  if (!rdma_plan<T>(info, nx, ny, L, card_shards, &plan, &grid, tile_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lbm_temporal_steps_rdma<T, GEOM><<<static_cast<unsigned>(grid.ctas), kShardThreads,
                                     static_cast<size_t>(info.smem), st>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), solid, g, nx, ny, plan.rows, L, k,
      fast_math, h, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* src, void* dst, void* top, void* bot, void* up_bot, void* down_top,
                 void* flags, void* up_flag, void* down_flag, void* work, const uint8_t* solid,
                 const void* solid_top, const void* solid_bot, const Spec& g, int64_t geometry,
                 int64_t nx, int64_t ny, int64_t depth, int64_t offset, int64_t gnx, int L,
                 const Params& k, int fast_math, int64_t pass, int64_t timeout_ns,
                 int64_t card_shards, int tile_rows, cudaStream_t st) {
  using U = unsigned long long;
  // this pass's parity of every comm block
  const int64_t p = (pass % 2) * 9 * depth * ny;
  const TemporalHalo<T> h{static_cast<const T*>(top) + p, static_cast<const T*>(bot) + p,
                          static_cast<const uint8_t*>(solid_top),
                          static_cast<const uint8_t*>(solid_bot), static_cast<int>(depth), 0,
                          static_cast<int>(nx), offset, gnx};
  const Rdma<T> r{static_cast<T*>(up_bot) + p, static_cast<T*>(down_top) + p,
                  static_cast<U*>(up_flag), static_cast<U*>(down_flag), static_cast<U*>(flags),
                  static_cast<U*>(work), static_cast<U>(pass), static_cast<U>(timeout_ns)};
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny)};
  switch (geometry) {
    case kPlane:
      return launch_rdma<T, kPlane>(src, dst, solid, g, n[0], n[1], L, k, fast_math, h, r,
                                    card_shards, tile_rows, st);
    case kSpec:
      return launch_rdma<T, kSpec>(src, dst, solid, g, n[0], n[1], L, k, fast_math, h, r,
                                   card_shards, tile_rows, st);
    default:
      return launch_rdma<T, kNone>(src, dst, solid, g, n[0], n[1], L, k, fast_math, h, r,
                                   card_shards, tile_rows, st);
  }
}

}  // namespace

// The number of int64 launch words an rdma end of this form holds.
extern "C" int64_t lbm_temporal_steps_rdma_words() { return kWorkWords; }

// One pass of `steps` steps of a whole shard src -> dst on `stream`, halo
// exchange included. src, dst: (9, nx, ny) as lbm_temporal_steps_launch's,
// nx >= steps. top, bot: this shard's comm blocks (2, 9, depth, ny) of src's
// storage (by pass parity: the rows above local row 0, the rows below local
// row nx - 1), written by the neighbours' launches of the same pass; up_bot,
// down_top: the blocks this launch writes (the upper neighbour's bot, the
// lower neighbour's top), all 16-byte aligned; up_flag, down_flag: the flag
// words it then sets to `pass` (the upper neighbour's bot flag, the lower
// neighbour's top flag). flags: this shard's own [top, bot] flag words;
// work: its lbm_temporal_steps_rdma_words() launch words; all uint64,
// zeroed together before pass 1, on memory this device can address (its
// own, or a peer's after lbm_enable_peer_access). pass counts 1, 2, ...
// since that reset; every shard of the ring must launch the same pass, each
// on a stream of its own, or the edge tiles wait timeout_ns and give up,
// leaving `pass` in work[1]. card_shards: the ring's launches that share
// this card (its virtual shards; 1 on a card of its own). solid,
// solid_top, solid_bot (the (depth, ny) class rows of the halo rows), spec,
// offset, gnx, storage, geometry, fast_math, steps (at most depth), params,
// tile_rows (0: the plan's tile, lbm_temporal_steps_rdma_grid) and the
// return as lbm_temporal_steps_ext_launch's.
extern "C" int lbm_temporal_steps_rdma_launch(
    const void* src, void* dst, void* top, void* bot, void* up_bot, void* down_top,
    void* flags, void* up_flag, void* down_flag, void* work, const void* solid,
    const void* solid_top, const void* solid_bot, const void* spec, int64_t nx, int64_t ny,
    int64_t depth, int64_t offset, int64_t gnx, int64_t storage, int64_t geometry,
    int64_t fast_math, int64_t steps, const void* params, int64_t pass, int64_t timeout_ns,
    int64_t card_shards, int64_t tile_rows, void* stream) {
  const bool plane = geometry == kPlane;
  const void* rows[] = {src, dst, top, bot, up_bot, down_top};
  for (const void* q : rows) {
    if (q == nullptr || misaligned(q)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (src == dst || nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) || storage < 0 ||
      storage > 1 || ny % (storage == 1 ? vec_columns<__nv_bfloat16>() : vec_columns<float>()) ||
      geometry < kNone || geometry > kSpec ||
      (plane && (solid == nullptr || solid_top == nullptr || solid_bot == nullptr ||
                 misaligned(solid) || misaligned(solid_top) || misaligned(solid_bot))) ||
      (geometry == kSpec && spec == nullptr) || steps < 1 || steps > 64 || params == nullptr ||
      depth < steps || depth >= (1LL << 30) || nx < steps || offset < 0 || gnx >= (1LL << 62) ||
      offset + nx > gnx || pass < 1 || timeout_ns < 0 || card_shards < 1 || flags == nullptr ||
      up_flag == nullptr || down_flag == nullptr || work == nullptr || tile_rows < 0 ||
      tile_rows >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  const Spec g = spec_from(spec, geometry);
  const uint8_t* w = plane ? static_cast<const uint8_t*>(solid) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = static_cast<int>(steps);
  const int fast = fast_math != 0;
  if (storage == 1) {
    return launch_typed<__nv_bfloat16>(src, dst, top, bot, up_bot, down_top, flags, up_flag,
                                       down_flag, work, w, solid_top, solid_bot, g, geometry, nx,
                                       ny, depth, offset, gnx, L, k, fast, pass, timeout_ns,
                                       card_shards, static_cast<int>(tile_rows), st);
  }
  return launch_typed<float>(src, dst, top, bot, up_bot, down_top, flags, up_flag, down_flag,
                             work, w, solid_top, solid_bot, g, geometry, nx, ny, depth, offset,
                             gnx, L, k, fast, pass, timeout_ns, card_shards,
                             static_cast<int>(tile_rows), st);
}

// lbm_temporal_steps_info for the rdma form: the same eight values, the
// card's largest tile (a launch plans its own, lbm_temporal_steps_rdma_grid).
extern "C" int lbm_temporal_steps_rdma_info(int64_t storage, int64_t geometry, int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1 || geometry < kNone || geometry > kSpec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = storage == 1 ? info_geometry<__nv_bfloat16>(geometry, &info)
                                       : info_geometry<float>(geometry, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  info_values(info, out);
  return 0;
}

// The grid of a pass at its plan: out[0] the CTAs launched (every one of
// which may spin), out[1] interior tiles, out[2] edge tiles, out[3] the
// tile's rows (halos included), out[4] the tiles a CTA walks at most if
// the tiles spread evenly, for a shard of nx rows on the current card; the
// arguments as the launch's. Returns 0, or cudaErrorInvalidValue where the
// launch would be refused.
extern "C" int lbm_temporal_steps_rdma_grid(int64_t storage, int64_t geometry, int64_t nx,
                                            int64_t ny, int64_t steps, int64_t card_shards,
                                            int64_t tile_rows, int64_t* out) {
  if (out == nullptr || storage < 0 || storage > 1 || geometry < kNone || geometry > kSpec ||
      nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) || steps < 1 || steps > 64 ||
      card_shards < 1 || tile_rows < 0 || tile_rows >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Info info;
  const cudaError_t err = storage == 1 ? info_geometry<__nv_bfloat16>(geometry, &info)
                                       : info_geometry<float>(geometry, &info);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  RdmaGrid grid;
  const int L = static_cast<int>(steps);
  const int t = static_cast<int>(tile_rows);
  const bool ok = storage == 1
                      ? rdma_plan<__nv_bfloat16>(info, nx, ny, L, card_shards, &plan, &grid, t)
                      : rdma_plan<float>(info, nx, ny, L, card_shards, &plan, &grid, t);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = grid.ctas;
  out[1] = grid.interior;
  out[2] = grid.edge;
  out[3] = plan.rows;
  out[4] = plan.waves;
  return 0;
}
