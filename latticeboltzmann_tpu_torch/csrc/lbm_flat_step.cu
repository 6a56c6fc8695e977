// The flat multi-step kernel for Hopper (sm_90a): n_steps wall-free D2Q9
// lattice-Boltzmann steps (channel forcing with the all-or-nothing guard,
// periodic pull, BGK collision) in ONE launch over a stacked ping-pong
// pair.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::make_flat_step's
// pl.pallas_call (ops/fused_kernel.py:1845; _make_kernel(multipass=P),
// :212-232, guards :387-404): P passes of T steps per launch over a
// stacked (2, 9, NX, NYP) buffer, in place, the final state back at
// parity 0. Here P * T is one run-time count, n_steps (even): step s reads
// parity s % 2 and writes the other. The TPU kernel's block rows, rotating
// slots, mirror pads, refresh phase and cross-pass VMEM carry are staging
// and have no counterpart.
//
// The Hopper form is a persistent cooperative kernel: a grid no larger
// than what is co-resident on the card (occupancy x SM count), every CTA
// walking the lattice's (row, 256-column tile) items in a grid-stride
// loop, and cooperative_groups' grid-wide sync between steps, which also
// orders one step's stores before the next step's loads (the buffers are
// neither const nor __restrict__ here, so no load takes the non-coherent
// path). The launch goes through cudaLaunchCooperativeKernel: a grid the
// card cannot hold at once is refused with an error code, which the
// wrapper raises on; it never hangs in grid.sync().
//
// A site's update is the single-chip kernel's (lbm_step.cu), with the same
// indexing per item, the same forcing re-evaluated at column-0 source
// sites of the SOURCE parity, and the shared collision of lbm_collide.cuh,
// so with -fmad=false it rounds exactly like n_steps chained steps of the
// plain PyTorch version (fused_kernel.flat_reference in the port): float32
// bitwise; bf16 storage rounds to nearest even after every step, as every
// bf16 path of the port does. fast_math (rcp.approx.f32) has no bitwise
// reference.
//
// Bound: device-memory bytes once the two parities outgrow the 50 MB L2
// (72 B per site and step in float32, 36 B in bf16, as the step kernel);
// a pair that fits L2 (2 x 9 x NX x NY x sizeof(T) under 50 MB) can run
// under that bound, since a step's source was the previous step's
// destination. What the one launch saves is the launch boundary between
// steps; what it adds is a grid-wide barrier per step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_collide.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
// CTAs per SM the kernel is compiled for. The step loop and the item loop
// keep more values live than one step per launch does: without a bound
// ptxas takes 52 registers, so only 4 CTAs fit an SM; a bound of 5 gives 48
// registers without spills; bounds of 6 and 8 spill. The kernel's time
// follows the CTAs per SM it runs on (the anatomy script's flat section
// shows it at 1, 2, 4 and 5).
constexpr int kMinBlocksPerSM = 5;

// Forcing guard of the column-0 site in row `row` of a wall-free lattice:
// f6, f3, f7 all stay above their decrements.
template <typename T>
__device__ __forceinline__ bool forced_free(const T* src, int64_t row, int64_t ny,
                                            int64_t plane, const Params& k) {
  const int64_t site = row * ny;  // column 0
  return (load(src + 6 * plane + site) - k.a58 > 0.0f) &&
         (load(src + 3 * plane + site) - k.a14 > 0.0f) &&
         (load(src + 7 * plane + site) - k.a58 > 0.0f);
}

// f2: (2, 9, nx, ny). tiles: 256-column tiles per row; items: nx * tiles.
template <typename T>
__global__ void __launch_bounds__(kBlock, kMinBlocksPerSM)
lbm_flat_steps(T* f2, int64_t nx, int64_t ny, int tiles, int items, Params k,
               int fast_math, int n_steps) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};

  cg::grid_group grid = cg::this_grid();
  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  const int64_t plane = nx * ny;  // plane offsets in 64 bits
  const int64_t buffer = 9 * plane;

  for (int step = 0; step < n_steps; ++step) {
    const T* src = f2 + static_cast<int64_t>(step & 1) * buffer;
    T* dst = f2 + static_cast<int64_t>((step & 1) ^ 1) * buffer;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int i = item / tiles;
      const int j = (item - i * tiles) * kBlock + threadIdx.x;
      if (j >= nyi) continue;
      // source rows i - e_x and columns j - e_y, indexed by e + 1
      const int rows[3] = {(i + 1) % nxi, i, (i - 1 + nxi) % nxi};
      const int cols[3] = {(j + 1) % nyi, j, (j - 1 + nyi) % nyi};
      float p[9];
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const int64_t si = rows[EX[s] + 1];
        const int64_t sj = cols[EY[s] + 1];
        float v = load(src + s * plane + si * ny + sj);
        if (FORCE[s] != 0 && sj == 0 && forced_free<T>(src, si, ny, plane, k)) {
          const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
          v = v + (FORCE[s] > 0 ? a : -a);
        }
        p[s] = v;
      }
      collide_store<T, kNone>(p, [] { return 0; }, dst, plane,
                              static_cast<int64_t>(i) * ny + j, k, fast_math);
    }
    // every store of this step before any load of the next
    if (step + 1 < n_steps) grid.sync();
  }
}

template <typename T>
int launch_flat(void* f2, int64_t nx, int64_t ny, const Params& k, int fast_math,
                int n_steps, int64_t blocks, cudaStream_t st) {
  int device = 0, cooperative = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lbm_flat_steps<T>, kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);

  int tiles = static_cast<int>((ny + kBlock - 1) / kBlock);
  int items = static_cast<int>(nx) * tiles;
  // the co-resident grid, no larger than the work; an explicit count is
  // taken as it is, and the cooperative launch refuses one too large
  int64_t n_blocks = blocks > 0 ? blocks : static_cast<int64_t>(per_sm) * sms;
  if (blocks <= 0 && n_blocks > items) n_blocks = items;
  if (n_blocks < 1 || n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  T* f = static_cast<T*>(f2);
  int fast = fast_math;
  int steps = n_steps;
  Params kk = k;
  void* args[] = {&f, &nx, &ny, &tiles, &items, &kk, &fast, &steps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lbm_flat_steps<T>),
                                    dim3(static_cast<unsigned>(n_blocks)), dim3(kBlock),
                                    args, 0, st);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error: it is returned, not left behind
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_steps wall-free steps in one cooperative launch on `stream`. f2: (2, 9,
// nx, ny), device, contiguous, float32 (storage 0) or bf16 (storage 1),
// the live state at parity 0; updated in place, the result at parity 0
// (parity 1 holds the state one step earlier). n_steps even and >= 2.
// blocks: 0 sizes the grid to what is co-resident; a positive count is
// launched as given (a count the card cannot hold at once is refused).
// params: 9 host floats in Params order. Returns 0, or the CUDA error of
// the refused launch.
extern "C" int lbm_flat_steps_launch(void* f2, int64_t nx, int64_t ny, int64_t storage,
                                     int64_t fast_math, int64_t n_steps, int64_t blocks,
                                     const void* params, void* stream) {
  // 32-bit item arithmetic: nx * tiles and every row and column under 2^30
  if (f2 == nullptr || nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
      nx * ((ny + kBlock - 1) / kBlock) >= (1LL << 30) || storage < 0 || storage > 1 ||
      n_steps < 2 || n_steps % 2 != 0 || n_steps >= (1LL << 30) || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k = params_from(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fast = fast_math != 0;
  const int steps = static_cast<int>(n_steps);
  if (storage == 1) {
    return launch_flat<__nv_bfloat16>(f2, nx, ny, k, fast, steps, blocks, st);
  }
  return launch_flat<float>(f2, nx, ny, k, fast, steps, blocks, st);
}
