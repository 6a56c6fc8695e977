// One fused D2Q9 lattice-Boltzmann step for Hopper (sm_90a): channel
// forcing, periodic pull stream, BGK collision and bounce-back.
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757), in
// its float32 wall-free (wall_mode=False) and masked variants, one time
// step per launch. HAS_WALLS selects the variant at compile time.
//
// Bound: device-memory bytes. A site update reads 9 f values and writes 9
// (4 B each), plus 1 B of mask in the masked variant: 72-73 B against the
// reference's 124 FLOP, about 1.7 FLOP/B, far below the card's f32
// balance point. The design serves that bound: one thread per site,
// threads along y (the contiguous axis), so each plane's loads and stores
// of a warp coalesce; the pulls from rows i-1 and i+1 re-read lines that
// the neighbouring row blocks read too, and L1/L2 serve those repeats, so
// device memory sees each byte about once per step. The step is out of
// place (src != dst): the pull never reads the buffer it writes.
//
// Not carried over from the TPU kernel: the mirror-pad lanes (the y wrap
// is an index wrap here), the rotating VMEM slots, temporal blocking and
// the launch partitioner.
//
// Forcing: the TPU kernel forces column 0 of its staged window before the
// pull. A one-thread-per-site kernel cannot, so each forced speed whose
// source site lies in column 0 re-evaluates the forcing guard at that
// source site. Every forced speed (1, 3, 5, 6, 7, 8) has e_y != 0, so only
// destination columns 1 and NY-1 ever take this branch.
//
// Arithmetic keeps the TPU kernel's association order (moments from the
// d56/d78/d58/d67 partial sums, the base/q +- eu pairs,
// ops/fused_kernel.py:1020-1105) with host-rounded constants; built with
// -fmad=false and IEEE division it rounds exactly like the plain PyTorch
// version (ops/fused_kernel.py::step_reference in the port).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Launch constants, float32, rounded on the host in this order by
// fused_kernel.kernel_constants.
struct Params {
  float c1;    // 1 - 1/tau
  float iw0;   // w0/tau
  float iw14;  // w1/tau
  float iw58;  // w5/tau
  float k3;    // 3/c^2
  float k6;    // c^2/6
  float half;  // 0.5
  float a14;   // accel * w1
  float a58;   // accel * w5
};

constexpr int kBlock = 256;

// Forcing guard of the column-0 site in row `row`: fluid, and f6, f3, f7
// all stay above their decrements (src/latticeboltzmann.c:500-513).
template <bool HAS_WALLS>
__device__ __forceinline__ bool forced_at(const float* __restrict__ src,
                                          const uint8_t* __restrict__ solid,
                                          int64_t row, int64_t ny,
                                          int64_t plane, const Params& k) {
  const int64_t site = row * ny;  // column 0
  if (HAS_WALLS && solid[site] != 0) return false;
  return (src[6 * plane + site] - k.a58 > 0.0f) &&
         (src[3 * plane + site] - k.a14 > 0.0f) &&
         (src[7 * plane + site] - k.a58 > 0.0f);
}

template <bool HAS_WALLS>
__global__ void __launch_bounds__(kBlock)
lbm_stream_collide_f32(const float* __restrict__ src, float* __restrict__ dst,
                       const uint8_t* __restrict__ solid, int64_t nx,
                       int64_t ny, Params k) {
  // e_s = (e_x, e_y), the opposite speed, and the forcing increment sign
  // (+1 speeds gain, -1 speeds lose), as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
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
    float v = src[s * plane + si * ny + sj];
    if (FORCE[s] != 0 && sj == 0 &&
        forced_at<HAS_WALLS>(src, solid, si, ny, plane, k)) {
      const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
      v = v + (FORCE[s] > 0 ? a : -a);
    }
    p[s] = v;
  }

  // moments from shared partial sums
  const float d56 = p[5] + p[6];
  const float d78 = p[7] + p[8];
  const float d58 = p[5] + p[8];
  const float d67 = p[6] + p[7];
  const float density = (p[0] + (p[1] + p[3])) + ((p[2] + p[4]) + (d56 + d78));
  const float inv_rho = 1.0f / density;
  const float u_x = ((p[2] - p[4]) + (d56 - d78)) * inv_rho;
  const float u_y = ((p[1] - p[3]) + (d58 - d67)) * inv_rho;
  const float ux3 = k.k3 * u_x;
  const float uy3 = k.k3 * u_y;
  const float base = 1.0f - k.k6 * (ux3 * ux3 + uy3 * uy3);

  // relaxation folded into the weights, quadratic part shared per pair
  const float r0 = k.iw0 * density;
  const float r14 = k.iw14 * density;
  const float r58 = k.iw58 * density;
  float out[9];
  out[0] = k.c1 * p[0] + r0 * base;
  const int SP[4] = {1, 2, 5, 6};
  const int SN[4] = {3, 4, 7, 8};
  const float EU[4] = {uy3, ux3, ux3 + uy3, ux3 - uy3};
  const float R[4] = {r14, r14, r58, r58};
#pragma unroll
  for (int q_i = 0; q_i < 4; ++q_i) {
    const float eu = EU[q_i];
    const float q = base + k.half * eu * eu;
    out[SP[q_i]] = k.c1 * p[SP[q_i]] + R[q_i] * (q + eu);
    out[SN[q_i]] = k.c1 * p[SN[q_i]] + R[q_i] * (q - eu);
  }

  const int64_t site = static_cast<int64_t>(i) * ny + j;
  if (HAS_WALLS && solid[site] != 0) {
    // bounce-back; OPP[0] == 0 passes the site's own f0 through
#pragma unroll
    for (int s = 0; s < 9; ++s) out[s] = p[OPP[s]];
  }
#pragma unroll
  for (int s = 0; s < 9; ++s) dst[s * plane + site] = out[s];
}

}  // namespace

// One step src -> dst on `stream`. src, dst: (9, nx, ny) float32, device,
// contiguous, distinct. solid: (nx, ny) uint8 codes 0 fluid / 1
// bounce-back (read only when has_walls != 0). params: 9 host floats in
// Params order. Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_f32_launch(const void* src, void* dst,
                                             const void* solid, int64_t nx,
                                             int64_t ny, int64_t has_walls,
                                             const void* params,
                                             void* stream) {
  // grid.x = rows (at most 2^31 - 1), grid.y = column tiles (at most
  // 65535); the kernel's 32-bit index arithmetic needs nx, ny < 2^30
  if (nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
      (ny + kBlock - 1) / kBlock > 65535LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* h = static_cast<const float*>(params);
  const Params k{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8]};
  const dim3 grid(static_cast<unsigned>(nx),
                  static_cast<unsigned>((ny + kBlock - 1) / kBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  if (has_walls) {
    lbm_stream_collide_f32<true><<<grid, kBlock, 0, st>>>(s, d, w, nx, ny, k);
  } else {
    lbm_stream_collide_f32<false><<<grid, kBlock, 0, st>>>(s, d, w, nx, ny, k);
  }
  return static_cast<int>(cudaGetLastError());
}
