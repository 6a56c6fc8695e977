// One fused D2Q9 lattice-Boltzmann step for Hopper (sm_90a): channel
// forcing, periodic pull stream, BGK collision and the solid classes
// (bounce-back, free-slip reflections).
//
// Replaces latticeboltzmann_tpu/ops/fused_kernel.py::_make_kernel as
// launched by make_step's pl.pallas_call (ops/fused_kernel.py:1757), in
// its single-chip variants, one time step per launch (T=1). Two template
// axes select the variant at compile time:
// - the storage type T: float, or __nv_bfloat16 with float arithmetic
//   (the TPU kernel's bf16 storage, :277-280, :420-422, window cast to f32
//   at :1194-1203);
// - the geometry source GEOM: none (wall_mode=False), a uint8 class plane
//   (0 fluid, 1 bounce-back, 2 slip_x, 3 slip_y; :1062-1090 and
//   class_plane :1879), or a closed-form wall spec evaluated from the site
//   indices (:1220-1269), which reads no plane at all.
// fast_math (an approximate 1/rho, :1028-1036) is a uniform run-time flag.
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
// Arithmetic keeps the TPU kernel's association order (moments from the
// d56/d78/d58/d67 partial sums, the base/q +- eu pairs,
// ops/fused_kernel.py:1020-1105) with host-rounded constants; built with
// -fmad=false and IEEE division it rounds exactly like the plain PyTorch
// version (ops/fused_kernel.py::step_reference in the port). bf16 loads
// are exact (__bfloat162float); the forced column stays float through the
// pull, and each result is rounded once, to nearest even
// (__float2bfloat16_rn, as PyTorch's .to(torch.bfloat16)).
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

// A closed-form wall spec (core/geometry.py): at most one of each
// primitive, in fused_kernel.kernel_spec's order. Solid where any
// present primitive holds.
struct Spec {
  int64_t channel;  // rows 0 and nx - 1
  int64_t rect;     // rows [r0, r1) x columns [c0, c1)
  int64_t r0, r1, c0, c1;
  int64_t circle;   // (2i - ci2)^2 + (2j - cj2)^2 <= r2q
  int64_t ci2, cj2, r2q;
};

enum Geometry : int { kNone = 0, kPlane = 1, kSpec = 2 };

constexpr int kBlock = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// geometry.spec_mask at one site, in 64-bit integers (the wrapper refuses
// a circle whose test could overflow them)
__device__ __forceinline__ bool spec_solid(const Spec& g, int64_t i, int64_t j,
                                           int64_t nx) {
  bool w = false;
  if (g.channel) w = w || i == 0 || i == nx - 1;
  if (g.rect) w = w || (i >= g.r0 && i < g.r1 && j >= g.c0 && j < g.c1);
  if (g.circle) {
    const int64_t di = 2 * i - g.ci2;
    const int64_t dj = 2 * j - g.cj2;
    w = w || di * di + dj * dj <= g.r2q;
  }
  return w;
}

// solid class of site (i, j): 0 fluid, 1 bounce-back, 2 slip_x, 3 slip_y
template <int GEOM>
__device__ __forceinline__ int solid_class(const uint8_t* __restrict__ solid,
                                           const Spec& g, int64_t i, int64_t j,
                                           int64_t nx, int64_t ny) {
  if (GEOM == kPlane) return solid[i * ny + j];
  if (GEOM == kSpec) return spec_solid(g, i, j, nx) ? 1 : 0;
  return 0;
}

// Forcing guard of the column-0 site in row `row`: fluid, and f6, f3, f7
// all stay above their decrements (src/latticeboltzmann.c:500-513).
template <typename T, int GEOM>
__device__ __forceinline__ bool forced_at(const T* __restrict__ src,
                                          const uint8_t* __restrict__ solid,
                                          const Spec& g, int64_t row,
                                          int64_t nx, int64_t ny,
                                          int64_t plane, const Params& k) {
  if (solid_class<GEOM>(solid, g, row, 0, nx, ny) != 0) return false;
  const int64_t site = row * ny;  // column 0
  return (load(src + 6 * plane + site) - k.a58 > 0.0f) &&
         (load(src + 3 * plane + site) - k.a14 > 0.0f) &&
         (load(src + 7 * plane + site) - k.a58 > 0.0f);
}

__device__ __forceinline__ float approx_reciprocal(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T, int GEOM>
__global__ void __launch_bounds__(kBlock)
lbm_stream_collide(const T* __restrict__ src, T* __restrict__ dst,
                   const uint8_t* __restrict__ solid, Spec g, int64_t nx,
                   int64_t ny, Params k, int fast_math) {
  // e_s = (e_x, e_y), the opposite and the two mirrored speeds, and the
  // forcing increment sign (+1 speeds gain, -1 speeds lose), as in
  // core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int REFLECT_X[9] = {0, 1, 4, 3, 2, 8, 7, 6, 5};
  constexpr int REFLECT_Y[9] = {0, 3, 2, 1, 4, 6, 5, 8, 7};
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

  // moments from shared partial sums
  const float d56 = p[5] + p[6];
  const float d78 = p[7] + p[8];
  const float d58 = p[5] + p[8];
  const float d67 = p[6] + p[7];
  const float density = (p[0] + (p[1] + p[3])) + ((p[2] + p[4]) + (d56 + d78));
  const float inv_rho = fast_math ? approx_reciprocal(density) : 1.0f / density;
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

  // solid classes: bounce-back (OPP[0] == 0 passes the site's own f0
  // through) and the specular reflections of free-slip walls
  const int cls = solid_class<GEOM>(solid, g, i, j, nx, ny);
  if (cls == 1) {
#pragma unroll
    for (int s = 0; s < 9; ++s) out[s] = p[OPP[s]];
  } else if (GEOM == kPlane && cls == 2) {
#pragma unroll
    for (int s = 0; s < 9; ++s) out[s] = p[REFLECT_X[s]];
  } else if (GEOM == kPlane && cls == 3) {
#pragma unroll
    for (int s = 0; s < 9; ++s) out[s] = p[REFLECT_Y[s]];
  }

  const int64_t site = static_cast<int64_t>(i) * ny + j;
#pragma unroll
  for (int s = 0; s < 9; ++s) store(dst + s * plane + site, out[s]);
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
  // grid.x = rows (at most 2^31 - 1), grid.y = column tiles (at most
  // 65535); the kernel's 32-bit index arithmetic needs nx, ny < 2^30
  if (nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
      (ny + kBlock - 1) / kBlock > 65535LL || storage < 0 || storage > 1 ||
      geometry < kNone || geometry > kSpec ||
      (geometry == kPlane && solid == nullptr) ||
      (geometry == kSpec && spec == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* h = static_cast<const float*>(params);
  const Params k{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8]};
  Spec g{};
  if (geometry == kSpec) {
    const int64_t* v = static_cast<const int64_t*>(spec);
    g = Spec{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9]};
  }
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
