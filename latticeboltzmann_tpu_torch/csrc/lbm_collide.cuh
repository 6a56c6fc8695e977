// What the stream-collide kernels share: the launch constants, the
// storage loads and stores, the geometry sources (class plane, wall spec)
// with the forcing guard, and what follows the pull (moments, BGK
// relaxation, the solid classes, the store). Included by lbm_step.cu (one
// step per launch, one site per thread: single-chip, ext-halo and rdma
// forms), lbm_wide_step.cu (the single-chip form with several columns per
// thread), lbm_flat_step.cu (many wall-free steps per launch) and
// lbm_temporal_step.cu (a pass of several steps with walls). Each
// kernel keeps its own indexing and pull: only what a site's values go
// through is shared, so that a change to one kernel's addressing cannot
// cost another its registers.
//
// Arithmetic keeps the TPU kernel's association order (moments from the
// d56/d78/d58/d67 partial sums, the base/q +- eu pairs,
// latticeboltzmann_tpu/ops/fused_kernel.py:1020-1105) with host-rounded
// constants; built with -fmad=false and IEEE division it rounds exactly
// like the plain PyTorch version (fused_kernel.collide_reference in the
// port).

#pragma once

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

enum Geometry : int { kNone = 0, kPlane = 1, kSpec = 2 };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float approx_reciprocal(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

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

// What follows the pull: moments, BGK relaxation and the site's solid
// class, from its pulled values p into out. site_class() gives the class;
// it is called after the relaxation, where the single-chip kernel always
// evaluated it: an evaluation before the pull's guard branches kept the
// spec variant's 64-bit class arithmetic live across them (40 and 46
// registers against 32 and 30, the bf16 step 28% slower on an H100).
template <int GEOM, typename SiteClass>
__device__ __forceinline__ void collide(const float (&p)[9], SiteClass site_class,
                                        const Params& k, int fast_math, float (&out)[9]) {
  // the opposite and the two mirrored speeds, as in core/spec.py
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int REFLECT_X[9] = {0, 1, 4, 3, 2, 8, 7, 6, 5};
  constexpr int REFLECT_Y[9] = {0, 3, 2, 1, 4, 6, 5, 8, 7};

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
  const int cls = site_class();
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
}

// collide, stored at offset `site` of each of dst's planes: the kernels
// that own one site per thread.
template <typename T, int GEOM, typename SiteClass>
__device__ __forceinline__ void collide_store(const float (&p)[9], SiteClass site_class,
                                              T* __restrict__ dst, int64_t plane,
                                              int64_t site, const Params& k,
                                              int fast_math) {
  float out[9];
  collide<GEOM>(p, site_class, k, fast_math, out);
#pragma unroll
  for (int s = 0; s < 9; ++s) store(dst + s * plane + site, out[s]);
}

// The launch constants from their 9 host floats.
inline Params params_from(const void* params) {
  const float* h = static_cast<const float*>(params);
  return Params{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8]};
}

// The wall spec from its 10 host int64 (geometry 2), else an empty one.
inline Spec spec_from(const void* spec, int64_t geometry) {
  if (geometry != kSpec) return Spec{};
  const int64_t* v = static_cast<const int64_t*>(spec);
  return Spec{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9]};
}

}  // namespace
