// One fused D2Q9 lattice-Boltzmann step in double-single (f32-pair)
// arithmetic for Hopper (sm_90a): channel forcing at pair precision,
// periodic pull stream, BGK collision at pair precision and bounce-back.
//
// Replaces latticeboltzmann_tpu/ops/fused_ds_kernel.py::_make_ds_pass as
// launched by its pl.pallas_call (ops/fused_ds_kernel.py:272), in its local
// (non-sharded) form, one time step per launch. Template parameters:
// HAS_WALLS selects the masked or wall-free variant, EXACT the collision
// tier: ds_engine.collide_planes (exact, ~2.6k f32 ops per site) or
// ds_engine.collide_planes_fast (fast, ~1.1k ops, the default).
//
// Bound: a site update moves 145 B (9 hi and 9 lo floats read and written,
// plus the mask byte) against ~1.1k (fast) or ~2.6k (exact) f32 ops, about
// 8 or 18 ops per byte. With FMA unavailable by construction (below), the
// card's non-FMA f32 rate and its memory bandwidth are about balanced for
// the fast tier, and the exact tier leans to compute (on an H100 80GB
// HBM3 at 700 W, 800x4000: fast ~211 us/step, exact ~275 us/step, against
// a ~160 us byte bound; see PERF.md). The design is therefore the plain
// one of lbm_step.cu: one thread per site, threads
// along y (the contiguous axis), so each plane's loads and stores of a
// warp coalesce; hi and lo are two separate (9, NX, NY) planes (the JAX
// DS layout), so both components' loads coalesce too. The step is out of
// place: the pull never reads the buffers it writes.
//
// One rounding per op is the whole contract. Every error-free transform
// (two_sum, quick_two_sum, split, two_prod) silently collapses to f32
// accuracy if a mul+add is contracted to an FMA or an expression is
// reassociated. So every f32 op of the pair arithmetic is an _rn
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which the
// compiler never fuses or reorders, whatever -fmad says; and the build
// never uses --use_fast_math. The op order is ops/df64.py's, op for op, so
// the kernel equals the plain PyTorch version (fused_ds_kernel
// .step_reference in the port) bit for bit.
//
// Not carried over from the TPU kernel: the mirror-pad lanes (the y wrap
// is an index wrap here), row blocks and halo rows, pad re-mirroring and
// temporal blocking.
//
// Forcing: the TPU kernel forces column 0 of its window before the pull.
// Here each forced speed whose source site lies in column 0 re-evaluates
// the pair guard at that source site (6 extra loads: f6, f3, f7, both
// components). Every forced speed has e_y != 0, so only destination
// columns 1 and NY-1 take this branch. The forcing uses the full pair add
// and sub (not the fast tier's add_s), as the TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxParams = 30;

// Launch constants, float32, split on the host from float64 by
// fused_ds_kernel.kernel_constants_ds. Fast tier (30 floats): the
// split_const quads (hi, lo, hh, hl) of c1, iw0, iw14, iw58, c3, csixth,
// then the pairs one, a14, a58. Exact tier (20 floats): the pairs one,
// itau, c3, c45, c15, w0, w14, w58, a14, a58.
struct Params {
  float v[kMaxParams];
};

struct ds {
  float hi, lo;
};

// A constant presplit for mul_c: (hi, lo, hh, hl).
struct quad {
  float hi, lo, hh, hl;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// --- error-free transforms (ops/df64.py) ----------------------------------

// Knuth TwoSum: s + e == a + b exactly.
__device__ __forceinline__ ds two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float v = fsub(s, a);
  return {s, fadd(fsub(a, fsub(s, v)), fsub(b, v))};
}

// Dekker FastTwoSum: requires |a| >= |b| (or a == 0).
__device__ __forceinline__ ds quick_two_sum(float a, float b) {
  const float s = fadd(a, b);
  return {s, fsub(b, fsub(s, a))};
}

// Dekker split by 2^12 + 1 into two 12-bit halves.
__device__ __forceinline__ ds split(float a) {
  const float t = fmul(a, 4097.0f);
  const float hi = fsub(t, fsub(t, a));
  return {hi, fsub(a, hi)};
}

// Dekker TwoProd: p + e == a * b exactly, without FMA.
__device__ __forceinline__ ds two_prod(float a, float b) {
  const float p = fmul(a, b);
  const ds as = split(a);
  const ds bs = split(b);
  const float e = fadd(
      fadd(fadd(fsub(fmul(as.hi, bs.hi), p), fmul(as.hi, bs.lo)), fmul(as.lo, bs.hi)),
      fmul(as.lo, bs.lo));
  return {p, e};
}

// --- pair arithmetic ------------------------------------------------------

__device__ __forceinline__ ds neg(ds a) { return {-a.hi, -a.lo}; }

__device__ __forceinline__ ds add(ds a, ds b) {
  const ds s = two_sum(a.hi, b.hi);
  const ds t = two_sum(a.lo, b.lo);
  const ds r = quick_two_sum(s.hi, fadd(s.lo, t.hi));
  return quick_two_sum(r.hi, fadd(r.lo, t.lo));
}

__device__ __forceinline__ ds sub(ds a, ds b) { return add(a, neg(b)); }

__device__ __forceinline__ ds add_f(ds a, float b) {
  const ds s = two_sum(a.hi, b);
  return quick_two_sum(s.hi, fadd(s.lo, a.lo));
}

__device__ __forceinline__ ds mul(ds a, ds b) {
  const ds p = two_prod(a.hi, b.hi);
  return quick_two_sum(p.hi, fadd(p.lo, fadd(fmul(a.hi, b.lo), fmul(a.lo, b.hi))));
}

__device__ __forceinline__ ds mul_f(ds a, float b) {
  const ds p = two_prod(a.hi, b);
  return quick_two_sum(p.hi, fadd(p.lo, fmul(a.lo, b)));
}

__device__ __forceinline__ ds recip(ds b, ds one) {
  const float q1 = fdiv(one.hi, b.hi);
  ds r = sub(one, mul_f(b, q1));
  const float q2 = fdiv(r.hi, b.hi);
  r = sub(r, mul_f(b, q2));
  const float q3 = fdiv(r.hi, b.hi);
  return add_f(quick_two_sum(q1, q2), q3);
}

// fast-tier variants
__device__ __forceinline__ ds add_s(ds a, ds b) {
  const ds s = two_sum(a.hi, b.hi);
  return quick_two_sum(s.hi, fadd(fadd(s.lo, a.lo), b.lo));
}

__device__ __forceinline__ ds sub_s(ds a, ds b) { return add_s(a, neg(b)); }

template <int N>
__device__ __forceinline__ ds acc(const ds (&t)[N]) {
  float s = t[0].hi;
  float e = t[0].lo;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const ds r = two_sum(s, t[k].hi);
    s = r.hi;
    e = fadd(e, fadd(r.lo, t[k].lo));
  }
  return quick_two_sum(s, e);
}

__device__ __forceinline__ ds mul_nr(ds a, ds b) {
  const ds p = two_prod(a.hi, b.hi);
  return {p.hi, fadd(p.lo, fadd(fmul(a.hi, b.lo), fmul(a.lo, b.hi)))};
}

__device__ __forceinline__ ds mul_c(ds a, const quad& c) {
  const float p = fmul(a.hi, c.hi);
  const ds as = split(a.hi);
  const float e = fadd(
      fadd(fadd(fsub(fmul(as.hi, c.hh), p), fmul(as.hi, c.hl)), fmul(as.lo, c.hh)),
      fmul(as.lo, c.hl));
  return {p, fadd(e, fadd(fmul(a.hi, c.lo), fmul(a.lo, c.hi)))};
}

__device__ __forceinline__ ds scale_pow2(ds a, float s) {
  return {fmul(a.hi, s), fmul(a.lo, s)};
}

__device__ __forceinline__ ds recip_newton(ds b, ds one) {
  const float q0 = fdiv(one.hi, b.hi);
  const ds r = sub_s(one, mul_f(b, q0));
  return two_sum(q0, fmul(q0, r.hi));
}

__device__ __forceinline__ bool gt_zero(ds a) {
  return a.hi > 0.0f || (a.hi == 0.0f && a.lo > 0.0f);
}

// --- the two collision tiers (ops/ds_engine.py) ----------------------------

__device__ __forceinline__ ds pair(const Params& k, int i) { return {k.v[i], k.v[i + 1]}; }

__device__ __forceinline__ quad quad_at(const Params& k, int i) {
  return {k.v[i], k.v[i + 1], k.v[i + 2], k.v[i + 3]};
}

// ds_engine.collide_planes_fast
__device__ __forceinline__ void collide_fast(const ds (&p)[9], ds (&out)[9], const Params& k) {
  const quad c1 = quad_at(k, 0), iw0 = quad_at(k, 4), iw14 = quad_at(k, 8),
             iw58 = quad_at(k, 12), c3 = quad_at(k, 16), csixth = quad_at(k, 20);
  const ds one = pair(k, 24);

  const ds d56 = add_s(p[5], p[6]);
  const ds d78 = add_s(p[7], p[8]);
  const ds d58 = add_s(p[5], p[8]);
  const ds d67 = add_s(p[6], p[7]);
  const ds dens_terms[7] = {p[0], p[1], p[2], p[3], p[4], d56, d78};
  const ds density = acc(dens_terms);
  const ds nx_terms[4] = {p[2], neg(p[4]), d56, neg(d78)};
  const ds ny_terms[4] = {p[1], neg(p[3]), d58, neg(d67)};
  const ds num_x = acc(nx_terms);
  const ds num_y = acc(ny_terms);
  const ds irho = recip_newton(density, one);
  const ds u_x = mul_nr(num_x, irho);
  const ds u_y = mul_nr(num_y, irho);
  const ds ux3 = mul_c(u_x, c3);
  const ds uy3 = mul_c(u_y, c3);
  const ds ssum = add_s(mul_nr(ux3, ux3), mul_nr(uy3, uy3));
  const ds base = sub_s(one, mul_c(ssum, csixth));
  const ds r0 = mul_c(density, iw0);
  const ds r14 = mul_c(density, iw14);
  const ds r58 = mul_c(density, iw58);

  out[0] = add_s(mul_c(p[0], c1), mul_nr(r0, base));
  const int SP[4] = {1, 2, 5, 6};
  const int SN[4] = {3, 4, 7, 8};
  const ds EU[4] = {uy3, ux3, add_s(ux3, uy3), sub_s(ux3, uy3)};
  const ds R[4] = {r14, r14, r58, r58};
#pragma unroll
  for (int q_i = 0; q_i < 4; ++q_i) {
    const ds eu = EU[q_i];
    const ds q = add_s(base, scale_pow2(mul_nr(eu, eu), 0.5f));
    out[SP[q_i]] = add_s(mul_c(p[SP[q_i]], c1), mul_nr(R[q_i], add_s(q, eu)));
    out[SN[q_i]] = add_s(mul_c(p[SN[q_i]], c1), mul_nr(R[q_i], sub_s(q, eu)));
  }
}

// ds_engine.collide_planes (the golden model's association order)
__device__ __forceinline__ void collide_exact(const ds (&p)[9], ds (&out)[9], const Params& k) {
  const ds one = pair(k, 0), itau = pair(k, 2), c3 = pair(k, 4), c45 = pair(k, 6),
           c15 = pair(k, 8), w0 = pair(k, 10), w14 = pair(k, 12), w58 = pair(k, 14);

  ds density = p[0];
#pragma unroll
  for (int s = 1; s < 9; ++s) density = add(density, p[s]);
  const ds num_x = sub(add(add(p[6], p[2]), p[5]), add(add(p[7], p[4]), p[8]));
  const ds num_y = sub(add(add(p[5], p[1]), p[8]), add(add(p[6], p[3]), p[7]));
  const ds irho = recip(density, one);
  const ds u_x = mul(num_x, irho);
  const ds u_y = mul(num_y, irho);
  const ds uterm = mul(c15, add(mul(u_x, u_x), mul(u_y, u_y)));
  const ds wd14 = mul(w14, density);
  const ds wd58 = mul(w58, density);

  const ds feq0 = mul(mul(w0, density), sub(one, uterm));
  out[0] = add(p[0], mul(itau, sub(feq0, p[0])));
  const int SP[4] = {1, 2, 5, 6};
  const int SN[4] = {3, 4, 7, 8};
  const ds V[4] = {u_y, u_x, add(u_x, u_y), sub(u_x, u_y)};
  const ds WD[4] = {wd14, wd14, wd58, wd58};
#pragma unroll
  for (int q_i = 0; q_i < 4; ++q_i) {
    const ds v = V[q_i];
    const ds t3 = mul(c3, v);
    const ds t45 = mul(c45, mul(v, v));
    const ds base = sub(add(add_f(t3, one.hi), t45), uterm);
    const ds base_n = sub(add(add_f(neg(t3), one.hi), t45), uterm);
    const ds feq_p = mul(WD[q_i], base);
    const ds feq_n = mul(WD[q_i], base_n);
    const int sp = SP[q_i], sn = SN[q_i];
    out[sp] = add(p[sp], mul(itau, sub(feq_p, p[sp])));
    out[sn] = add(p[sn], mul(itau, sub(feq_n, p[sn])));
  }
}

// --- the step --------------------------------------------------------------

// Forcing guard of the column-0 site in row `row`, at pair precision:
// fluid, and f6 - a58, f3 - a14, f7 - a58 all > 0
// (src/latticeboltzmann.c:500-513, fused_ds_kernel.py:179-185).
template <bool HAS_WALLS>
__device__ __forceinline__ bool forced_at(const float* __restrict__ hi,
                                          const float* __restrict__ lo,
                                          const uint8_t* __restrict__ solid,
                                          int64_t row, int64_t ny, int64_t plane,
                                          ds a14, ds a58) {
  const int64_t site = row * ny;  // column 0
  if (HAS_WALLS && solid[site] != 0) return false;
  const ds f6 = {hi[6 * plane + site], lo[6 * plane + site]};
  const ds f3 = {hi[3 * plane + site], lo[3 * plane + site]};
  const ds f7 = {hi[7 * plane + site], lo[7 * plane + site]};
  return gt_zero(sub(f6, a58)) && gt_zero(sub(f3, a14)) && gt_zero(sub(f7, a58));
}

template <bool HAS_WALLS, bool EXACT>
__global__ void __launch_bounds__(kBlock)
lbm_stream_collide_ds(const float* __restrict__ src_hi, const float* __restrict__ src_lo,
                      float* __restrict__ dst_hi, float* __restrict__ dst_lo,
                      const uint8_t* __restrict__ solid, int64_t nx, int64_t ny,
                      Params k) {
  // e_s = (e_x, e_y), the opposite speed, and the forcing increment sign
  // (+1 speeds gain, -1 speeds lose), as in core/spec.py
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  // the pairs a14 and a58 sit after the other constants of each tier
  constexpr int A14 = EXACT ? 16 : 26;
  constexpr int A58 = EXACT ? 18 : 28;

  // index arithmetic in 32 bits (the launcher bounds nx and ny), plane
  // offsets in 64
  const int i = blockIdx.x;
  const int j = blockIdx.y * kBlock + threadIdx.x;
  const int nxi = static_cast<int>(nx);
  const int nyi = static_cast<int>(ny);
  if (j >= nyi) return;
  const int64_t plane = nx * ny;
  const int rows[3] = {(i + 1) % nxi, i, (i - 1 + nxi) % nxi};
  const int cols[3] = {(j + 1) % nyi, j, (j - 1 + nyi) % nyi};
  const ds a14 = pair(k, A14);
  const ds a58 = pair(k, A58);

  // pull: p_s(i, j) = f_s(i - e_x, j - e_y), periodic in both axes, with
  // the source site's forcing applied first
  ds p[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int64_t si = rows[EX[s] + 1];
    const int64_t sj = cols[EY[s] + 1];
    const int64_t idx = s * plane + si * ny + sj;
    ds v = {src_hi[idx], src_lo[idx]};
    if (FORCE[s] != 0 && sj == 0 &&
        forced_at<HAS_WALLS>(src_hi, src_lo, solid, si, ny, plane, a14, a58)) {
      const ds a = (s == 1 || s == 3) ? a14 : a58;
      v = add(v, FORCE[s] > 0 ? a : neg(a));
    }
    p[s] = v;
  }

  ds out[9];
  if constexpr (EXACT) {
    collide_exact(p, out, k);
  } else {
    collide_fast(p, out, k);
  }

  const int64_t site = static_cast<int64_t>(i) * ny + j;
  if (HAS_WALLS && solid[site] != 0) {
    // bounce-back; OPP[0] == 0 passes the site's own f0 through
#pragma unroll
    for (int s = 0; s < 9; ++s) out[s] = p[OPP[s]];
  }
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    dst_hi[s * plane + site] = out[s].hi;
    dst_lo[s * plane + site] = out[s].lo;
  }
}

template <bool HAS_WALLS, bool EXACT>
void launch(dim3 grid, cudaStream_t st, const float* sh, const float* sl, float* dh,
            float* dl, const uint8_t* w, int64_t nx, int64_t ny, const Params& k) {
  lbm_stream_collide_ds<HAS_WALLS, EXACT><<<grid, kBlock, 0, st>>>(sh, sl, dh, dl, w, nx, ny, k);
}

}  // namespace

// One pair step (src_hi, src_lo) -> (dst_hi, dst_lo) on `stream`. All four:
// (9, nx, ny) float32, device, contiguous, distinct. solid: (nx, ny) uint8
// codes 0 fluid / 1 bounce-back (read only when has_walls != 0). exact
// selects the collision tier. params: 20 (exact) or 30 (fast) host floats
// in Params order. Returns cudaGetLastError() after the launch.
extern "C" int lbm_stream_collide_ds_launch(const void* src_hi, const void* src_lo,
                                            void* dst_hi, void* dst_lo,
                                            const void* solid, int64_t nx, int64_t ny,
                                            int64_t has_walls, int64_t exact,
                                            const void* params, void* stream) {
  // grid.x = rows (at most 2^31 - 1), grid.y = column tiles (at most
  // 65535); the kernel's 32-bit index arithmetic needs nx, ny < 2^30
  if (nx < 1 || ny < 1 || nx >= (1LL << 30) || ny >= (1LL << 30) ||
      (ny + kBlock - 1) / kBlock > 65535LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params k{};
  const float* h = static_cast<const float*>(params);
  const int n = exact ? 20 : kMaxParams;
  for (int q = 0; q < n; ++q) k.v[q] = h[q];
  const dim3 grid(static_cast<unsigned>(nx),
                  static_cast<unsigned>((ny + kBlock - 1) / kBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sh = static_cast<const float*>(src_hi);
  const float* sl = static_cast<const float*>(src_lo);
  float* dh = static_cast<float*>(dst_hi);
  float* dl = static_cast<float*>(dst_lo);
  const uint8_t* w = static_cast<const uint8_t*>(solid);
  if (has_walls) {
    if (exact) {
      launch<true, true>(grid, st, sh, sl, dh, dl, w, nx, ny, k);
    } else {
      launch<true, false>(grid, st, sh, sl, dh, dl, w, nx, ny, k);
    }
  } else {
    if (exact) {
      launch<false, true>(grid, st, sh, sl, dh, dl, w, nx, ny, k);
    } else {
      launch<false, false>(grid, st, sh, sl, dh, dl, w, nx, ny, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
