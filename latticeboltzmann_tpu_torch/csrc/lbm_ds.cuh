// The pair (double-single, f32-pair) arithmetic of the ds kernels: the
// launch constants, the error-free transforms, the pair operations and the
// two collision tiers, shared by the one-step kernel (lbm_ds_step.cu) and
// the temporal form (lbm_ds_temporal_step.cu), both held bit for bit
// against fused_ds_kernel.step_reference.
//
// One rounding per op is the whole contract. Every error-free transform
// (two_sum, quick_two_sum, two_prod) silently collapses to f32 accuracy if
// a mul+add is contracted to an FMA or an expression is reassociated. So
// every f32 op of the pair arithmetic is an _rn intrinsic (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn, and the one explicit __fmaf_rn of a
// product's error), which the compiler never fuses or reorders, whatever
// -fmad says; and the build never uses --use_fast_math. The op order is
// ops/df64.py's, op for op, so a kernel equals the plain PyTorch version
// bit for bit. lbm_ds_step.cu's header gives the domain in which the
// product's one-FMA error equals the plain version's Dekker split.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParams = 20;

// Launch constants, float32, split on the host from float64 by
// fused_ds_kernel.kernel_constants_ds. Fast tier (18 floats): the pairs
// c1, iw0, iw14, iw58, c3, csixth, one, a14, a58. Exact tier (20 floats):
// the pairs one, itau, c3, c45, c15, w0, w14, w58, a14, a58.
struct Params {
  float v[kMaxParams];
};

struct ds {
  float hi, lo;
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

// TwoProd: p + e == a * b exactly, the error by one FMA; Dekker's
// TwoProd (df64.two_prod) to the bit in the domain of the header.
__device__ __forceinline__ ds two_prod(float a, float b) {
  const float p = fmul(a, b);
  return {p, __fmaf_rn(a, b, -p)};
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

// df64.mul_c: a times a constant. The plain version splits a.hi at run
// time and takes the constant's halves from the host (split_const's hh,
// hl: Veltkamp's halves of c.hi), which is Dekker's TwoProd of a.hi and
// c.hi; here that product's error is one FMA against c.hi whole.
__device__ __forceinline__ ds mul_c(ds a, ds c) {
  const ds p = two_prod(a.hi, c.hi);
  return {p.hi, fadd(p.lo, fadd(fmul(a.hi, c.lo), fmul(a.lo, c.hi)))};
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

// ds_engine.collide_planes_fast
__device__ __forceinline__ void collide_fast(const ds (&p)[9], ds (&out)[9], const Params& k) {
  const ds c1 = pair(k, 0), iw0 = pair(k, 2), iw14 = pair(k, 4), iw58 = pair(k, 6),
           c3 = pair(k, 8), csixth = pair(k, 10), one = pair(k, 12);

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

}  // namespace
