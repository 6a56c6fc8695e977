// What the wide stream-collide kernels share (V consecutive columns per
// thread, every access to a plane of device memory one 16-byte vector):
// the CTA's shape, the columns per thread by storage type, vector loads
// and stores, element access and packing, the class bytes of V sites, the
// wall spec's row tests. Included by lbm_wide_step.cu (the single-chip
// form) and lbm_wide_ext_step.cu (the ext-halo and rdma forms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_collide.cuh"

namespace {

// Columns per thread by storage type and the CTA's shape: the values that
// won on an H100 at 800x4000 and 4000x16000 (64 lanes x 2 rows is 1-2 us
// ahead of 128 x 1 in bf16 and level with it in float32; in bf16 CTAs of 256
// threads lose 2-8 us). fused_kernel.WIDE_COLUMNS restates the two column
// counts for the host's choice of form.
constexpr int kWideX = 64;    // lanes along y: whole warps
constexpr int kWideRows = 2;  // rows of one CTA
static_assert(kWideX % 32 == 0 && kWideX * kWideRows <= 1024, "CTA shape");

template <typename T> struct WideColumns;
template <> struct WideColumns<float> { static constexpr int v = 4; };
template <> struct WideColumns<__nv_bfloat16> { static constexpr int v = 8; };

// N 32-bit words of device memory at p (aligned to their size, 16 bytes at
// most per access), read-only for the kernel's lifetime.
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[N]) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "1, 2 or whole 16-byte vectors");
  if constexpr (N == 1) {
    w[0] = __ldg(static_cast<const uint32_t*>(p));
  } else if constexpr (N == 2) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const uint4 v = __ldg(static_cast<const uint4*>(p) + c);
      w[4 * c] = v.x, w[4 * c + 1] = v.y, w[4 * c + 2] = v.z, w[4 * c + 3] = v.w;
    }
  }
}

// The same from a row that another kernel may write while this one runs
// (the rdma form's comm rows): plain, coherent loads, never the read-only
// path of __ldg, whose data may be stale.
template <int N>
__device__ __forceinline__ void load_words_coherent(const void* p, uint32_t (&w)[N]) {
  static_assert(N % 4 == 0, "whole 16-byte vectors");
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const uint4 v = static_cast<const uint4*>(p)[c];
    w[4 * c] = v.x, w[4 * c + 1] = v.y, w[4 * c + 2] = v.z, w[4 * c + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[N]) {
  if constexpr (N == 1) {
    *static_cast<uint32_t*>(p) = w[0];
  } else if constexpr (N == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      static_cast<uint4*>(p)[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
    }
  }
}

// Value v of a vector's words as a float, exactly; v is a compile-time
// constant wherever this is called (the loops over v are unrolled).
template <typename T, int N>
__device__ __forceinline__ float element(const uint32_t (&w)[N], int v) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[v]);
  } else {
    // a bf16 value is the upper 16 bits of the float it stands for
    return __uint_as_float((v & 1) ? (w[v >> 1] & 0xffff0000u) : (w[v >> 1] << 16));
  }
}

// x as value v of a vector's words (zeroed before their first value): bf16
// rounds each value on its own, to nearest even, as store() does.
template <typename T, int N>
__device__ __forceinline__ void pack(uint32_t (&w)[N], int v, float x) {
  if constexpr (sizeof(T) == 4) {
    w[v] = __float_as_uint(x);
  } else {
    const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    w[v >> 1] |= bits << (16 * (v & 1));
  }
}

// The V class bytes of a thread's sites, in one load of V bytes.
template <int V>
__device__ __forceinline__ uint64_t load_classes(const uint8_t* p) {
  static_assert(V == 2 || V == 4 || V == 8, "2, 4 or 8 columns per thread");
  if constexpr (V == 8) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  } else if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// spec_solid with the row's tests taken once per thread: whether the whole
// row is solid, whether it crosses the rectangle's rows, and the circle's
// squared row distance, for row i of an nx-row lattice (a shard's row: its
// global row and the global row count). Integers: exact.
struct SpecRow {
  bool solid;
  bool rect;
  int64_t di2;
};

__device__ __forceinline__ SpecRow spec_row(const Spec& g, int64_t i, int64_t nx) {
  const int64_t di = 2 * i - g.ci2;
  return SpecRow{g.channel && (i == 0 || i == nx - 1), g.rect && i >= g.r0 && i < g.r1,
                 di * di};
}

__device__ __forceinline__ bool spec_column(const Spec& g, const SpecRow& r, int64_t j) {
  bool w = r.solid || (r.rect && j >= g.c0 && j < g.c1);
  if (g.circle) {
    const int64_t dj = 2 * j - g.cj2;
    w = w || r.di2 + dj * dj <= g.r2q;
  }
  return w;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }


}  // namespace
