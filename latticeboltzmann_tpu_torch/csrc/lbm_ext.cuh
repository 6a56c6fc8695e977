// What the row-sharded forms of the stream-collide kernel share: where a
// shard's local block sits and what lies beyond it (Ext), the forcing guard
// of a row that may be a halo row, and the rdma form's exchange (Rdma, the
// acquire/release flag words, the bounded wait).
// Included by lbm_step.cu (the narrow ext-halo and rdma kernels, one site
// per thread) and lbm_wide_ext_step.cu (their wide forms, V columns per
// thread). See lbm_step.cu's header for the protocol these pieces carry.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lbm_collide.cuh"

namespace {

// Where a shard's local block sits and what lies beyond it (ext-halo
// form).
template <typename T>
struct Ext {
  const T* top;              // (9, ny): the row above local row 0
  const T* bot;              // (9, ny): the row below local row nx - 1
  const uint8_t* solid_top;  // (ny): top's class row (plane variant)
  const uint8_t* solid_bot;  // (ny): bot's class row (plane variant)
  int64_t row0;              // first local row this launch writes
  int64_t offset;            // global row of local row 0
  int64_t gnx;               // global row count
};

// The ext-halo form's solid_class and forced_at, for a row that may be a
// halo row: the row's class row (plane variant) or its global row gi of a
// gnx-row lattice (spec variant); for the guard also the row's column-0
// value of speed 0 and the stride between its speed planes.
template <int GEOM>
__device__ __forceinline__ int row_class(const uint8_t* __restrict__ cls_row,
                                         const Spec& g, int64_t gi, int64_t j,
                                         int64_t gnx) {
  if (GEOM == kPlane) return cls_row[j];
  if (GEOM == kSpec) return spec_solid(g, gi, j, gnx) ? 1 : 0;
  return 0;
}

template <typename T, int GEOM>
__device__ __forceinline__ bool forced_row(const T* __restrict__ row, int64_t stride,
                                           const uint8_t* __restrict__ cls_row,
                                           const Spec& g, int64_t gi, int64_t gnx,
                                           const Params& k) {
  if (row_class<GEOM>(cls_row, g, gi, 0, gnx) != 0) return false;
  return (load(row + 6 * stride) - k.a58 > 0.0f) &&
         (load(row + 3 * stride) - k.a14 > 0.0f) &&
         (load(row + 7 * stride) - k.a58 > 0.0f);
}

// What the rdma form adds to Ext: where this step's rows go, and the words
// the launches of a ring signal through. The comm pointers are this step's
// parity already.
template <typename T>
struct Rdma {
  T* up_bot;                      // the upper neighbour's bot rows (9, ny): row 0 goes there
  T* down_top;                    // the lower neighbour's top rows (9, ny): row nx - 1
  unsigned long long* up_flag;    // the upper neighbour's bot flag word
  unsigned long long* down_flag;  // the lower neighbour's top flag word
  unsigned long long* flags;      // this shard's own [top, bot] flag words
  unsigned long long* work;       // this shard's [ticket counter, error word]
  unsigned long long step;        // 1, 2, ... since the flags were reset
  unsigned long long timeout_ns;  // bound of an edge CTA's spin
};

// CTAs of the rdma form that send: one per direction
constexpr int kSendCtas = 2;

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_timer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 of an edge CTA: wait until *flag holds at least `step`. False
// when the shard's error word is set, or is set here because the wait
// outlasted the bound.
__device__ __forceinline__ bool wait_for_rows(const unsigned long long* flag,
                                              unsigned long long* error,
                                              unsigned long long step,
                                              unsigned long long timeout_ns) {
  if (*reinterpret_cast<volatile unsigned long long*>(error) != 0) return false;
  const unsigned long long start = global_timer_ns();
  unsigned backoff = 32;
  while (load_acquire_sys(flag) < step) {
    if (*reinterpret_cast<volatile unsigned long long*>(error) != 0) return false;
    if (global_timer_ns() - start > timeout_ns) {
      atomicCAS(error, 0ULL, step);
      return false;
    }
    __nanosleep(backoff);
    if (backoff < 1024) backoff *= 2;
  }
  return true;
}

// Ext and Rdma of one rdma launch from the entry point's untyped pointers;
// the comm buffers are (2, 9, ny) and this step takes parity step mod 2.
template <typename T>
void rdma_args(void* top, void* bot, void* up_bot, void* down_top, void* flags, void* up_flag,
               void* down_flag, void* work, const uint8_t* solid_top, const uint8_t* solid_bot,
               int64_t ny, int64_t offset, int64_t gnx, int64_t step, int64_t timeout_ns,
               Ext<T>* e, Rdma<T>* r) {
  using U = unsigned long long;
  const int64_t p = (step % 2) * 9 * ny;
  *e = Ext<T>{static_cast<const T*>(top) + p, static_cast<const T*>(bot) + p, solid_top,
              solid_bot, 0, offset, gnx};
  *r = Rdma<T>{static_cast<T*>(up_bot) + p, static_cast<T*>(down_top) + p,
               static_cast<U*>(up_flag), static_cast<U*>(down_flag), static_cast<U*>(flags),
               static_cast<U*>(work), static_cast<U>(step), static_cast<U>(timeout_ns)};
}

}  // namespace
