// Measurement kernels of scripts/temporal_parts.py: the local temporal
// pass's CTA (csrc/lbm_temporal_step.cu's lbm_temporal_steps: two CTAs of
// 256 threads an SM, one tile buffer each) taken apart, and the designs
// measured against the pass. Built by that script alone, beside the port's
// library, from the same headers and flags; the port never calls them.
//
// - bytes_alone: a tile's loads, then a store of its output tile, with no
//   level between;
// - levels_alone: the first tile loaded, then every tile's levels on what
//   the shared tile holds, at NT threads, CTAS CTAs an SM, S sites a
//   thread and with or without the per-level barriers (without them the
//   results are wrong: timing only);
// - buffered: one CTA an SM with two tile buffers walking its tiles in a
//   grid-stride loop, the next tile's copies started as a cp.async group
//   of their own before the current tile's levels (the shard forms'
//   pass_tiles with the local form's periodic loads), at NT threads and S
//   sites a thread;
// - single: the tile loaded as one group of copies, waited for, then its
//   levels (the pass before its rows were split in two groups), at NT
//   threads and CTAS CTAs an SM;
// - banded: the pass's body with its rows in NB groups of copies and its
//   first level run group by group as its rows land.
// The last three take a planned or forced tile height. Every design
// computes the pass's sites with its arithmetic (collide, -fmad=false), so
// its output is bitwise the pass's.

#include "lbm_temporal.cuh"

namespace {

// load_tile at NT threads
template <typename T, int GEOM, int NT>
__device__ __forceinline__ void load_tile_nt(T* sm, uint8_t* cls, const TileAt& a, const T* src,
                                             const uint8_t* solid, const Spec& g, int nx, int ny,
                                             int64_t plane) {
  constexpr int V = vec_columns<T>();
  const int k0 = a.lc0 / V;
  const int nb = (a.lc1 + V - 1) / V - k0;
  const int n = a.lr1 * nb;
  WalkOf<NT> at(nb);
  for (int i = threadIdx.x; i < n; i += NT, at.next()) {
    const int lr = at.a;
    const int lc = (k0 + at.b) * V;
    const int gi = wrap(a.gr0 + lr, nx);
    const int gj = wrap(a.gc0 + lc, ny);
    const int64_t gs = static_cast<int64_t>(gi) * ny + gj;
    T* d = sm + lr * 9 * kW + lc;
#pragma unroll
    for (int s = 0; s < 9; ++s) copy16_async(d + s * kW, src + gs + s * plane);
    uint8_t* c = cls + lr * kW + lc;
    if (GEOM == kPlane) {
      copy_small_async<V>(c, solid + gs);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        c[j] = (GEOM == kSpec && spec_solid(g, gi, gj + j, nx)) ? 1 : 0;
      }
    }
  }
}

// lbm_collide.cuh's collide for S sites side by side, stage by stage: the
// S densities, then their reciprocals, then the rest, so that one site's
// chain runs under another's latency. Each site's arithmetic is collide's,
// operation for operation. site_class(j): site j's class.
template <int GEOM, int S, typename SiteClass>
__device__ __forceinline__ void collide_sites(const float (&p)[S][9], SiteClass site_class,
                                              const Params& k, int fast_math,
                                              float (&out)[S][9]) {
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int REFLECT_X[9] = {0, 1, 4, 3, 2, 8, 7, 6, 5};
  constexpr int REFLECT_Y[9] = {0, 3, 2, 1, 4, 6, 5, 8, 7};
  float d56[S], d78[S], d58[S], d67[S], density[S], inv_rho[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    d56[j] = p[j][5] + p[j][6];
    d78[j] = p[j][7] + p[j][8];
    d58[j] = p[j][5] + p[j][8];
    d67[j] = p[j][6] + p[j][7];
    density[j] = (p[j][0] + (p[j][1] + p[j][3])) + ((p[j][2] + p[j][4]) + (d56[j] + d78[j]));
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    inv_rho[j] = fast_math ? approx_reciprocal(density[j]) : 1.0f / density[j];
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float u_x = ((p[j][2] - p[j][4]) + (d56[j] - d78[j])) * inv_rho[j];
    const float u_y = ((p[j][1] - p[j][3]) + (d58[j] - d67[j])) * inv_rho[j];
    const float ux3 = k.k3 * u_x;
    const float uy3 = k.k3 * u_y;
    const float base = 1.0f - k.k6 * (ux3 * ux3 + uy3 * uy3);
    const float r0 = k.iw0 * density[j];
    const float r14 = k.iw14 * density[j];
    const float r58 = k.iw58 * density[j];
    out[j][0] = k.c1 * p[j][0] + r0 * base;
    const int SP[4] = {1, 2, 5, 6};
    const int SN[4] = {3, 4, 7, 8};
    const float EU[4] = {uy3, ux3, ux3 + uy3, ux3 - uy3};
    const float R[4] = {r14, r14, r58, r58};
#pragma unroll
    for (int q_i = 0; q_i < 4; ++q_i) {
      const float eu = EU[q_i];
      const float q = base + k.half * eu * eu;
      out[j][SP[q_i]] = k.c1 * p[j][SP[q_i]] + R[q_i] * (q + eu);
      out[j][SN[q_i]] = k.c1 * p[j][SN[q_i]] + R[q_i] * (q - eu);
    }
    const int cls = site_class(j);
    if (cls == 1) {
#pragma unroll
      for (int s = 0; s < 9; ++s) out[j][s] = p[j][OPP[s]];
    } else if (GEOM == kPlane && cls == 2) {
#pragma unroll
      for (int s = 0; s < 9; ++s) out[j][s] = p[j][REFLECT_X[s]];
    } else if (GEOM == kPlane && cls == 3) {
#pragma unroll
      for (int s = 0; s < 9; ++s) out[j][s] = p[j][REFLECT_Y[s]];
    }
  }
}

// tile_level with S sites a thread: a thread's items i, i + NT, ..., i + (S
// - 1) NT of each stride of S NT items, their chains side by side
// (collide_sites). An item past the region repeats the thread's first and
// stores nothing. Every site computes and writes what tile_level's would.
template <typename T, int GEOM, bool PUSHED, bool HAS0, bool LAST, int NT, int S>
__device__ __forceinline__ void tile_level_sites(T* sm, const uint8_t* cls, int ra, int rb,
                                                 int ca, int cb, T* dst, int64_t out0, int ny,
                                                 int64_t plane, const Params& k,
                                                 int fast_math) {
  constexpr int EX[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  constexpr int EY[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  constexpr int OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  constexpr int FORCE[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};

  const int w = cb - ca;
  const int n = (rb - ra) * w;
  WalkOf<S * NT> at(w);
  for (int i = threadIdx.x; i < n; i += S * NT, at.next()) {
    int r[S], c[S], g[S];
    bool live[S];
    T* site[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      // item i + j NT: (j NT) / w rows and (j NT) % w columns on
      int a = at.a + (j * NT) / w, b = at.b + (j * NT) % w;
      if (b >= w) {
        b -= w;
        ++a;
      }
      live[j] = j == 0 || i + j * NT < n;
      if (!live[j]) {
        a = at.a;
        b = at.b;
      }
      r[j] = ra + a;
      c[j] = ca + b;
      g[j] = r[j] * kW + c[j];
      site[j] = sm + r[j] * 9 * kW + c[j];
    }
    float p[S][9];
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        p[j][s] = load(site[j] + (PUSHED ? OPP[s] * kW : (s - 9 * EX[s]) * kW - EY[s]));
      }
    }
    if (HAS0) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
#pragma unroll
        for (int s = 0; s < 9; ++s) {
          if (FORCE[s] != 0) {
            const int y = g[j] - EX[s] * kW - EY[s];
            if (cls[y] & kGuardBit) {
              const float a = (s == 1 || s == 3) ? k.a14 : k.a58;
              p[j][s] = p[j][s] + (FORCE[s] > 0 ? a : -a);
            }
          }
        }
      }
    }
    float out[S][9];
    collide_sites<GEOM, S>(
        p, [&](int j) { return GEOM == kNone ? 0 : static_cast<int>(cls[g[j]] & kClassBits); }, k,
        fast_math, out);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (!live[j]) continue;
      if (LAST) {
        T* o = dst + out0 + static_cast<int64_t>(r[j]) * ny + c[j];
#pragma unroll
        for (int s = 0; s < 9; ++s) store(o + s * plane, out[j][s]);
      } else {
#pragma unroll
        for (int s = 0; s < 9; ++s) {
          store(site[j] + (PUSHED ? s * kW : (9 * EX[s] + OPP[s]) * kW + EY[s]), out[j][s]);
        }
      }
    }
  }
}

// a level at NT threads and S sites a thread
template <typename T, int GEOM, bool HAS0, bool LAST, int NT, int S>
__device__ __forceinline__ void level_s(bool pushed, T* sm, const uint8_t* cls, int ra, int rb,
                                        int ca, int cb, T* dst, int64_t out0, int ny,
                                        int64_t plane, const Params& k, int fast_math) {
  if constexpr (S > 1) {
    if (pushed) {
      tile_level_sites<T, GEOM, true, HAS0, LAST, NT, S>(sm, cls, ra, rb, ca, cb, dst, out0, ny,
                                                         plane, k, fast_math);
    } else {
      tile_level_sites<T, GEOM, false, HAS0, LAST, NT, S>(sm, cls, ra, rb, ca, cb, dst, out0, ny,
                                                          plane, k, fast_math);
    }
  } else {
    level<T, GEOM, HAS0, LAST, NT>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane, k,
                                   fast_math);
  }
}

// loads, then a store of the output tile: the pass's CTA
template <typename T, int GEOM>
__global__ void __launch_bounds__(kNT, kCtasPerSm)
bytes_alone(const T* __restrict__ src, T* __restrict__ dst, const uint8_t* __restrict__ solid,
            Spec g, int nx, int ny, int rows, int L, Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  uint8_t* cls = smem + static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  const int tiles = ((nx + R - 1) / R) * tiles_y;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt a(tile, tiles_y, R, C, nx, ny, L, pad);
    load_tile<T, GEOM>(sm, cls, a, src, solid, g, nx, ny, plane, 0, a.lr1);
    copies_wait();
    __syncthreads();
    const int64_t out0 = static_cast<int64_t>(a.gr0) * ny + a.gc0;
    const int n = a.Re * a.Ce;
    for (int i = threadIdx.x; i < n; i += kNT) {
      const int r = L + i / a.Ce, c = pad + i % a.Ce;
      T* o = dst + out0 + static_cast<int64_t>(r) * ny + c;
#pragma unroll
      for (int s = 0; s < 9; ++s) o[s * plane] = sm[r * 9 * kW + s * kW + c];
    }
    __syncthreads();
  }
}

// tile_levels with the per-level barriers optional (SYNC false: timing only)
template <typename T, int GEOM, int NT, int S, bool SYNC>
__device__ __forceinline__ void levels_of(T* sm, uint8_t* cls, const TileAt& a, T* dst, int ny,
                                          int64_t plane, const Params& k, int fast_math) {
  const int64_t out0 = static_cast<int64_t>(a.gr0) * ny + a.gc0;
  for (int t = 1; t <= a.L; ++t) {
    const int gg = a.L - t;
    const int ra = a.L - gg, rb = a.L + a.Re + gg;
    const int ca = a.pad - gg, cb = a.pad + a.Ce + gg;
    const bool pushed = (t % 2) == 0;
    const bool last = t == a.L;
    if (a.has0) {
      const int lo = ca - 1;
      const int first = lo + wrap(a.first0 - lo, ny);
      if (pushed) {
        guard_bits<T, true, NT>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, k);
      } else {
        guard_bits<T, false, NT>(sm, cls, ra - 1, rb + 1, first, cb + 1, ny, k);
      }
      if (SYNC) __syncthreads();
      if (last) {
        level_s<T, GEOM, true, true, NT, S>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny,
                                            plane, k, fast_math);
      } else {
        level_s<T, GEOM, true, false, NT, S>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny,
                                             plane, k, fast_math);
      }
    } else if (last) {
      level_s<T, GEOM, false, true, NT, S>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane,
                                           k, fast_math);
    } else {
      level_s<T, GEOM, false, false, NT, S>(pushed, sm, cls, ra, rb, ca, cb, dst, out0, ny, plane,
                                            k, fast_math);
    }
    if (SYNC) __syncthreads();
  }
}

// levels alone: the first tile loaded, then every tile's levels on what
// the shared tile holds
template <typename T, int GEOM, int NT, int CTAS, int S, bool SYNC>
__global__ void __launch_bounds__(NT, CTAS)
levels_alone(const T* __restrict__ src, T* __restrict__ dst, const uint8_t* __restrict__ solid,
             Spec g, int nx, int ny, int rows, int L, Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  uint8_t* cls = smem + static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  const int tiles = ((nx + R - 1) / R) * tiles_y;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt a(tile, tiles_y, R, C, nx, ny, L, pad);
    if (first) {
      load_tile_nt<T, GEOM, NT>(sm, cls, a, src, solid, g, nx, ny, plane);
      copies_wait();
      __syncthreads();
      first = false;
    }
    levels_of<T, GEOM, NT, S, SYNC>(sm, cls, a, dst, ny, plane, k, fast_math);
    __syncthreads();
  }
}

// one CTA an SM, two tile buffers: the next tile's copies start as a group
// of their own before the current tile's levels, which wait only for
// their own group and a barrier
template <typename T, int GEOM, int NT, int S>
__global__ void __launch_bounds__(NT, 1)
buffered(const T* __restrict__ src, T* __restrict__ dst, const uint8_t* __restrict__ solid,
         Spec g, int nx, int ny, int rows, int L, Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t buffer = buffer_bytes(rows, sizeof(T));
  const int64_t planes = static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  StrideTiles next(((nx + R - 1) / R) * tiles_y);
  int cur = next();
  if (cur >= 0) {
    const TileAt a(cur, tiles_y, R, C, nx, ny, L, pad);
    load_tile_nt<T, GEOM, NT>(reinterpret_cast<T*>(smem), smem + planes, a, src, solid, g, nx, ny,
                              plane);
  }
  copies_commit();
  for (int b = 0; cur >= 0; b ^= 1) {
    const int nxt = next();
    if (nxt >= 0) {
      unsigned char* buf = smem + (b ^ 1) * buffer;
      const TileAt a(nxt, tiles_y, R, C, nx, ny, L, pad);
      load_tile_nt<T, GEOM, NT>(reinterpret_cast<T*>(buf), buf + planes, a, src, solid, g, nx,
                                ny, plane);
    }
    copies_commit();
    copies_wait_but_newest();
    __syncthreads();
    unsigned char* buf = smem + b * buffer;
    const TileAt a(cur, tiles_y, R, C, nx, ny, L, pad);
    levels_of<T, GEOM, NT, S, true>(reinterpret_cast<T*>(buf), buf + planes, a, dst, ny, plane, k,
                                    fast_math);
    cur = nxt;
  }
}

// the tile loaded as one group of copies, waited for, then its levels (one
// tile buffer) at NT threads and CTAS CTAs an SM
template <typename T, int GEOM, int NT, int CTAS>
__global__ void __launch_bounds__(NT, CTAS)
single(const T* __restrict__ src, T* __restrict__ dst, const uint8_t* __restrict__ solid, Spec g,
       int nx, int ny, int rows, int L, Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  uint8_t* cls = smem + static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  const int tiles = ((nx + R - 1) / R) * tiles_y;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt a(tile, tiles_y, R, C, nx, ny, L, pad);
    load_tile_nt<T, GEOM, NT>(sm, cls, a, src, solid, g, nx, ny, plane);
    copies_wait();
    __syncthreads();
    levels_of<T, GEOM, NT, 1, true>(sm, cls, a, dst, ny, plane, k, fast_math);
  }
}

// load_tile_nt for the tile rows [r0, r1) only
template <typename T, int GEOM, int NT>
__device__ __forceinline__ void load_rows(T* sm, uint8_t* cls, const TileAt& a, const T* src,
                                          const uint8_t* solid, const Spec& g, int nx, int ny,
                                          int64_t plane, int r0, int r1) {
  constexpr int V = vec_columns<T>();
  const int k0 = a.lc0 / V;
  const int nb = (a.lc1 + V - 1) / V - k0;
  const int n = (r1 - r0) * nb;
  WalkOf<NT> at(nb);
  for (int i = threadIdx.x; i < n; i += NT, at.next()) {
    const int lr = r0 + at.a;
    const int lc = (k0 + at.b) * V;
    const int gi = wrap(a.gr0 + lr, nx);
    const int gj = wrap(a.gc0 + lc, ny);
    const int64_t gs = static_cast<int64_t>(gi) * ny + gj;
    T* d = sm + lr * 9 * kW + lc;
#pragma unroll
    for (int s = 0; s < 9; ++s) copy16_async(d + s * kW, src + gs + s * plane);
    uint8_t* c = cls + lr * kW + lc;
    if (GEOM == kPlane) {
      copy_small_async<V>(c, solid + gs);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        c[j] = (GEOM == kSpec && spec_solid(g, gi, gj + j, nx)) ? 1 : 0;
      }
    }
  }
}

// until every group of copies this thread committed but the newest N has
// landed
template <int N>
__device__ __forceinline__ void copies_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one tile buffer, NT threads, 2 CTAs an SM, each tile's loads in NB row
// bands, each a cp.async group of its own, and its first level run band by
// band as the rows it reads land, so that the tile's later bands load
// under its first level; a tile that holds global column 0 waits for all
// its rows first
template <typename T, int GEOM, int NT, int NB>
__global__ void __launch_bounds__(NT, kCtasPerSm)
banded(const T* __restrict__ src, T* __restrict__ dst, const uint8_t* __restrict__ solid, Spec g,
       int nx, int ny, int rows, int L, Params k, int fast_math) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  uint8_t* cls = smem + static_cast<int64_t>(rows) * 9 * kW * sizeof(T);
  const int64_t plane = static_cast<int64_t>(nx) * ny;
  const int pad = column_halo<T>(L);
  const int R = rows - 2 * L;
  const int C = kW - 2 * pad;
  const int tiles_y = (ny + C - 1) / C;
  const int tiles = ((nx + R - 1) / R) * tiles_y;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt a(tile, tiles_y, R, C, nx, ny, L, pad);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      load_rows<T, GEOM, NT>(sm, cls, a, src, solid, g, nx, ny, plane, b * a.lr1 / NB,
                             (b + 1) * a.lr1 / NB);
      copies_commit();
    }
    if (a.has0) {
      copies_wait();
      __syncthreads();
      levels_of<T, GEOM, NT, 1, true>(sm, cls, a, dst, ny, plane, k, fast_math);
      continue;
    }
    // level 1 over rows [1, lr1 - 1): row r reads rows r - 1 .. r + 1
    const int64_t out0 = static_cast<int64_t>(a.gr0) * ny + a.gc0;
    const int ca = a.pad - (L - 1), cb = a.pad + a.Ce + (L - 1);
    int done = 1;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (NB - 1 - b >= 3) {
        copies_wait_group<3>();
      } else if (NB - 1 - b == 2) {
        copies_wait_group<2>();
      } else if (NB - 1 - b == 1) {
        copies_wait_group<1>();
      } else {
        copies_wait_group<0>();
      }
      __syncthreads();
      const int upto = b == NB - 1 ? a.lr1 - 1 : (b + 1) * a.lr1 / NB - 1;
      if (upto > done) {
        if (L == 1) {
          tile_level<T, GEOM, false, false, true, NT>(sm, cls, done, upto, ca, cb, dst, out0, ny,
                                                      plane, k, fast_math);
        } else {
          tile_level<T, GEOM, false, false, false, NT>(sm, cls, done, upto, ca, cb, dst, out0, ny,
                                                       plane, k, fast_math);
        }
        done = upto;
      }
    }
    __syncthreads();
    // levels 2 .. L as tile_levels runs them
    for (int t = 2; t <= L; ++t) {
      const int gg = L - t;
      const int ra = L - gg, rb = L + a.Re + gg;
      const int c0 = a.pad - gg, c1 = a.pad + a.Ce + gg;
      const bool pushed = (t % 2) == 0;
      if (t == L) {
        level<T, GEOM, false, true, NT>(pushed, sm, cls, ra, rb, c0, c1, dst, out0, ny, plane, k,
                                        fast_math);
      } else {
        level<T, GEOM, false, false, NT>(pushed, sm, cls, ra, rb, c0, c1, dst, out0, ny, plane,
                                         k, fast_math);
      }
      __syncthreads();
    }
  }
}

// Launch `kernel` (nt threads, `buffers` tile buffers of the card's rows a
// CTA) over the lattice: planned, at the tile plan_tiles gives over its
// rows (tile_rows > 0: that tile), one CTA a slot; else at the card's tile
// or tile_rows, one CTA a slot. out: registers, CTAs/SM, shared bytes a
// CTA, local bytes a thread, the tile's rows, CTAs launched, the tiles the
// busiest CTA walks.
template <typename T, typename K>
int run(K kernel, int nt, int buffers, bool planned, const void* src, void* dst, const Spec& g,
        int nx, int ny, int L, const Params& k, int tile_rows, int64_t* out, cudaStream_t st) {
  Info info, cache[kMaxDevices];
  bool known[kMaxDevices] = {};
  const cudaError_t err = card_info<T>(kernel, cache, known, &info, nt, buffers);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t C = kW - 2 * column_halo<T>(L);
  const int64_t slots = static_cast<int64_t>(info.per_sm) * info.sms;
  const auto lay = [&](int R, Plan* p) {
    p->tiles = ((nx + R - 1) / R) * ((ny + C - 1) / C);
    p->ctas = std::min<int64_t>(p->tiles, slots);
    p->waves = (p->tiles + p->ctas - 1) / p->ctas;
    return true;
  };
  Plan plan;
  if (!plan_tiles<T>(info.rows, L, lay, &plan, planned ? tile_rows : (tile_rows ? tile_rows
                                                                               : info.rows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(plan.ctas), nt, static_cast<size_t>(info.smem), st>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), nullptr, g, nx, ny, plan.rows, L, k, 0);
  out[0] = info.attr.numRegs;
  out[1] = info.per_sm;
  out[2] = info.smem;
  out[3] = static_cast<int64_t>(info.attr.localSizeBytes);
  out[4] = plan.rows;
  out[5] = plan.ctas;
  out[6] = plan.waves;
  return static_cast<int>(cudaGetLastError());
}

// the wall-spec variant of every kernel above, by kind and variant (the
// tables in scripts/temporal_parts.py)
template <typename T>
int dispatch(int64_t kind, int64_t variant, const void* src, void* dst, const Spec& g, int nx,
             int ny, int L, const Params& k, int tile_rows, int64_t* out, cudaStream_t st) {
  constexpr int P = kSpec;
  const auto go = [&](auto kernel, int nt, int buffers, bool planned) {
    return run<T>(kernel, nt, buffers, planned, src, dst, g, nx, ny, L, k, tile_rows, out, st);
  };
  switch (kind * 16 + variant) {
    case 0:
      return go(bytes_alone<T, P>, kNT, 1, false);
    case 16:
      return go(levels_alone<T, P, 256, 2, 1, true>, 256, 1, false);
    case 17:
      return go(levels_alone<T, P, 512, 2, 1, true>, 512, 1, false);
    case 18:
      return go(levels_alone<T, P, 1024, 1, 1, true>, 1024, 2, false);
    case 19:
      return go(levels_alone<T, P, 256, 2, 2, true>, 256, 1, false);
    case 20:
      return go(levels_alone<T, P, 256, 2, 1, false>, 256, 1, false);
    case 21:
      return go(levels_alone<T, P, 512, 1, 1, true>, 512, 2, false);
    case 22:
      return go(levels_alone<T, P, 512, 1, 2, true>, 512, 2, false);
    case 23:
      return go(levels_alone<T, P, 512, 2, 2, true>, 512, 1, false);
    case 32:
      return go(buffered<T, P, 512, 1>, 512, 2, true);
    case 33:
      return go(buffered<T, P, 1024, 1>, 1024, 2, true);
    case 34:
      return go(buffered<T, P, 512, 2>, 512, 2, true);
    case 35:
      return go(buffered<T, P, 256, 2>, 256, 2, true);
    case 48:
      return go(single<T, P, 256, 2>, 256, 1, true);
    case 49:
      return go(single<T, P, 512, 2>, 512, 1, true);
    case 64:
      return go(banded<T, P, 256, 4>, 256, 1, false);
    case 65:
      return go(banded<T, P, 512, 4>, 512, 1, false);
    case 66:
      return go(banded<T, P, 256, 4>, 256, 1, true);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch of a measurement kernel over an (nx, ny) lattice src -> dst
// (float32 storage 0 or bf16 storage 1, the wall spec of 10 host int64,
// params: 9 host floats): kind 0 bytes alone, 1 levels alone, 2 buffered,
// 3 single, 4 banded, variant its CTA (scripts/temporal_parts.py's
// tables); tile_rows 0: the card's tile or, where the variant plans, the
// plan's. out: 7 int64 (run's). Returns 0 or a CUDA error.
extern "C" int temporal_parts_launch(int64_t kind, int64_t variant, int64_t storage,
                                     const void* src, void* dst, const void* spec, int64_t nx,
                                     int64_t ny, int64_t steps, const void* params,
                                     int64_t tile_rows, int64_t* out, void* stream) {
  const Params k = params_from(params);
  const Spec g = spec_from(spec, kSpec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n[] = {static_cast<int>(nx), static_cast<int>(ny), static_cast<int>(steps),
                   static_cast<int>(tile_rows)};
  if (storage == 1) {
    return dispatch<__nv_bfloat16>(kind, variant, src, dst, g, n[0], n[1], n[2], k, n[3], out,
                                   st);
  }
  return dispatch<float>(kind, variant, src, dst, g, n[0], n[1], n[2], k, n[3], out, st);
}
