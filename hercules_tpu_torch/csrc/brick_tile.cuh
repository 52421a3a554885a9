// The tiled elastic step on a brick's flat node grid, in two marches:
// brick_tile_step, the synchronous march of brick_chunk (K5, a
// persistent launch per chunk of steps), and brick_tile_step_staged, the
// staged pipeline of brick_step (K1, one launch per step; its note is
// below).  Both run the same arithmetic in the same order and give
// bit-identical states; only the data movement differs.
//
// Layout (hercules_tpu_torch/solver/fused_brick.py):
//   S [8, len]: rows 0:3 = u (this step), 3:6 = u- (previous step),
//               6:8 = zero rows carried through.
//   K [8, len]: rows 0:3 = (c1, c2, beta) of the element whose lowest
//               corner is this column (zero for padding and invalid
//               elements), 3:6 = mass_minusaM, 6 = inv_mass, 7 = 0.
//
// The step (hercules_tpu/solver/pallas_brick.py:_make_kernel; its
// elastic fold, :913-932):
//   W_e = u + beta_e (u - u-)                      at e's 8 corners
//   F_e = c1_e A1 W_e + c2_e A2 W_e,  A = -[M1; M2]
//       = H (c1_e D1 + c2_e D2)(-H W_e)  (H the 8-corner Hadamard
//         transform, D1 and D2 the sparse spectral factors)
//   F_n = sum over the 8 elements e = n - o[j] of rows 3j..3j+2 of F_e
//   u+  = u + (F_n + mass_minusaM (u - u-)) inv_mass
//
// Design of the synchronous march (H100): the march of bkt_tile.cuh (its
// Geom, tiles, slabs and shared-memory layout), with the elastic
// per-plane values and force.
// A work item is a tile of 31 x 7 owned nodes on a slab of planes; one
// block of 256 threads marches through the slab plane by plane:
//   1. state: u and du = u - u- of the next plane at the tile's nodes and
//      a one-node halo (33 x 9) into shared memory.  Not W: beta is per
//      element, so W is formed per element.  Thread (lx, ly) holds the
//      node slot of the owned node it updates, threads 0..40 the 41
//      slots of the halo's last column and row.
//   2. force: one thread per element of the 32 x 8 element tile forms
//      W at its 8 corners from shared memory, the Hadamard transform,
//      a multiply-add per nonzero of the sparse factors of M1 and M2
//      with the minus folded in (elastic_spectral.cuh, immediate
//      operands), scaled by its c1 and c2, and the inverse transform --
//      330 operations instead of the dense operator's 2,304 -- and
//      writes its 24 force values into shared memory once.  Padding and
//      invalid elements (c1 = c2 = 0) and elements whose corners pass
//      len give no force.
//   3. update: each owned node sums its 8 slices, j ascending (a fixed
//      order, no atomics), reads u and du from its own shared slot (so
//      the state is read from device memory once per step: 23 rows of
//      traffic, S 6 + 2, K 3 + 4, S' 8) and stores u+, u and rows 6:8;
//      a source hook may add to the new displacement before it is
//      stored (K5's sources).
// A node's slot is read by the update only after the next plane's state
// has been loaded, and written with the next plane only after the
// update, by the same thread: no other thread touches an owned slot
// between the barriers, so two plane buffers suffice.  Each iteration's
// device-memory loads (the next plane's state, the element coefficients
// of the plane about to be formed, the update's K rows and S rows 6:8)
// come before its stores in the code: the compiler keeps a coherent load
// behind every earlier store that may alias it, and K5 reads with
// coherent loads the buffers other blocks wrote earlier in its launch
// (bkt_tile.cuh, PERF.md).
//
// Rounding: W = fma(beta, du, u); the force in the spectral form's own
// order (the plain version multiplies the dense matrices), so it agrees
// with the plain version to rounding, not bit for bit; the update as
// fma(fma(mm, du, F), inv_mass, u).
#pragma once

#include "bkt_tile.cuh"
#include "elastic_spectral.cuh"

namespace ht {
namespace {

// One element's force f [24] = c1 A1 w + c2 A2 w, A = -[M1; M2], in the
// spectral form: the transform of w (in place), a multiply-add per
// nonzero of the two sparse factors with the minus folded into the
// immediate, f = c1 y1 + c2 y2, and the inverse transform.
template <typename T>
__device__ __forceinline__ void elastic_force_spectral(T* w, T c1, T c2,
                                                       T* f) {
  hadamard8(w);
  T y1[24], y2[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) y1[i] = y2[i] = T(0);
#define HT_ACC_M1(mo, co, mi, ci, v) \
  y1[3 * mo + co] = fma_rn(T(-(v)), w[3 * mi + ci], y1[3 * mo + co]);
#define HT_ACC_M2(mo, co, mi, ci, v) \
  y2[3 * mo + co] = fma_rn(T(-(v)), w[3 * mi + ci], y2[3 * mo + co]);
  HT_ELASTIC_SPECTRAL_M1(HT_ACC_M1)
  HT_ELASTIC_SPECTRAL_M2(HT_ACC_M2)
#undef HT_ACC_M1
#undef HT_ACC_M2
#pragma unroll
  for (int i = 0; i < 24; ++i) f[i] = fma_rn(c1, y1[i], c2 * y2[i]);
  hadamard8(f);
}

// One step of work item `item` by the calling block: S -> out at the
// item's owned nodes.  smem holds tile_smem_bytes<T>() bytes (the state
// of two planes [2][6][NN], then the force rows [lower | upper x 2][kF]).
// src(n, un) is called by the thread that updates owned node n with its
// new displacement un[3] before it is stored.  S is read with plain
// (coherent) loads: brick_chunk reads buffers that other blocks wrote
// earlier in its launch.  Consecutive calls by one block need no barrier
// between them: a call's last shared-memory reads (the final update, of
// the force rows and the thread's own slots) come before the next call's
// first barrier, and before it the next call writes only node slots,
// each by the thread that read it.
template <typename T, typename Sources>
__device__ __forceinline__ void brick_tile_step(const T* S, const T* K,
                                                T* out, int len,
                                                const Geom& g, int item,
                                                T* smem, const Sources& src) {
  T* pb = smem;              // [2 planes][u, du: 6][NN]
  T* fb = pb + 2 * 6 * NN;   // [lower | upper x 2][kF]
  const int tid = threadIdx.x;
  const int lx = tid % TX, ly = tid / TX;
  const int tiles = g.tiles_x * g.tiles_y;
  const int tile = item % tiles;
  const int x0 = (tile % g.tiles_x) * OX, y0 = (tile / g.tiles_x) * OY;
  const int a0 = (item / tiles) * g.slab;
  const int a1 = min(a0 + g.slab, g.nplanes);
  // this thread's element (force) and node (update): its lowest corner
  const int ex = x0 - 1 + lx, ey = y0 - 1 + ly;
  const int exy = ey * g.s_mid + ex;
  // elements past the last row or column alias flat neighbours that no
  // owned node gathers
  const bool on_grid = ex < g.nx && ey < g.ny;
  const bool own_xy = lx >= 1 && ly >= 1 && on_grid;
  // this thread's node slots: its own, and one of the halo's last column
  // (threads 0..TY) or last row (the next TX) -- or none
  const int mine = ly * NX + lx;
  const int extra = tid <= TY ? tid * NX + TX
                    : tid < NN - kThreads ? TY * NX + tid - (TY + 1) : -1;

  // 1. u and du of node slot q of plane a (zero off the state)
  auto load_node = [&](int a, int q, T* v) {
    const int x = x0 - 1 + q % NX, y = y0 - 1 + q / NX;
    const int n = a * g.s_out + y * g.s_mid + x;
    T us[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    // no element on the grid reads a node past x = nx or y = ny
    if (a >= 0 && x <= g.nx && y <= g.ny && n >= 0 && n < len)
#pragma unroll
      for (int k = 0; k < 6; ++k) us[k] = S[k * len + n];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = us[c];
      v[3 + c] = us[c] - us[3 + c];
    }
  };
  auto store_node = [&](int a, int q, const T* v) {
    T* d = pb + (a & 1) * 6 * NN + q;
#pragma unroll
    for (int k = 0; k < 6; ++k) d[k * NN] = v[k];
  };
  // the coefficients (c1, c2, beta) of this thread's element in plane p
  // (zero where it gives no force)
  auto load_coef = [&](int p, T* k) {
    const int e = p * g.s_out + exy;
    k[0] = k[1] = k[2] = T(0);
    if (on_grid && p >= 0 && e >= 0 && e + g.o[7] < len)
#pragma unroll
      for (int r = 0; r < 3; ++r) k[r] = K[r * len + e];
  };

  // 2. the force of element plane p into the lower half (corners in
  // plane p) and the upper half of p's parity (corners in plane p + 1)
  auto force_plane = [&](int p, const T* k) {
    if (!on_grid) return;
    const T* d0 = pb + (p & 1) * 6 * NN + mine;
    const T* d1 = pb + ((p + 1) & 1) * 6 * NN + mine;
    T* fh = fb + kF * (1 + (p & 1));
    T f[24];
    if (k[0] != T(0) || k[1] != T(0)) {
      T w[24];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T* s = (g.cda[i] ? d1 : d0) + g.nof[i];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          w[3 * i + c] = fma_rn(k[2], s[(3 + c) * NN], s[c * NN]);
      }
      elastic_force_spectral<T>(w, k[0], k[1], f);
    } else {
#pragma unroll
      for (int i = 0; i < 24; ++i) f[i] = T(0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T* dst = (g.cda[j] ? fh : fb) + g.fdst[j] + tid;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c * kThreads] = f[3 * j + c];
    }
  };

  // 3. the owned node of plane q: its force from the elements of planes
  // q (lower half) and q - 1 (upper half), u and du from its own slot,
  // then the update
  auto update_plane = [&](int q) {
    if (!own_xy) return;
    const int n = q * g.s_out + exy;
    if (n >= len) return;
    T kn[4], z[2];
#pragma unroll
    for (int r = 0; r < 4; ++r) kn[r] = K[(3 + r) * len + n];
    z[0] = S[6 * len + n];
    z[1] = S[7 * len + n];
    const T* fh = fb + kF * (1 + ((q - 1) & 1));
    T f[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* s = (g.cda[j] ? fh : fb) + g.fdst[j] + tid - g.gof[j];
#pragma unroll
      for (int c = 0; c < 3; ++c) f[c] = f[c] + s[c * kThreads];
    }
    const T* d = pb + (q & 1) * 6 * NN + mine;
    T u[3], un[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = d[c * NN];
      un[c] = fma_rn(fma_rn(kn[c], d[(3 + c) * NN], f[c]), kn[3], u[c]);
    }
    src(n, un);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c * len + n] = un[c];
      out[(3 + c) * len + n] = u[c];
    }
    out[6 * len + n] = z[0];
    out[7 * len + n] = z[1];
  };

  // the march: plane p's state comes one plane ahead of its element
  // forces, and a node plane is updated once both element planes around
  // it are formed.  Shared buffers alternate by parity; two barriers per
  // plane separate each buffer's writers and readers.
  T v[6], k[3];
  load_node(a0 - 1, mine, v);
  store_node(a0 - 1, mine, v);
  if (extra >= 0) {
    load_node(a0 - 1, extra, v);
    store_node(a0 - 1, extra, v);
  }
  for (int p = a0 - 1; p < a1; ++p) {
    // every device-memory load of the iteration before its first store
    load_node(p + 1, mine, v);
    load_coef(p, k);
    if (extra >= 0) {
      T w[6];
      load_node(p + 1, extra, w);
      store_node(p + 1, extra, w);  // a halo slot: no update reads it
    }
    if (p - 1 >= a0) update_plane(p - 1);
    store_node(p + 1, mine, v);     // after this thread's update read it
    __syncthreads();
    force_plane(p, k);
    __syncthreads();
  }
  update_plane(a1 - 1);
}


// ---- K1's staged march ------------------------------------------------
//
// The same step as brick_tile_step, bit for bit: du = u - u- per node
// slot, W = fma(beta, du, u), elastic_force_spectral, the gather over j
// ascending and fma(fma(mm, du, F), inv_mass, u) compute the same values
// in the same order; only the data movement and the bookkeeping differ.
//   ring [kStepStages][6][NN]: the raw rows u and u- of node planes p and
//        p + 1 (read by the force of element plane p) and p + 2 (in
//        flight), copied asynchronously (cp.async, 4 or 8 bytes a
//        thread, zeros off the state) while plane p's forces are formed;
//        du = u - u- is formed where it is read.
//   lo, hi [kF] each: the forces of element plane p's lower corners and
//        of plane p - 1's upper corners.  Node plane p is updated in the
//        iteration that forms element plane p; the thread keeps plane
//        p's upper corners in registers through the update and writes
//        them into hi after the next iteration's first barrier, so one hi
//        buffer suffices where brick_tile_step has two.  The lower
//        corner of the thread's own element is read from its registers.
//   coefficients (c1, c2, beta) of the element plane, K rows 3:7 of the
//        owned node: in float32 copied asynchronously into shared memory
//        with the state (coef [2][3][kThreads], kn [4][kThreads]), where
//        registers bind (80 a thread for three blocks an SM); in float64
//        loaded into registers (plane p's coefficients before its
//        barrier, K rows 3:7 before its forces), where shared-memory
//        bandwidth binds (8-byte accesses, two wavefronts a warp).
// The corner roles (which bit of the corner index steps the inner, mid
// and plane axis) are template arguments (BX, BY, BA), so the force and
// gather addresses are compile-time offsets.  Per iteration: wait for
// the copies, barrier; write hi, issue the copies of plane p + 2 (and
// the coefficients of p + 1 and K rows of p in float32); form the forces
// into lo; barrier; update.  Two barriers per plane, as before.
// Shared memory: 91,920 B in float64 (two blocks an SM), 56,200 B in
// float32 (three).
constexpr int kStepStages = 3;

// the march's shared memory: lo, hi, the ring and, in float32 alone,
// coef and kn
template <typename T>
constexpr int step_smem_bytes() {
  return (2 * kF + kStepStages * 6 * NN +
          (sizeof(T) == 4 ? (2 * 3 + 4) * kThreads : 0)) *
         static_cast<int>(sizeof(T));
}

// dst <- *src (sizeof(T) bytes) by an asynchronous copy into shared
// memory, or zeros where !valid (src is then not read)
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Corner j's roles with bit BX of j stepping the inner axis, BY the mid
// axis and BA the plane axis (make_geom's cda, nof, gof, fdst).
template <int BX, int BY, int BA>
struct Corners {
  __host__ __device__ static constexpr int da(int j) { return j >> BA & 1; }
  __host__ __device__ static constexpr int nof(int j) {
    return (j >> BY & 1) * NX + (j >> BX & 1);
  }
  __host__ __device__ static constexpr int gof(int j) {
    return (j >> BY & 1) * TX + (j >> BX & 1);
  }
  // j's rank among the corners of its plane, bit BA dropped from j
  __host__ __device__ static constexpr int fdst(int j) {
    return ((j >> (BA + 1) << BA) | (j & ((1 << BA) - 1))) * 3 * kThreads;
  }
};

// One step of work item `item` by the calling block: S -> out at the
// item's owned nodes, as brick_tile_step without sources, on a brick
// whose corner roles are (BX, BY, BA).  smem holds step_smem_bytes<T>()
// bytes.  One work item per block: a call's last shared-memory reads
// are not separated from a next call's writes.
template <typename T, int BX, int BY, int BA>
__device__ __forceinline__ void brick_tile_step_staged(
    const T* __restrict__ S, const T* __restrict__ K, T* __restrict__ out,
    int len, const Geom& g, int item, T* smem) {
  using C = Corners<BX, BY, BA>;
  constexpr bool kStaged = sizeof(T) == 4;
  T* lo = smem;                           // [kF]
  T* hi = lo + kF;                        // [kF]
  T* ring = hi + kF;                      // [kStepStages][6][NN]
  T* coef = ring + kStepStages * 6 * NN;  // [2][3][kThreads] (float32)
  T* kn = coef + 2 * 3 * kThreads;        // [4][kThreads] (float32)
  const int tid = threadIdx.x;
  const int lx = tid % TX, ly = tid / TX;
  const int tiles = g.tiles_x * g.tiles_y;
  const int tile = item % tiles;
  const int x0 = (tile % g.tiles_x) * OX, y0 = (tile / g.tiles_x) * OY;
  const int a0 = (item / tiles) * g.slab;
  const int a1 = min(a0 + g.slab, g.nplanes);
  // this thread's element (force) and node (update): its lowest corner
  const int ex = x0 - 1 + lx, ey = y0 - 1 + ly;
  const int exy = ey * g.s_mid + ex;
  const bool on_grid = ex < g.nx && ey < g.ny;
  const bool own_xy = lx >= 1 && ly >= 1 && on_grid;
  const int mine = ly * NX + lx;

  // the ring slot of node plane a >= -1
  auto slot = [&](int a) {
    return ring + (a + kStepStages) % kStepStages * 6 * NN;
  };
  // 1. the rows u and u- of node plane a: thread tid copies the pairs of
  // slots i = tid + k kThreads < 3 NN (component i / NN), zero off the
  // state as brick_tile_step's load_node
  auto copy_state = [&](int a) {
    T* d = slot(a);
#pragma unroll
    for (int k = 0; k < (3 * NN + kThreads - 1) / kThreads; ++k) {
      const int i = tid + k * kThreads;
      if (i < 3 * NN) {
        const int c = i / NN, q = i % NN;
        const int x = x0 - 1 + q % NX, y = y0 - 1 + q / NX;
        const int n = a * g.s_out + y * g.s_mid + x;
        const bool ok =
            a >= 0 && x <= g.nx && y <= g.ny && n >= 0 && n < len;
        const int m = ok ? n : 0;
        cp_async(d + c * NN + q, S + c * len + m, ok);
        cp_async(d + (3 + c) * NN + q, S + (3 + c) * len + m, ok);
      }
    }
  };
  // whether this thread's element in plane p gives a force, as load_coef
  auto has_coef = [&](int p, int* e) {
    *e = p * g.s_out + exy;
    return on_grid && p >= 0 && *e >= 0 && *e + g.o[7] < len;
  };
  // (float32) its coefficients into coef, zero where it gives none
  auto copy_coef = [&](int p) {
    int e;
    const bool ok = has_coef(p, &e);
    T* d = coef + (p & 1) * 3 * kThreads + tid;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      cp_async(d + r * kThreads, K + r * len + (ok ? e : 0), ok);
  };
  // (float64) its coefficients into k
  auto load_coef = [&](int p, T* k) {
    int e;
    k[0] = k[1] = k[2] = T(0);
    if (has_coef(p, &e))
#pragma unroll
      for (int r = 0; r < 3; ++r) k[r] = K[r * len + e];
  };

  // 2. the force f [24] of this thread's element in plane p; its lower
  // corners but its own node's into lo
  auto force_plane = [&](int p, const T* k, T* f) {
    const T* d0 = slot(p) + mine;
    const T* d1 = slot(p + 1) + mine;
    if (k[0] != T(0) || k[1] != T(0)) {
      T w[24];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T* s = (C::da(i) ? d1 : d0) + C::nof(i);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T u = s[c * NN];
          w[3 * i + c] = fma_rn(k[2], u - s[(3 + c) * NN], u);
        }
      }
      elastic_force_spectral<T>(w, k[0], k[1], f);
    } else {
#pragma unroll
      for (int i = 0; i < 24; ++i) f[i] = T(0);
    }
#pragma unroll
    for (int j = 1; j < 8; ++j)
      if (!C::da(j))
#pragma unroll
        for (int c = 0; c < 3; ++c)
          lo[C::fdst(j) + tid + c * kThreads] = f[3 * j + c];
  };

  // 3. the owned node of plane q (column n): its force from f (its own
  // element's lower corner), lo (element plane q) and hi (q - 1), u and
  // du from its own slot, then the update with kv = K rows 3:7
  auto update_plane = [&](int q, int n, const T* f, const T* kv,
                          const T* z) {
    T fn[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* s = (C::da(j) ? hi : lo) + C::fdst(j) + tid - C::gof(j);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        fn[c] = fn[c] + (j == 0 ? f[c] : s[c * kThreads]);
    }
    const T* d = slot(q) + mine;
    T u[3], un[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = d[c * NN];
      un[c] = fma_rn(fma_rn(kv[c], u[c] - d[(3 + c) * NN], fn[c]), kv[3],
                     u[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c * len + n] = un[c];
      out[(3 + c) * len + n] = u[c];
    }
    out[6 * len + n] = z[0];
    out[7 * len + n] = z[1];
  };

  // the march: one copy group a plane (the state ahead; in float32 a
  // second for the node's K rows)
  copy_state(a0 - 1);
  copy_state(a0);
  if (kStaged) copy_coef(a0 - 1);
  cp_async_commit();
  T f[24];
  for (int p = a0 - 1; p < a1; ++p) {
    T k[3];
    if (!kStaged) load_coef(p, k);
    cp_async_wait<0>();
    __syncthreads();
    // plane p - 1's upper corners, after every read of hi by the update
    // of plane p - 1
    if (p > a0 - 1 && on_grid)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (C::da(j))
#pragma unroll
          for (int c = 0; c < 3; ++c)
            hi[C::fdst(j) + tid + c * kThreads] = f[3 * j + c];
    const int n = p * g.s_out + exy;
    const bool upd = p >= a0 && own_xy && n < len;
    if (kStaged) {
      if (upd)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cp_async(kn + r * kThreads + tid, K + (3 + r) * len + n, true);
      cp_async_commit();
    }
    if (p + 2 <= a1) copy_state(p + 2);
    if (kStaged && p + 1 < a1) copy_coef(p + 1);
    cp_async_commit();
    T kv[4], z[2];
    if (upd) {
      z[0] = S[6 * len + n];
      z[1] = S[7 * len + n];
      if (!kStaged)
#pragma unroll
        for (int r = 0; r < 4; ++r) kv[r] = K[(3 + r) * len + n];
    }
    if (on_grid) {
      if (kStaged) {
        const T* kc = coef + (p & 1) * 3 * kThreads + tid;
        const T ks[3] = {kc[0], kc[kThreads], kc[2 * kThreads]};
        force_plane(p, ks, f);
      } else {
        force_plane(p, k, f);
      }
    }
    if (kStaged) cp_async_wait<1>();
    __syncthreads();
    if (upd) {
      if (kStaged)
#pragma unroll
        for (int r = 0; r < 4; ++r) kv[r] = kn[r * kThreads + tid];
      update_plane(p, n, f, kv, z);
    }
  }
}

}  // namespace
}  // namespace ht
