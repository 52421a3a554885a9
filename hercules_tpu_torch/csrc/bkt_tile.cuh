// The tiled BKT step body on a brick's flat node grid, shared by
// bkt_step (K2, one launch per step), bkt_chunk (K6, a persistent
// launch per chunk of steps) and, for its geometry and tiles, bkt_node
// (K3, with the element force) and the elastic march of brick_tile.cuh
// (K1, K5, with hadamard8, the chunk grid and the source hooks).  K2
// and K6 inline bkt_tile_step with the same arguments, so they run the
// same arithmetic in the same order and give bit-identical states.
//
// Layout (hercules_tpu_torch/solver/fused_bkt.py):
//   S    [8, len]: rows 0:3 = u, 3:6 = u-, 6:8 = zero rows carried
//                  through.
//   conv [R, len]: the node memory variables in the storage type CT
//                  (bfloat16, float or double): rows 0:3 = s0, 3:6 = s1,
//                  and with KAPPA 6:9 = k0, 9:12 = k1 (R = 6 or 12).
//   K    [8, len]: rows 0:3 = mass_minusaM, 3 = inv_mass, 4 = element
//                  valid (the element whose lowest corner is this
//                  column), 5:8 = 0.
//   r    the 9 | 18 recursion scalars (bkt_step.cuh's BktRec); mu_f and
//        kappa_f the brick's one pair of operator scales.
//
// The step (hercules_tpu/solver/pallas_brick.py:_make_bkt_uniform_kernel,
// :1477-1496 and :1642-1646):
//   s0' = c2 u + c1 u- + e0 s0,   s1' = c4 u + c3 u- + e1 s1
//   dvs = coef (u - u-) + u - a0 s0' - a1 s1'     (dvk alike, or u)
//   F_e = valid_e (mu_f Kmu dvs_e + kappa_f Kkappa dvk_e)
//   F_n = sum over the 8 elements e = n - o[j] of rows 3j..3j+2 of F_e
//   u+  = u + (F_n + mass_minusaM (u - u-)) inv_mass
//
// Design (H100).  A work item is a tile of 31 x 7 owned nodes on a slab
// of kSlab planes; one block of 256 threads runs it and marches through
// the slab plane by plane:
//   1. dv: the recursion at the tile's nodes plus a one-node halo on
//      each side (33 x 9) of the next plane, from device memory into
//      shared memory; owned nodes store conv'.  Halo nodes are
//      recomputed, never stored, so the damping vectors never leave the
//      chip and no block reads what another block writes in the step.
//   2. force: one thread per element of the 32 x 8 element tile (the
//      owned nodes' elements and the halo row and column on the minus
//      side) forms the element's 24 force values once, in the spectral
//      form, into shared memory; the rows of the corners in the upper
//      plane are kept for the next plane's gather.
//   3. gather: each owned node sums its 8 slices, j ascending (a fixed
//      order, no atomics), and updates S; a source hook may add to the
//      new displacement before it is stored (K6's sources).
// The flat node grid is read as planes: of the three strides o[1],
// o[2], o[4] one is 1 (the inner axis), one the inner extent (mid axis)
// and one a plane (outer axis), in whatever order the brick has.  Halo
// coordinates past a row or plane edge name the flat neighbours, so
// every element e reads exactly the columns e + o[i] as the plain
// version does.
//
// The element force is the TPU kernels' spectral form
// (physics/kmats.py:spectral_bkt_factors): the 8-corner Hadamard
// transform of dvs and dvk, a multiply-add per nonzero of the sparse
// factors as immediate operands (bkt_spectral.cuh), mu and kappa, the
// inverse transform -- about 400 operations per element instead of a
// dense [24, 48] product's 2,304.  The dense product was the slower by
// far on an H100 (PERF.md).
//
// Rounding: the recursion as rec_pair (the plain version's order; the
// library is built with --fmad=false, so nothing is contracted), conv'
// rounded to CT once, on store; the force in the spectral form's own
// order (the plain version multiplies the dense matrices), so it agrees
// with the plain version to rounding, not bit for bit.
#pragma once

#include "bkt_spectral.cuh"
#include "bkt_step.cuh"

namespace ht {
namespace {

// x <- H x over the 8 corners, per component, in place: the butterfly
// stages of physics/kmats.py:hadamard8_stages (lo + hi, lo - hi).
template <typename T>
__device__ __forceinline__ void hadamard8(T* x) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!(j >> k & 1)) {
        const int h = j | (1 << k);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T lo = x[3 * j + c], hi = x[3 * h + c];
          x[3 * j + c] = lo + hi;
          x[3 * h + c] = lo - hi;
        }
      }
}

// One element's force f [24] = mu Kmu xs + ka Kkappa xk in the spectral
// form: the transforms of xs and xk (in place), a multiply-add per
// nonzero of the sparse factors (bkt_spectral.cuh, immediate operands),
// the scaling, and the inverse transform.
template <typename T>
__device__ __forceinline__ void element_force_spectral(T* xs, T* xk, T mu,
                                                       T ka, T* f) {
  hadamard8(xs);
  hadamard8(xk);
  T ym[24], yk[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) ym[i] = yk[i] = T(0);
#define HT_ACC_MU(mo, co, mi, ci, v) \
  ym[3 * mo + co] = fma_rn(T(v), xs[3 * mi + ci], ym[3 * mo + co]);
#define HT_ACC_KAPPA(mo, co, mi, ci, v) \
  yk[3 * mo + co] = fma_rn(T(v), xk[3 * mi + ci], yk[3 * mo + co]);
  HT_BKT_SPECTRAL_MU(HT_ACC_MU)
  HT_BKT_SPECTRAL_KAPPA(HT_ACC_KAPPA)
#undef HT_ACC_MU
#undef HT_ACC_KAPPA
#pragma unroll
  for (int i = 0; i < 24; ++i) f[i] = mu * ym[i] + ka * yk[i];
  hadamard8(f);
}

// The block's tile: TX x TY elements, one per thread; the owned nodes
// are the (TX - 1) x (TY - 1) lowest corners of all but the first
// column and row; the damping vectors cover (TX + 1) x (TY + 1) nodes.
// kernels/tiles.py mirrors TX, TY and make_geom's tile numbering (K6's
// per-tile source lists).  K1 may take a wider tile (brick_tile.cuh's
// StepTile) and counts its tiles_x itself (brick_step.cu:plan).
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int kThreads = TX * TY;
constexpr int OX = TX - 1;
constexpr int OY = TY - 1;
constexpr int NX = TX + 1;
constexpr int NN = NX * (TY + 1);
constexpr int kF = 12 * kThreads;  // the force rows of 4 corners
// planes of the node grid each work item marches through (4 was no
// faster on an H100, 16 slower in float32; PERF.md).  The kernels read
// it from Geom: compiled into the march's trip count, it made K3's
// float32 kernel take 144 registers instead of 128 on an H100, one
// block per SM instead of two, and 41 % slower (PERF.md).
constexpr int kSlab = 8;

// Shared memory of one block: the damping vectors of two planes
// [2][6][NN], then the force rows [lower | upper x 2][kF].
template <typename T>
constexpr int tile_smem_bytes() {
  return (2 * 6 * NN + 3 * kF) * static_cast<int>(sizeof(T));
}

// Geometry of the flat node grid and of the tiles, from the corner
// offsets (make_geom).  Per corner j with offset (dx, dy, da) in tile
// coordinates: cda = da, nof = its node in the dv tile relative to the
// element's lowest corner, gof = the element n - o[j] in the element
// tile relative to node n's thread, fdst = rows 3j..3j+2 of the force in
// the shared half of its plane (da = 0: the element's plane, 1: the
// next one).
struct Geom {
  int o[8];
  int s_mid, s_out, nx, ny, nplanes, tiles_x, tiles_y, slab;
  int cda[8], nof[8], gof[8], fdst[8];
};

// Geom of a brick's corner offsets, or false when they are not the 8
// corners of a flat grid (a stride of 1, a mid stride, a plane stride
// that the mid stride divides at least twice).
inline bool make_geom(const int* o, int len, Geom* g) {
  int s[3] = {o[1], o[2], o[4]};
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 2 - i; ++k)
      if (s[k] > s[k + 1]) {
        const int t = s[k];
        s[k] = s[k + 1];
        s[k + 1] = t;
      }
  if (o[0] != 0 || s[0] != 1 || s[1] < 2 || s[2] % s[1] != 0 ||
      s[2] / s[1] < 2 || len < 1)
    return false;
  for (int j = 0; j < 8; ++j) {
    const int want = ((j & 1) ? o[1] : 0) + ((j & 2) ? o[2] : 0) +
                     ((j & 4) ? o[4] : 0);
    if (o[j] != want) return false;
    g->o[j] = o[j];
  }
  g->s_mid = s[1];
  g->s_out = s[2];
  g->nx = s[1];
  g->ny = s[2] / s[1];
  g->nplanes = (len + s[2] - 1) / s[2];
  g->tiles_x = (g->nx + OX - 1) / OX;
  g->tiles_y = (g->ny + OY - 1) / OY;
  g->slab = kSlab < g->nplanes ? kSlab : g->nplanes;
  int lo = 0, hi = 0;
  for (int j = 0; j < 8; ++j) {
    const int da = o[j] / s[2], r = o[j] % s[2];
    const int dy = r / s[1], dx = r % s[1];
    g->cda[j] = da;
    g->nof[j] = dy * NX + dx;
    g->gof[j] = dy * TX + dx;
    g->fdst[j] = (da ? hi++ : lo++) * 3 * kThreads;
  }
  return lo == 4 && hi == 4;
}

// The work items, (tile, slab) pairs: item i is tile i % tiles on slab
// i / tiles; every node column of [0, len) is owned by exactly one.
__host__ __device__ __forceinline__ int tile_items(const Geom& g) {
  return g.tiles_x * g.tiles_y * ((g.nplanes + g.slab - 1) / g.slab);
}

// The chunk kernels' grid (K5, K6): `resident` blocks, as many as the
// card holds at once.  Where it holds a block for every tile, the slabs
// are deepened until each resident block has at most one work item (at
// 2^20 elements in float32: 380 items of 17 planes on 396 blocks, where
// 8-plane slabs would leave a third round to a sixth of the blocks and
// repeat a halo plane every 8 planes).  Returns the blocks to launch.
inline int chunk_grid(Geom* g, int resident) {
  const int per_tile = resident / (g->tiles_x * g->tiles_y);
  if (per_tile >= 1) g->slab = (g->nplanes + per_tile - 1) / per_tile;
  const int items = tile_items(*g);
  return resident < items ? resident : items;
}

// The source hook of a step without sources (K1, K2: the step routes
// add them after the kernel).
struct NoSources {
  template <typename T>
  __device__ __forceinline__ void operator()(int, T*) const {}
};

// The source hook of one work item in step t of a chunk kernel (K5,
// K6): the increments inc [3, nsrc] of this step at src_pos; list
// [count] the sources of the item's tile (those on other slabs match no
// node of the item), in source order (kernels/tiles.py:tile_sources),
// so sources sharing a position are added one after another in source
// order.
template <typename T>
struct ItemSources {
  const int* list;
  int count;
  const int* pos;
  const T* inc;
  int nsrc;

  __device__ __forceinline__ void operator()(int n, T* un) const {
    for (int i = 0; i < count; ++i) {
      const int m = list[i];
      if (pos[m] == n)
#pragma unroll
        for (int c = 0; c < 3; ++c) un[c] = un[c] + inc[c * nsrc + m];
    }
  }
};

// One step of work item `item` by the calling block: (S, conv) ->
// (out, conv_out) at the item's owned nodes.  smem holds
// tile_smem_bytes<T>() bytes.  src(n, un) is called by the thread that
// updates owned node n with its new displacement un[3] before it is
// stored.  Every state pointer is read with plain (coherent) loads:
// bkt_chunk reads buffers that other blocks wrote earlier in its
// launch.  Each node's loads come before its stores in the code: the
// compiler keeps a coherent load behind every earlier store that may
// alias it (only loads it can prove read-only, such as K2's through its
// restrict inputs, move freely), so K6 with loads and stores
// interleaved waited on memory one group at a time (PERF.md).
// Consecutive calls by one block need no barrier between them:
// the last shared-memory reads of a call (the final gather, of the
// force rows) come before the next call's first barrier, and its first
// writes (the damping vectors) go to the other buffer.
template <typename T, typename CT, bool KAPPA, typename Sources>
__device__ __forceinline__ void bkt_tile_step(
    const T* S, const CT* conv, const T* K, T* out, CT* conv_out, int len,
    const Geom& g, const BktRec<T>& r, T mu_f, T kappa_f, int item, T* smem,
    const Sources& src) {
  T* dvb = smem;              // [2 planes][6][NN]
  T* fb = dvb + 2 * 6 * NN;   // [lower | upper x 2][kF]
  const int tid = threadIdx.x;
  const int lx = tid % TX, ly = tid / TX;
  const int tiles = g.tiles_x * g.tiles_y;
  const int tile = item % tiles;
  const int x0 = (tile % g.tiles_x) * OX, y0 = (tile / g.tiles_x) * OY;
  const int a0 = (item / tiles) * g.slab;
  const int a1 = min(a0 + g.slab, g.nplanes);
  // this thread's element (force) and node (gather): its lowest corner
  const int ex = x0 - 1 + lx, ey = y0 - 1 + ly;
  const int exy = ey * g.s_mid + ex;
  // elements past the last row or column alias flat neighbours that no
  // owned node gathers
  const bool on_grid = ex < g.nx && ey < g.ny;
  const bool own_xy = lx >= 1 && ly >= 1 && on_grid;

  // 1. the damping vectors of plane a (tile and halo) into shared
  // memory; conv' at the owned nodes
  auto dv_plane = [&](int a) {
    T* d = dvb + (a & 1) * 6 * NN;
    const bool own_plane = a >= a0 && a < a1;
    for (int q = tid; q < NN; q += kThreads) {
      const int qx = q % NX, qy = q / NX;
      const int x = x0 - 1 + qx, y = y0 - 1 + qy;
      if (x > g.nx || y > g.ny) continue;  // no element on the grid reads it
      const int n = a * g.s_out + y * g.s_mid + x;
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (a >= 0 && n >= 0 && n < len) {
        const bool own = own_plane && qx >= 1 && qy >= 1 && qx <= OX &&
                         qy <= OY && x < g.nx && y < g.ny;
        // every load before the first store (see above)
        T us[6], cv[KAPPA ? 12 : 6];
#pragma unroll
        for (int k = 0; k < 6; ++k) us[k] = S[k * len + n];
#pragma unroll
        for (int k = 0; k < (KAPPA ? 12 : 6); ++k)
          cv[k] = conv_load(conv + k * len + n);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T u = us[c];
          const T up = us[3 + c];
          const T du = u - up;
          T s0n, s1n;
          rec_pair<T>(r.v, u, up, du, cv[c], cv[3 + c], s0n, s1n, v[c]);
          if (own) {
            conv_store(conv_out + c * len + n, s0n);
            conv_store(conv_out + (3 + c) * len + n, s1n);
          }
          if (KAPPA) {
            rec_pair<T>(r.v + 9, u, up, du, cv[6 + c], cv[9 + c], s0n, s1n,
                        v[3 + c]);
            if (own) {
              conv_store(conv_out + (6 + c) * len + n, s0n);
              conv_store(conv_out + (9 + c) * len + n, s1n);
            }
          } else {
            v[3 + c] = u;  // shear-only: the kappa term acts on u
          }
        }
      }
#pragma unroll
      for (int f = 0; f < 6; ++f) d[f * NN + q] = v[f];
    }
  };

  // 2. the force of element plane p: 24 values per element into the
  // lower half (corners in plane p) and the upper half of p's parity
  // (corners in plane p + 1)
  auto force_plane = [&](int p) {
    if (!on_grid) return;
    const T* d0 = dvb + (p & 1) * 6 * NN;
    const T* d1 = dvb + ((p + 1) & 1) * 6 * NN;
    T* fh = fb + kF * (1 + (p & 1));
    const int e = p * g.s_out + exy;
    T valid = T(0);
    if (p >= 0 && e >= 0 && e + g.o[7] < len) valid = K[4 * len + e];
    T f[24];
    if (valid != T(0)) {
      T xs[24], xk[24];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T* s = (g.cda[i] ? d1 : d0) + ly * NX + lx + g.nof[i];
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          xs[3 * i + cc] = s[cc * NN];
          xk[3 * i + cc] = s[(3 + cc) * NN];
        }
      }
      element_force_spectral<T>(xs, xk, mu_f * valid, kappa_f * valid, f);
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

  // 3. the owned nodes of plane q: their force from the elements of
  // planes q (lower half) and q - 1 (upper half), then the update
  auto gather_plane = [&](int q) {
    if (!own_xy) return;
    const int n = q * g.s_out + exy;
    if (n >= len) return;
    const T* fh = fb + kF * (1 + ((q - 1) & 1));
    T f[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* s = (g.cda[j] ? fh : fb) + g.fdst[j] + tid - g.gof[j];
#pragma unroll
      for (int c = 0; c < 3; ++c) f[c] = f[c] + s[c * kThreads];
    }
    // every load before the first store (see above)
    T us[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) us[k] = S[k * len + n];
    const T invm = K[3 * len + n];
    T un[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      un[c] = fma_rn(fma_rn(K[c * len + n], us[c] - us[3 + c], f[c]), invm,
                     us[c]);
    src(n, un);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c * len + n] = un[c];
      out[(3 + c) * len + n] = us[c];
    }
    out[6 * len + n] = us[6];
    out[7 * len + n] = us[7];
  };

  // the march: plane p's damping vectors come one plane ahead of its
  // element forces, and a node plane is gathered once both element
  // planes around it are formed.  Shared buffers alternate by parity;
  // two barriers per plane separate each buffer's writers and readers.
  dv_plane(a0 - 1);
  for (int p = a0 - 1; p < a1; ++p) {
    dv_plane(p + 1);
    if (p - 1 >= a0) gather_plane(p - 1);
    __syncthreads();
    force_plane(p);
    __syncthreads();
  }
  gather_plane(a1 - 1);
}

// Opt the kernel into `bytes` of dynamic shared memory (above 48 KB
// only after opting in), once per device and kernel.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes, int device,
                               unsigned* opted) {
  if (*opted >> device & 1u) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *opted |= 1u << device;
  return err;
}

}  // namespace
}  // namespace ht
