// bkt_node: one step of a general-Q BKT brick with node-basis memory
// variables (the port's K3), the mixed elements' force formed inside.
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_bkt_node_kernel,
// launched by build_bkt_node_call (one call per step,
// _make_packed_bkt_node_step), together with the mixed-element epilogue
// the JAX package runs after it (bkt_mix_epilogue, _bkt_mix_runs,
// _bkt_mix_one).
//
// A brick whose elements carry several BKT coefficient sets (one per
// QTABLE bin of the Qs(Vs) fit) keeps one memory variable per node, as
// the uniform tier does: every node takes the set of one adjacent
// element (solver/fused_bktq.py:assign_bkt_node_coeffs).  The "mixed"
// elements, whose corners carry a foreign set, keep their own corner-
// basis state conv_mix [R, 8, M]: for them this kernel runs the
// recursion on conv_mix with the element's own coefficient row and forms
// the force from those element-basis damping vectors (the direct form).
// In exact arithmetic that is the JAX package's F(dv_n) + FM mu_f (dvs_e
// - dvs_n) (and the kappa term); it also holds at the columns a coalesced
// mixed set bridges, whose mu_f = kappa_f = 0 when invalid.
//
// Layout (hercules_tpu_torch/solver/fused_bktq.py):
//   S    [8, len]: u, u-, 0, 0.
//   conv [R, len]: s0, s1 (and k0, k1 with KAPPA) x 3 in the storage type.
//   K    [8, len]: rows 0:3 = mass_minusaM, 3 = inv_mass, 4 = mu_f and
//                  5 = kappa_f of the element whose lowest corner is this
//                  column (0 for padding and invalid elements), 6 = the
//                  node's set index as a float (nsets: no adjacent
//                  element, whose table row is zero), 7 = 0.
//   slot [len] int32: m if the element at this column is mixed_cols[m],
//                  else -1 (values outside [0, M) count as -1).
//   mce  [9 | 18, M]: the mixed elements' own recursion rows (c1 c2 c3 c4
//                  e0 e1 a0 a1 coef, shear then kappa).
//   cmix [R, 8, M]: their state, row r, corner i, slot m at (8 r + i) M
//                  + m, in the storage type; cmix_out the same.
//   tab  [24 * 48 + kTab]: fm [24, 48] = [Kmu | Kkappa] (the plain
//        version's; the kernel uses the spectral form, bkt_spectral.cuh),
//        then the sets table [kMaxSets + 1, 18], which goes to constant
//        memory: row b = the 9 shear and 9 kappa recursion coefficients
//        of set b (c1 c2 c3 c4 e0 e1 a0 a1 coef), zero rows from nsets on.
//
// Design (H100).  One launch per step; no intermediate leaves the chip.
// The flat node grid is read as planes: of the three strides o[1], o[2],
// o[4] one is 1 (the inner axis), one the inner extent (mid axis) and one
// a plane (outer axis); which is which follows the brick's axis order.
// A block of 256 threads owns a tile of 31 x 7 nodes on a slab of
// kSlab planes and marches through the slab plane by plane:
//   1. dv: the recursion at the tile's nodes plus a one-node halo on
//      each side (33 x 9) of the next plane, from device memory into
//      shared memory (dvs and dvk, or u when shear-only); owned nodes
//      store conv'.  Halo nodes are recomputed, never stored.
//   2. force: one thread per element of the 32 x 8 element tile (the
//      owned nodes' elements and the halo row and column on the minus
//      side) forms the element's 24 force values ONCE into shared
//      memory, from the 48 damping values of its 8 corners (from step 1,
//      or for a mixed element from its own recursion on cmix, which the
//      owning block stores).  The rows of the corners in the element's
//      upper plane are kept for the next plane's gather, as the TPU
//      kernel carries its O(plane) tail.
//   3. gather: each owned node sums its 8 slices from shared memory, j
//      ascending (a fixed order, no atomics), and updates S.
// A node's column is flat: halo coordinates past the row or plane edge
// name the flat neighbours, so every element e reads exactly the columns
// e + o[i] as the plain version does.
//
// The element force is the TPU kernels' spectral form
// (physics/kmats.py:spectral_bkt_factors): the 8-corner Hadamard
// transform of dvs and dvk, 69 multiply-adds by the sparse factors'
// nonzeros as immediate operands, mu_f and kappa_f, the inverse
// transform -- about 400 operations per element instead of a dense
// [24, 48] product's 2,304, and no operator table to read.  The dense
// product, this kernel's first form, was the slower by far on an H100
// (PERF.md).
//
// What bounds it: memory.  The function reads S (6 rows), K (7 rows),
// conv, the mixed state and the mixed columns once and writes S', conv'
// and conv_mix' once: 157 MB per step at 2^20 elements in float32 with
// 12 bfloat16 rows (0.047 ms at 3.35 TB/s).
//
// Rounding: the recursion as bkt_step.cuh's rec_pair (the plain
// version's order, --fmad=false), conv' and conv_mix' rounded to the
// storage type once, on store; the force in the spectral form's own
// order (the plain version multiplies the dense matrices), so it agrees
// with the plain version to rounding, not bit for bit.
#include "bkt_tile.cuh"

namespace {

// the tile geometry, its constants and the spectral element force
// (bkt_tile.cuh), shared with K2 and K6
using ht::element_force_spectral;
using ht::Geom;
using ht::kF;
using ht::kThreads;
using ht::make_geom;
using ht::NN;
using ht::NX;
using ht::opt_in_smem;
using ht::OX;
using ht::OY;
using ht::tile_items;
using ht::tile_smem_bytes;
using ht::TX;

// the most distinct coefficient sets a brick may have (len(QTABLE));
// the table holds one more, zero row
constexpr int kMaxSets = 18;
constexpr int kRow = 18;  // coefficients per set row
constexpr int kTab = (kMaxSets + 1) * kRow;

static __constant__ float c_sets_f32[kTab];
static __constant__ double c_sets_f64[kTab];

template <typename T> __device__ __forceinline__ T setv(int i);
template <> __device__ __forceinline__ float setv<float>(int i) {
  return c_sets_f32[i];
}
template <> __device__ __forceinline__ double setv<double>(int i) {
  return c_sets_f64[i];
}

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    bkt_node_kernel(const T* __restrict__ S, const CT* __restrict__ conv,
                    const T* __restrict__ K, T* __restrict__ out,
                    CT* __restrict__ conv_out, const int* __restrict__ slot,
                    const T* __restrict__ mce, const CT* __restrict__ cmix,
                    CT* __restrict__ cmix_out, int M, int len, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* dvb = reinterpret_cast<T*>(smem);  // [2 planes][6][NN]
  T* fb = dvb + 2 * 6 * NN;             // [lower | upper x 2][kF]
  const int tid = threadIdx.x;
  const int lx = tid % TX, ly = tid / TX;
  const int tiles = g.tiles_x * g.tiles_y;
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile % g.tiles_x) * OX, y0 = (tile / g.tiles_x) * OY;
  const int a0 = (blockIdx.x / tiles) * g.slab;
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
        int bin = static_cast<int>(K[6 * len + n]);
        bin = bin < 0 ? 0 : (bin > kMaxSets ? kMaxSets : bin);
        T k[kRow];
#pragma unroll
        for (int i = 0; i < (KAPPA ? 18 : 9); ++i)
          k[i] = setv<T>(bin * kRow + i);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T u = S[c * len + n];
          const T up = S[(3 + c) * len + n];
          const T du = u - up;
          T s0n, s1n;
          ht::rec_pair<T>(k, u, up, du, ht::conv_load(conv + c * len + n),
                          ht::conv_load(conv + (3 + c) * len + n), s0n, s1n,
                          v[c]);
          if (own) {
            ht::conv_store(conv_out + c * len + n, s0n);
            ht::conv_store(conv_out + (3 + c) * len + n, s1n);
          }
          if (KAPPA) {
            ht::rec_pair<T>(k + 9, u, up, du,
                            ht::conv_load(conv + (6 + c) * len + n),
                            ht::conv_load(conv + (9 + c) * len + n), s0n,
                            s1n, v[3 + c]);
            if (own) {
              ht::conv_store(conv_out + (6 + c) * len + n, s0n);
              ht::conv_store(conv_out + (9 + c) * len + n, s1n);
            }
          } else {
            v[3 + c] = u;
          }
        }
      }
#pragma unroll
      for (int f = 0; f < 6; ++f) d[f * NN + q] = v[f];
    }
  };

  // 2. the force of element plane p: 24 values per element into the
  // lower half (corners in plane p) and the upper half of p's parity
  // (corners in plane p + 1); conv_mix' of the owned mixed elements
  auto force_plane = [&](int p) {
    if (!on_grid) return;
    const T* d0 = dvb + (p & 1) * 6 * NN;
    const T* d1 = dvb + ((p + 1) & 1) * 6 * NN;
    T* fh = fb + kF * (1 + (p & 1));
    const int e = p * g.s_out + exy;
    const bool fits = p >= 0 && e >= 0 && e + g.o[7] < len;
    T mu = T(0), ka = T(0);
    if (fits) {
      mu = K[4 * len + e];
      ka = K[5 * len + e];
    }
    const bool live = fits && !(mu == T(0) && ka == T(0));
    int m = -1;
    if (M > 0 && fits) {
      m = slot[e];
      if (m >= M) m = -1;
    }
    T xs[24], xk[24];
    if (m >= 0) {
      // a mixed element: its own recursion on its corner-basis state
      const bool own = own_xy && p >= a0 && p < a1;
      T k[kRow];
#pragma unroll
      for (int r = 0; r < (KAPPA ? 18 : 9); ++r) k[r] = mce[r * M + m];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = e + g.o[i];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T u = S[c * len + col];
          const T up = S[(3 + c) * len + col];
          const T du = u - up;
          const int r0 = (c * 8 + i) * M + m, r1 = ((3 + c) * 8 + i) * M + m;
          T s0n, s1n;
          ht::rec_pair<T>(k, u, up, du, ht::conv_load(cmix + r0),
                          ht::conv_load(cmix + r1), s0n, s1n, xs[3 * i + c]);
          if (own) {
            ht::conv_store(cmix_out + r0, s0n);
            ht::conv_store(cmix_out + r1, s1n);
          }
          if (KAPPA) {
            const int r2 = ((6 + c) * 8 + i) * M + m;
            const int r3 = ((9 + c) * 8 + i) * M + m;
            ht::rec_pair<T>(k + 9, u, up, du, ht::conv_load(cmix + r2),
                            ht::conv_load(cmix + r3), s0n, s1n,
                            xk[3 * i + c]);
            if (own) {
              ht::conv_store(cmix_out + r2, s0n);
              ht::conv_store(cmix_out + r3, s1n);
            }
          } else {
            xk[3 * i + c] = u;
          }
        }
      }
    } else if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T* src = (g.cda[i] ? d1 : d0) + ly * NX + lx + g.nof[i];
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          xs[3 * i + cc] = src[cc * NN];
          xk[3 * i + cc] = src[(3 + cc) * NN];
        }
      }
    }
    T f[24];
    if (live) {
      element_force_spectral<T>(xs, xk, mu, ka, f);
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
      const T* src = (g.cda[j] ? fh : fb) + g.fdst[j] + tid - g.gof[j];
#pragma unroll
      for (int c = 0; c < 3; ++c) f[c] = f[c] + src[c * kThreads];
    }
    const T invm = K[3 * len + n];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T u = S[c * len + n];
      const T up = S[(3 + c) * len + n];
      const T mm = K[c * len + n];
      out[c * len + n] = ht::fma_rn(ht::fma_rn(mm, u - up, f[c]), invm, u);
      out[(3 + c) * len + n] = u;
    }
    out[6 * len + n] = S[6 * len + n];
    out[7 * len + n] = S[7 * len + n];
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

template <typename T, typename CT, bool KAPPA>
int launch_k(const T* S, const CT* conv, const T* K, T* out, CT* conv_out,
             const int* slot, const T* mce, const CT* cmix, CT* cmix_out,
             int M, int len, const Geom& g, int device, cudaStream_t s) {
  const int smem = tile_smem_bytes<T>();
  static unsigned opted = 0;
  cudaError_t err =
      opt_in_smem(bkt_node_kernel<T, CT, KAPPA>, smem, device, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  bkt_node_kernel<T, CT, KAPPA><<<tile_items(g), kThreads, smem, s>>>(
      S, conv, K, out, conv_out, slot, mce, cmix, cmix_out, M, len, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(const T* S, const void* conv, const T* K, T* out, void* conv_out,
           const int* slot, const T* mce, const void* cmix, void* cmix_out,
           int M, int len, const int* offs, int kappa, int device,
           void* stream) {
  Geom g;
  if (device < 0 || device >= 32 || !make_geom(offs, len, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CT* c = static_cast<const CT*>(conv);
  CT* co = static_cast<CT*>(conv_out);
  const CT* cm = static_cast<const CT*>(cmix);
  CT* cmo = static_cast<CT*>(cmix_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(S, c, K, out, co, slot, mce, cm, cmo, M,
                                 len, g, device, s);
  return launch_k<T, CT, false>(S, c, K, out, co, slot, mce, cm, cmo, M,
                                len, g, device, s);
}

// Upload the sets table [kTab] of tab = (fm [24 * 48], sets) (one device
// array) into this unit's constant bank, ordered on `stream`; the kernel
// takes the operators in their spectral form (bkt_spectral.cuh), so fm,
// which the plain version reads, stays on the device.
template <typename T>
int set_tab(const T* dev_tab, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* sets = dev_tab + 24 * 48;
  if constexpr (sizeof(T) == sizeof(float))
    err = cudaMemcpyToSymbolAsync(c_sets_f32, sets, sizeof(c_sets_f32), 0,
                                  cudaMemcpyDeviceToDevice, s);
  else
    err = cudaMemcpyToSymbolAsync(c_sets_f64, sets, sizeof(c_sets_f64), 0,
                                  cudaMemcpyDeviceToDevice, s);
  return static_cast<int>(err);
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer; slot, mce, cmix and cmix_out may be null when M is 0;
// the suffix names the working type and the conv storage type; `kappa`
// selects the 12-row state.  The return value is a cudaError_t (0 =
// success; cudaErrorInvalidValue for offsets that are not a brick's).
extern "C" {

int ht_bkt_node_set_tab_f32(const float* tab, int device, void* stream) {
  return set_tab<float>(tab, device, stream);
}
int ht_bkt_node_set_tab_f64(const double* tab, int device, void* stream) {
  return set_tab<double>(tab, device, stream);
}
int ht_bkt_node_step_f32_bf16(const float* S, const void* conv,
                              const float* K, float* out, void* conv_out,
                              const int* slot, const float* mce,
                              const void* cmix, void* cmix_out, int M,
                              int len, const int* offs, int kappa,
                              int device, void* stream) {
  return launch<float, __nv_bfloat16>(S, conv, K, out, conv_out, slot, mce,
                                      cmix, cmix_out, M, len, offs, kappa,
                                      device, stream);
}
int ht_bkt_node_step_f32_f32(const float* S, const void* conv,
                             const float* K, float* out, void* conv_out,
                             const int* slot, const float* mce,
                             const void* cmix, void* cmix_out, int M,
                             int len, const int* offs, int kappa,
                             int device, void* stream) {
  return launch<float, float>(S, conv, K, out, conv_out, slot, mce, cmix,
                              cmix_out, M, len, offs, kappa, device, stream);
}
int ht_bkt_node_step_f64_f64(const double* S, const void* conv,
                             const double* K, double* out, void* conv_out,
                             const int* slot, const double* mce,
                             const void* cmix, void* cmix_out, int M,
                             int len, const int* offs, int kappa,
                             int device, void* stream) {
  return launch<double, double>(S, conv, K, out, conv_out, slot, mce, cmix,
                                cmix_out, M, len, offs, kappa, device,
                                stream);
}

}  // extern "C"
