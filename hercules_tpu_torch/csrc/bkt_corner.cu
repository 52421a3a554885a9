// bkt_corner: one step of a BKT brick with memory variables per element
// corner (the port's K4).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_bkt_kernel,
// launched by build_bkt_call (one call per step, make_pallas_step).  It
// is the tier for bricks whose coefficient sets the node tier (K3)
// declines, and it holds any BKT brick exactly.
//
// Layout (hercules_tpu_torch/solver/fused_bktq.py):
//   S    [8, len]: u, u-, 0, 0 (the port's packed state).
//   conv [R, len]: R = 48 (shear-only) or 96 rows per element column e,
//                  row 24 v + 3 j + c = variable v (s0, s1, k0, k1) of
//                  e's corner j, component c, in the storage type
//                  (bfloat16 in float32 runs, double in float64 runs).
//   K    [8, len]: rows 0:3 = mass_minusaM, 3 = inv_mass, and of the
//                  element whose lowest corner is this column: 4 = mu_f,
//                  5 = kappa_f (0 at padding and invalid elements), 6 =
//                  its shear coefficient set and 7 its kappa set (set
//                  indices as floats).
//   tab  [24 * 48 + 2 * kSets * 9]: fm [24, 48] = [Kmu | Kkappa] (the
//        plain version's; the kernel uses the spectral form), then the
//        sets table [2][kSets][9], which goes to constant memory: row
//        [0][i] = shear set i, [1][i] = kappa set i (c1 c2 c3 c4 e0 e1
//        a0 a1 coef), zero rows after the brick's sets.  Each channel's
//        coefficients follow its QTABLE bin (18, or none: 19 sets at
//        most), so one index per channel holds any brick, where one
//        index for the pair would need up to 19 x 19 sets.
//
// The step (pallas_brick.py:1280-1332), per element e with u24, u-24 at
// its 8 corners (rows 3 j + c), du = u - u-, up = u - du:
//   s0' = c2 u + c1 up + e0 s0,   s1' = c4 u + c3 up + e1 s1
//   dvs = coef du + u - a0 s0' - a1 s1'      (dvk alike, or u)
//   F_e = mu_f Kmu dvs + kappa_f Kkappa dvk                 [24]
//   u+  = u + (sum of F at the node + mass_minusaM (u - u-)) inv_mass
//
// The memory variables belong to (element, corner), so the recursion
// runs once per element on its own 48 | 96 rows with its own
// coefficients: the mixed-element branch of K3 (bkt_node.cu), here for
// every element and with no node-basis damping vectors.
//
// Design (H100).  One launch per step on bkt_tile.cuh's geometry and
// tiles; no intermediate leaves the chip.  A work item is a tile of
// 31 x 7 owned nodes on a slab of planes; one block of 256 threads runs
// it and marches through the slab plane by plane:
//   1. plane: u and du = u - u- of the next node plane, the tile and a
//      one-node halo on each side (33 x 9), from device memory into
//      shared memory.
//   2. force: one thread per element of the 32 x 8 element tile (the
//      owned nodes' elements and the halo row and column on the minus
//      side) loads its conv rows and its K rows 4:8 (contiguous along
//      the inner axis: coalesced across the warp) and its two sets'
//      coefficients from constant memory, reads its 8 corners' u and du
//      from shared memory, runs the recursion per corner and component,
//      and forms its 24 force values ONCE, in the spectral form
//      (bkt_tile.cuh:element_force_spectral, no operator table), into
//      shared memory.  Only the block that owns the element's lowest
//      corner stores conv'; halo elements (the minus-side row and
//      column, and the plane below the slab) are recomputed, never
//      stored.  The force uses the unrounded s', so a halo copy gives
//      the owner's bits.  Padding columns (e + o[7] >= len) store zero.
//   3. gather: each owned node sums its 8 slices from shared memory, j
//      ascending (a fixed order, no atomics), and updates S.
// Slabs: shallow ones.  A slab of s planes marches s + 1 element
// planes, but at 2^20 elements 2-plane slabs (3135 work items) were the
// fastest of 2, 3, 4, 5, 6, 8, 13 and 17 in float32 (0.410 ms against
// 0.476 at 8) and within 1 % of the fastest in float64; the re-read
// plane comes mostly from the L2 (PERF.md).  On the 2048-element box (3
// tiles on each of 11 planes, padding included) corner_geom thins them
// to one plane, 33 work items, where 8-plane slabs would leave 6 blocks
// for 132 SMs.
//
// What bounds it: memory.  Per column and step in float32 with
// bfloat16 memory variables and kappa the function reads S (6 rows), K
// (8) and conv (96 bfloat16) once and writes S' (6) and conv' once: 464
// B, 502.2 MB at 2^20 elements (0.150 ms at 3.35 TB/s).  The kernel
// reads S again for the update and re-reads the halo elements' K rows
// 4:8 and conv rows (256/217 of them, and half again at 2-plane slabs):
// 719 MB requested at 2^20 elements, the re-read plane mostly from the
// L2.
//
// Rounding: the recursion as bkt_step.cuh's rec_pair (the plain
// version's order, --fmad=false), conv' rounded to the storage type
// once, on store; the force in the spectral form's own order (the plain
// version multiplies the dense matrices), so it agrees with the plain
// version to rounding, not bit for bit.
#include "bkt_tile.cuh"

namespace {

using ht::element_force_spectral;
using ht::Geom;
using ht::kF;
using ht::kThreads;
using ht::NN;
using ht::NX;
using ht::OX;
using ht::OY;
using ht::TX;

// K4's deepest slab, in planes
constexpr int kCornerSlab = 2;
// coefficient sets per channel in the table (kernels/bkt_corner_step.py:
// CORNER_SETS)
constexpr int kSets = 32;
constexpr int kTab = 2 * kSets * 9;

static __constant__ float c_sets_f32[kTab];
static __constant__ double c_sets_f64[kTab];

template <typename T> __device__ __forceinline__ T setv(int i);
template <> __device__ __forceinline__ float setv<float>(int i) {
  return c_sets_f32[i];
}
template <> __device__ __forceinline__ double setv<double>(int i) {
  return c_sets_f64[i];
}

// The 9 coefficients of set row K[row * len + e] of channel `ch` into k.
template <typename T>
__device__ __forceinline__ void set_coeffs(const T* K, int row, int len,
                                           int e, int ch, T* k) {
  int i = static_cast<int>(K[row * len + e]);
  i = i < 0 ? 0 : (i >= kSets ? kSets - 1 : i);
#pragma unroll
  for (int r = 0; r < 9; ++r) k[r] = setv<T>((ch * kSets + i) * 9 + r);
}

// make_geom, then K4's slab depth for a grid of `resident` blocks at
// once: kCornerSlab planes, thinned until the grid has a work item for
// every resident block, one plane where even that does not.
// kernels/tiles.py:corner_grid mirrors it.
inline bool corner_geom(const int* offs, int len, int resident, Geom* g) {
  if (resident < 1 || !ht::make_geom(offs, len, g)) return false;
  const int slab = g->tiles_x * g->tiles_y * g->nplanes / resident;
  g->slab = slab < 1 ? 1 : (slab > kCornerSlab ? kCornerSlab : slab);
  return true;
}

// Two blocks per SM in float32 (128 registers, no spill; three, at 80,
// spilled and were slower), one in float64 (two, at 128, spilled and
// took 1.8 times as long; PERF.md).
template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    bkt_corner_kernel(const T* __restrict__ S, const CT* __restrict__ conv,
                      const T* __restrict__ K, T* __restrict__ out,
                      CT* __restrict__ conv_out, int len, Geom g) {
  constexpr int R = KAPPA ? 96 : 48;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ub = reinterpret_cast<T*>(smem);  // [2 planes][u 3 | du 3][NN]
  T* fb = ub + 2 * 6 * NN;             // [lower | upper x 2][kF]
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

  // 1. u and du of node plane a (tile and halo) into shared memory
  auto node_plane = [&](int a) {
    T* d = ub + (a & 1) * 6 * NN;
    for (int q = tid; q < NN; q += kThreads) {
      const int qx = q % NX, qy = q / NX;
      const int x = x0 - 1 + qx, y = y0 - 1 + qy;
      if (x > g.nx || y > g.ny) continue;  // no element on the grid reads it
      const int n = a * g.s_out + y * g.s_mid + x;
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (a >= 0 && n >= 0 && n < len) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] = S[c * len + n];
          v[3 + c] = v[c] - S[(3 + c) * len + n];
        }
      }
#pragma unroll
      for (int f = 0; f < 6; ++f) d[f * NN + q] = v[f];
    }
  };

  // 2. element plane p: the recursion on each element's corner rows
  // (conv' stored by the owner), its 24 force values into the lower
  // half (corners in plane p) and the upper half of p's parity (corners
  // in plane p + 1)
  auto force_plane = [&](int p) {
    if (!on_grid) return;
    const T* d0 = ub + (p & 1) * 6 * NN;
    const T* d1 = ub + ((p + 1) & 1) * 6 * NN;
    T* fh = fb + kF * (1 + (p & 1));
    const int e = p * g.s_out + exy;
    const bool own = own_xy && p >= a0 && p < a1 && e < len;
    T f[24];
    if (p >= 0 && e >= 0 && e + g.o[7] < len) {
      const T mu = K[4 * len + e], ka = K[5 * len + e];
      T b[18];
      set_coeffs<T>(K, 6, len, e, 0, b);
      if (KAPPA) set_coeffs<T>(K, 7, len, e, 1, b + 9);
      T xs[24], xk[24];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T* s = (g.cda[i] ? d1 : d0) + ly * NX + lx + g.nof[i];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int slot = 3 * i + c;
          const T u = s[c * NN];
          const T du = s[(3 + c) * NN];
          const T up = u - du;
          T s0n, s1n;
          ht::rec_pair<T>(b, u, up, du, ht::conv_load(conv + slot * len + e),
                          ht::conv_load(conv + (24 + slot) * len + e), s0n,
                          s1n, xs[slot]);
          if (own) {
            ht::conv_store(conv_out + slot * len + e, s0n);
            ht::conv_store(conv_out + (24 + slot) * len + e, s1n);
          }
          if (KAPPA) {
            ht::rec_pair<T>(b + 9, u, up, du,
                            ht::conv_load(conv + (48 + slot) * len + e),
                            ht::conv_load(conv + (72 + slot) * len + e),
                            s0n, s1n, xk[slot]);
            if (own) {
              ht::conv_store(conv_out + (48 + slot) * len + e, s0n);
              ht::conv_store(conv_out + (72 + slot) * len + e, s1n);
            }
          } else {
            xk[slot] = u;  // shear-only: the kappa term acts on u
          }
        }
      }
      element_force_spectral<T>(xs, xk, mu, ka, f);
    } else {
      // outside the state (padding, or the halo plane below plane 0)
      if (own) {
#pragma unroll 8
        for (int r = 0; r < R; ++r)
          ht::conv_store(conv_out + r * len + e, T(0));
      }
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
      out[c * len + n] =
          ht::fma_rn(ht::fma_rn(K[c * len + n], u - up, f[c]), invm, u);
      out[(3 + c) * len + n] = u;
    }
    out[6 * len + n] = S[6 * len + n];
    out[7 * len + n] = S[7 * len + n];
  };

  // the march: node plane p + 1 comes one plane ahead of element plane
  // p's forces, and a node plane is gathered once both element planes
  // around it are formed.  Shared buffers alternate by parity; two
  // barriers per plane separate each buffer's writers and readers.
  node_plane(a0 - 1);
  for (int p = a0 - 1; p < a1; ++p) {
    node_plane(p + 1);
    if (p - 1 >= a0) gather_plane(p - 1);
    __syncthreads();
    force_plane(p);
    __syncthreads();
  }
  gather_plane(a1 - 1);
}

// The blocks of this kernel the card holds at once (SMs x blocks per SM
// at its registers and shared memory), asked once per device; opts the
// kernel into its shared memory first.
template <typename T, typename CT, bool KAPPA>
cudaError_t corner_resident(int device, int* resident) {
  static int held[32];
  static unsigned opted = 0;
  if (held[device] == 0) {
    auto kernel = bkt_corner_kernel<T, CT, KAPPA>;
    const int smem = ht::tile_smem_bytes<T>();
    cudaError_t err = ht::opt_in_smem(kernel, smem, device, &opted);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    held[device] = sms * per_sm;
  }
  *resident = held[device];
  return cudaSuccess;
}

// (resident blocks, slab depth, work items) of a launch on this grid
template <typename T, typename CT, bool KAPPA>
cudaError_t corner_grid(const int* offs, int len, int device, Geom* g,
                        int* got) {
  cudaError_t err = corner_resident<T, CT, KAPPA>(device, &got[0]);
  if (err != cudaSuccess) return err;
  if (!corner_geom(offs, len, got[0], g)) return cudaErrorInvalidValue;
  got[1] = g->slab;
  got[2] = ht::tile_items(*g);
  return cudaSuccess;
}

template <typename T, typename CT, bool KAPPA>
int launch_k(const T* S, const CT* conv, const T* K, T* out, CT* conv_out,
             int len, const int* offs, int device, cudaStream_t s) {
  Geom g;
  int got[3];
  cudaError_t err = corner_grid<T, CT, KAPPA>(offs, len, device, &g, got);
  if (err != cudaSuccess) return static_cast<int>(err);
  bkt_corner_kernel<T, CT, KAPPA><<<got[2], kThreads,
                                    ht::tile_smem_bytes<T>(), s>>>(
      S, conv, K, out, conv_out, len, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(const T* S, const void* conv, const T* K, T* out,
           void* conv_out, int len, const int* offs, int kappa, int device,
           void* stream) {
  if (device < 0 || device >= 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CT* c = static_cast<const CT*>(conv);
  CT* co = static_cast<CT*>(conv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(S, c, K, out, co, len, offs, device, s);
  return launch_k<T, CT, false>(S, c, K, out, co, len, offs, device, s);
}

template <typename T, typename CT>
int grid_query(const int* offs, int len, int kappa, int device, int* got) {
  if (device < 0 || device >= 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geom g;
  return static_cast<int>(
      kappa ? corner_grid<T, CT, true>(offs, len, device, &g, got)
            : corner_grid<T, CT, false>(offs, len, device, &g, got));
}

// Upload the sets table [kTab] of tab = (fm [24 * 48], sets) (one device
// array) into this unit's constant bank, ordered on `stream`.
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

// C entries (ctypes): every pointer except `offs` (8 host ints) and
// `got` is a device pointer; the suffix names the working type and the conv
// storage type; `kappa` selects the 96-row state.  The return value is a
// cudaError_t (0 = success; cudaErrorInvalidValue for offsets that are
// not a brick's).  ht_bkt_corner_grid_* write the launch's grid for a
// brick's offsets and len into got[3] (host ints): the resident blocks,
// the slab depth and the work items (the grid's blocks).
extern "C" {

int ht_bkt_corner_grid_f32_bf16(const int* offs, int len, int kappa,
                                int device, int* got) {
  return grid_query<float, __nv_bfloat16>(offs, len, kappa, device, got);
}
int ht_bkt_corner_grid_f64_f64(const int* offs, int len, int kappa,
                               int device, int* got) {
  return grid_query<double, double>(offs, len, kappa, device, got);
}
int ht_bkt_corner_set_tab_f32(const float* tab, int device, void* stream) {
  return set_tab<float>(tab, device, stream);
}
int ht_bkt_corner_set_tab_f64(const double* tab, int device, void* stream) {
  return set_tab<double>(tab, device, stream);
}
int ht_bkt_corner_step_f32_bf16(const float* S, const void* conv,
                                const float* K, float* out, void* conv_out,
                                int len, const int* offs, int kappa,
                                int device, void* stream) {
  return launch<float, __nv_bfloat16>(S, conv, K, out, conv_out, len, offs,
                                      kappa, device, stream);
}
int ht_bkt_corner_step_f64_f64(const double* S, const void* conv,
                               const double* K, double* out, void* conv_out,
                               int len, const int* offs, int kappa,
                               int device, void* stream) {
  return launch<double, double>(S, conv, K, out, conv_out, len, offs, kappa,
                                device, stream);
}

}  // extern "C"
