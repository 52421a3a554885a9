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
//   K    [8, len]: rows 0:3 = mass_minusaM, 3 = inv_mass (5:8 unused).
//   bk   [11 | 20, len]: the element's coefficient rows (bk_row_names):
//                  shear c1 c2 c3 c4 e0 e1 a0 a1 coef, with KAPPA the
//                  same 9 for kappa, then mu_f, kappa_f; zero at padding
//                  and invalid elements.
//   fm   [24, 48] in constant memory: [Kmu | Kkappa] (unscaled).
//
// The step (pallas_brick.py:1280-1332), per element e with u24, u-24 at
// its 8 corners (rows 3 j + c), du = u - u-, up = u - du:
//   s0' = c2 u + c1 up + e0 s0,   s1' = c4 u + c3 up + e1 s1
//   dvs = coef du + u - a0 s0' - a1 s1'      (dvk alike, or u)
//   F_e = fm [mu_f dvs; kappa_f dvk]                    [24]
//   u+  = u + (sum of F at the node + mass_minusaM (u - u-)) inv_mass
//
// The memory variables belong to (element, corner), so the recursion
// must run once per element, not once per node as the force gather of
// K1 and K2 would run it.  Two passes, two launches:
//   1. corner_elem: one thread per element column: gathers u, u- at the
//      8 corners, runs the recursion on its R rows, writes conv' and
//      F_e to a scratch F [24, len];
//   2. corner_node: one thread per node: gathers its force from the 8
//      elements sharing it (rows 3 j .. 3 j + 2 of F at e = n - o[j], j
//      ascending: no atomics, a fixed order) and updates S.
// What bounds it on an H100: memory.  Per column per step in float32
// with bfloat16 memory variables and kappa: pass 1 reads 24 B of S
// (neighbours' reads hit L1/L2), 192 B of conv and 80 B of bk and
// writes 192 B of conv and 96 B of F; pass 2 reads 96 B of F, 32 B
// of S, 16 B of K and writes 32 B: about 0.75 KB per column, 0.82 GB
// per step at 2^20 elements.  On the four-layer box at 2^20 elements in
// float32 (H100 80GB HBM3, 700 W) this kernel takes about 0.56 ms per
// step and K3, the node tier's kernel with its mixed elements, about
// 0.16 ms (PERF.md); the tier rule stays the JAX package's (node
// first) for parity.  Pass 1 does 24 x 48 = 1152 FMAs per element.
//
// Rounding: the recursion is written as separate products and sums in
// the plain version's order (rec_pair, under --fmad=false), and conv'
// rounds to the storage type once, on store, to nearest even.  Element
// columns whose corners leave the state (padding) store zero.
#include "bkt_step.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    corner_elem_kernel(const T* __restrict__ S, const CT* __restrict__ conv,
                       const T* __restrict__ bk, CT* __restrict__ conv_out,
                       T* __restrict__ F, int len, ht::Offs offs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  constexpr int R = KAPPA ? 96 : 48;
  if (e + offs.o[7] >= len) {
#pragma unroll 8
    for (int r = 0; r < R; ++r) ht::conv_store(conv_out + r * len + e, T(0));
#pragma unroll
    for (int r = 0; r < 24; ++r) F[r * len + e] = T(0);
    return;
  }
  constexpr int NB = KAPPA ? 20 : 11;
  T b[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) b[r] = bk[r * len + e];
  const T muf = b[NB - 2], kaf = b[NB - 1];
  T xs[24], xk[24];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = e + offs.o[j];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int slot = 3 * j + c;
      const T u = S[c * len + col];
      const T du = u - S[(3 + c) * len + col];
      const T up = u - du;
      T s0n, s1n, d;
      ht::rec_pair<T>(b, u, up, du, ht::conv_load(conv + slot * len + e),
                      ht::conv_load(conv + (24 + slot) * len + e), s0n, s1n,
                      d);
      ht::conv_store(conv_out + slot * len + e, s0n);
      ht::conv_store(conv_out + (24 + slot) * len + e, s1n);
      xs[slot] = d * muf;
      if (KAPPA) {
        ht::rec_pair<T>(b + 9, u, up, du,
                        ht::conv_load(conv + (48 + slot) * len + e),
                        ht::conv_load(conv + (72 + slot) * len + e), s0n,
                        s1n, d);
        ht::conv_store(conv_out + (48 + slot) * len + e, s0n);
        ht::conv_store(conv_out + (72 + slot) * len + e, s1n);
        xk[slot] = d * kaf;
      } else {
        xk[slot] = u * kaf;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 24; ++k)
      acc = ht::fma_rn(ht::fm<T>(r * 48 + k), xs[k], acc);
#pragma unroll
    for (int k = 0; k < 24; ++k)
      acc = ht::fma_rn(ht::fm<T>(r * 48 + 24 + k), xk[k], acc);
    F[r * len + e] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    corner_node_kernel(const T* __restrict__ S, const T* __restrict__ K,
                       const T* __restrict__ F, T* __restrict__ out, int len,
                       ht::Offs offs) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= len) return;
  T f[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = n - offs.o[j];
    if (e < 0 || e + offs.o[7] >= len) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = f[c] + F[(3 * j + c) * len + e];
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
}

template <typename T, typename CT, bool KAPPA>
int launch_k(const T* S, const CT* conv, const T* K, const T* bk, T* out,
             CT* conv_out, T* F, int len, const int* offs,
             cudaStream_t stream) {
  const int blocks = (len + kThreads - 1) / kThreads;
  const ht::Offs o = ht::make_offs(offs);
  corner_elem_kernel<T, CT, KAPPA><<<blocks, kThreads, 0, stream>>>(
      S, conv, bk, conv_out, F, len, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  corner_node_kernel<T><<<blocks, kThreads, 0, stream>>>(S, K, F, out, len,
                                                         o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(const T* S, const void* conv, const T* K, const T* bk, T* out,
           void* conv_out, T* F, int len, const int* offs, int kappa,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CT* c = static_cast<const CT*>(conv);
  CT* co = static_cast<CT*>(conv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(S, c, K, bk, out, co, F, len, offs, s);
  return launch_k<T, CT, false>(S, c, K, bk, out, co, F, len, offs, s);
}

template <typename T>
int set_fm(const T* dev_fm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      ht::set_fm<T>(dev_fm, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer; F is a [24, len] scratch of the working type; the
// suffix names the working type and the conv storage type; `kappa`
// selects the 96-row state.  The return value is a cudaError_t (0 =
// success).
extern "C" {

int ht_bkt_corner_set_fm_f32(const float* fm, int device, void* stream) {
  return set_fm<float>(fm, device, stream);
}
int ht_bkt_corner_set_fm_f64(const double* fm, int device, void* stream) {
  return set_fm<double>(fm, device, stream);
}
int ht_bkt_corner_step_f32_bf16(const float* S, const void* conv,
                                const float* K, const float* bk, float* out,
                                void* conv_out, float* F, int len,
                                const int* offs, int kappa, int device,
                                void* stream) {
  return launch<float, __nv_bfloat16>(S, conv, K, bk, out, conv_out, F, len,
                                      offs, kappa, device, stream);
}
int ht_bkt_corner_step_f64_f64(const double* S, const void* conv,
                               const double* K, const double* bk,
                               double* out, void* conv_out, double* F,
                               int len, const int* offs, int kappa,
                               int device, void* stream) {
  return launch<double, double>(S, conv, K, bk, out, conv_out, F, len, offs,
                                kappa, device, stream);
}

}  // extern "C"
