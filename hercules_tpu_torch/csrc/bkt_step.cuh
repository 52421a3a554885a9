// Per-node bodies of the node-basis BKT step, shared by bkt_step (K2, one
// step per call) and bkt_chunk (K6, one launch per chunk of steps).  K2
// and K6 inline these functions with the same arguments, so they run the
// same arithmetic in the same order and give bit-identical states.
// bkt_node (K3, the general-Q step) uses rec_pair and the conv storage
// helpers, with its own tiled force pass in the spectral form.
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
//   dv   [3 | 6, len]: the damping vectors dvs (and dvk with KAPPA) of
//                  this step, in the working type T.
//   fm   [24, 48] in constant memory: [mu_f Kmu | kappa_f Kkappa].
//
// The step (hercules_tpu/solver/pallas_brick.py:_make_bkt_uniform_kernel,
// :1477-1496 and :1642-1646):
//   s0' = c2 u + c1 u- + e0 s0,   s1' = c4 u + c3 u- + e1 s1
//   dvs = coef (u - u-) + u - a0 s0' - a1 s1'     (dvk alike, or u)
//   F_e = fm [dvs at e's 8 corners; dvk at e's 8 corners]
//   F_n = sum over the 8 elements e = n - o[j] of rows 3j..3j+2 of F_e
//   u+  = u + (F_n + mass_minusaM (u - u-)) inv_mass
//
// Node n's force needs dvs/dvk at the 27 nodes around it, and those come
// from the recursion at those nodes.  The step is therefore two passes
// with a grid-wide dependency between them: node_rec writes conv' and
// dv for every node, then node_force GATHERS each node's force from the
// 8 elements that share it (no atomics, a fixed summation order) and
// updates S.  K2 makes them two launches, K6 separates them with a grid
// barrier.
//
// Rounding: the recursion is written as separate products and sums in
// the order of the plain version (bkt_step_plain) -- the library is
// built with --fmad=false, so nothing is contracted -- and conv' is
// rounded to CT once, on store (round to nearest even).  The force
// spells every multiply-add as an fma intrinsic, as brick_step.cuh does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "brick_step.cuh"

// Internal linkage throughout (unnamed namespace): each translation unit
// owns its constant bank and its set_fm writes that bank.
namespace ht {
namespace {

static __constant__ float c_fm_f32[24 * 48];
static __constant__ double c_fm_f64[24 * 48];

template <typename T> __device__ __forceinline__ T fm(int i);
template <> __device__ __forceinline__ float fm<float>(int i) {
  return c_fm_f32[i];
}
template <> __device__ __forceinline__ double fm<double>(int i) {
  return c_fm_f64[i];
}

// The recursion scalars: shear c1 c2 c3 c4 e0 e1 a0 a1 coef, then the
// same 9 for kappa (unused when shear-only), in the working type.
template <typename T>
struct BktRec {
  T v[18];
};

__device__ __forceinline__ float conv_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float conv_load(const float* p) { return *p; }
__device__ __forceinline__ double conv_load(const double* p) { return *p; }
__device__ __forceinline__ void conv_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void conv_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void conv_store(double* p, double v) { *p = v; }

// One recursion pair and its damping vector (k = c1 c2 c3 c4 e0 e1 a0
// a1 coef), in the plain version's order of operations.
template <typename T>
__device__ __forceinline__ void rec_pair(const T* k, T u, T up, T du, T s0,
                                         T s1, T& s0n, T& s1n, T& dv) {
  s0n = (k[1] * u + k[0] * up) + k[4] * s0;
  s1n = (k[3] * u + k[2] * up) + k[5] * s1;
  dv = ((k[8] * du + u) - k[6] * s0n) - k[7] * s1n;
}

// Pass 1 at node n: conv -> conv_out, and dv, with the 9 | 18
// recursion coefficients k (shear, then kappa).  Plain (coherent)
// loads: bkt_chunk reads buffers that other blocks wrote earlier in the
// launch.
template <typename T, typename CT, bool KAPPA>
__device__ __forceinline__ void node_rec(const T* S, const CT* conv,
                                         CT* conv_out, T* dv, int n, int len,
                                         const T* k) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T u = S[c * len + n];
    const T up = S[(3 + c) * len + n];
    const T du = u - up;
    T s0n, s1n, d;
    rec_pair<T>(k, u, up, du, conv_load(conv + c * len + n),
                conv_load(conv + (3 + c) * len + n), s0n, s1n, d);
    conv_store(conv_out + c * len + n, s0n);
    conv_store(conv_out + (3 + c) * len + n, s1n);
    dv[c * len + n] = d;
    if (KAPPA) {
      rec_pair<T>(k + 9, u, up, du, conv_load(conv + (6 + c) * len + n),
                  conv_load(conv + (9 + c) * len + n), s0n, s1n, d);
      conv_store(conv_out + (6 + c) * len + n, s0n);
      conv_store(conv_out + (9 + c) * len + n, s1n);
      dv[(3 + c) * len + n] = d;
    }
  }
}

// Pass 2 at node n: the force gathered from the 8 elements sharing n,
// then the update S -> out.  Shear-only runs read dvk = u from S.  fm
// has mu_f and kappa_f folded in and K row 4 flags the valid elements.
template <typename T, bool KAPPA>
__device__ __forceinline__ void node_force(const T* S, const T* K,
                                           const T* dv, T* out, int n,
                                           int len, const Offs& offs) {
  T f[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = n - offs.o[j];
    // every corner of e must lie inside the state; valid elements
    // always do (their corners are brick nodes < nb <= len)
    if (e < 0 || e + offs.o[7] >= len) continue;
    if (K[4 * len + e] == T(0)) continue;  // padding or invalid element
    T a[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = e + offs.o[i];
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const T xs = dv[cc * len + col];
        const T xk = KAPPA ? dv[(3 + cc) * len + col] : S[cc * len + col];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int row = (3 * j + c) * 48;
          a[c] = fma_rn(fm<T>(row + 3 * i + cc), xs, a[c]);
          a[c] = fma_rn(fm<T>(row + 24 + 3 * i + cc), xk, a[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = f[c] + a[c];
  }
  const T invm = K[3 * len + n];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T u = S[c * len + n];
    const T up = S[(3 + c) * len + n];
    const T mm = K[c * len + n];
    out[c * len + n] = fma_rn(fma_rn(mm, u - up, f[c]), invm, u);
    out[(3 + c) * len + n] = u;
  }
  out[6 * len + n] = S[6 * len + n];
  out[7 * len + n] = S[7 * len + n];
}

// Upload fm (a device array of 24*48 values) into this translation
// unit's constant bank, ordered on `stream`.
template <typename T>
inline cudaError_t set_fm(const T* dev_fm, cudaStream_t stream);
template <>
inline cudaError_t set_fm<float>(const float* dev_fm, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_fm_f32, dev_fm, sizeof(c_fm_f32), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}
template <>
inline cudaError_t set_fm<double>(const double* dev_fm, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_fm_f64, dev_fm, sizeof(c_fm_f64), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}

template <typename T>
inline BktRec<T> make_rec(const T* host_rec) {
  BktRec<T> r;
  for (int i = 0; i < 18; ++i) r.v[i] = host_rec[i];
  return r;
}

}  // namespace
}  // namespace ht
