// Pieces of the node-basis BKT step shared by the BKT kernels: the
// recursion scalars, the memory variables' storage helpers and one
// recursion pair in the plain version's order (bkt_tile.cuh's march in
// bkt_step, K2, bkt_chunk, K6, and bkt_node, K3; bkt_corner, K4, per
// element corner).
//
// The recursion (hercules_tpu/solver/pallas_brick.py:
// _make_bkt_uniform_kernel, :1477-1496):
//   s0' = c2 u + c1 u- + e0 s0,   s1' = c4 u + c3 u- + e1 s1
//   dv  = coef (u - u-) + u - a0 s0' - a1 s1'
//
// Rounding: the recursion is written as separate products and sums in
// the order of the plain version (bkt_step_plain) -- the library is
// built with --fmad=false, so nothing is contracted -- and the kernels
// round conv' to CT once, on store (round to nearest even).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace ht {
namespace {

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

template <typename T>
inline BktRec<T> make_rec(const T* host_rec) {
  BktRec<T> r;
  for (int i = 0; i < 18; ++i) r.v[i] = host_rec[i];
  return r;
}

}  // namespace
}  // namespace ht
