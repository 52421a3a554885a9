// Per-node body of the uniform-brick elastic step, shared by brick_step
// (K1, one launch per step) and brick_chunk (K5, one launch per chunk
// of steps).  Both kernels inline this one function, so they run the
// same arithmetic in the same order and give bit-identical states.
//
// Layout (hercules_tpu_torch/solver/fused_brick.py):
//   S [8, len]: rows 0:3 = u (this step), 3:6 = u- (previous step),
//               6:8 = zero rows carried through.
//   K [8, len]: rows 0:3 = (c1, c2, beta) of the element whose lowest
//               corner is this column (zero for padding and invalid
//               elements), 3:6 = mass_minusaM, 6 = inv_mass, 7 = 0.
//   Column n is node n of the brick's flat node grid; element e has
//   its 8 corners at columns e + o[j], o[7] the largest offset.
//
// The step (hercules_tpu/solver/pallas_brick.py:_make_kernel, the
// "general" tier in exact arithmetic):
//   W_e   = u + beta_e (u - u-)                    at e's 8 corners
//   F_e   = c1_e A1 W_e + c2_e A2 W_e,  A = -[M1; M2] (48 x 24)
//   F_n   = sum over the 8 elements e = n - o[j] of rows 3j..3j+2 of F_e
//   u+    = u + (F_n + mass_minusaM (u - u-)) inv_mass
//
// The TPU kernel computes F per element and scatters it with shifted
// adds, carrying a tail across its sequential tiles.  GPU blocks run
// in no order, so here each thread GATHERS its node's force from the
// 8 elements that share it: no atomics, no carried state, a fixed
// summation order.  W_e is formed again by each of the 8 threads that
// read it (8x the W arithmetic and 8x the loads of the element-wise
// form; the loads hit L1/L2, which neighbouring threads share).
//
// Every multiply-add is an explicit fma intrinsic and the library is
// built with --fmad=false, so no contraction choice of the compiler
// can make the two kernels round differently.
#pragma once

#include <cuda_runtime.h>

// Everything here has internal linkage (unnamed namespace): each
// translation unit owns its constant bank, and its set_ops must write
// that bank and not another unit's.
namespace ht {
namespace {

// A = -[M1; M2], row-major [48][24] (rows 0:24 = -M1, 24:48 = -M2),
// uploaded once per translation unit by its *_set_ops entry.  The
// fully unrolled loops below index it with compile-time offsets, so
// each operand is a constant-bank operand of its FMA instruction.
static __constant__ float c_ops_f32[48 * 24];
static __constant__ double c_ops_f64[48 * 24];

template <typename T> __device__ __forceinline__ T op(int i);
template <> __device__ __forceinline__ float op<float>(int i) {
  return c_ops_f32[i];
}
template <> __device__ __forceinline__ double op<double>(int i) {
  return c_ops_f64[i];
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

struct Offs {
  int o[8];
};

// Node n's step from S into out.  S and out must be distinct buffers;
// S, K are only read.  Plain (coherent) loads: brick_chunk reads
// buffers that other blocks wrote earlier in the same launch.
template <typename T>
__device__ __forceinline__ void node_step(const T* S, const T* K, T* out,
                                          int n, int len, const Offs& offs) {
  T f[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = n - offs.o[j];
    // every corner of e must lie inside the state; valid elements
    // always do (their corners are brick nodes < nb <= len)
    if (e < 0 || e + offs.o[7] >= len) continue;
    const T c1 = K[e];
    const T c2 = K[len + e];
    // padding and invalid elements: zero coefficients, no force
    if (c1 == T(0) && c2 == T(0)) continue;
    const T beta = K[2 * len + e];
    T w[24];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = e + offs.o[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T u = S[c * len + col];
        const T up = S[(3 + c) * len + col];
        w[3 * i + c] = fma_rn(beta, u - up, u);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int r = 3 * j + c;
      T a1 = T(0), a2 = T(0);
#pragma unroll
      for (int k = 0; k < 24; ++k) {
        a1 = fma_rn(op<T>(r * 24 + k), w[k], a1);
        a2 = fma_rn(op<T>((24 + r) * 24 + k), w[k], a2);
      }
      f[c] = fma_rn(c1, a1, f[c]);
      f[c] = fma_rn(c2, a2, f[c]);
    }
  }
  const T invm = K[6 * len + n];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T u = S[c * len + n];
    const T up = S[(3 + c) * len + n];
    const T mm = K[(3 + c) * len + n];
    out[c * len + n] = fma_rn(fma_rn(mm, u - up, f[c]), invm, u);
    out[(3 + c) * len + n] = u;
  }
  out[6 * len + n] = S[6 * len + n];
  out[7 * len + n] = S[7 * len + n];
}

// Upload A (a device array of 48*24 values) into this translation
// unit's constant bank, ordered on `stream`.
template <typename T>
inline cudaError_t set_ops(const T* dev_ops, cudaStream_t stream);
template <>
inline cudaError_t set_ops<float>(const float* dev_ops, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_ops_f32, dev_ops, sizeof(c_ops_f32), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}
template <>
inline cudaError_t set_ops<double>(const double* dev_ops,
                                   cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_ops_f64, dev_ops, sizeof(c_ops_f64), 0,
                                 cudaMemcpyDeviceToDevice, stream);
}

inline Offs make_offs(const int* host_offs) {
  Offs o;
  for (int j = 0; j < 8; ++j) o.o[j] = host_offs[j];
  return o;
}

}  // namespace
}  // namespace ht
