// The piece every kernel of the library shares: the explicit
// multiply-add.
//
// Every multiply-add of a kernel body is an explicit fma intrinsic and
// the library is built with --fmad=false (kernels/build.py), so no
// contraction choice of the compiler can make two kernels that inline
// one body (K1 and K5, K2 and K6) round it differently.
#pragma once

#include <cuda_runtime.h>

// Everything here has internal linkage (unnamed namespace), as in the
// other headers: a translation unit's constant banks and their setters
// must be its own.
namespace ht {
namespace {

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

}  // namespace
}  // namespace ht
