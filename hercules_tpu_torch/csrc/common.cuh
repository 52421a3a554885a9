// Pieces every kernel of the library shares: the explicit multiply-add
// and the corner offsets of K4's per-element kernels.
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

// The 8 corner offsets of a brick's elements: element e has its corners
// at columns e + o[j].
struct Offs {
  int o[8];
};

inline Offs make_offs(const int* host_offs) {
  Offs o;
  for (int j = 0; j < 8; ++j) o.o[j] = host_offs[j];
  return o;
}

}  // namespace
}  // namespace ht
