// The elastic stiffness operators in the spectral basis of the 8-corner
// Hadamard transform: the nonzeros of hercules_tpu_torch/physics/
// kmats.py:spectral_factors() (M1, then M2), each as X(m_out, c_out,
// m_in, c_in, coef).  With s = H x per component (H the unnormalised
// 8-point Hadamard over the corners, its 1/8 folded into coef), y[m_out,
// c_out] = sum of coef s[m_in, c_in], and f = H y: f = M1 x (or M2 x)
// exactly.  The coefficients are dyadic, so they are exact in float32
// too.  tests/test_torch_brick_step.py holds these lists equal to the
// factors.
#pragma once

#define HT_ELASTIC_SPECTRAL_M1(X) \
  X(1, 0, 1, 0, 1.125) \
  X(1, 1, 1, 1, 0.5625) \
  X(1, 1, 2, 0, 0.5625) \
  X(1, 2, 1, 2, 0.5625) \
  X(1, 2, 4, 0, 0.5625) \
  X(2, 0, 1, 1, 0.5625) \
  X(2, 0, 2, 0, 0.5625) \
  X(2, 1, 2, 1, 1.125) \
  X(2, 2, 2, 2, 0.5625) \
  X(2, 2, 4, 1, 0.5625) \
  X(3, 0, 3, 0, 0.5625) \
  X(3, 1, 3, 1, 0.5625) \
  X(3, 2, 3, 2, 0.375) \
  X(3, 2, 5, 1, 0.1875) \
  X(3, 2, 6, 0, 0.1875) \
  X(4, 0, 1, 2, 0.5625) \
  X(4, 0, 4, 0, 0.5625) \
  X(4, 1, 2, 2, 0.5625) \
  X(4, 1, 4, 1, 0.5625) \
  X(4, 2, 4, 2, 1.125) \
  X(5, 0, 5, 0, 0.5625) \
  X(5, 1, 3, 2, 0.1875) \
  X(5, 1, 5, 1, 0.375) \
  X(5, 1, 6, 0, 0.1875) \
  X(5, 2, 5, 2, 0.5625) \
  X(6, 0, 3, 2, 0.1875) \
  X(6, 0, 5, 1, 0.1875) \
  X(6, 0, 6, 0, 0.375) \
  X(6, 1, 6, 1, 0.5625) \
  X(6, 2, 6, 2, 0.5625) \
  X(7, 0, 7, 0, 0.25) \
  X(7, 1, 7, 1, 0.25) \
  X(7, 2, 7, 2, 0.25)

#define HT_ELASTIC_SPECTRAL_M2(X) \
  X(1, 0, 1, 0, 0.5625) \
  X(1, 0, 2, 1, 0.5625) \
  X(1, 0, 4, 2, 0.5625) \
  X(2, 1, 1, 0, 0.5625) \
  X(2, 1, 2, 1, 0.5625) \
  X(2, 1, 4, 2, 0.5625) \
  X(3, 0, 3, 0, 0.1875) \
  X(3, 0, 6, 2, 0.1875) \
  X(3, 1, 3, 1, 0.1875) \
  X(3, 1, 5, 2, 0.1875) \
  X(4, 2, 1, 0, 0.5625) \
  X(4, 2, 2, 1, 0.5625) \
  X(4, 2, 4, 2, 0.5625) \
  X(5, 0, 5, 0, 0.1875) \
  X(5, 0, 6, 1, 0.1875) \
  X(5, 2, 3, 1, 0.1875) \
  X(5, 2, 5, 2, 0.1875) \
  X(6, 1, 5, 0, 0.1875) \
  X(6, 1, 6, 1, 0.1875) \
  X(6, 2, 3, 0, 0.1875) \
  X(6, 2, 6, 2, 0.1875) \
  X(7, 0, 7, 0, 0.0625) \
  X(7, 1, 7, 1, 0.0625) \
  X(7, 2, 7, 2, 0.0625)
