// brick_step: one explicit central-difference step of a uniform brick
// (the port's K1).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_kernel with
// packed_state=True, launched by build_call_packed /
// _build_call_packed_impl (the packed [8, LEN] state/constant layout).
//
// Design (H100): one launch per step, one block per work item (a 31 x 7
// node tile on a slab of 8 planes) running brick_tile.cuh's march: u
// and du on the tile plus a one-node halo into shared memory, each
// element's force once in the spectral form, a fixed-order gather and
// the update at the owned nodes from the same shared state.  Launch
// bounds hold three blocks per SM in float32 (80 registers; four, at
// 64, were slower) and two in float64 (128 registers; without the bound
// it took 142, one block per SM, and was slower; PERF.md).  Slabs
// deepened to one wave of blocks, as K5's, were slower in float64 and
// no faster in float32.
//
// What bounds it: memory.  The function reads S (6 rows) and K (7 rows)
// once and writes S' (6 rows) once: 164.5 MB per step at 2^20 elements
// in float64 (0.049 ms at 3.35 TB/s); the kernel streams 23 rows (S 8
// in and out, K 7).  Its 402 operations per element (W and the force in
// the spectral form) are 0.013 ms of the float64 peak.
#include "brick_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ht::kThreads, sizeof(T) == 4 ? 3 : 2)
    brick_step_kernel(const T* __restrict__ S, const T* __restrict__ K,
                      T* __restrict__ out, int len, ht::Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  ht::brick_tile_step<T>(S, K, out, len, g, blockIdx.x,
                         reinterpret_cast<T*>(smem), ht::NoSources());
}

template <typename T>
int launch(const T* S, const T* K, T* out, int len, const int* offs,
           int device, void* stream) {
  ht::Geom g;
  if (device < 0 || device >= 32 || !ht::make_geom(offs, len, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = ht::tile_smem_bytes<T>();
  static unsigned opted = 0;
  err = ht::opt_in_smem(brick_step_kernel<T>, smem, device, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  brick_step_kernel<T><<<ht::tile_items(g), ht::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(S, K, out, len,
                                                              g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer; the return value is a cudaError_t (0 = success;
// cudaErrorInvalidValue for offsets that are not a brick's).
extern "C" {

int ht_brick_step_f32(const float* S, const float* K, float* out, int len,
                      const int* offs, int device, void* stream) {
  return launch<float>(S, K, out, len, offs, device, stream);
}
int ht_brick_step_f64(const double* S, const double* K, double* out,
                      int len, const int* offs, int device, void* stream) {
  return launch<double>(S, K, out, len, offs, device, stream);
}

}  // extern "C"
