// brick_step: one explicit central-difference step of a uniform brick
// (the port's K1).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_kernel with
// packed_state=True, launched by build_call_packed /
// _build_call_packed_impl (the packed [8, LEN] state/constant layout).
//
// What bounds it on an H100: at 2^20 elements in float32 one step
// streams S in (8 rows), S out (8 rows) and K (7 rows): 23 rows x 4 B
// x 1.08M columns = 99.6 MB of device memory, and it does about
// 2.3 kFLOP of FP32 FMAs per element (the 48x24 operator) -- memory
// and FP32 arithmetic are roughly balanced.  The gather form below
// repeats each element's 48 state reads for the 8 nodes that share
// it; those repeats are served by L1/L2 (neighbouring threads read
// neighbouring columns), so the device-memory traffic stays near the
// 99.6 MB floor while L1 load throughput and FMA issue share the
// bound.
//
// Design: one thread per node column, the shared per-node body of
// brick_step.cuh (force gathered from the 8 elements that share the
// node -- no atomics, no state carried between blocks), the 48x24
// operator in constant memory.  Later work: stage each block's element
// window in shared memory so W is formed once per element.
#include "brick_step.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    brick_step_kernel(const T* __restrict__ S, const T* __restrict__ K,
                      T* __restrict__ out, int len, ht::Offs offs) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < len) ht::node_step<T>(S, K, out, n, len, offs);
}

template <typename T>
int launch(const T* S, const T* K, T* out, int len, const int* offs,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (len + threads - 1) / threads;
  brick_step_kernel<T><<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      S, K, out, len, ht::make_offs(offs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int set_ops(const T* dev_ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      ht::set_ops<T>(dev_ops, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer; the return value is a cudaError_t (0 = success).
extern "C" {

int ht_brick_step_set_ops_f32(const float* ops, int device, void* stream) {
  return set_ops<float>(ops, device, stream);
}
int ht_brick_step_set_ops_f64(const double* ops, int device, void* stream) {
  return set_ops<double>(ops, device, stream);
}
int ht_brick_step_f32(const float* S, const float* K, float* out, int len,
                      const int* offs, int device, void* stream) {
  return launch<float>(S, K, out, len, offs, device, stream);
}
int ht_brick_step_f64(const double* S, const double* K, double* out,
                      int len, const int* offs, int device, void* stream) {
  return launch<double>(S, K, out, len, offs, device, stream);
}

}  // extern "C"
