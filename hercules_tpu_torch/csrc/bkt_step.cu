// bkt_step: one step of a uniform-Q BKT brick with node-basis memory
// variables (the port's K2).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_bkt_uniform_kernel,
// launched by build_bkt_uniform_call (one call per step,
// _make_packed_bkt_uniform_step).
//
// What bounds it on an H100: memory.  The TPU kernel forms the
// recursion for a tile plus its halo and keeps the damping vectors in
// VMEM; here blocks run in no order and share nothing, so the step is
// two launches (bkt_step.cuh):
//   1. bkt_rec: per node, S rows 0:6 and conv in, conv' and dv out;
//   2. bkt_force: per node, the force gathered from the 8 elements that
//      share it (dv and, shear-only, u at their corners; repeats served
//      by L1/L2), then the update; S 8 rows and K 5 rows in, S' out.
// Per column per step in float32: pass 1 moves 24 B of S, 2 x 4 B x R
// of conv (R = 6 rows float32 shear-only, 12 rows bfloat16 with kappa:
// 48 B either way) and writes 12 or 24 B of dv; pass 2 reads 32 B of S,
// 20 B of K, 12 or 24 B of dv and writes 32 B.  At 2^20 elements
// (1,082,368 columns) that is 180 (shear-only) to 204 (kappa) B per
// column, 195-221 MB per step: about twice K1's 99.6 MB.  The force
// pass does 8 x 8 x 3 x 6 = 1152 FMAs per node, as K1.
//
// Design: one thread per node column in each pass; fm [24, 48] in
// constant memory (each FMA reads a warp-uniform constant operand); the
// recursion scalars by value.  Later work: one pass that recomputes the
// recursion at the 27 neighbours, or a shared-memory tile of dv, to cut
// the dv round trip through device memory.
#include "bkt_step.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    bkt_rec_kernel(const T* __restrict__ S, const CT* __restrict__ conv,
                   CT* __restrict__ conv_out, T* __restrict__ dv, int len,
                   ht::BktRec<T> r) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < len)
    ht::node_rec<T, CT, KAPPA>(S, conv, conv_out, dv, n, len, r.v);
}

template <typename T, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    bkt_force_kernel(const T* __restrict__ S, const T* __restrict__ K,
                     const T* __restrict__ dv, T* __restrict__ out, int len,
                     ht::Offs offs) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < len) ht::node_force<T, KAPPA>(S, K, dv, out, n, len, offs);
}

template <typename T, typename CT, bool KAPPA>
int launch_k(const T* S, const CT* conv, const T* K, T* out, CT* conv_out,
             T* dv, int len, const int* offs, const T* rec,
             cudaStream_t stream) {
  const int blocks = (len + kThreads - 1) / kThreads;
  bkt_rec_kernel<T, CT, KAPPA><<<blocks, kThreads, 0, stream>>>(
      S, conv, conv_out, dv, len, ht::make_rec<T>(rec));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bkt_force_kernel<T, KAPPA><<<blocks, kThreads, 0, stream>>>(
      S, K, dv, out, len, ht::make_offs(offs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(const T* S, const void* conv, const T* K, T* out, void* conv_out,
           T* dv, int len, const int* offs, const T* rec, int kappa,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CT* c = static_cast<const CT*>(conv);
  CT* co = static_cast<CT*>(conv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(S, c, K, out, co, dv, len, offs, rec, s);
  return launch_k<T, CT, false>(S, c, K, out, co, dv, len, offs, rec, s);
}

template <typename T>
int set_fm(const T* dev_fm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      ht::set_fm<T>(dev_fm, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) and
// `rec` (18 host values of the working type) is a device pointer; the
// suffix names the working type and the conv storage type; `kappa`
// selects the 12-row state.  The return value is a cudaError_t (0 =
// success).
extern "C" {

int ht_bkt_step_set_fm_f32(const float* fm, int device, void* stream) {
  return set_fm<float>(fm, device, stream);
}
int ht_bkt_step_set_fm_f64(const double* fm, int device, void* stream) {
  return set_fm<double>(fm, device, stream);
}
int ht_bkt_step_f32_bf16(const float* S, const void* conv, const float* K,
                         float* out, void* conv_out, float* dv, int len,
                         const int* offs, const float* rec, int kappa,
                         int device, void* stream) {
  return launch<float, __nv_bfloat16>(S, conv, K, out, conv_out, dv, len,
                                      offs, rec, kappa, device, stream);
}
int ht_bkt_step_f32_f32(const float* S, const void* conv, const float* K,
                        float* out, void* conv_out, float* dv, int len,
                        const int* offs, const float* rec, int kappa,
                        int device, void* stream) {
  return launch<float, float>(S, conv, K, out, conv_out, dv, len, offs, rec,
                              kappa, device, stream);
}
int ht_bkt_step_f64_f64(const double* S, const void* conv, const double* K,
                        double* out, void* conv_out, double* dv, int len,
                        const int* offs, const double* rec, int kappa,
                        int device, void* stream) {
  return launch<double, double>(S, conv, K, out, conv_out, dv, len, offs,
                                rec, kappa, device, stream);
}

}  // extern "C"
