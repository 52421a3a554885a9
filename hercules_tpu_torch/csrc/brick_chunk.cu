// brick_chunk: CH steps of the uniform-brick elastic step in one
// persistent cooperative launch, with the per-step station sampling
// and source injection fused in (the port's K5).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:build_resident_call,
// the VMEM-resident time loop.  That kernel keeps the whole state in
// the TPU core's scratch memory for a chunk and updates it in place,
// which is sound there only because TPU tiles run in order.
//
// What bounds it on an H100: the per-step work is K1's (brick_step.cu:
// about 100 MB of state and constants and 2.3 kFLOP of FP32 FMAs per
// element at 2^20 elements in float32).  The two state buffers and
// the constants (104 MB at 2^20 elements) do not fit the 50 MB L2, so
// unlike the TPU kernel this one still streams the state through
// device memory every step; what it removes is the per-step launch,
// the separate source and sampling kernels, and their host round
// trips.  Each step pays two grid-wide barriers instead.
//
// Design: the grid is exactly as large as the card can hold at once
// (SMs x resident blocks per SM), launched with
// cudaLaunchCooperativeKernel so that grid.sync() is legal.  The state
// ping-pongs between two buffers (no in-place update: GPU blocks run in
// no order).  Per step t:
//   1. threads 0..3*ns-1 write the station samples of the state before
//      the step, sum_j phi_sj S[c, pos_sj] in j order;
//   2. every thread runs the shared per-node body (brick_step.cuh)
//      over its grid-stride columns, S_cur -> S_nxt;
//   3. grid.sync();
//   4. threads 0..3*L-1 add the pre-scaled source increments to S_nxt;
//      the first source at each position adds every source at that
//      position in source order (duplicates are summed in a fixed
//      order, as index_add_ does on the CPU);
//   5. grid.sync(); swap buffers.
#include <cooperative_groups.h>

#include "brick_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    brick_chunk_kernel(T* Sa, T* Sb, const T* __restrict__ K, int len,
                       ht::Offs offs, int ch,
                       const T* __restrict__ srcf,     // [ch, 3, nsrc]
                       const int* __restrict__ src_pos,  // [nsrc]
                       int nsrc,
                       const int* __restrict__ st_pos,   // [nst, 8]
                       const T* __restrict__ st_phi,     // [nst, 8]
                       int nst,
                       T* __restrict__ samples) {        // [ch, nst, 3]
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  T* cur = Sa;
  T* nxt = Sb;
  for (int t = 0; t < ch; ++t) {
    if (tid < 3 * nst) {
      const int s = tid / 3, c = tid % 3;
      T acc = T(0);
      for (int j = 0; j < 8; ++j)
        acc = ht::fma_rn(st_phi[8 * s + j], cur[c * len + st_pos[8 * s + j]],
                         acc);
      samples[(t * nst + s) * 3 + c] = acc;
    }
    for (int n = tid; n < len; n += stride)
      ht::node_step<T>(cur, K, nxt, n, len, offs);
    grid.sync();
    if (tid < 3 * nsrc) {
      const int l = tid / 3, c = tid % 3;
      const int p = src_pos[l];
      bool first = true;
      for (int m = 0; m < l; ++m) first = first && src_pos[m] != p;
      if (first) {
        T v = nxt[c * len + p];
        for (int m = l; m < nsrc; ++m)
          if (src_pos[m] == p) v = v + srcf[(t * 3 + c) * nsrc + m];
        nxt[c * len + p] = v;
      }
    }
    grid.sync();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T>
int launch(T* Sa, T* Sb, const T* K, int len, const int* offs, int ch,
           const T* srcf, const int* src_pos, int nsrc, const int* st_pos,
           const T* st_phi, int nst, T* samples, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, brick_chunk_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  ht::Offs o = ht::make_offs(offs);
  void* args[] = {&Sa,      &Sb,   &K,      &len,    &o,   &ch,
                  &srcf,    &src_pos, &nsrc, &st_pos, &st_phi, &nst,
                  &samples};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(brick_chunk_kernel<T>), dim3(sms * per_sm),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
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
// device pointer (null where the count is 0); the return value is a
// cudaError_t (0 = success).  After ch steps the state is in Sa when
// ch is even, in Sb when it is odd.
extern "C" {

int ht_brick_chunk_set_ops_f32(const float* ops, int device, void* stream) {
  return set_ops<float>(ops, device, stream);
}
int ht_brick_chunk_set_ops_f64(const double* ops, int device, void* stream) {
  return set_ops<double>(ops, device, stream);
}
int ht_brick_chunk_f32(float* Sa, float* Sb, const float* K, int len,
                       const int* offs, int ch, const float* srcf,
                       const int* src_pos, int nsrc, const int* st_pos,
                       const float* st_phi, int nst, float* samples,
                       int device, void* stream) {
  return launch<float>(Sa, Sb, K, len, offs, ch, srcf, src_pos, nsrc, st_pos,
                       st_phi, nst, samples, device, stream);
}
int ht_brick_chunk_f64(double* Sa, double* Sb, const double* K, int len,
                       const int* offs, int ch, const double* srcf,
                       const int* src_pos, int nsrc, const int* st_pos,
                       const double* st_phi, int nst, double* samples,
                       int device, void* stream) {
  return launch<double>(Sa, Sb, K, len, offs, ch, srcf, src_pos, nsrc,
                        st_pos, st_phi, nst, samples, device, stream);
}
}  // extern "C"
