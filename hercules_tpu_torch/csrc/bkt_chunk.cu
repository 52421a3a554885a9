// bkt_chunk: CH steps of the uniform-Q BKT step in one persistent
// cooperative launch, with the per-step station sampling and source
// injection fused in (the port's K6).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:build_resident_bkt_call,
// the VMEM-resident BKT time loop.  That kernel keeps S, K and the
// memory variables in the TPU core's scratch memory for a chunk and
// updates them in place, sound there only because TPU tiles run in
// order.
//
// What bounds it on an H100: the per-step work is K2's (bkt_step.cu:
// 195-221 MB of device-memory traffic per step at 2^20 elements in
// float32 and 1152 FMAs per node).  The two state buffers, the two conv
// buffers, dv and K (169-182 MB at 2^20 elements) do not fit the 50 MB
// L2, so unlike the TPU kernel this one streams them through device
// memory every step; what it removes is the two launches per step, the
// separate source and sampling kernels, and their host round trips.
// Each step pays three grid-wide barriers instead.
//
// Design: K5's (brick_chunk.cu).  The grid is exactly as large as the
// card can hold at once, launched with cudaLaunchCooperativeKernel so
// that grid.sync() is legal.  S and conv ping-pong between two buffers
// each.  Per step t:
//   1. threads 0..3*ns-1 write the station samples of the state before
//      the step, sum_j phi_sj S[c, pos_sj] in j order;
//   2. every thread runs node_rec (bkt_step.cuh) over its grid-stride
//      columns: conv_cur -> conv_nxt and dv;
//   3. grid.sync();
//   4. every thread runs node_force over its columns: S_cur -> S_nxt;
//   5. grid.sync();
//   6. threads 0..3*L-1 add the pre-scaled source increments to S_nxt;
//      the first source at each position adds every source at that
//      position in source order;
//   7. grid.sync(); swap buffers.
#include <cooperative_groups.h>

#include "bkt_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    bkt_chunk_kernel(T* Sa, T* Sb, CT* Ca, CT* Cb, T* dv,
                     const T* __restrict__ K, int len, ht::Offs offs,
                     ht::BktRec<T> r, int ch,
                     const T* __restrict__ srcf,       // [ch, 3, nsrc]
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
  CT* ccur = Ca;
  CT* cnxt = Cb;
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
      ht::node_rec<T, CT, KAPPA>(cur, ccur, cnxt, dv, n, len, r.v);
    grid.sync();
    for (int n = tid; n < len; n += stride)
      ht::node_force<T, KAPPA>(cur, K, dv, nxt, n, len, offs);
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
    CT* ctmp = ccur;
    ccur = cnxt;
    cnxt = ctmp;
  }
}

template <typename T, typename CT, bool KAPPA>
int launch_k(T* Sa, T* Sb, CT* Ca, CT* Cb, T* dv, const T* K, int len,
             const int* offs, const T* rec, int ch, const T* srcf,
             const int* src_pos, int nsrc, const int* st_pos,
             const T* st_phi, int nst, T* samples, int device,
             cudaStream_t stream) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bkt_chunk_kernel<T, CT, KAPPA>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  ht::Offs o = ht::make_offs(offs);
  ht::BktRec<T> r = ht::make_rec<T>(rec);
  void* args[] = {&Sa,   &Sb,      &Ca,   &Cb,     &dv,     &K,   &len,
                  &o,    &r,       &ch,   &srcf,   &src_pos, &nsrc,
                  &st_pos, &st_phi, &nst, &samples};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bkt_chunk_kernel<T, CT, KAPPA>),
      dim3(sms * per_sm), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(T* Sa, T* Sb, void* Ca, void* Cb, T* dv, const T* K, int len,
           const int* offs, const T* rec, int kappa, int ch, const T* srcf,
           const int* src_pos, int nsrc, const int* st_pos, const T* st_phi,
           int nst, T* samples, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CT* ca = static_cast<CT*>(Ca);
  CT* cb = static_cast<CT*>(Cb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(Sa, Sb, ca, cb, dv, K, len, offs, rec, ch,
                                 srcf, src_pos, nsrc, st_pos, st_phi, nst,
                                 samples, device, s);
  return launch_k<T, CT, false>(Sa, Sb, ca, cb, dv, K, len, offs, rec, ch,
                                srcf, src_pos, nsrc, st_pos, st_phi, nst,
                                samples, device, s);
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
// `rec` (18 host values of the working type) is a device pointer (null
// where the count is 0); the suffix names the working type and the conv
// storage type; `kappa` selects the 12-row state.  The return value is
// a cudaError_t (0 = success).  After ch steps S and conv are in Sa and
// Ca when ch is even, in Sb and Cb when it is odd.
extern "C" {

int ht_bkt_chunk_set_fm_f32(const float* fm, int device, void* stream) {
  return set_fm<float>(fm, device, stream);
}
int ht_bkt_chunk_set_fm_f64(const double* fm, int device, void* stream) {
  return set_fm<double>(fm, device, stream);
}
int ht_bkt_chunk_f32_bf16(float* Sa, float* Sb, void* Ca, void* Cb,
                          float* dv, const float* K, int len,
                          const int* offs, const float* rec, int kappa,
                          int ch, const float* srcf, const int* src_pos,
                          int nsrc, const int* st_pos, const float* st_phi,
                          int nst, float* samples, int device,
                          void* stream) {
  return launch<float, __nv_bfloat16>(Sa, Sb, Ca, Cb, dv, K, len, offs, rec,
                                      kappa, ch, srcf, src_pos, nsrc, st_pos,
                                      st_phi, nst, samples, device, stream);
}
int ht_bkt_chunk_f32_f32(float* Sa, float* Sb, void* Ca, void* Cb,
                         float* dv, const float* K, int len, const int* offs,
                         const float* rec, int kappa, int ch,
                         const float* srcf, const int* src_pos, int nsrc,
                         const int* st_pos, const float* st_phi, int nst,
                         float* samples, int device, void* stream) {
  return launch<float, float>(Sa, Sb, Ca, Cb, dv, K, len, offs, rec, kappa,
                              ch, srcf, src_pos, nsrc, st_pos, st_phi, nst,
                              samples, device, stream);
}
int ht_bkt_chunk_f64_f64(double* Sa, double* Sb, void* Ca, void* Cb,
                         double* dv, const double* K, int len,
                         const int* offs, const double* rec, int kappa,
                         int ch, const double* srcf, const int* src_pos,
                         int nsrc, const int* st_pos, const double* st_phi,
                         int nst, double* samples, int device,
                         void* stream) {
  return launch<double, double>(Sa, Sb, Ca, Cb, dv, K, len, offs, rec, kappa,
                                ch, srcf, src_pos, nsrc, st_pos, st_phi, nst,
                                samples, device, stream);
}

}  // extern "C"
