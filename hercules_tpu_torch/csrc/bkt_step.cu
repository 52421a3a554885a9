// bkt_step: one step of a uniform-Q BKT brick with node-basis memory
// variables (the port's K2).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_bkt_uniform_kernel,
// launched by build_bkt_uniform_call (one call per step,
// _make_packed_bkt_uniform_step).
//
// Design (H100): one launch per step, one block per work item (a 31 x 7
// node tile on a slab of 8 planes) running bkt_tile.cuh's march: the
// recursion on the tile plus a one-node halo into shared memory, each
// element's force once in the spectral form, a fixed-order gather at the
// owned nodes.  The damping vectors never leave the chip; the brick's
// one coefficient set reaches the kernel by value (the recursion
// scalars, mu_f and kappa_f).
//
// What bounds it: memory.  The function reads S (6 rows), K (5 rows) and
// conv once and writes S' (6 rows) and conv' once: 251 MB per step at
// 2^20 elements in float64 shear-only (0.075 ms at 3.35 TB/s).
#include "bkt_tile.cuh"

namespace {

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(ht::kThreads, sizeof(T) == 4 ? 3 : 1)
    bkt_step_kernel(const T* __restrict__ S, const CT* __restrict__ conv,
                    const T* __restrict__ K, T* __restrict__ out,
                    CT* __restrict__ conv_out, int len, ht::Geom g,
                    ht::BktRec<T> r, T mu_f, T kappa_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  ht::bkt_tile_step<T, CT, KAPPA>(S, conv, K, out, conv_out, len, g, r,
                                  mu_f, kappa_f, blockIdx.x,
                                  reinterpret_cast<T*>(smem),
                                  ht::NoSources());
}

template <typename T, typename CT, bool KAPPA>
int launch_k(const T* S, const CT* conv, const T* K, T* out, CT* conv_out,
             int len, const ht::Geom& g, const T* rec, int device,
             cudaStream_t s) {
  const int smem = ht::tile_smem_bytes<T>();
  static unsigned opted = 0;
  cudaError_t err = ht::opt_in_smem(bkt_step_kernel<T, CT, KAPPA>, smem,
                                    device, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  bkt_step_kernel<T, CT, KAPPA><<<ht::tile_items(g), ht::kThreads, smem,
                                  s>>>(S, conv, K, out, conv_out, len, g,
                                       ht::make_rec<T>(rec), rec[18],
                                       rec[19]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(const T* S, const void* conv, const T* K, T* out, void* conv_out,
           int len, const int* offs, const T* rec, int kappa, int device,
           void* stream) {
  ht::Geom g;
  if (device < 0 || device >= 32 || !ht::make_geom(offs, len, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CT* c = static_cast<const CT*>(conv);
  CT* co = static_cast<CT*>(conv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(S, c, K, out, co, len, g, rec, device, s);
  return launch_k<T, CT, false>(S, c, K, out, co, len, g, rec, device, s);
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) and
// `rec` (20 host values of the working type: the 18 recursion scalars,
// the kappa ones zero when shear-only, then mu_f and kappa_f) is a
// device pointer; the suffix names the working type and the conv
// storage type; `kappa` selects the 12-row state.  The return value is
// a cudaError_t (0 = success; cudaErrorInvalidValue for offsets that
// are not a brick's).
extern "C" {

int ht_bkt_step_f32_bf16(const float* S, const void* conv, const float* K,
                         float* out, void* conv_out, int len,
                         const int* offs, const float* rec, int kappa,
                         int device, void* stream) {
  return launch<float, __nv_bfloat16>(S, conv, K, out, conv_out, len, offs,
                                      rec, kappa, device, stream);
}
int ht_bkt_step_f32_f32(const float* S, const void* conv, const float* K,
                        float* out, void* conv_out, int len, const int* offs,
                        const float* rec, int kappa, int device,
                        void* stream) {
  return launch<float, float>(S, conv, K, out, conv_out, len, offs, rec,
                              kappa, device, stream);
}
int ht_bkt_step_f64_f64(const double* S, const void* conv, const double* K,
                        double* out, void* conv_out, int len,
                        const int* offs, const double* rec, int kappa,
                        int device, void* stream) {
  return launch<double, double>(S, conv, K, out, conv_out, len, offs, rec,
                                kappa, device, stream);
}

}  // extern "C"
