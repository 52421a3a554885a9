// bkt_node: one step of a general-Q BKT brick with node-basis memory
// variables (the port's K3).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_bkt_node_kernel,
// launched by build_bkt_node_call (one call per step,
// _make_packed_bkt_node_step).
//
// A brick whose elements carry several BKT coefficient sets (one per
// QTABLE bin of the Qs(Vs) fit) keeps one memory variable per node, as
// the uniform tier does: every node takes the set of one adjacent
// element (solver/fused_bktq.py:assign_bkt_node_coeffs), and the few
// "mixed" elements whose corners carry a foreign set are corrected after
// each launch by the torch epilogue (fused_bktq.bkt_mix_epilogue).
//
// Layout (hercules_tpu_torch/solver/fused_bktq.py):
//   S    [8, len]: u, u-, 0, 0.
//   conv [R, len]: s0, s1 (and k0, k1 with KAPPA) x 3 in the storage type.
//   K    [8, len]: rows 0:3 = mass_minusaM, 3 = inv_mass, 4 = mu_f and
//                  5 = kappa_f of the element whose lowest corner is this
//                  column (0 for padding and invalid elements), 6 = the
//                  node's set index as a float (nsets: no adjacent
//                  element, whose table row is zero), 7 = 0.
//   tab  in constant memory: fm [24, 48] = [Kmu | Kkappa] (unscaled),
//        then the sets table [kMaxSets + 1, 18]: row b = the 9 shear and
//        9 kappa recursion coefficients of set b (c1 c2 c3 c4 e0 e1 a0 a1
//        coef), zero rows from nsets on.
//
// The step is K2's (bkt_step.cuh) with two changes: node_rec takes its
// coefficients from the table row of the node's set -- a plain indexed
// load, so the values are bit for bit those of sets[bin] -- and
// node_force scales each element's two products by its mu_f and kappa_f
// on the output side (the TPU kernel's default a8 path, :2394).
//
// What bounds it on an H100: memory, as K2.  Per column per step in
// float32: pass 1 reads 24 B of S, 4 B of K (the set index), 2 x R x
// (2 or 4) B of conv (48 B: 6 rows float32 shear-only or 12 bfloat16)
// and writes 12 or 24 B of dv; pass 2 reads 32 B of S, 24 B of K, 12 or
// 24 B of dv and writes 32 B: 188 (shear-only) to 212 B per column,
// 203-229 MB per step at 2^20 elements.  The force pass does 1152 FMAs
// per node as K2's, plus 3 x 3 per element for the mu_f/kappa_f scaling.
//
// Design: one thread per node column in each pass, fm and the sets table
// in this unit's constant bank; warps whose nodes share a set (all but
// those at an interface plane) read one table address each.
#include "bkt_step.cuh"

namespace {

constexpr int kThreads = 256;
// the most distinct coefficient sets a brick may have (len(QTABLE));
// the table holds one more, zero row
constexpr int kMaxSets = 18;
constexpr int kRow = 18;  // coefficients per set row
constexpr int kTab = (kMaxSets + 1) * kRow;

static __constant__ float c_sets_f32[kTab];
static __constant__ double c_sets_f64[kTab];

template <typename T> __device__ __forceinline__ T setv(int i);
template <> __device__ __forceinline__ float setv<float>(int i) {
  return c_sets_f32[i];
}
template <> __device__ __forceinline__ double setv<double>(int i) {
  return c_sets_f64[i];
}

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    bkt_node_rec_kernel(const T* __restrict__ S, const CT* __restrict__ conv,
                        const T* __restrict__ K, CT* __restrict__ conv_out,
                        T* __restrict__ dv, int len) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= len) return;
  int bin = static_cast<int>(K[6 * len + n]);
  bin = bin < 0 ? 0 : (bin > kMaxSets ? kMaxSets : bin);
  T k[kRow];
#pragma unroll
  for (int i = 0; i < (KAPPA ? 18 : 9); ++i) k[i] = setv<T>(bin * kRow + i);
  ht::node_rec<T, CT, KAPPA>(S, conv, conv_out, dv, n, len, k);
}

template <typename T, bool KAPPA>
__global__ void __launch_bounds__(kThreads)
    bkt_node_force_kernel(const T* __restrict__ S, const T* __restrict__ K,
                          const T* __restrict__ dv, T* __restrict__ out,
                          int len, ht::Offs offs) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < len) ht::node_force<T, KAPPA, true>(S, K, dv, out, n, len, offs);
}

template <typename T, typename CT, bool KAPPA>
int launch_k(const T* S, const CT* conv, const T* K, T* out, CT* conv_out,
             T* dv, int len, const int* offs, cudaStream_t stream) {
  const int blocks = (len + kThreads - 1) / kThreads;
  bkt_node_rec_kernel<T, CT, KAPPA><<<blocks, kThreads, 0, stream>>>(
      S, conv, K, conv_out, dv, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bkt_node_force_kernel<T, KAPPA><<<blocks, kThreads, 0, stream>>>(
      S, K, dv, out, len, ht::make_offs(offs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(const T* S, const void* conv, const T* K, T* out, void* conv_out,
           T* dv, int len, const int* offs, int kappa, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CT* c = static_cast<const CT*>(conv);
  CT* co = static_cast<CT*>(conv_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(S, c, K, out, co, dv, len, offs, s);
  return launch_k<T, CT, false>(S, c, K, out, co, dv, len, offs, s);
}

// Upload tab = fm [24 * 48] then the sets table [kTab] (one device
// array) into this unit's constant banks, ordered on `stream`.
template <typename T>
int set_tab(const T* dev_tab, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = ht::set_fm<T>(dev_tab, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* sets = dev_tab + 24 * 48;
  if constexpr (sizeof(T) == sizeof(float))
    err = cudaMemcpyToSymbolAsync(c_sets_f32, sets, sizeof(c_sets_f32), 0,
                                  cudaMemcpyDeviceToDevice, s);
  else
    err = cudaMemcpyToSymbolAsync(c_sets_f64, sets, sizeof(c_sets_f64), 0,
                                  cudaMemcpyDeviceToDevice, s);
  return static_cast<int>(err);
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer; the suffix names the working type and the conv
// storage type; `kappa` selects the 12-row state.  The return value is
// a cudaError_t (0 = success).
extern "C" {

int ht_bkt_node_set_tab_f32(const float* tab, int device, void* stream) {
  return set_tab<float>(tab, device, stream);
}
int ht_bkt_node_set_tab_f64(const double* tab, int device, void* stream) {
  return set_tab<double>(tab, device, stream);
}
int ht_bkt_node_step_f32_bf16(const float* S, const void* conv,
                              const float* K, float* out, void* conv_out,
                              float* dv, int len, const int* offs, int kappa,
                              int device, void* stream) {
  return launch<float, __nv_bfloat16>(S, conv, K, out, conv_out, dv, len,
                                      offs, kappa, device, stream);
}
int ht_bkt_node_step_f32_f32(const float* S, const void* conv,
                             const float* K, float* out, void* conv_out,
                             float* dv, int len, const int* offs, int kappa,
                             int device, void* stream) {
  return launch<float, float>(S, conv, K, out, conv_out, dv, len, offs,
                              kappa, device, stream);
}
int ht_bkt_node_step_f64_f64(const double* S, const void* conv,
                             const double* K, double* out, void* conv_out,
                             double* dv, int len, const int* offs, int kappa,
                             int device, void* stream) {
  return launch<double, double>(S, conv, K, out, conv_out, dv, len, offs,
                                kappa, device, stream);
}

}  // extern "C"
