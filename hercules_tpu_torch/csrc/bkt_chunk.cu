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
// What bounds it on an H100: memory, as K2 (bkt_step.cu): S, conv and K
// come to 100 MB and more at 2^20 elements, twice the 50 MB L2, so the
// state streams through device memory every step.  What the launch
// removes is one launch per step, the separate source and sampling
// kernels, and their host round trips.
//
// Design: K2's tiled step (bkt_tile.cuh) inside a grid that is exactly
// as large as the card holds at once, launched with
// cudaLaunchCooperativeKernel so that grid.sync() is legal, with slabs
// deepened until each resident block has at most one work item where
// the card holds a block for every tile (bkt_tile.cuh:chunk_grid, K5's
// rule too).  S and conv ping-pong between two buffers each.  Per step
// t:
//   1. threads 0..3*ns-1 write the station samples of the state before
//      the step, sum_j phi_sj S[c, pos_sj] in j order;
//   2. each block takes work items grid-stride and runs the tile step
//      from (S_cur, conv_cur) into (S_nxt, conv_nxt).  A tile's halo is
//      recomputed from S_cur and conv_cur, so no block reads what
//      another block writes in the same step.  The thread that updates
//      a source node adds that node's pre-scaled increments to the new
//      displacement before storing it: the host lists each tile's
//      sources in source order (tile_ptr, tile_src), so sources sharing
//      a position are added one after another in source order;
//   3. grid.sync(); swap buffers.
// One barrier per step.  The state buffers are read with plain
// (coherent) loads: other blocks wrote them before the barrier.
#include <cooperative_groups.h>

#include "bkt_tile.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T, typename CT, bool KAPPA>
__global__ void __launch_bounds__(ht::kThreads, sizeof(T) == 4 ? 3 : 1)
    bkt_chunk_kernel(T* Sa, T* Sb, CT* Ca, CT* Cb, const T* __restrict__ K,
                     int len, ht::Geom g, ht::BktRec<T> r, T mu_f, T kappa_f,
                     int ch,
                     const T* __restrict__ srcf,         // [ch, 3, nsrc]
                     const int* __restrict__ src_pos,    // [nsrc]
                     int nsrc,
                     const int* __restrict__ tile_ptr,   // [tiles + 1]
                     const int* __restrict__ tile_src,   // [nsrc]
                     const int* __restrict__ st_pos,     // [nst, 8]
                     const T* __restrict__ st_phi,       // [nst, 8]
                     int nst,
                     T* __restrict__ samples) {          // [ch, nst, 3]
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int items = ht::tile_items(g);
  const int tiles = g.tiles_x * g.tiles_y;
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
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int tile = item % tiles;
      const ht::ItemSources<T> src{tile_src + tile_ptr[tile],
                               tile_ptr[tile + 1] - tile_ptr[tile], src_pos,
                               srcf + t * 3 * nsrc, nsrc};
      ht::bkt_tile_step<T, CT, KAPPA>(cur, ccur, K, nxt, cnxt, len, g, r,
                                      mu_f, kappa_f, item,
                                      reinterpret_cast<T*>(smem), src);
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
int launch_k(T* Sa, T* Sb, CT* Ca, CT* Cb, const T* K, int len,
             ht::Geom g, const T* rec, int ch, const T* srcf,
             const int* src_pos, int nsrc, const int* tile_ptr,
             const int* tile_src, const int* st_pos,
             const T* st_phi, int nst, T* samples, int device,
             cudaStream_t stream) {
  auto kernel = bkt_chunk_kernel<T, CT, KAPPA>;
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem = ht::tile_smem_bytes<T>();
  static unsigned opted = 0;
  err = ht::opt_in_smem(kernel, smem, device, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the resident blocks at this kernel's registers and shared memory
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      ht::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = ht::chunk_grid(&g, sms * per_sm);
  ht::BktRec<T> r = ht::make_rec<T>(rec);
  T mu_f = rec[18], kappa_f = rec[19];
  void* args[] = {&Sa,       &Sb,      &Ca,     &Cb,       &K,
                  &len,      &g,       &r,
                  &mu_f,     &kappa_f, &ch,     &srcf,     &src_pos,
                  &nsrc,     &tile_ptr, &tile_src, &st_pos,  &st_phi,
                  &nst,      &samples};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(ht::kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch(T* Sa, T* Sb, void* Ca, void* Cb, const T* K, int len,
           const int* offs, const T* rec, int kappa, int ch, const T* srcf,
           const int* src_pos, int nsrc, const int* tile_ptr,
           const int* tile_src, const int* st_pos,
           const T* st_phi, int nst, T* samples, int device, void* stream) {
  ht::Geom g;
  if (device < 0 || device >= 32 || !ht::make_geom(offs, len, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CT* ca = static_cast<CT*>(Ca);
  CT* cb = static_cast<CT*>(Cb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kappa)
    return launch_k<T, CT, true>(Sa, Sb, ca, cb, K, len, g, rec, ch, srcf,
                                 src_pos, nsrc, tile_ptr, tile_src,
                                 st_pos, st_phi, nst, samples, device, s);
  return launch_k<T, CT, false>(Sa, Sb, ca, cb, K, len, g, rec, ch, srcf,
                                src_pos, nsrc, tile_ptr, tile_src,
                                st_pos, st_phi, nst, samples, device, s);
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) and
// `rec` (20 host values of the working type, as ht_bkt_step_*) is a
// device pointer (null where the count is 0); tile_ptr [tiles + 1] and
// tile_src [nsrc] list each tile's sources in source order
// (kernels/tiles.py:tile_sources); the suffix names the working
// type and the conv storage type; `kappa` selects the 12-row state.
// The return value is a cudaError_t (0 = success).  After ch steps S
// and conv are in Sa and Ca when ch is even, in Sb and Cb when it is
// odd.
extern "C" {

int ht_bkt_chunk_f32_bf16(float* Sa, float* Sb, void* Ca, void* Cb,
                          const float* K, int len, const int* offs,
                          const float* rec, int kappa, int ch,
                          const float* srcf, const int* src_pos, int nsrc,
                          const int* tile_ptr, const int* tile_src,
                          const int* st_pos,
                          const float* st_phi, int nst, float* samples,
                          int device, void* stream) {
  return launch<float, __nv_bfloat16>(Sa, Sb, Ca, Cb, K, len, offs, rec,
                                      kappa, ch, srcf, src_pos, nsrc,
                                      tile_ptr, tile_src, st_pos,
                                      st_phi, nst, samples, device, stream);
}
int ht_bkt_chunk_f32_f32(float* Sa, float* Sb, void* Ca, void* Cb,
                         const float* K, int len, const int* offs,
                         const float* rec, int kappa, int ch,
                         const float* srcf, const int* src_pos, int nsrc,
                         const int* tile_ptr, const int* tile_src,
                         const int* st_pos,
                         const float* st_phi, int nst, float* samples,
                         int device, void* stream) {
  return launch<float, float>(Sa, Sb, Ca, Cb, K, len, offs, rec, kappa, ch,
                              srcf, src_pos, nsrc, tile_ptr, tile_src,
                              st_pos, st_phi, nst, samples, device,
                              stream);
}
int ht_bkt_chunk_f64_f64(double* Sa, double* Sb, void* Ca, void* Cb,
                         const double* K, int len, const int* offs,
                         const double* rec, int kappa, int ch,
                         const double* srcf, const int* src_pos, int nsrc,
                         const int* tile_ptr, const int* tile_src,
                         const int* st_pos,
                         const double* st_phi, int nst, double* samples,
                         int device, void* stream) {
  return launch<double, double>(Sa, Sb, Ca, Cb, K, len, offs, rec, kappa,
                                ch, srcf, src_pos, nsrc, tile_ptr, tile_src,
                                st_pos, st_phi, nst, samples, device,
                                stream);
}

}  // extern "C"
