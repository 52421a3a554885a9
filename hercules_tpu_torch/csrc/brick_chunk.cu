// brick_chunk: CH steps of the uniform-brick elastic step in one
// persistent cooperative launch, with the per-step station sampling
// and source injection fused in (the port's K5).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:build_resident_call,
// the VMEM-resident time loop.  That kernel keeps the whole state in
// the TPU core's scratch memory for a chunk and updates it in place,
// which is sound there only because TPU tiles run in order.
//
// What bounds it on an H100: memory, as K1 (brick_step.cu): the two
// state buffers and K come to 104 MB at 2^20 elements in float32, twice
// the 50 MB L2, so the state streams through device memory every step.
// What the launch removes is one launch per step, the separate source
// and sampling kernels, and their host round trips.
//
// Design: the synchronous tiled march (brick_tile.cuh:brick_tile_step)
// with K1's launch bounds, inside a grid that is exactly as large as the
// card holds at once, launched with cudaLaunchCooperativeKernel so that
// grid.sync() is legal, with slabs deepened until each resident block
// has at most one work item where the card holds a block for every tile
// (bkt_tile.cuh:chunk_grid, K6's rule).  The state ping-pongs between
// two buffers (no in-place update: GPU blocks run in no order).  Per
// step t:
//   1. threads 0..3*ns-1 write the station samples of the state before
//      the step, sum_j phi_sj S[c, pos_sj] in j order;
//   2. each block takes work items grid-stride and runs the tile step
//      from S_cur into S_nxt.  A tile's halo is read from S_cur, so no
//      block reads what another block writes in the same step.  The
//      thread that updates a source node adds that node's pre-scaled
//      increments to the new displacement before storing it: the host
//      lists each tile's sources in source order (tile_ptr, tile_src),
//      so sources sharing a position are added one after another in
//      source order, as the K1 route's index_add_ does;
//   3. grid.sync(); swap buffers.
// One barrier per step.  The state buffers are read with plain
// (coherent) loads: other blocks wrote them before the barrier.
#include <cooperative_groups.h>

#include "brick_tile.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(ht::kThreads, sizeof(T) == 4 ? 3 : 2)
    brick_chunk_kernel(T* Sa, T* Sb, const T* __restrict__ K, int len,
                       ht::Geom g, int ch,
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
                                   tile_ptr[tile + 1] - tile_ptr[tile],
                                   src_pos, srcf + t * 3 * nsrc, nsrc};
      ht::brick_tile_step<T>(cur, K, nxt, len, g, item,
                             reinterpret_cast<T*>(smem), src);
    }
    grid.sync();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T>
int launch(T* Sa, T* Sb, const T* K, int len, const int* offs, int ch,
           const T* srcf, const int* src_pos, int nsrc, const int* tile_ptr,
           const int* tile_src, const int* st_pos, const T* st_phi, int nst,
           T* samples, int device, void* stream) {
  ht::Geom g;
  if (device < 0 || device >= 32 || !ht::make_geom(offs, len, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = brick_chunk_kernel<T>;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
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
  void* args[] = {&Sa,     &Sb,       &K,        &len,    &g,
                  &ch,     &srcf,     &src_pos,  &nsrc,   &tile_ptr,
                  &tile_src, &st_pos, &st_phi,   &nst,    &samples};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(ht::kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer (null where the count is 0); tile_ptr [tiles + 1] and
// tile_src [nsrc] list each tile's sources in source order
// (kernels/tiles.py:tile_sources).  The return value is a cudaError_t
// (0 = success; cudaErrorInvalidValue for offsets that are not a
// brick's).  After ch steps the state is in Sa when ch is even, in Sb
// when it is odd.
extern "C" {

int ht_brick_chunk_f32(float* Sa, float* Sb, const float* K, int len,
                       const int* offs, int ch, const float* srcf,
                       const int* src_pos, int nsrc, const int* tile_ptr,
                       const int* tile_src, const int* st_pos,
                       const float* st_phi, int nst, float* samples,
                       int device, void* stream) {
  return launch<float>(Sa, Sb, K, len, offs, ch, srcf, src_pos, nsrc,
                       tile_ptr, tile_src, st_pos, st_phi, nst, samples,
                       device, stream);
}
int ht_brick_chunk_f64(double* Sa, double* Sb, const double* K, int len,
                       const int* offs, int ch, const double* srcf,
                       const int* src_pos, int nsrc, const int* tile_ptr,
                       const int* tile_src, const int* st_pos,
                       const double* st_phi, int nst, double* samples,
                       int device, void* stream) {
  return launch<double>(Sa, Sb, K, len, offs, ch, srcf, src_pos, nsrc,
                        tile_ptr, tile_src, st_pos, st_phi, nst, samples,
                        device, stream);
}
}  // extern "C"
