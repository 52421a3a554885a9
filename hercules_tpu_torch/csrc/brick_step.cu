// brick_step: one explicit central-difference step of a uniform brick
// (the port's K1).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_kernel with
// packed_state=True, launched by build_call_packed /
// _build_call_packed_impl (the packed [8, LEN] state/constant layout).
//
// Design (H100): one launch per step, one block of 256 threads per work
// item (a 31 x 7 node tile on a slab of planes) running brick_tile.cuh's
// staged march: the state streams by asynchronous copies into a ring of
// three node planes in shared memory, one plane ahead of the element
// plane whose forces are formed; each element's force once in the
// spectral form, a fixed-order gather and the update at the owned
// nodes, bit for bit the arithmetic of the synchronous march that K5
// keeps.  One kernel for each set of corner roles (which bit of the
// corner index steps the inner, the mid and the plane axis: six), so
// that the force's and gather's shared-memory addresses are
// compile-time offsets: read from Geom at run time they cost 15-35 %.
// Launch bounds hold three blocks per SM in float32 (80 registers) and
// two in float64 (128).  The slab: of 1..12 planes, the one whose work
// items end first when the card's resident blocks take them in order
// (step_slab); a shorter last slab shortens the launch's tail.
//
// Two forms (a run-time flag, brick_tile.cuh), one kernel: u and u-
// from two blocks of 3 rows in, and u+ alone out, 16 rows (275 MB at
// 2^21 in float64), or with `canon` the layout S = (u+, u, 0, 0), 21
// rows (361 MB).  The step route of a single brick keeps its
// displacement levels in a ring of such blocks
// (solver/fused_brick.py:ring_plan), so the next step's u- is this
// step's u where it already lies, and writes the layout S only on a
// chunk's last step; the mesh route and the multi-card fragments step
// their S [8, len] in the layout S, its rows 0:3 and 3:6 the two blocks.
//
// What bounds it.  Device memory: the step needs u, u- and K's 7 rows
// in and u+ out, 13 rows a node and the 2 element rows of the roofline's
// count (port_bench/roofline.py), 256.8 MB at 2^21 in float64 (0.077 ms
// at 3.35 TB/s); u+ alone moves 16 rows.  And shared memory: an
// element takes about 100 accesses (its corners' u and u-, the force
// exchange, the copies), each two wavefronts a warp in float64; with
// no device-memory traffic the march still took 0.141 ms
// of its 0.225 at 2^21 (PERF.md).  So the float64 march loads its
// coefficients into registers and the float32 march, where registers
// bind, copies them into shared memory.  The 402 operations per element
// are 0.013 ms of the float64 peak at 2^20.  Measured at 2^21 (H100,
// 700 W; PERF.md): u+ alone 0.157 ms in float64 (1.76 TB/s of its 16
// rows) and 0.0995 ms in float32, the layout S 0.175 and 0.105, against
// the synchronous march's 0.225 and 0.118: nearer the shared-memory
// floor than the bytes'.
//
// K5 (brick_chunk.cu) keeps the synchronous march, brick_tile_step: the
// copies of 4 and 8 bytes go through the L1 cache (cp.async.ca), which
// does not see what other blocks wrote earlier in the same launch, and
// K5 reads the state its blocks wrote before each grid barrier.
#include <functional>
#include <queue>
#include <vector>

#include "brick_tile.cuh"

namespace {

// (U, Um) -> u+, or with canon the layout S (brick_tile.cuh).
template <typename T, int BX, int BY, int BA>
__global__ void __launch_bounds__(ht::kThreads, sizeof(T) == 4 ? 3 : 2)
    brick_step_kernel(const T* __restrict__ U, const T* __restrict__ Um,
                      const T* __restrict__ K, T* __restrict__ out, int len,
                      ht::Geom g, bool canon) {
  extern __shared__ __align__(16) unsigned char smem[];
  ht::brick_tile_step_staged<T, BX, BY, BA>(
      U, Um, K, out, len, g, blockIdx.x, reinterpret_cast<T*>(smem), canon);
}

// The kernel's blocks an SM holds at its registers and shared memory,
// and the SMs, asked once per device; opts the kernel into its shared
// memory first.
template <typename T, int BX, int BY, int BA>
cudaError_t step_resident(int device, int* per_sm, int* sms) {
  static int held[32][2];
  static unsigned opted = 0;
  if (held[device][0] == 0) {
    auto kernel = brick_step_kernel<T, BX, BY, BA>;
    const int smem = ht::step_smem_bytes<T>();
    cudaError_t err = ht::opt_in_smem(kernel, smem, device, &opted);
    if (err != cudaSuccess) return err;
    int n = 0, b = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel,
                                                        ht::kThreads, smem);
    if (err != cudaSuccess) return err;
    if (b < 1) return cudaErrorInvalidConfiguration;
    held[device][1] = n;
    held[device][0] = b;
  }
  *per_sm = held[device][0];
  *sms = held[device][1];
  return cudaSuccess;
}

// The deepest slab K1 marches: deeper ones gained nothing on an H100
// and left long work items for the end of the launch (PERF.md).
constexpr int kStepSlabMax = 12;

// How long the work items of slabs of `slab` planes keep the card, in
// half planes: `resident` blocks take the items in order (every tile of
// slab 0, then of slab 1, ...), each the next as one ends, and an item
// of p planes takes 2 p + 1 (its planes and the pipeline's fill).
inline long step_makespan(int tiles, int nplanes, int slab, int resident) {
  std::priority_queue<long, std::vector<long>, std::greater<long>> ends;
  long last = 0;
  for (int a0 = 0; a0 < nplanes; a0 += slab) {
    const int p = nplanes - a0 < slab ? nplanes - a0 : slab;
    for (int t = 0; t < tiles; ++t) {
      long start = 0;
      if (static_cast<int>(ends.size()) == resident) {
        start = ends.top();
        ends.pop();
      }
      const long end = start + 2L * p + 1;
      ends.push(end);
      if (end > last) last = end;
    }
  }
  return last;
}

// The slab depth for `resident` blocks at once: of 1..kStepSlabMax
// planes (at most the brick's), the one whose items end first
// (step_makespan), the deepest of equals; kept for the last few grids
// asked, since a search takes up to a millisecond and a step route
// launches every step.  kernels/tiles.py:step_grid mirrors it.
inline void step_slab(ht::Geom* g, int resident) {
  struct Kept {
    int tiles, nplanes, resident, slab;
  };
  thread_local Kept kept[8] = {};
  thread_local int next = 0;
  const int tiles = g->tiles_x * g->tiles_y;
  for (const Kept& k : kept)
    if (k.slab && k.tiles == tiles && k.nplanes == g->nplanes &&
        k.resident == resident) {
      g->slab = k.slab;
      return;
    }
  long best = -1;
  for (int slab = 1; slab <= kStepSlabMax && slab <= g->nplanes; ++slab) {
    const long t = step_makespan(tiles, g->nplanes, slab, resident);
    if (best < 0 || t <= best) {
      best = t;
      g->slab = slab;
    }
  }
  kept[next] = {tiles, g->nplanes, resident, g->slab};
  next = (next + 1) % 8;
}

// The launch on one brick: its Geom, its corner roles and the kernel of
// those roles, with (stages, blocks per SM, resident blocks, slab depth,
// work items) in got [5].
template <typename T>
struct Launch {
  ht::Geom g;
  int got[5];
  cudaError_t (*run)(const T*, const T*, const T*, T*, int, const ht::Geom&,
                     int, bool, cudaStream_t);
};

template <typename T, int BX, int BY, int BA>
cudaError_t run_roles(const T* U, const T* Um, const T* K, T* out, int len,
                      const ht::Geom& g, int items, bool canon,
                      cudaStream_t stream) {
  brick_step_kernel<T, BX, BY, BA><<<items, ht::kThreads,
                                     ht::step_smem_bytes<T>(), stream>>>(
      U, Um, K, out, len, g, canon);
  return cudaGetLastError();
}

template <typename T, int BX, int BY, int BA>
cudaError_t plan_roles(int device, Launch<T>* L) {
  int per_sm = 0, sms = 0;
  const cudaError_t err =
      step_resident<T, BX, BY, BA>(device, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  step_slab(&L->g, per_sm * sms);
  L->got[0] = ht::kStepStages;
  L->got[1] = per_sm;
  L->got[2] = per_sm * sms;
  L->got[3] = L->g.slab;
  L->got[4] = ht::tile_items(L->g);
  L->run = run_roles<T, BX, BY, BA>;
  return cudaSuccess;
}

// make_geom on the brick, then the plan of the kernel of its corner
// roles: the bit of the corner index whose offset is 1 steps the inner
// axis, the mid stride's the mid axis, the plane stride's the planes.
template <typename T>
cudaError_t plan(const int* offs, int len, int device, Launch<T>* L) {
  if (device < 0 || device >= 32 || !ht::make_geom(offs, len, &L->g))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int bx = 0, by = 0;
  for (int b = 0; b < 3; ++b) {
    if (offs[1 << b] == 1) bx = b;
    if (offs[1 << b] == L->g.s_mid) by = b;
  }
  switch (bx * 3 + by) {
    case 0 * 3 + 1: return plan_roles<T, 0, 1, 2>(device, L);
    case 0 * 3 + 2: return plan_roles<T, 0, 2, 1>(device, L);
    case 1 * 3 + 0: return plan_roles<T, 1, 0, 2>(device, L);
    case 1 * 3 + 2: return plan_roles<T, 1, 2, 0>(device, L);
    case 2 * 3 + 0: return plan_roles<T, 2, 0, 1>(device, L);
    case 2 * 3 + 1: return plan_roles<T, 2, 1, 0>(device, L);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const T* U, const T* Um, const T* K, T* out, int len,
           const int* offs, int device, void* stream, bool canon) {
  Launch<T> L;
  cudaError_t err = plan<T>(offs, len, device, &L);
  if (err == cudaSuccess)
    err = L.run(U, Um, K, out, len, L.g, L.got[4], canon,
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

template <typename T>
int grid(const int* offs, int len, int device, int* got) {
  Launch<T> L;
  const cudaError_t err = plan<T>(offs, len, device, &L);
  if (err == cudaSuccess)
    for (int i = 0; i < 5; ++i) got[i] = L.got[i];
  return static_cast<int>(err);
}

}  // namespace

// C entries (ctypes): every pointer except `offs` (8 host ints) is a
// device pointer; the return value is a cudaError_t (0 = success;
// cudaErrorInvalidValue for offsets that are not a brick's).
extern "C" {

// u = U [3, len] and u- = Um [3, len] -> out [3, len] (u+), or with
// canon != 0 out [8, len] = (u+, u, 0, 0).
int ht_brick_step_f32(const float* U, const float* Um, const float* K,
                      float* out, int len, const int* offs, int device,
                      void* stream, int canon) {
  return launch<float>(U, Um, K, out, len, offs, device, stream,
                       canon != 0);
}
int ht_brick_step_f64(const double* U, const double* Um, const double* K,
                      double* out, int len, const int* offs, int device,
                      void* stream, int canon) {
  return launch<double>(U, Um, K, out, len, offs, device, stream,
                        canon != 0);
}

// got [5] = (stages, blocks per SM, resident blocks, slab depth, work
// items) of the launch on this brick and device, by type.
int ht_brick_step_grid_f32(const int* offs, int len, int device, int* got) {
  return grid<float>(offs, len, device, got);
}
int ht_brick_step_grid_f64(const int* offs, int len, int device, int* got) {
  return grid<double>(offs, len, device, got);
}

}  // extern "C"
