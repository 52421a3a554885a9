// brick_step: one explicit central-difference step of a uniform brick
// (the port's K1).
//
// Replaces: hercules_tpu/solver/pallas_brick.py:_make_kernel with
// packed_state=True, launched by build_call_packed /
// _build_call_packed_impl (the packed [8, LEN] state/constant layout).
//
// Design (H100): one launch per step, one block per work item (a tile
// of W x 8 elements, W - 1 x 7 owned node columns, on a slab of planes)
// running brick_tile.cuh's staged march: the state streams by
// asynchronous copies into a ring of three node planes in shared
// memory, one plane ahead of the element plane whose forces are formed;
// each element's force once in the spectral form, a fixed-order gather
// and the update at the owned nodes, bit for bit the arithmetic of the
// synchronous march that K5 keeps.  One kernel for each set of corner
// roles (which bit of the corner index steps the inner, the mid and the
// plane axis: six), so that the force's and gather's shared-memory
// addresses are compile-time offsets: read from Geom at run time they
// cost 15-35 %.
// The tile's width W is a template argument too: 32 (256 threads), or
// in float32 44 (352) where a brick's rows waste enough fewer warps on
// it (step_width; B1's 129-node rows take 3 tiles of 43 columns instead
// of 5 of 31, 606 warps a plane that form an element instead of 730).
// Launch bounds hold three blocks per SM in float32 32 wide (80
// registers), two 44 wide (shared memory: 97,120 B a block) and two in
// float64 (128 registers).  The slab: of 1..12 planes, the one whose
// work items end first when the card's resident blocks take them in
// order (step_slab); a shorter last slab shortens the launch's tail.
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

// (U, Um) -> u+, or with canon the layout S (brick_tile.cuh), on tiles
// W wide.
template <typename T, int BX, int BY, int BA, int W>
__global__ void __launch_bounds__(ht::StepTile<W>::kThreads,
                                  sizeof(T) == 4 && W == 32 ? 3 : 2)
    brick_step_kernel(const T* __restrict__ U, const T* __restrict__ Um,
                      const T* __restrict__ K, T* __restrict__ out, int len,
                      ht::Geom g, bool canon) {
  extern __shared__ __align__(16) unsigned char smem[];
  ht::brick_tile_step_staged<T, BX, BY, BA, W>(
      U, Um, K, out, len, g, blockIdx.x, reinterpret_cast<T*>(smem), canon);
}

// The kernel's blocks an SM holds at its registers and shared memory,
// and the SMs, asked once per device; opts the kernel into its shared
// memory first.
template <typename T, int BX, int BY, int BA, int W>
cudaError_t step_resident(int device, int* per_sm, int* sms) {
  static int held[32][2];
  static unsigned opted = 0;
  if (held[device][0] == 0) {
    auto kernel = brick_step_kernel<T, BX, BY, BA, W>;
    const int smem = ht::step_smem_bytes<T, W>();
    cudaError_t err = ht::opt_in_smem(kernel, smem, device, &opted);
    if (err != cudaSuccess) return err;
    int n = 0, b = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, kernel, ht::StepTile<W>::kThreads, smem);
    if (err != cudaSuccess) return err;
    if (b < 1) return cudaErrorInvalidConfiguration;
    held[device][1] = n;
    held[device][0] = b;
  }
  *per_sm = held[device][0];
  *sms = held[device][1];
  return cudaSuccess;
}

// The warps of a plane of W-wide tiles that form at least one element of
// a brick of n_in x n_mid nodes a plane (inner x mid): a warp whose
// lanes all lie off the brick's elements costs nothing, one with a lane
// on them costs as much as a full one.  A warp covers one row of a
// 32-wide tile and two of a 44-wide one.
inline long step_heavy_warps(int n_in, int n_mid, int w) {
  const int ox = w - 1, threads = w * ht::TY;
  const int tiles_x = (n_in + ox - 1) / ox;
  const int tiles_y = (n_mid + ht::OY - 1) / ht::OY;
  long heavy = 0;
  for (int ty = 0; ty < tiles_y; ++ty)
    for (int tx = 0; tx < tiles_x; ++tx)
      for (int t0 = 0; t0 < threads; t0 += 32) {
        const int t1 = (t0 + 32 < threads ? t0 + 32 : threads) - 1;
        bool any = false;
        for (int ly = t0 / w; ly <= t1 / w; ++ly) {
          // the lanes of row ly: elements ex0..ex1 of element row ey
          const int ex0 = tx * ox - 1 + (t0 > ly * w ? t0 - ly * w : 0);
          const int ex1 = tx * ox - 1 + (t1 < ly * w + w - 1 ? t1 - ly * w
                                                              : w - 1);
          const int ey = ty * ht::OY - 1 + ly;
          any = any || (ey >= 0 && ey <= n_mid - 2 && ex1 >= 0 &&
                        ex0 <= n_in - 2);
        }
        heavy += any;
      }
  return heavy;
}

// The tile width of T's march on a brick of n_in x n_mid nodes a plane:
// in float32 44 where a plane's heavy warps (step_heavy_warps) over the
// warps an SM holds at once are fewer than at 32 wide (22 at 44: two
// blocks of 11 warps; 24 at 32: three of 8), 32 on a tie: a 44-wide
// tile's fewer warps must make up for the SM's fewer resident warps
// (PERF.md: on 257-node rows, 8 % fewer heavy warps ran 2-3 % slower);
// in float64 32 (a 44-wide block needs 125,904 B of shared memory even
// with 45-word ring rows: one block an SM, which every barrier would
// drain).  Kept for the last few bricks asked: the count is a loop over
// a plane's tiles.  kernels/tiles.py:step_width mirrors it.
template <typename T>
int step_width(int n_in, int n_mid) {
  if (sizeof(T) != 4) return 32;
  struct Kept {
    int n_in, n_mid, w;
  };
  thread_local Kept kept[8] = {};
  thread_local int next = 0;
  for (const Kept& k : kept)
    if (k.w && k.n_in == n_in && k.n_mid == n_mid) return k.w;
  const int w = step_heavy_warps(n_in, n_mid, 44) * 24 <
                        step_heavy_warps(n_in, n_mid, 32) * 22
                    ? 44
                    : 32;
  kept[next] = {n_in, n_mid, w};
  next = (next + 1) % 8;
  return w;
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

// The launch on one brick: its Geom, its corner roles, its tile width
// and the kernel of those, with (stages, blocks per SM, resident blocks,
// slab depth, work items, tile width) in got [6].
template <typename T>
struct Launch {
  ht::Geom g;
  int got[6];
  cudaError_t (*run)(const T*, const T*, const T*, T*, int, const ht::Geom&,
                     int, bool, cudaStream_t);
};

template <typename T, int BX, int BY, int BA, int W>
cudaError_t run_roles(const T* U, const T* Um, const T* K, T* out, int len,
                      const ht::Geom& g, int items, bool canon,
                      cudaStream_t stream) {
  brick_step_kernel<T, BX, BY, BA, W>
      <<<items, ht::StepTile<W>::kThreads, ht::step_smem_bytes<T, W>(),
         stream>>>(U, Um, K, out, len, g, canon);
  return cudaGetLastError();
}

template <typename T, int BX, int BY, int BA, int W>
cudaError_t plan_roles(int device, Launch<T>* L) {
  int per_sm = 0, sms = 0;
  const cudaError_t err =
      step_resident<T, BX, BY, BA, W>(device, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  step_slab(&L->g, per_sm * sms);
  L->got[0] = ht::kStepStages;
  L->got[1] = per_sm;
  L->got[2] = per_sm * sms;
  L->got[3] = L->g.slab;
  L->got[4] = ht::tile_items(L->g);
  L->got[5] = W;
  L->run = run_roles<T, BX, BY, BA, W>;
  return cudaSuccess;
}

// plan_roles for the tile width w: 32, or in float32 44
template <typename T, int BX, int BY, int BA>
cudaError_t plan_width(int device, int w, Launch<T>* L) {
  if constexpr (sizeof(T) == 4)
    if (w == 44) return plan_roles<T, BX, BY, BA, 44>(device, L);
  return plan_roles<T, BX, BY, BA, 32>(device, L);
}

// make_geom on the brick, its tile width (step_width) and the tiles of
// that width a plane, then the plan of the kernel of its corner roles
// and width: the bit of the corner index whose offset is 1 steps the
// inner axis, the mid stride's the mid axis, the plane stride's the
// planes.
template <typename T>
cudaError_t plan(const int* offs, int len, int device, Launch<T>* L) {
  if (device < 0 || device >= 32 || !ht::make_geom(offs, len, &L->g))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int w = step_width<T>(L->g.nx, L->g.ny);
  L->g.tiles_x = (L->g.nx + w - 2) / (w - 1);
  int bx = 0, by = 0;
  for (int b = 0; b < 3; ++b) {
    if (offs[1 << b] == 1) bx = b;
    if (offs[1 << b] == L->g.s_mid) by = b;
  }
  switch (bx * 3 + by) {
    case 0 * 3 + 1: return plan_width<T, 0, 1, 2>(device, w, L);
    case 0 * 3 + 2: return plan_width<T, 0, 2, 1>(device, w, L);
    case 1 * 3 + 0: return plan_width<T, 1, 0, 2>(device, w, L);
    case 1 * 3 + 2: return plan_width<T, 1, 2, 0>(device, w, L);
    case 2 * 3 + 0: return plan_width<T, 2, 0, 1>(device, w, L);
    case 2 * 3 + 1: return plan_width<T, 2, 1, 0>(device, w, L);
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
    for (int i = 0; i < 6; ++i) got[i] = L.got[i];
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

// got [6] = (stages, blocks per SM, resident blocks, slab depth, work
// items, tile width) of the launch on this brick and device, by type.
int ht_brick_step_grid_f32(const int* offs, int len, int device, int* got) {
  return grid<float>(offs, len, device, got);
}
int ht_brick_step_grid_f64(const int* offs, int len, int device, int* got) {
  return grid<double>(offs, len, device, got);
}

}  // extern "C"
