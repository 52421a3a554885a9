// stream_add: the HBM streaming probe out = a + b on [8, LEN] float32
// (the port's K7).
//
// Replaces: hercules_tpu/tools/hbm_ceiling.py:main, the pallas_call at
// :75 whose body `kern` (:69-70) computes o = x + y over (8, B) blocks,
// run plain and with input_output_aliases={0: 0} (the output written
// over the first input).
//
// What bounds it on an H100: nothing but device memory.  Each element
// is two 4-byte reads, one 4-byte write and one FP32 add, 12 bytes per
// FLOP, far below the card's 67 TFLOP/s over 3.35 TB/s = 20 FLOP per
// byte.  So the kernel's only job is to keep enough 16-byte loads in
// flight: one thread per float4 (neighbouring threads on neighbouring
// 16 bytes, so every warp reads whole 512-byte lines), a grid of
// ceil(n4 / 256) blocks, grid-stride beyond 2^20 blocks.
//
// The entries launch on the given stream of the current device (the
// wrapper checks that the tensors lie there) and query nothing per
// launch: at the probe's size the kernel takes about 0.037 ms on an
// H100 80GB HBM3 (700 W), so host work per call shows in a lone call's
// time.
//
// The aliased form is its own entry point (s += c): s is read and
// written through one pointer, so it is not declared __restrict__.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

__global__ void __launch_bounds__(kThreads)
    stream_add_kernel(const float4* __restrict__ a,
                      const float4* __restrict__ b,
                      float4* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride)
    out[i] = add4(a[i], b[i]);
}

__global__ void __launch_bounds__(kThreads)
    stream_add_inplace_kernel(float4* s, const float4* __restrict__ c,
                              long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride)
    s[i] = add4(s[i], c[i]);
}

// Blocks for n4 float4s: one thread each, up to kMaxBlocks (the rest is
// the grid-stride loop).  Nothing is asked of the device per launch.
int grid_for(long long n4) {
  const long long need = (n4 + kThreads - 1) / kThreads;
  return static_cast<int>(need < kMaxBlocks ? need : kMaxBlocks);
}

}  // namespace

// C entries (ctypes): a, b, out, s, c are device pointers to n4 float4s
// (16-byte aligned); the return value is a cudaError_t (0 = success).
extern "C" {

int ht_stream_add_f32(const void* a, const void* b, void* out,
                      long long n4, void* stream) {
  if (n4 == 0) return 0;
  stream_add_kernel<<<grid_for(n4), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

int ht_stream_add_inplace_f32(void* s, const void* c, long long n4,
                              void* stream) {
  if (n4 == 0) return 0;
  stream_add_inplace_kernel<<<grid_for(n4), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(s), static_cast<const float4*>(c), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
