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
// flight: each thread issues kUnroll float4 loads of a and of b
// (neighbouring threads on neighbouring 16 bytes, so every warp reads
// whole 512-byte lines) before its stores, over a grid of a few waves of
// the card's SMs that strides through the rest.  The SM count is read
// once, by ht_stream_add_init when the library loads, never per launch.
//
// The entries launch on the given stream of the current device (the
// wrapper checks that the tensors lie there).  Loads and stores are
// streaming (__ldcs / __stcs: evict-first, the data is touched once);
// the sum is bit-identical to torch.add.  No L2 persistence hint: the
// probe measures device memory.
//
// The aliased form is its own entry point (s += c): s is read and
// written through one pointer, so it is not declared __restrict__.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// resident blocks per SM at 256 threads, and waves of them per launch
constexpr int kBlocksPerSm = 8;
constexpr int kWaves = 2;

int g_sms = 132;  // H100 SXM; replaced by ht_stream_add_init

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// out[i] = a[i] + b[i]; `out` may be `a` itself (the in-place kernel
// makes no __restrict__ promise)
__device__ __forceinline__ void add_range(const float4* a, const float4* b,
                                          float4* out, long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  for (; i + (kUnroll - 1) * step < n4; i += kUnroll * step) {
    float4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      x[k] = __ldcs(a + i + k * step);
      y[k] = __ldcs(b + i + k * step);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      __stcs(out + i + k * step, add4(x[k], y[k]));
  }
  for (; i < n4; i += step)
    __stcs(out + i, add4(__ldcs(a + i), __ldcs(b + i)));
}

__global__ void __launch_bounds__(kThreads)
    stream_add_kernel(const float4* __restrict__ a,
                      const float4* __restrict__ b,
                      float4* __restrict__ out, long long n4) {
  add_range(a, b, out, n4);
}

__global__ void __launch_bounds__(kThreads)
    stream_add_inplace_kernel(float4* s, const float4* __restrict__ c,
                              long long n4) {
  add_range(s, c, s, n4);
}

// Blocks for n4 float4s: enough for kUnroll per thread, at most kWaves
// waves of resident blocks (the rest is the grid-stride loop).
int grid_for(long long n4) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long need = (n4 + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(g_sms) * kBlocksPerSm * kWaves;
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace

// C entries (ctypes): a, b, out, s, c are device pointers to n4 float4s
// (16-byte aligned); the return value is a cudaError_t (0 = success).
extern "C" {

// Read the SM count of `device` once (called when the library loads).
int ht_stream_add_init(int device) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms > 0) g_sms = sms;
  return 0;
}

int ht_stream_add_f32(const void* a, const void* b, void* out, long long n4,
                      void* stream) {
  if (n4 == 0) return 0;
  const auto* x = static_cast<const float4*>(a);
  const auto* y = static_cast<const float4*>(b);
  auto* o = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_add_kernel<<<grid_for(n4), kThreads, 0, s>>>(x, y, o, n4);
  return static_cast<int>(cudaGetLastError());
}

int ht_stream_add_inplace_f32(void* s, const void* c, long long n4,
                              void* stream) {
  if (n4 == 0) return 0;
  auto* x = static_cast<float4*>(s);
  const auto* y = static_cast<const float4*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stream_add_inplace_kernel<<<grid_for(n4), kThreads, 0, st>>>(x, y, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
