// XOR delta of two word streams and its changed-word count, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/delta/delta.py::_delta_kernel
// (launched by delta_tiles, wrapped by delta/ops.py::xor_delta, which sums the
// per-tile counts).
//
// What it computes, over two streams of n uint32 words:
//   delta[i] = cur[i] ^ prev[i]   and   count = #{i : delta[i] != 0}.
//
// What bounds it on an H100: device memory. Each word is read twice and written
// once (12 bytes) against three integer operations. The design:
//   * The TPU walked (8, 128) tiles in a sequential grid and wrote one count per
//     tile. Here a grid-stride loop, capped at a few blocks per SM, moves 16 bytes
//     per thread and load or store (uint4), with kUnroll vectors of each stream in
//     flight per thread and step, neighbouring threads on neighbouring addresses.
//   * The count is kept per thread, reduced with warp shuffles, then across the
//     block's warps in shared memory, and each block adds its total into the zeroed
//     64-bit count with one atomicAdd: exact, the same on every run, and no per-tile
//     counts array or second reduction.
//   * The ragged tail is masked here (scalar loads and stores past the last whole
//     vector), so the wrapper never pads or copies either stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // uint4 vectors of each stream in flight per thread
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ p, long long g,
                                       long long n) {
  if (g + 4 <= n) return *reinterpret_cast<const uint4*>(p + g);
  uint4 v;
  v.x = g + 0 < n ? p[g + 0] : 0u;
  v.y = g + 1 < n ? p[g + 1] : 0u;
  v.z = g + 2 < n ? p[g + 2] : 0u;
  v.w = g + 3 < n ? p[g + 3] : 0u;
  return v;
}

__global__ void __launch_bounds__(kThreads)
xor_delta_kernel(const uint32_t* __restrict__ cur, const uint32_t* __restrict__ prev,
                 uint32_t* __restrict__ delta, unsigned long long* __restrict__ count,
                 long long n) {
  const long long n_vec = (n + 3) / 4;  // the last vector may be partial
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t changed = 0;
  for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j0 < n_vec;
       j0 += stride * kUnroll) {
    uint4 c[kUnroll], p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = 4 * (j0 + u * stride);
      c[u] = load4(cur, g, n);
      p[u] = load4(prev, g, n);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = 4 * (j0 + u * stride);
      const uint4 d = make_uint4(c[u].x ^ p[u].x, c[u].y ^ p[u].y, c[u].z ^ p[u].z,
                                 c[u].w ^ p[u].w);
      // words past n were loaded as zeros on both sides, so they count nothing
      changed += (d.x != 0u) + (d.y != 0u) + (d.z != 0u) + (d.w != 0u);
      if (g + 4 <= n) {
        *reinterpret_cast<uint4*>(delta + g) = d;
      } else if (g < n) {
        delta[g] = d.x;
        if (g + 1 < n) delta[g + 1] = d.y;
        if (g + 2 < n) delta[g + 2] = d.z;
      }
    }
  }
  changed = warp_sum(changed);
  __shared__ uint32_t part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = changed;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += part[i];
    atomicAdd(count, total);
  }
}

}  // namespace

// cur, prev, delta: n_words uint32 each, 16-byte aligned, n_words >= 1. count: one
// 64-bit integer, zeroed by the caller. Returns the CUDA error of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int xor_delta_launch(const void* cur, const void* prev, void* delta, void* count,
                                long long n_words, void* stream) {
  if (n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = (n_words + 3) / 4;
  long long grid = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (grid > static_cast<long long>(sms) * kBlocksPerSm) grid = static_cast<long long>(sms) * kBlocksPerSm;
  xor_delta_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cur), static_cast<const uint32_t*>(prev),
      static_cast<uint32_t*>(delta), static_cast<unsigned long long*>(count), n_words);
  return static_cast<int>(cudaGetLastError());
}
