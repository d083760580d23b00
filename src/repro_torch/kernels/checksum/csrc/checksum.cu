// Whole-stream two-track checksum of uint32 words, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/checksum/checksum.py::_checksum_kernel
// (launched by checksum_tiles; its tiles are combined in checksum/ops.py::checksum_u32).
//
// What it computes, over n words w_i with all arithmetic mod 2^32:
//   S = sum w_i,   T = sum ((i & (2^20 - 1)) * w_i),   i the word's index in the stream.
// The TPU kernel gave each 1024-word tile g partials (S_g, T_g) with a tile-local
// index l and combined them as T = sum (T_g + ((g * 1024) mod 2^20) * S_g). As
// ((g * 1024) mod 2^20) + l < 2^20 for every l < 1024, that is the global-index form
// above, which this kernel computes directly: no partials array, no second pass.
//
// What bounds it on an H100: device memory. Each word is read once (4 bytes)
// against four integer operations; at 3.35 TB/s the read is the whole cost.
// The design keeps loads in flight:
//   * A grid-stride loop over 16-byte vectors (uint4), kUnroll independent loads
//     per thread and step, neighbouring threads on neighbouring addresses; the grid
//     is capped at a few blocks per SM, so the block count does not grow with n.
//   * S and T stay in uint32 registers, are reduced with warp shuffles, then across
//     the block's warps in shared memory, and each block adds its pair into the
//     zeroed (2,) output with atomicAdd. Addition mod 2^32 is associative and
//     commutative, so the result is exact and the same on every run.
//   * The words need only be 4-byte aligned: a stream that starts off a 16-byte
//     boundary (a view into a leaf) has up to three head words, which block 0 adds
//     with scalar loads; the body is read as uint4 from the first boundary on. The
//     ragged tail is masked here too, so the wrapper never pads or copies.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                     // uint4 loads in flight per thread
constexpr int kBlocksPerSm = 8;
constexpr uint32_t kIdxMask = (1u << 20) - 1;  // IDX_MOD - 1

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint32_t* __restrict__ w, uint32_t* __restrict__ out, long long n,
                long long head) {
  uint32_t s = 0, t = 0;
  if (blockIdx.x == 0 && threadIdx.x < head) {  // index < 3: no mask needed
    const uint32_t x = w[threadIdx.x];
    s += x;
    t += threadIdx.x * x;
  }
  const uint32_t* body = w + head;  // 16-byte aligned
  const long long n_body = n - head;
  const long long n_vec = (n_body + 3) / 4;  // the last vector may be partial
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j0 < n_vec;
       j0 += stride * kUnroll) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      const long long g = 4 * j;
      if (g + 4 <= n_body) {
        x[u] = reinterpret_cast<const uint4*>(body)[j];
      } else {
        x[u].x = g + 0 < n_body ? body[g + 0] : 0u;
        x[u].y = g + 1 < n_body ? body[g + 1] : 0u;
        x[u].z = g + 2 < n_body ? body[g + 2] : 0u;
        x[u].w = g + 3 < n_body ? body[g + 3] : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // the low 32 bits of the global index are enough for i & (2^20 - 1)
      const uint32_t k = static_cast<uint32_t>(head + 4 * (j0 + u * stride));
      s += x[u].x + x[u].y + x[u].z + x[u].w;
      t += ((k + 0u) & kIdxMask) * x[u].x + ((k + 1u) & kIdxMask) * x[u].y +
           ((k + 2u) & kIdxMask) * x[u].z + ((k + 3u) & kIdxMask) * x[u].w;
    }
  }
  s = warp_sum(s);
  t = warp_sum(t);
  __shared__ uint32_t part[2][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = t;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kThreads / 32;
    s = warp_sum(live ? part[0][lane] : 0u);
    t = warp_sum(live ? part[1][lane] : 0u);
    if (lane == 0) {
      atomicAdd(out + 0, s);
      atomicAdd(out + 1, t);
    }
  }
}

}  // namespace

// words: n_words uint32, 4-byte aligned, n_words >= 1. out: 2 uint32, zeroed by the
// caller. Returns the CUDA error of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int checksum_launch(const void* words, void* out, long long n_words, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(words);
  if (n_words <= 0 || addr % 4) return static_cast<int>(cudaErrorInvalidValue);
  long long head = static_cast<long long>((16 - addr % 16) % 16 / 4);
  if (head > n_words) head = n_words;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = (n_words - head + 3) / 4;
  long long grid = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (grid > static_cast<long long>(sms) * kBlocksPerSm) grid = static_cast<long long>(sms) * kBlocksPerSm;
  if (grid < 1) grid = 1;
  checksum_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n_words, head);
  return static_cast<int>(cudaGetLastError());
}
