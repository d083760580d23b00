// Fused XOR-delta + per-chunk dirty count + two-track digest, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fused/fused.py::_fused_kernel
// (launched by fused_chunk_tiles, wrapped by fused/ops.py::fused_precodec).
//
// What it computes, per chunk of `chunk_words` uint32 words (the stream is
// zero-padded to a chunk multiple; padding words count as zeros):
//   delta[i] = cur[i] ^ base[i]
//   meta[c]  = (changed, S, T) with changed = #{i : delta[i] != 0},
//              S = sum w_i mod 2^32, T = sum ((i & (2^20 - 1)) * w_i) mod 2^32,
//              w = cur and i the word index *within* the chunk.
//
// What bounds it on an H100: device memory. Each word is read twice (cur and
// base) and written once (delta), 12 bytes, against a handful of integer ops;
// at 3.35 TB/s that is the whole cost, so the design is about keeping the
// memory system busy:
//   * The TPU ran one sequential grid step per chunk. Here the grid is 2-D,
//     (chunk, slice of the chunk), so even a state of a few chunks fills the
//     132 SMs with blocks.
//   * Every thread moves 16 bytes per load and store (uint4), neighbouring
//     threads on neighbouring addresses.
//   * S, T and the count are kept in uint32 registers, reduced with warp
//     shuffles, then across the block's warps in shared memory, and each block
//     adds its three partials into the zeroed meta row with atomicAdd.
//     Addition mod 2^32 is associative and commutative, so the result is
//     exact and the same on every run, whatever order the blocks finish in.
//   * The ragged tail of the last chunk is masked here (loads past n_words
//     read as zero, delta is still written there), so the wrapper never pads
//     or copies the input stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 8;                                   // uint4 steps per thread
constexpr long long kSliceWords = 4LL * kThreads * kIters;  // 8192 words per block
constexpr uint32_t kIdxMask = (1u << 20) - 1;               // IDX_MOD - 1

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ p, long long g,
                                       long long n_words) {
  if (g + 4 <= n_words) return *reinterpret_cast<const uint4*>(p + g);
  uint4 v;
  v.x = g + 0 < n_words ? p[g + 0] : 0u;
  v.y = g + 1 < n_words ? p[g + 1] : 0u;
  v.z = g + 2 < n_words ? p[g + 2] : 0u;
  v.w = g + 3 < n_words ? p[g + 3] : 0u;
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_precodec_kernel(const uint32_t* __restrict__ cur, const uint32_t* __restrict__ base,
                      uint32_t* __restrict__ delta, uint32_t* __restrict__ meta,
                      long long n_words, long long chunk_words) {
  const long long chunk = blockIdx.x;
  const long long lo = static_cast<long long>(blockIdx.y) * kSliceWords;
  const long long hi = lo + kSliceWords < chunk_words ? lo + kSliceWords : chunk_words;
  const long long off = chunk * chunk_words;
  uint32_t changed = 0, s = 0, t = 0;
  // chunk_words is a multiple of 1024, so i + 4 <= hi on every step
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * kThreads) {
    const long long g = off + i;
    const uint4 c = load4(cur, g, n_words);
    const uint4 b = load4(base, g, n_words);
    const uint4 d = make_uint4(c.x ^ b.x, c.y ^ b.y, c.z ^ b.z, c.w ^ b.w);
    *reinterpret_cast<uint4*>(delta + g) = d;
    changed += (d.x != 0u) + (d.y != 0u) + (d.z != 0u) + (d.w != 0u);
    s += c.x + c.y + c.z + c.w;
    const uint32_t k = static_cast<uint32_t>(i);
    t += ((k + 0u) & kIdxMask) * c.x + ((k + 1u) & kIdxMask) * c.y +
         ((k + 2u) & kIdxMask) * c.z + ((k + 3u) & kIdxMask) * c.w;
  }
  changed = warp_sum(changed);
  s = warp_sum(s);
  t = warp_sum(t);
  __shared__ uint32_t part[3][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = changed;
    part[1][warp] = s;
    part[2][warp] = t;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kThreads / 32;
    changed = warp_sum(live ? part[0][lane] : 0u);
    s = warp_sum(live ? part[1][lane] : 0u);
    t = warp_sum(live ? part[2][lane] : 0u);
    if (lane == 0) {
      atomicAdd(meta + 3 * chunk + 0, changed);
      atomicAdd(meta + 3 * chunk + 1, s);
      atomicAdd(meta + 3 * chunk + 2, t);
    }
  }
}

}  // namespace

// cur, base: n_words uint32 each, 16-byte aligned. delta: n_chunks * chunk_words
// uint32. meta: n_chunks * 3 uint32, zeroed by the caller. Returns the CUDA error
// of the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int fused_precodec_launch(const void* cur, const void* base, void* delta,
                                     void* meta, long long n_words, long long chunk_words,
                                     long long n_chunks, void* stream) {
  const long long slices = (chunk_words + kSliceWords - 1) / kSliceWords;
  if (slices > 65535 || n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(slices));
  fused_precodec_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cur), static_cast<const uint32_t*>(base),
      static_cast<uint32_t*>(delta), static_cast<uint32_t*>(meta), n_words, chunk_words);
  return static_cast<int>(cudaGetLastError());
}
