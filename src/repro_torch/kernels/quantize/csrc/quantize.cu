// Blockwise int8 quantizer, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quantize/quantize.py::_quant_kernel
// (launched by quantize_tiles, wrapped by quantize/ops.py::quantize).
//
// What it computes, for each block of 128 float32 values:
//   absmax = max |x|            (NaN propagates, as jnp.max does)
//   scale  = absmax / 127
//   q      = clip(trunc(x / scale + (x >= 0 ? 0.5 : -0.5)), -127, 127) as int8,
//            and q = 0 where scale == 0 (or is NaN).
// Every step is one IEEE float32 operation rounded to nearest, as in the
// Pallas kernel. The divisions and the add are written as __fdiv_rn and
// __fadd_rn so that nvcc can neither turn x / scale into x * (1 / scale) nor
// contract the add into an FMA: either would move some codes by one. Build
// without --use_fast_math.
//
// What bounds it on an H100: device memory. Per value it reads 4 bytes and
// writes 1, plus 4 bytes of scale per 128 values (about 5.03 bytes a value),
// against ~10 float ops. The design: one warp per block of 128 values, each
// lane loading one float4 (16 bytes, neighbouring lanes on neighbouring
// addresses) and storing one char4; absmax is reduced with xor shuffles, so
// no shared memory and no second pass. Eight warps per thread block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // values per quantization block
constexpr int kWarps = 8;    // quantization blocks per thread block

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ signed char code(float v, float safe, bool live) {
  float r = truncf(__fadd_rn(__fdiv_rn(v, safe), v >= 0.0f ? 0.5f : -0.5f));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return live ? static_cast<signed char>(static_cast<int>(r)) : static_cast<signed char>(0);
}

__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                long long n_blocks) {
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float4 v = reinterpret_cast<const float4*>(x + blk * kBlock)[lane];
  float m = nan_max(nan_max(fabsf(v.x), fabsf(v.y)), nan_max(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float scale = __fdiv_rn(m, 127.0f);
  const bool live = scale > 0.0f;
  const float safe = live ? scale : 1.0f;
  char4 out;
  out.x = code(v.x, safe, live);
  out.y = code(v.y, safe, live);
  out.z = code(v.z, safe, live);
  out.w = code(v.w, safe, live);
  reinterpret_cast<char4*>(q + blk * kBlock)[lane] = out;
  if (lane == 0) s[blk] = scale;
}

}  // namespace

// x: n_blocks * 128 float32, 16-byte aligned. q: n_blocks * 128 int8, 4-byte
// aligned. s: n_blocks float32. Returns the CUDA error of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int quantize_launch(const void* x, void* q, void* s, long long n_blocks,
                               void* stream) {
  const long long grid = (n_blocks + kWarps - 1) / kWarps;
  quantize_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), n_blocks);
  return static_cast<int>(cudaGetLastError());
}
