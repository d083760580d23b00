// Blockwise int8 dequantizer, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/quantize/quantize.py::_dequant_kernel
// (launched by dequantize_tiles, wrapped by quantize/ops.py::dequantize).
//
// What it computes, for each block b of 128 int8 codes and its float32 scale:
//   x[128 * b + l] = float(q[b, l]) * s[b],   for 128 * b + l < n only.
// The int8 -> float32 conversion is exact and the product is one IEEE float32
// multiply rounded to nearest, written as __fmul_rn so that nvcc cannot contract
// it with anything; a NaN scale gives NaN, a zero scale zeros. The Pallas wrapper
// built the padded (n_blocks * 128) array and sliced it to n; this kernel writes
// the first n values only, so the slice costs no copy.
//
// What bounds it on an H100: device memory. Per value it reads 1 byte and writes 4,
// plus 4 bytes of scale per 128 values, against two operations. The design: one
// warp per block of 128 values, each lane loading one char4 (neighbouring lanes on
// neighbouring addresses) and storing one float4; the block's scale is one
// broadcast load. The last block, cut at n, stores its values one by one. Eight
// warps per thread block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // values per quantization block
constexpr int kWarps = 8;    // quantization blocks per thread block

__global__ void __launch_bounds__(kWarps * 32)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ out, long long n) {
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long lo = blk * kBlock;
  if (lo >= n) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float scale = s[blk];
  const char4 c = reinterpret_cast<const char4*>(q + lo)[lane];
  float4 x;
  x.x = __fmul_rn(static_cast<float>(c.x), scale);
  x.y = __fmul_rn(static_cast<float>(c.y), scale);
  x.z = __fmul_rn(static_cast<float>(c.z), scale);
  x.w = __fmul_rn(static_cast<float>(c.w), scale);
  const long long i = lo + 4 * lane;
  if (i + 4 <= n) {
    reinterpret_cast<float4*>(out + lo)[lane] = x;
  } else if (i < n) {
    out[i] = x.x;
    if (i + 1 < n) out[i + 1] = x.y;
    if (i + 2 < n) out[i + 2] = x.z;
  }
}

}  // namespace

// q: at least ceil(n / 128) * 128 int8, 4-byte aligned. s: ceil(n / 128) float32.
// out: n float32, 16-byte aligned; n >= 1. Returns the CUDA error of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int dequantize_launch(const void* q, const void* s, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlock - 1) / kBlock;
  const long long grid = (blocks + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dequantize_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
