// What the recurrent scan kernels share (gru_scan.cu, lstm_scan.cu): dtype
// conversions, the gate nonlinearity, the batch tiling, and the block-ordered
// reduction of the backward kernels' weight-gradient partials.  Everything
// here sits in an anonymous namespace, so each source that includes it gets
// its own copy and the library exports only the sources' extern "C" entries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads a block aims for: a batch tile of kTileThreads / H rows.
constexpr int kTileThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// v rounded to T and back: the value a carry or a gradient holds in T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      n <= 0)
    n = 132;
  return n;
}

// Batch rows per block: at most kTileThreads / H, and few enough that the
// grid covers the SMs before a block takes more than one row.
inline int tile_rows(int B, int H, int device) {
  const int max_rows = H >= kTileThreads ? 1 : kTileThreads / H;
  const int sms = sm_count(device);
  int rows = (B + sms - 1) / sms;
  if (rows > max_rows) rows = max_rows;
  if (rows < 1) rows = 1;
  return rows;
}

// out[e] = sum over blocks of partials[block][e], in block order: the
// backward kernels' weight gradients, the same from run to run.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int n_blocks, int n,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int i = 0; i < n_blocks; ++i) sum += partials[(long long)i * n + e];
  out[e] = sum;
}

inline cudaError_t reduce_partials(const float* partials, int n_blocks, int n,
                                   float* out, cudaStream_t s) {
  const int threads = 256;
  reduce_partials_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      partials, n_blocks, n, out);
  return cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory limit when it needs over 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
