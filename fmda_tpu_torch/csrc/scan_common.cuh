// What the recurrent kernels share (gru_scan.cu, lstm_scan.cu, ssm_step.cu,
// scan_dw.cu): dtype conversions, the gate nonlinearity, the batch tiling,
// and the lane sums of the backward sweeps.  Everything here sits in an
// anonymous namespace, so each source that includes it gets its own copy and
// the library exports only the sources' extern "C" entries.

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

// The same with an approximate reciprocal (div.approx: within 2 ulp of the
// rounded quotient, and 0 where 1 + e^-x passes 2^126, for x < -87): no
// call to the slow path of IEEE division, whose saved registers spill in
// the backward sweeps.
__device__ __forceinline__ float sigmoid_rcp_f32(float x) {
  return __fdividef(1.0f, 1.0f + expf(-x));
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

// The backward sweeps' layout (gru_scan.cu, lstm_scan.cu): one block per
// batch row, L lanes per hidden unit, lane l of unit j at thread j * L + l.
// Where H <= kSweepRegH, L = kSweepLanes and each lane holds its slices of
// W_hh in registers (kSweepRegH / L values of each gate row it recomputes,
// as many of each gate's share of the column it chains), in blocks of at
// most kSweepRegThreads; else W_hh is read from shared memory while it fits
// under kMaxSweepSmemBytes, and from device memory past that.  Fewer lanes
// would mean more W_hh a lane: two lanes spill the LSTM's registers.
constexpr int kSweepLanes = 4;
constexpr int kSweepRegH = 32;
constexpr int kSweepRegThreads = kSweepRegH * kSweepLanes;
constexpr size_t kMaxSweepSmemBytes = 225 * 1024;

// The lanes a sweep gives each hidden unit outside the register layout: as
// many as a block of at most max_threads holds, kSweepLanes or 1.
inline int sweep_lanes(int H, int max_threads) {
  return H * kSweepLanes <= max_threads ? kSweepLanes : 1;
}

// The threads of this thread's warp that exist: all 32 but in a block's
// last, partial warp.  The mask of every shuffle the sweeps make.
__device__ __forceinline__ unsigned warp_mask() {
  const int n = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  return n == 32 ? 0xffffffffu : (1u << n) - 1u;
}

// v summed over the L lanes of an aligned group of L threads (L a power of
// two, at most 32): a butterfly, so every lane of the group ends with the
// same bits (each add is commutative), the same from run to run.
template <int L>
__device__ __forceinline__ float lane_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// The step profile of a backward sweep, built only with
// -DFMDA_PROFILE_SWEEP (experiments/torch_scan_sweep_profile.py): the clock
// cycles each part of a step takes, summed over the steps, by the first and
// the last thread of block 0, in g_sweep_prof[0..4] and [8..12] (then the
// total cycles and nanoseconds of the loop).  PROF_MARK(k) ends part k:
// 0 the gate recompute and its lane sums, 1 the gate and cotangent algebra
// and the outputs, 2 the barrier, 3 the dh chain, 4 the loop's own work.
// Off, it compiles to nothing.
#ifdef FMDA_PROFILE_SWEEP
__device__ long long g_sweep_prof[16];
struct SweepProfile {
  bool on;
  long long acc[5] = {0, 0, 0, 0, 0};
  long long last, start;
  unsigned long long ns0;
  __device__ SweepProfile()
      : on(blockIdx.x == 0 &&
           (threadIdx.x == 0 || threadIdx.x == blockDim.x - 1)) {
    last = start = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  }
  __device__ void mark(int k) {
    if (!on) return;
    const long long c = clock64();
    acc[k] += c - last;
    last = c;
  }
  __device__ void flush() {
    if (!on) return;
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    const int o = threadIdx.x == 0 ? 0 : 8;
    for (int k = 0; k < 5; ++k) g_sweep_prof[o + k] = acc[k];
    g_sweep_prof[o + 5] = clock64() - start;
    g_sweep_prof[o + 6] = (long long)(ns1 - ns0);
  }
};
#define SWEEP_PROFILE SweepProfile sweep_profile
#define PROF_MARK(k) sweep_profile.mark(k)
#define PROF_FLUSH() sweep_profile.flush()
#else
#define SWEEP_PROFILE
#define PROF_MARK(k)
#define PROF_FLUSH()
#endif

// Raise a kernel's dynamic shared-memory limit when it needs over 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
