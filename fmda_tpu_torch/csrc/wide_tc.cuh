// What the wide route's fused GRU steps share (gru_wide_step.cu, the
// forward; gru_wide_bwd_step.cu, the backward): one layout rule for a step's
// product on Hopper's tensor cores (output tiles of 64 rows, K in k-steps
// of 64, clusters that multicast a box or split K), and the primitives the two
// kernels are built from: TMA boxes with 128-byte swizzle completing on
// mbarriers, the wgmma descriptor of a K-major box, programmatic dependent
// launch, the bf16 word helpers, and the host side's tensor maps and
// occupancy figures.  Everything sits in an anonymous namespace, so each
// source that includes it gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "scan_common.cuh"

namespace {

namespace pcg = cooperative_groups;

constexpr int kTile = 64;     // batch rows and hidden units a CTA
constexpr int kBoxK = 64;     // K elements a box row: 128 bytes of bf16
constexpr int kRowBytes = kBoxK * 2;
constexpr int kAlignBytes = 1024;  // the 128-byte swizzle's atom
constexpr int kBarrierBytes = 128;
// returned where a launch's plan does not fit its shapes
constexpr int kPlanRefused = 1;
constexpr int kMaxSplit = 8;
// how long any wait may take before the kernel traps
constexpr unsigned long long kWatchdogNs = 4000000000ull;

// The plan: batch tiles, unit tiles, CTAs a cluster along the batch
// (multicasting the B operand's boxes) and along K (split), the cluster's
// size, k-steps a CTA, the grid, shared bytes a CTA.  One of mcast and
// split is 1.
struct TilePlan {
  int tiles_m, tiles_n, mcast, split, cluster, k_steps, grid, smem;
};
constexpr int kPlanInts = 8;

// The card's figures: SMs, and the clusters of 1, 2, 4 and 8 CTAs of a
// kernel that can be resident at once.
struct TileFigures {
  int sms;
  int clusters[4];
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The layout of a product of B rows by H units over `k_total` k-steps of
// 64, in tiles of 64 rows by `units` units, CTAs of `smem` shared bytes:
// few tiles (at most half the SMs): split K over the largest cluster (8,
// 4, 2) that divides the k-steps, stays within the SMs and is resident all
// at once; an even number of batch tiles otherwise: clusters of 2 along
// the batch.  A pure function of its arguments; B >= 1 and H a multiple
// of `units`.
TilePlan tile_plan(int B, int H, int units, int k_total, int smem,
                   const TileFigures& f) {
  TilePlan q{};
  q.tiles_m = cdiv(B, kTile);
  q.tiles_n = H / units;
  const int ctas = q.tiles_m * q.tiles_n;
  q.mcast = 1;
  q.split = 1;
  if (2 * ctas <= f.sms) {
    for (int k = 3; k >= 1; --k) {
      const int s = 1 << k;
      if (k_total % s == 0 && ctas * s <= f.sms && ctas <= f.clusters[k]) {
        q.split = s;
        break;
      }
    }
  } else if (q.tiles_m % 2 == 0) {
    q.mcast = 2;
  }
  q.cluster = q.mcast * q.split;
  q.k_steps = k_total / q.split;
  q.grid = ctas * q.split;
  q.smem = smem;
  return q;
}

// Whether `p` lays out a product of B rows by H units over `k_total`
// k-steps in tiles of `units` units and CTAs of `smem` bytes: the fields
// tile_plan would derive from its cluster choice.
bool tile_plan_fits(int B, int H, int units, int k_total, int smem,
                    const TilePlan& p) {
  if (B < 1 || H < units || H % units) return false;
  const bool split_ok = p.split == 1 || p.split == 2 || p.split == 4 ||
                        p.split == 8;
  return split_ok && (p.mcast == 1 || p.mcast == 2) &&
         (p.mcast == 1 || p.split == 1) && p.tiles_m == cdiv(B, kTile) &&
         p.tiles_n == H / units && (p.mcast == 1 || p.tiles_m % 2 == 0) &&
         k_total % p.split == 0 && p.k_steps * p.split == k_total &&
         p.cluster == p.mcast * p.split &&
         p.grid == p.tiles_m * p.tiles_n * p.split && p.smem == smem;
}

// ---- the primitives --------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A step's profile, built only with -DFMDA_PROFILE_STEP: %globaltimer
// stamps of CTA 0's last launch, in columns each kernel names (its
// source's own copy of g_step_prof).  Off, it compiles to nothing.
#ifdef FMDA_PROFILE_STEP
constexpr int kProfCols = 8;
__device__ unsigned long long g_step_prof[kProfCols];
#define STEP_STAMP(cond, col)                              \
  do {                                                     \
    if ((cond) && blockIdx.x == 0) g_step_prof[col] = global_ns(); \
  } while (0)
#else
#define STEP_STAMP(cond, col) \
  do {                        \
  } while (0)
#endif

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete; trap past the watchdog.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWatchdogNs) asm volatile("trap;");
}

// One arrival on the barrier at the same offset in CTA `cta` of the
// cluster (this CTA's own where the cluster is one CTA).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned cta,
                                            int cluster) {
  if (cluster > 1) {
    asm volatile(
        "{\n .reg .b32 rem;\n"
        " mapa.shared::cluster.u32 rem, %0, %1;\n"
        " mbarrier.arrive.shared::cluster.b64 _, [rem];\n}\n" ::"r"(
            smem_u32(bar)),
        "r"(cta)
        : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
  }
}

// One TMA box of the 2-D tensor map `map` at (column c0, row c1) into
// shared dst, completing on `bar`: in this CTA, or at the same offsets in
// both CTAs of a cluster of 2 (multicast).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint64_t* bar,
                                        int mcast) {
  const unsigned long long desc = reinterpret_cast<unsigned long long>(map);
  if (mcast > 1) {
    const unsigned short mask = (unsigned short)((1u << mcast) - 1u);
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], "
        "%5;\n" ::"r"(smem_u32(dst)),
        "l"(desc), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(dst)),
        "l"(desc), "r"(c0), "r"(c1), "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<unsigned long long>(map))
               : "memory");
}

__device__ __forceinline__ void cluster_sync() { pcg::this_cluster().sync(); }

// Programmatic dependent launch: wait until the grid before this one in
// the stream has completed and its writes are visible (at once where this
// launch did not overlap it), and let the next grid be launched.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The wgmma descriptor of a K-major operand in a ring slot: 128-byte
// rows, 128-byte swizzle, 8-row groups 1024 bytes apart; `p` is the
// slot's box plus 32 bytes a k16 step (the swizzle is applied to the
// address, so the step advances the start alone).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving an accumulator across the asynchronous
// products that write it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float lo_f(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(unsigned v) {
  return __uint_as_float(v & 0xFFFF0000u);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// Word i (two bf16) of 16 values held as two uint4; i a constant once
// unrolled, so the words stay in registers.
__device__ __forceinline__ unsigned word_of(const uint4 (&v)[2], int i) {
  const uint4 q = v[i >> 2];
  return (i & 3) == 0 ? q.x : (i & 3) == 1 ? q.y : (i & 3) == 2 ? q.z : q.w;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---- the host side ---------------------------------------------------------

constexpr int kMaxDevices = 64;

// The card's figures for `kernel` launched with `threads` threads and
// `smem` dynamic shared bytes a CTA (its shared-memory limit set first):
// SMs, and the clusters of 1, 2, 4 and 8 CTAs that can be resident at once.
template <typename Kernel>
cudaError_t query_figures(Kernel kernel, int threads, int smem, int device,
                          TileFigures* f) {
  TileFigures r{};
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  r.clusters[0] = per_sm * r.sms;
  for (int k = 1; k < 4 && err == cudaSuccess; ++k) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1u << k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1u << k);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&r.clusters[k], kernel, &cfg);
  }
  if (err == cudaSuccess) *f = r;
  return err;
}

// query_figures once a device: the figures of a kernel this source
// launches, cached under `Tag` (one tag a kernel; the query also sets the
// kernel's shared-memory limit).
template <int Tag, typename Kernel>
cudaError_t figures_cached(Kernel kernel, int threads, int smem, int device,
                           TileFigures* f) {
  static std::mutex mu;
  static bool have[kMaxDevices];
  static TileFigures cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!have[device]) {
    const cudaError_t err =
        query_figures(kernel, threads, smem, device, &cache[device]);
    if (err != cudaSuccess) return err;
    have[device] = true;
  }
  *f = cache[device];
  return cudaSuccess;
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry
// point query (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static std::mutex mu;
  static EncodeTiled found = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  if (found == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = found;
  return cudaSuccess;
}

// The 2-D bf16 map of `rows` rows of `cols` elements at `base`, rows
// `stride` elements apart; boxes of 64 columns (128 bytes) by `box_rows`,
// 128-byte swizzle, rows past the end read as zeros.
cudaError_t encode_map(CUtensorMap* map, const void* base, long long cols,
                       long long rows, long long stride, int box_rows) {
  EncodeTiled fn;
  const cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch attributes of a step: its cluster (where more than one CTA)
// and, where `early`, programmatic dependent launch on the grid before it.
// Returns how many of `attr` it set.
int step_attrs(const TilePlan& p, int early, cudaLaunchAttribute (&attr)[2]) {
  int n = 0;
  if (p.cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = p.cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (early) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  return n;
}

}  // namespace
