// The wide LSTM route's persistent scans for NVIDIA Hopper (sm_90a): one
// launch a scan direction forward, one a backward sweep, bound to PyTorch
// via ctypes by fmda_tpu_torch/ops/wide_scan.py (the library is built by
// fmda_tpu_torch/ops/_cuda_lib.py, the layout decided by
// lstm_persist_plan.cc).
//
// Replaces: no Pallas kernel.  Past pallas_lstm.kernel_supported the JAX
// package's select_lstm_scan_fn runs lax.scan (fmda_tpu/ops/lstm.py::
// lstm_scan): each step one (B, H) x (H, 4 H) product and the gate
// algebra XLA fuses.  The port's first counterpart (scan_wide.cu's
// lstm_wide_fwd and lstm_wide_bwd) runs each step as a cuBLAS product and
// a gate launch: 2 T host calls a direction, W_hh (8.4 MB in bf16 at
// H = 1024) and the (B, 4 H) pre-activations through device memory every
// step.  These kernels run the whole scan in one launch:
//
//   lstm_persist_fwd  CTA (p, q) of the plan's P x Q grid keeps the 4 U
//                     gate rows of W_hh for its units U_q in shared memory
//                     and c (and h, for a mask's held rows) of its (batch
//                     tile p, U_q) in registers for the whole scan.  Each
//                     step it streams h_{t-1}[tile p, :] through a ring of
//                     K-chunks, forms the (R, 4 U) pre-activations on the
//                     tensor cores (bf16 mma.sync m16n8k16, float32
//                     accumulation; float32 by FFMA, never TF32), rounds
//                     them with b_hh to the I/O dtype as the route's addmm
//                     does, adds xp_t, runs the gate algebra in float32
//                     as PyTorch's element-wise kernels do (expf, tanhf,
//                     IEEE division, every product and sum rounded on its
//                     own: __fmul_rn/__fadd_rn, never contracted to FMA),
//                     writes h_t and c_t into hs[:, t] and cs[:, t], and
//                     crosses one grid barrier.
//   lstm_persist_bwd  the sweep: CTA (p, q) keeps the columns W_hh[:, U_q]
//                     (4 H x U) and, for its units, the float32 dc and the
//                     direct part of dh.  Each step it forms dh[tile p,
//                     U_q] = dgates_{t+1}[tile p, :] W_hh[:, U_q] + the
//                     direct part + dhs_t (the staged operand is the gate
//                     gradients every CTA wrote before the last barrier),
//                     recomputes the gates from the recomputed hh_t, and
//                     writes dgates_t (= dxp_t, rounded to the I/O dtype:
//                     what the next product sees) for its units; after the
//                     last step the same product gives dh0.  The products
//                     over all B T rows (hh before the sweep, dW_hh after)
//                     stay plain large products in ops/wide_scan.py.
//
// Semantics as the per-step kernels': a masked step (mask 0) keeps h and
// c and, backward, writes zero gate gradients and passes dh and dc
// through; reverse walks time backward; h0 and c0 are read, the carries
// rounded to the I/O dtype on store.
//
// What bounds them.  A step's product is 2 B 4 H H operations (4.3 GFLOP
// at (512, 1024): 4.4 us at 989 TFLOP/s), its bytes a few MB: operations,
// at the tensor cores' rate in bf16.  What the design does about it:
//   - W_hh never leaves shared memory (the grid holds ~30 MB: both dtypes
//     fit at H = 1024; past what fits the plan hands the scan back to the
//     per-step kernels);
//   - the step's shared operand is read from L2 once a cluster: the CTAs
//     of a cluster share a batch tile, and each chunk's rows are split
//     among them and multicast to all (cp.async.bulk .multicast::cluster,
//     completion on an mbarrier), a ring of `stages` chunks filled by a
//     copy warp while eight consumer warps multiply;
//   - one launch a direction: no host call a step, one grid barrier a step
//     (a cooperative launch, so every CTA is resident; a refused launch
//     raises, nothing falls back).
// Every wait (ring barriers, the grid barrier) traps after 4 s, so a fault
// in the protocol ends the kernel with an error instead of hanging it.

#include <cuda.h>

#include "flash_mma.cuh"
#include "lstm_persist_plan.h"

#include <mutex>

namespace {

namespace pcg = cooperative_groups;
using fmda_persist::Figures;
using fmda_persist::kConsumerWarps;
using fmda_persist::kThreads;
using fmda_persist::kUnitGroup;
using fmda_persist::Plan;

// ---- the primitives ---------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// how long any wait may take before the kernel traps
constexpr unsigned long long kWatchdogNs = 4000000000ull;

// The step profile, built only with -DFMDA_PROFILE_PERSIST
// (experiments/torch_lstm_persist.py --profile): %globaltimer stamps of
// CTA 0, row s a step: columns k < 64 the first consumer warp's wait for
// chunk k done, 64 + k the copy warp's issue of chunk k, 128 + k the
// first consumer warp's release of chunk k (its product done), 192 the
// step's start (a consumer), 193 its epilogue's end, 194 its barrier's
// end.  Off, it compiles to nothing.
#ifdef FMDA_PROFILE_PERSIST
constexpr int kProfSteps = 64, kProfCols = 200;
__device__ unsigned long long g_persist_prof[kProfSteps * kProfCols];
#define PERSIST_STAMP(cond, s, col)                                    \
  do {                                                                 \
    if ((cond) && blockIdx.x == 0 && (s) < kProfSteps && (col) < kProfCols) \
      g_persist_prof[(s) * kProfCols + (col)] = global_ns();           \
  } while (0)
#else
#define PERSIST_STAMP(cond, s, col) \
  do {                              \
  } while (0)
#endif

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
// every CTA of the cluster (the mask of its ranks).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint64_t* bar,
                                        int cluster) {
  const unsigned long long desc = reinterpret_cast<unsigned long long>(map);
  if (cluster > 1) {
    const unsigned short mask = (unsigned short)((1u << cluster) - 1u);
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

// Brings the line at p into L2 (a step's epilogue operands, asked for at
// the step's start so that they arrive while the product runs).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Brings a tensor map into the TMA unit's descriptor cache.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<unsigned long long>(map))
               : "memory");
}

// Orders this thread's generic-proxy accesses against the async proxy
// (the bulk copies of other CTAs read what the epilogues write).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// Every CTA of the grid reaches this barrier before any passes it: the
// `target`-th arrival count of the zeroed counter (a multiple of the
// grid).  The CTA's writes before it are visible to every CTA after it.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned long long t0 = global_ns();
    while (true) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(counter)
                   : "memory");
      if ((int)(v - target) >= 0) break;
      if (global_ns() - t0 > kWatchdogNs) asm volatile("trap;");
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_or_cta_sync(int cluster) {
  if (cluster > 1)
    pcg::this_cluster().sync();
  else
    __syncthreads();
}

// Two neighbouring values of T as floats, and stored from floats.
template <typename T>
__device__ __forceinline__ void load2(const T* p, float& a, float& b);
template <>
__device__ __forceinline__ void load2<float>(const float* p, float& a,
                                             float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
template <>
__device__ __forceinline__ void load2<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

// Two neighbouring values of T as loaded, unpacked later: an epilogue
// issues every load before it uses any.
template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using type = float2;
};
template <>
struct Pair2<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <typename T>
__device__ __forceinline__ typename Pair2<T>::type ld2(const T* p) {
  return *reinterpret_cast<const typename Pair2<T>::type*>(p);
}
__device__ __forceinline__ float lo(float2 v) { return v.x; }
__device__ __forceinline__ float hi_(float2 v) { return v.y; }
__device__ __forceinline__ float lo(__nv_bfloat162 v) {
  return __low2float(v);
}
__device__ __forceinline__ float hi_(__nv_bfloat162 v) {
  return __high2float(v);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- the arguments -------------------------------------------------------------

// The scan's operands.  xp is (B, T, 4 H) with row strides sxb, sxt and a
// contiguous last dimension; every other tensor is contiguous: h0, c0,
// dh_last, dc_last, dh0, dc0 (B, H); hs, cs, dhs (B, T, H); hh and dxp
// (B, T, 4 H); W_hh (4 H, H), b_hh (4 H); mask (B, T) uint8 or null.
// `counter` is the grid barrier's zeroed int.  The staged operand is read
// through 2-D tensor maps of (rows B, columns): forward `first` over h0 (H
// columns) and `rest` over hs (T H columns: step t's h at column t H);
// backward `rest` over dxp (T 4 H columns).  A box is `chunk` columns (128
// bytes, 128-byte swizzle) by R_pad / C rows.
template <typename T>
struct PersistArgs {
  CUtensorMap first, rest;
  const T *xp, *h0, *c0, *w, *b, *hh, *dhs;
  const uint8_t* mask;
  T *hs, *cs, *dxp;
  const float *dh_last, *dc_last;
  float *dh0, *dc0;
  unsigned* counter;
  long long sxb, sxt;
  int B, n_steps, H, reverse;
  Plan p;
};

// A chunk's TMA boxes, and its bytes in the ring: the boxes of R_pad rows
// of 128 bytes, one after another.
template <typename T>
__device__ __forceinline__ int boxes_of(const Plan& p) {
  return p.chunk * (int)sizeof(T) / fmda_persist::kBoxBytes;
}
template <typename T>
__device__ __forceinline__ size_t slot_bytes(const Plan& p) {
  return (size_t)boxes_of<T>(p) * p.rows_pad * fmda_persist::kBoxBytes;
}

// Where a CTA sits, and its shared memory (aligned to the swizzle's
// 1024-byte atom: W_hh's slice, the ring's stages of R_pad x 128 bytes,
// the ring's barriers).
template <typename T>
struct Cta {
  int tile, slice, rank, row0, rows_valid;
  T* w_s;
  unsigned char* ring;
  uint64_t *full, *empty;
  float* scratch;  // the K-split's partial sums

  __device__ Cta(const Plan& p, int batch, unsigned char* smem) {
    tile = blockIdx.x / p.slices;
    slice = blockIdx.x % p.slices;
    rank = slice % p.cluster;  // the cluster runs along the slices
    row0 = tile * p.rows;
    rows_valid = min(p.rows, batch - row0);
    unsigned char* base =
        smem + ((fmda_persist::kAlignBytes -
                 (smem_u32(smem) & (fmda_persist::kAlignBytes - 1))) &
                (fmda_persist::kAlignBytes - 1));
    w_s = reinterpret_cast<T*>(base);
    ring = base + p.ring_off;
    full = reinterpret_cast<uint64_t*>(ring + (size_t)p.stages *
                                                 slot_bytes<T>(p));
    empty = full + p.stages;
    scratch = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(full) +
                                       fmda_persist::kBarrierBytes);
  }

  // The ring's barriers, then every CTA of the cluster waits for all:
  // full[s] completes when this CTA's copy warp has announced a chunk's
  // bytes and they have landed; empty[s] when every consumer warp of
  // every CTA of the cluster has read slot s.
  __device__ void init_barriers(const Plan& p) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, p.cluster * kConsumerWarps);
      }
      fence_mbar_init();
    }
    cluster_or_cta_sync(p.cluster);
  }
};

// ---- the copy warp and the consumers' chunk loop ---------------------------------

// The copy warp's share of one step: the tile's R_pad rows of `map` from
// column col0 on, K columns, into the ring a chunk a slot.  For each box
// of a chunk this CTA loads rows [rank R_pad / C, (rank + 1) R_pad / C) of
// the tile and multicasts them to the cluster; every CTA's full barrier
// expects the whole chunk (rows past B arrive as zeros).
template <typename T>
__device__ void produce_step(const CUtensorMap* map, int col0, int K,
                             const Cta<T>& c, const Plan& p, unsigned& n,
                             int lane, int step) {
  constexpr int kBoxCols = fmda_persist::kBoxBytes / (int)sizeof(T);
  const int share = p.rows_pad / p.cluster, boxes = boxes_of<T>(p);
  const size_t box_bytes = (size_t)p.rows_pad * fmda_persist::kBoxBytes;
  if (lane == 0) fence_proxy_async();
  for (int k = 0; k < K / p.chunk; ++k, ++n) {
    const int slot = n % p.stages;
    if (lane == 0) {
      mbar_wait(c.empty + slot, ((n / p.stages) & 1u) ^ 1u);
      PERSIST_STAMP(true, step, 64 + k);
      mbar_expect_tx(c.full + slot, (unsigned)(boxes * box_bytes));
      unsigned char* dst = c.ring + slot * slot_bytes<T>(p) +
                           (size_t)c.rank * share * fmda_persist::kBoxBytes;
      for (int b = 0; b < boxes; ++b)
        tma_box(dst + b * box_bytes, map, col0 + k * p.chunk + b * kBoxCols,
                c.row0 + c.rank * share, c.full + slot, p.cluster);
    }
  }
  __syncwarp();
}

// A consumer warp is done with slot `slot`: lane r < C arrives on CTA r's
// empty barrier.
__device__ __forceinline__ void release_slot(uint64_t* empty, int cluster,
                                             int lane) {
  __syncwarp();
  if (lane < cluster) mbar_arrive(empty, lane, cluster);
}

// Byte offset of the 16-byte column group `j` of row `r` in a ring slot:
// 128-byte rows, group j stored at j ^ (r mod 8) (the TMA's 128-byte
// swizzle), so the eight rows of a fragment read distinct banks.
__device__ __forceinline__ int swz(int r, int j) {
  return r * fmda_persist::kBoxBytes + ((j ^ (r & 7)) << 4);
}

// One k16 step of a bf16 product: acc[i][n] += A's m-tiles mt0 + i (i <
// mts; the box at A, swizzled rows of 128 bytes, columns kk..kk+15) times
// W's rows nrow[n] + 0..7 at columns kk..kk+15 of Wb: the m16n8k16
// fragment layout (flash_mma.cuh), bf16 on the tensor cores.
template <int MT, int NT>
__device__ __forceinline__ void k16_step(float (&acc)[MT][NT][4],
                                         const unsigned char* A,
                                         const __nv_bfloat16* Wb, int w_ld,
                                         const int (&nrow)[NT], int kk,
                                         int mt0, int mts, int lane) {
  unsigned af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < mts)
      ldsm_x4(af[i],
              A + swz(16 * (mt0 + i) + (lane & 15), (kk >> 3) + (lane >> 4)));
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    unsigned b0, b1;
    ldsm_x2(b0, b1, Wb + (size_t)(nrow[n] + (lane & 7)) * w_ld + kk +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < mts) mma_bf16(acc[i][n], af[i], b0, b1);
  }
}

// One k4 step of a float32 product, by FFMA into the same fragment
// layout: lane (g, t4) owns rows g and g + 8 of each m-tile and columns
// 2 t4, 2 t4 + 1 of each n-tile, four columns a shared load.
template <int MT, int NT>
__device__ __forceinline__ void k4_step(float (&acc)[MT][NT][4],
                                        const unsigned char* A,
                                        const float* Wb, int w_ld,
                                        const int (&nrow)[NT], int kk,
                                        int mt0, int mts, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float4 av[MT][2], bv[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      av[i][hi] = i < mts ? *reinterpret_cast<const float4*>(
                                A + swz(16 * (mt0 + i) + g + 8 * hi, kk >> 2))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[n][e] = *reinterpret_cast<const float4*>(
          Wb + (size_t)(nrow[n] + 2 * t4 + e) * w_ld + kk);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& c = acc[i][n][2 * hi + e];
          const float4 x = av[i][hi], w = bv[n][e];
          c = fmaf(x.x, w.x, c);
          c = fmaf(x.y, w.y, c);
          c = fmaf(x.z, w.z, c);
          c = fmaf(x.w, w.w, c);
        }
}

// acc[i][n] += the staged rows of m-tiles mt0 + i, i < mts (a slot at A:
// `boxes` boxes of `rows_pad` rows, 128 bytes a row) times the shared W
// rows nrow[n] + 0..7 at the chunk's columns from k0.  A warp alone on
// its tile (ks = 1) takes every k-step, unrolled a box at a time; else
// its K-split group kq takes every ks-th.
template <int MT, int NT, typename T>
__device__ __forceinline__ void chunk_product(
    float (&acc)[MT][NT][4], const unsigned char* A, int boxes, int rows_pad,
    const T* W, int w_ld, const int (&nrow)[NT], int k0, int mt0, int mts,
    int ks, int kq, int lane) {
  constexpr int kCols = fmda_persist::kBoxBytes / (int)sizeof(T);
  constexpr int kStep = sizeof(T) == 2 ? 16 : 4;
  constexpr int kSteps = kCols / kStep;  // k-steps a box
  const size_t box = (size_t)rows_pad * fmda_persist::kBoxBytes;
  if (ks == 1) {
    for (int b = 0; b < boxes; ++b) {
#pragma unroll
      for (int kk = 0; kk < kCols; kk += kStep) {
        if constexpr (sizeof(T) == 2)
          k16_step<MT, NT>(acc, A + b * box, W + k0 + b * kCols, w_ld, nrow,
                           kk, mt0, mts, lane);
        else
          k4_step<MT, NT>(acc, A + b * box, W + k0 + b * kCols, w_ld, nrow,
                          kk, mt0, mts, lane);
      }
    }
  } else {
    for (int q = kq; q < boxes * kSteps; q += ks) {
      const int b = q / kSteps, kk = (q - b * kSteps) * kStep;
      if constexpr (sizeof(T) == 2)
        k16_step<MT, NT>(acc, A + b * box, W + k0 + b * kCols, w_ld, nrow, kk,
                         mt0, mts, lane);
      else
        k4_step<MT, NT>(acc, A + b * box, W + k0 + b * kCols, w_ld, nrow, kk,
                        mt0, mts, lane);
    }
  }
}

// One step's product for a consumer warp: every K-chunk of the ring in
// turn (the counter n is the CTA's chunk count so far, as the copy warp's),
// its K-split group's k-steps of each where it `computes`.
template <typename T, int MT, int NT>
__device__ __forceinline__ void consume_step(float (&acc)[MT][NT][4],
                                             const Cta<T>& c, const Plan& p,
                                             int K, int w_ld,
                                             const int (&nrow)[NT], int mt0,
                                             bool computes, int ks, int kq,
                                             unsigned& n, int lane,
                                             int step) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int m = 0; m < NT; ++m)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][m][v] = 0.0f;
  const int mts = min(MT, p.rows_pad / 16 - mt0);
  for (int k = 0; k < K / p.chunk; ++k, ++n) {
    const int slot = n % p.stages;
    mbar_wait(c.full + slot, (n / p.stages) & 1u);
    PERSIST_STAMP(threadIdx.x == 0, step, k);
    if (computes)
      chunk_product<MT, NT, T>(acc, c.ring + slot * slot_bytes<T>(p),
                            boxes_of<T>(p), p.rows_pad, c.w_s, w_ld, nrow,
                            k * p.chunk, mt0, mts, ks, kq, lane);
    PERSIST_STAMP(threadIdx.x == 0, step, 128 + k);
    release_slot(c.empty + slot, p.cluster, lane);
  }
}

// The consumer warps' own barrier (named barrier 1: the copy warp never
// waits on it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// A consumer warp's place: wu warps a K-split group (wi its index in
// one), ks groups (kq its own; bf16 only: the float32 FFMA steps gained
// nothing from the split on the card).
struct Split {
  int wu, ks, wi, kq;
  __device__ Split(int warps_used, int warp, bool split)
      : wu(warps_used),
        ks(split ? fmda_persist::ksplit(warps_used) : 1),
        wi(warp % warps_used),
        kq(warp / warps_used) {}
  __device__ bool computes() const { return kq < ks; }
  __device__ bool leads() const { return kq == 0; }
};

// The K-split groups' partial sums into group 0's acc through the shared
// scratch (every consumer warp calls it, where ks > 1).
template <int MT, int NT>
__device__ __forceinline__ void reduce_split(float (&acc)[MT][NT][4],
                                             float* scratch, const Split& sp,
                                             int lane) {
  constexpr int F = MT * NT * 4;
  if (sp.kq > 0 && sp.kq < sp.ks) {
    float* d =
        scratch + (size_t)((sp.kq - 1) * sp.wu + sp.wi) * F * 32 + lane;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int m = 0; m < NT; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v) d[((i * NT + m) * 4 + v) * 32] = acc[i][m][v];
  }
  consumer_sync();
  if (sp.kq == 0) {
    for (int q = 1; q < sp.ks; ++q) {
      const float* src =
          scratch + (size_t)((q - 1) * sp.wu + sp.wi) * F * 32 + lane;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int m = 0; m < NT; ++m)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[i][m][v] += src[((i * NT + m) * 4 + v) * 32];
    }
  }
}

// ---- the forward ------------------------------------------------------------------

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_persist_fwd_kernel(const __grid_constant__ PersistArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  constexpr int kPad = 16 / (int)sizeof(T);
  const int H = a.H, U = p.units, n_steps = a.n_steps;
  const int w_ld = H + kPad;
  Cta<T> c(p, a.B, smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // W_hh's rows of this slice, gate-major: row g U + u is W_hh[g H + U_q0
  // + u], in 16-byte copies
  {
    constexpr int V = 16 / (int)sizeof(T);
    const int per_row = H / V;
    for (int e = tid; e < 4 * U * per_row; e += kThreads) {
      const int n = e / per_row, k = (e - n * per_row) * V;
      const int g = n / U, u = n - g * U;
      *reinterpret_cast<uint4*>(c.w_s + (size_t)n * w_ld + k) =
          *reinterpret_cast<const uint4*>(
              a.w + ((size_t)g * H + (size_t)c.slice * U + u) * H + k);
    }
  }
  c.init_barriers(p);

  const int dt = a.reverse ? -1 : 1;
  const int t0 = a.reverse ? n_steps - 1 : 0;
  unsigned n = 0, target = 0;
  if (warp == kConsumerWarps) {
    if (lane == 0) {
      prefetch_map(&a.first);
      prefetch_map(&a.rest);
    }
    for (int s = 0, t = t0; s < n_steps; ++s, t += dt) {
      if (s == 0)
        produce_step<T>(&a.first, 0, H, c, p, n, lane, s);
      else
        produce_step<T>(&a.rest, (t - dt) * H, H, c, p, n, lane, s);
      if (s + 1 < n_steps) grid_barrier(a.counter, target += gridDim.x);
    }
  } else {
    const int blocks = U / kUnitGroup;
    // the product's warps (a column block and MT m-tiles each) and, where
    // fewer than the CTA's, the K-split groups; group 0 runs the epilogue
    const Split sp((p.rows_pad / 16 + MT - 1) / MT * blocks, warp,
                   sizeof(T) == 2);
    const int nb = sp.wi % blocks, mt0 = (sp.wi / blocks) * MT;
    const bool active = sp.leads();
    const int g = lane >> 2, t4 = lane & 3;
    // this lane's units j0, j0 + 1; its n-tiles: one a gate
    const int j0 = c.slice * U + nb * kUnitGroup + 2 * t4;
    int nrow[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) nrow[gate] = gate * U + nb * kUnitGroup;
    // c of rows 16 (mt0 + i) + g + 8 hi, units j0 + e, as stored (rounded);
    // h is read back from hs (or h0) only where a mask holds a row
    float cc[MT][2][2] = {};
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = 16 * (mt0 + i) + g + 8 * hi;
        if (active && r < c.rows_valid)
          load2(a.c0 + (size_t)(c.row0 + r) * H + j0, cc[i][hi][0],
                cc[i][hi][1]);
      }
    // the step's xp_t into L2 at its start, ahead of its epilogue
    auto prefetch_xp = [&](int tn) {
      if (!active || t4 != 0) return;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = 16 * (mt0 + i) + g + 8 * hi;
          if (r >= c.rows_valid) continue;
          const T* x =
              a.xp + (c.row0 + r) * a.sxb + (long long)tn * a.sxt + j0;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) prefetch_l2(x + gate * H);
        }
    };
    for (int s = 0, t = t0; s < n_steps; ++s, t += dt) {
      float acc[MT][4][4];
      PERSIST_STAMP(threadIdx.x == 0, s, 192);
      prefetch_xp(t);
      consume_step<T, MT, 4>(acc, c, p, H, w_ld, nrow, mt0, sp.computes(),
                             sp.ks, sp.kq, n, lane, s);
      if (sp.ks > 1) reduce_split<MT, 4>(acc, c.scratch, sp, lane);
      if (active) {
        // b_hh, then half the m-tiles at a time: every row's xp_t and mask
        // and a held row's h_{t-1} first, then the algebra, so that the
        // loads' latencies overlap (half: the registers of all would spill)
        constexpr int kHalf = MT > 1 ? MT / 2 : 1;
        typename Pair2<T>::type br[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) br[gate] = ld2(a.b + gate * H + j0);
#pragma unroll
        for (int i0 = 0; i0 < MT; i0 += kHalf) {
          typename Pair2<T>::type xr[kHalf][2][4], hr[kHalf][2];
          bool keep[kHalf][2];
#pragma unroll
          for (int ih = 0; ih < kHalf; ++ih)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int r = 16 * (mt0 + i0 + ih) + g + 8 * hi;
              keep[ih][hi] = true;
              if (r >= c.rows_valid) continue;
              const int b = c.row0 + r;
              const T* x = a.xp + b * a.sxb + (long long)t * a.sxt + j0;
#pragma unroll
              for (int gate = 0; gate < 4; ++gate)
                xr[ih][hi][gate] = ld2(x + gate * H);
              if (a.mask != nullptr) {
                keep[ih][hi] = a.mask[(size_t)b * n_steps + t] != 0;
                if (!keep[ih][hi])
                  hr[ih][hi] = ld2(s == 0 ? a.h0 + (size_t)b * H + j0
                                          : a.hs + ((size_t)b * n_steps +
                                                    (t - dt)) * H + j0);
              }
            }
#pragma unroll
          for (int ih = 0; ih < kHalf; ++ih)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int i = i0 + ih;
              const int r = 16 * (mt0 + i) + g + 8 * hi;
              if (r >= c.rows_valid) continue;
              const int b = c.row0 + r;
              float hn[2], cn[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float sg[4];
#pragma unroll
                for (int gate = 0; gate < 4; ++gate)
                  sg[gate] = __fadd_rn(
                      e ? hi_(xr[ih][hi][gate]) : lo(xr[ih][hi][gate]),
                      round_to<T>(__fadd_rn(acc[i][gate][2 * hi + e],
                                            e ? hi_(br[gate])
                                              : lo(br[gate]))));
                const float ig = sigmoid_f32(sg[0]);
                const float fg = sigmoid_f32(sg[1]);
                const float gg = tanhf(sg[2]);
                const float og = sigmoid_f32(sg[3]);
                const float c_new =
                    __fadd_rn(__fmul_rn(fg, cc[i][hi][e]), __fmul_rn(ig, gg));
                hn[e] = keep[ih][hi]
                            ? __fmul_rn(og, tanhf(c_new))
                            : (e ? hi_(hr[ih][hi]) : lo(hr[ih][hi]));
                cn[e] = keep[ih][hi] ? c_new : cc[i][hi][e];
              }
              const size_t o = ((size_t)b * n_steps + t) * H + j0;
              store2<T>(a.hs + o, hn[0], hn[1]);
              store2<T>(a.cs + o, cn[0], cn[1]);
#pragma unroll
              for (int e = 0; e < 2; ++e) cc[i][hi][e] = round_to<T>(cn[e]);
            }
        }
        fence_proxy_async();
      }
      PERSIST_STAMP(threadIdx.x == 0, s, 193);
      if (s + 1 < n_steps) grid_barrier(a.counter, target += gridDim.x);
      PERSIST_STAMP(threadIdx.x == 0, s, 194);
    }
  }
  // no CTA leaves while a peer may still copy into it or arrive on it
  cluster_or_cta_sync(p.cluster);
}

// ---- the backward sweep ---------------------------------------------------------

// A backward consumer warp owns m-tiles [mt0, mt0 + MT) of the tile and
// all NT = U / 8 n-tiles of the slice: each staged row is read by one warp.
template <typename T, int MT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_persist_bwd_kernel(const __grid_constant__ PersistArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  constexpr int kPad = 16 / (int)sizeof(T);
  const int H = a.H, K = 4 * a.H, U = p.units, n_steps = a.n_steps;
  const int w_ld = K + kPad;
  Cta<T> c(p, a.B, smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the columns W_hh[:, U_q0 + u] as rows u of 4 H
  for (int e = tid; e < K * U; e += kThreads) {
    const int k = e / U, u = e - k * U;
    c.w_s[(size_t)u * w_ld + k] = a.w[(size_t)k * H + c.slice * U + u];
  }
  c.init_barriers(p);

  // the forward's direction and first step; the sweep walks backward from
  // the forward's last step: processed step s is time tb0 - s fdt
  const int fdt = a.reverse ? -1 : 1;
  const int t_first = a.reverse ? n_steps - 1 : 0;
  const int tb0 = a.reverse ? 0 : n_steps - 1;
  unsigned n = 0, target = 0;
  if (warp == kConsumerWarps) {
    if (lane == 0) prefetch_map(&a.rest);
    for (int s = 0; s <= n_steps; ++s) {
      if (s > 0)
        produce_step<T>(&a.rest, (tb0 - (s - 1) * fdt) * K, K, c, p, n,
                        lane, s);
      if (s < n_steps) grid_barrier(a.counter, target += gridDim.x);
    }
  } else {
    const Split sp((p.rows_pad / 16 + MT - 1) / MT, warp, sizeof(T) == 2);
    const int mt0 = sp.wi * MT;
    const bool active = sp.leads();
    const int g = lane >> 2, t4 = lane & 3;
    // this lane's units in n-tile m: jm + e, jm = U_q0 + 8 m + 2 t4
    const int j0 = c.slice * U + 2 * t4;
    int nrow[NT];
#pragma unroll
    for (int m = 0; m < NT; ++m) nrow[m] = m * kUnitGroup;
    // the float32 carries: the direct part of dh (dh_last at the first
    // processed step, then dh where a mask held the row, else 0) and dc
    float dir[MT][NT][2][2] = {}, dcc[MT][NT][2][2] = {};
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int m = 0; m < NT; ++m)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = 16 * (mt0 + i) + g + 8 * hi;
          if (active && r < c.rows_valid) {
            const size_t o = (size_t)(c.row0 + r) * H + j0 + m * kUnitGroup;
            load2(a.dh_last + o, dir[i][m][hi][0], dir[i][m][hi][1]);
            load2(a.dc_last + o, dcc[i][m][hi][0], dcc[i][m][hi][1]);
          }
        }
    for (int s = 0; s <= n_steps; ++s) {
      float acc[MT][NT][4] = {};
      PERSIST_STAMP(threadIdx.x == 0, s, 192);
      if (s > 0) {
        consume_step<T, MT, NT>(acc, c, p, K, w_ld, nrow, mt0, sp.computes(),
                                sp.ks, sp.kq, n, lane, s);
        if (sp.ks > 1) reduce_split<MT, NT>(acc, c.scratch, sp, lane);
      }
      if (active && s < n_steps) {
        const int t = tb0 - s * fdt;
        const bool first = t == t_first;
        // a row's operands at a time (xp_t and hh_t's four gates, c_{t-1},
        // c_t, dhs_t for every n-tile), all issued before any is used
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = 16 * (mt0 + i) + g + 8 * hi;
            if (r >= c.rows_valid) continue;
            const int b = c.row0 + r;
            const size_t row = (size_t)b * n_steps + t;
            const bool keep =
                a.mask == nullptr || a.mask[(size_t)b * n_steps + t] != 0;
            typename Pair2<T>::type xr[NT][4], hr[NT][4], cpr[NT], ctr[NT],
                dsr[NT];
#pragma unroll
            for (int m = 0; m < NT; ++m) {
              const int j = j0 + m * kUnitGroup;
              const T* x = a.xp + b * a.sxb + (long long)t * a.sxt + j;
#pragma unroll
              for (int gate = 0; gate < 4; ++gate) {
                xr[m][gate] = ld2(x + gate * H);
                hr[m][gate] = ld2(a.hh + row * K + gate * H + j);
              }
              cpr[m] = ld2(first ? a.c0 + (size_t)b * H + j
                                 : a.cs + (size_t)((long long)row - fdt) * H +
                                       j);
              ctr[m] = ld2(a.cs + row * H + j);
              dsr[m] = ld2(a.dhs + row * H + j);
            }
#pragma unroll
            for (int m = 0; m < NT; ++m) {
              const int j = j0 + m * kUnitGroup;
              float sg[4][2];
#pragma unroll
              for (int gate = 0; gate < 4; ++gate) {
                sg[gate][0] = __fadd_rn(lo(xr[m][gate]), lo(hr[m][gate]));
                sg[gate][1] = __fadd_rn(hi_(xr[m][gate]), hi_(hr[m][gate]));
              }
              const float cp[2] = {lo(cpr[m]), hi_(cpr[m])};
              const float ct[2] = {lo(ctr[m]), hi_(ctr[m])};
              const float dhs[2] = {lo(dsr[m]), hi_(dsr[m])};
              float dg[4][2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float dh = __fadd_rn(__fadd_rn(dhs[e], dir[i][m][hi][e]),
                                           acc[i][m][2 * hi + e]);
                const float ig = sigmoid_f32(sg[0][e]);
                const float fg = sigmoid_f32(sg[1][e]);
                const float gg = tanhf(sg[2][e]);
                const float og = sigmoid_f32(sg[3][e]);
                const float tc = tanhf(ct[e]);
                const float dct = __fadd_rn(
                    dcc[i][m][hi][e],
                    __fmul_rn(__fmul_rn(dh, og),
                              __fsub_rn(1.0f, __fmul_rn(tc, tc))));
                dg[0][e] = keep ? __fmul_rn(__fmul_rn(__fmul_rn(dct, gg), ig),
                                            __fsub_rn(1.0f, ig))
                                : 0.0f;
                dg[1][e] = keep ? __fmul_rn(__fmul_rn(__fmul_rn(dct, cp[e]), fg),
                                            __fsub_rn(1.0f, fg))
                                : 0.0f;
                dg[2][e] = keep ? __fmul_rn(__fmul_rn(dct, ig),
                                            __fsub_rn(1.0f, __fmul_rn(gg, gg)))
                                : 0.0f;
                dg[3][e] = keep ? __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), og),
                                            __fsub_rn(1.0f, og))
                                : 0.0f;
                dir[i][m][hi][e] = keep ? 0.0f : dh;
                dcc[i][m][hi][e] = keep ? __fmul_rn(dct, fg) : dcc[i][m][hi][e];
              }
#pragma unroll
              for (int gate = 0; gate < 4; ++gate)
                store2<T>(a.dxp + row * K + gate * H + j, dg[gate][0],
                          dg[gate][1]);
            }
          }
        fence_proxy_async();
      } else if (active && s == n_steps) {
        // dh0: the direct part and the product of the last gate gradients
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = 16 * (mt0 + i) + g + 8 * hi;
            if (r >= c.rows_valid) continue;
#pragma unroll
            for (int m = 0; m < NT; ++m) {
              const size_t o =
                  (size_t)(c.row0 + r) * H + j0 + m * kUnitGroup;
              store2<float>(a.dh0 + o,
                            dir[i][m][hi][0] + acc[i][m][2 * hi],
                            dir[i][m][hi][1] + acc[i][m][2 * hi + 1]);
              store2<float>(a.dc0 + o, dcc[i][m][hi][0], dcc[i][m][hi][1]);
            }
          }
      }
      PERSIST_STAMP(threadIdx.x == 0, s, 193);
      if (s < n_steps) grid_barrier(a.counter, target += gridDim.x);
      PERSIST_STAMP(threadIdx.x == 0, s, 194);
    }
  }
  cluster_or_cta_sync(p.cluster);
}

// ---- the plan and the launches -------------------------------------------------

template <typename T>
using PersistKernel = void (*)(const PersistArgs<T>);

// The instance of a plan's warp tiles: the forward's (mt, 4 gates), the
// backward's (mt_bwd, U / 8 n-tiles), at most kMaxBwdTiles of them.
template <typename T>
PersistKernel<T> kernel_of(bool backward, int mt, int nt) {
  if (!backward) {
    if (mt == 1) return lstm_persist_fwd_kernel<T, 1>;
    if (mt == 2) return lstm_persist_fwd_kernel<T, 2>;
    return lstm_persist_fwd_kernel<T, 4>;
  }
  switch (mt * 8 + nt) {
    case 1 * 8 + 1: return lstm_persist_bwd_kernel<T, 1, 1>;
    case 2 * 8 + 1: return lstm_persist_bwd_kernel<T, 2, 1>;
    case 4 * 8 + 1: return lstm_persist_bwd_kernel<T, 4, 1>;
    case 1 * 8 + 2: return lstm_persist_bwd_kernel<T, 1, 2>;
    case 2 * 8 + 2: return lstm_persist_bwd_kernel<T, 2, 2>;
    case 1 * 8 + 4: return lstm_persist_bwd_kernel<T, 1, 4>;
    default: return nullptr;
  }
}

constexpr int kMaxDevices = 64;

// The card's figures for the kernels in T, queried once a device: one CTA
// an SM at the opt-in shared memory, and the clusters of 1, 2, 4 and 8
// such CTAs that can be resident at once.
template <typename T>
cudaError_t figures_of(int device, Figures* f) {
  static std::mutex mu;
  static bool have[kMaxDevices];
  static Figures cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (have[device]) {
    *f = cache[device];
    return cudaSuccess;
  }
  Figures r{};
  cudaError_t err =
      cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &r.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const PersistKernel<T> kernel = kernel_of<T>(false, fmda_persist::kMaxMt, 0);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, r.smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, r.smem);
  r.clusters[0] = per_sm * r.sms;
  for (int k = 1; k < 4 && err == cudaSuccess; ++k) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1u << k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1u << k);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = r.smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&r.clusters[k], kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  cache[device] = r;
  have[device] = true;
  *f = r;
  return cudaSuccess;
}

// The plan of (B, H) in T on card `device`: cudaSuccess and *p with
// *persistent set, or the figures' query's error.
template <typename T>
cudaError_t plan_of(int B, int H, int device, Plan* p, Figures* f,
                    bool* persistent) {
  cudaError_t err = figures_of<T>(device, f);
  if (err != cudaSuccess) return err;
  *persistent = fmda_persist::plan(B, H, (int)sizeof(T), *f, p) == 0;
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

// The 2-D map of `rows` rows of `cols` elements of T at `base` (row stride
// `cols`), boxes of 128 bytes by `box_rows`, 128-byte swizzle, rows past
// the end read as zeros.
template <typename T>
cudaError_t encode_map(CUtensorMap* map, const void* base, long long cols,
                       int rows, int box_rows) {
  EncodeTiled fn;
  const cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {
      (cuuint32_t)(fmda_persist::kBoxBytes / sizeof(T)), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One cooperative launch of the plan `plan` (kLaunchFields ints in Plan's
// order, decided before the call: fmda_lstm_persist_plan's, or another
// layout that fits) over its grid, clusters of p.cluster along the
// slices: every CTA resident, or the launch is refused.
template <typename T>
int launch(bool backward, PersistArgs<T> a, const int* plan, int device,
           void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.n_steps <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Figures f;
  err = figures_of<T>(device, &f);
  if (err != cudaSuccess) return (int)err;
  int* fields = reinterpret_cast<int*>(&a.p);
  for (int i = 0; i < fmda_persist::kLaunchFields; ++i) fields[i] = plan[i];
  if (!fmda_persist::fits(a.B, a.H, (int)sizeof(T), f, a.p))
    return fmda_persist::kPlanRefused;
  const int box_rows = a.p.rows_pad / a.p.cluster;
  const long long steps_cols = (long long)a.n_steps * a.H * (backward ? 4 : 1);
  err = encode_map<T>(&a.rest, backward ? (const void*)a.dxp
                                        : (const void*)a.hs,
                      steps_cols, a.B, box_rows);
  if (err == cudaSuccess)
    err = backward ? (a.first = a.rest, cudaSuccess)
                   : encode_map<T>(&a.first, a.h0, a.H, a.B, box_rows);
  if (err != cudaSuccess) return (int)err;
  const PersistKernel<T> kernel =
      kernel_of<T>(backward, backward ? a.p.mt_bwd : a.p.mt,
                   a.p.units / kUnitGroup);
  if (kernel == nullptr) return fmda_persist::kPlanRefused;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  int n_attr = 0;
  attr[n_attr].id = cudaLaunchAttributeCooperative;
  attr[n_attr].val.cooperative = 1;
  ++n_attr;
  if (a.p.cluster > 1) {
    attr[n_attr].id = cudaLaunchAttributeClusterDimension;
    attr[n_attr].val.clusterDim.x = a.p.cluster;
    attr[n_attr].val.clusterDim.y = 1;
    attr[n_attr].val.clusterDim.z = 1;
    ++n_attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int persist_fwd(const void* xp, long long sxb, long long sxt, const void* h0,
                const void* c0, const void* w, const void* b, const void* mask,
                void* hs, void* cs, void* counter, const int* plan, int B,
                int n_steps, int H, int reverse, int device, void* stream) {
  PersistArgs<T> a{};
  a.xp = static_cast<const T*>(xp);
  a.sxb = sxb;
  a.sxt = sxt;
  a.h0 = static_cast<const T*>(h0);
  a.c0 = static_cast<const T*>(c0);
  a.w = static_cast<const T*>(w);
  a.b = static_cast<const T*>(b);
  a.mask = static_cast<const uint8_t*>(mask);
  a.hs = static_cast<T*>(hs);
  a.cs = static_cast<T*>(cs);
  a.counter = static_cast<unsigned*>(counter);
  a.B = B;
  a.n_steps = n_steps;
  a.H = H;
  a.reverse = reverse;
  return launch<T>(false, a, plan, device, stream);
}

template <typename T>
int persist_bwd(const void* xp, long long sxb, long long sxt, const void* hh,
                const void* c0, const void* cs, const void* w,
                const void* dhs, const void* mask, const void* dh_last,
                const void* dc_last, void* dxp, void* dh0, void* dc0,
                void* counter, const int* plan, int B, int n_steps, int H,
                int reverse, int device, void* stream) {
  PersistArgs<T> a{};
  a.xp = static_cast<const T*>(xp);
  a.sxb = sxb;
  a.sxt = sxt;
  a.hh = static_cast<const T*>(hh);
  a.c0 = static_cast<const T*>(c0);
  a.cs = const_cast<T*>(static_cast<const T*>(cs));
  a.w = static_cast<const T*>(w);
  a.dhs = static_cast<const T*>(dhs);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dh_last = static_cast<const float*>(dh_last);
  a.dc_last = static_cast<const float*>(dc_last);
  a.dxp = static_cast<T*>(dxp);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.counter = static_cast<unsigned*>(counter);
  a.B = B;
  a.n_steps = n_steps;
  a.H = H;
  a.reverse = reverse;
  return launch<T>(true, a, plan, device, stream);
}

}  // namespace

extern "C" int fmda_lstm_persist_plan(int B, int H, int itemsize, int device,
                                      int* out) {
  if (B <= 0 || H <= 0 || (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  Plan p{};
  Figures f{};
  bool persistent = false;
  const cudaError_t err =
      itemsize == 4
          ? plan_of<float>(B, H, device, &p, &f, &persistent)
          : plan_of<__nv_bfloat16>(B, H, device, &p, &f, &persistent);
  if (err != cudaSuccess) return (int)err;
  if (!persistent) p = Plan{};
  const int v[fmda_persist::kPlanFields + fmda_persist::kFigureFields] = {
      persistent ? 1 : 0, p.tiles, p.slices, p.units, p.cluster, p.chunk,
      p.stages, p.mt, p.mt_bwd, p.rows, p.rows_pad, p.smem, p.grid,
      p.ring_off,
      f.sms, f.smem, f.clusters[0], f.clusters[1], f.clusters[2],
      f.clusters[3]};
  for (int i = 0; i < fmda_persist::kPlanFields + fmda_persist::kFigureFields;
       ++i)
    out[i] = v[i];
  return 0;
}

// Plain C interface for ctypes.  Pointers as PersistArgs lists them (xp
// with its batch and time strides in elements); `mask` may be null;
// `plan` is kLaunchFields ints (fmda_lstm_persist_plan's plan and its
// ring offset).  Returns kPlanRefused (1) where that plan does not fit the
// card (fmda_persist::fits), else cudaGetLastError() after the launch (0 =
// success).
extern "C" int fmda_lstm_persist_fwd_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w, const void* b, const void* mask, void* hs,
    void* cs, void* counter, const int* plan, int B, int n_steps, int H,
    int reverse, int device, void* stream) {
  return persist_fwd<float>(xp, sxb, sxt, h0, c0, w, b, mask, hs, cs,
                            counter, plan, B, n_steps, H, reverse, device,
                            stream);
}

extern "C" int fmda_lstm_persist_fwd_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w, const void* b, const void* mask, void* hs,
    void* cs, void* counter, const int* plan, int B, int n_steps, int H,
    int reverse, int device, void* stream) {
  return persist_fwd<__nv_bfloat16>(xp, sxb, sxt, h0, c0, w, b, mask, hs, cs,
                                    counter, plan, B, n_steps, H, reverse,
                                    device, stream);
}

extern "C" int fmda_lstm_persist_bwd_f32(
    const void* xp, long long sxb, long long sxt, const void* hh,
    const void* c0, const void* cs, const void* w, const void* dhs,
    const void* mask, const void* dh_last, const void* dc_last, void* dxp,
    void* dh0, void* dc0, void* counter, const int* plan, int B, int n_steps,
    int H, int reverse, int device, void* stream) {
  return persist_bwd<float>(xp, sxb, sxt, hh, c0, cs, w, dhs, mask, dh_last,
                            dc_last, dxp, dh0, dc0, counter, plan, B, n_steps,
                            H, reverse, device, stream);
}

extern "C" int fmda_lstm_persist_bwd_bf16(
    const void* xp, long long sxb, long long sxt, const void* hh,
    const void* c0, const void* cs, const void* w, const void* dhs,
    const void* mask, const void* dh_last, const void* dc_last, void* dxp,
    void* dh0, void* dc0, void* counter, const int* plan, int B, int n_steps,
    int H, int reverse, int device, void* stream) {
  return persist_bwd<__nv_bfloat16>(xp, sxb, sxt, hh, c0, cs, w, dhs, mask,
                                    dh_last, dc_last, dxp, dh0, dc0, counter,
                                    plan, B, n_steps, H, reverse, device,
                                    stream);
}

#ifdef FMDA_PROFILE_PERSIST
// The step profile of the last launch (kProfSteps x kProfCols stamps).
extern "C" int fmda_persist_prof(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_persist_prof,
                                   sizeof(g_persist_prof));
}
#endif
