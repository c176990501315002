// What the recurrent kernels share (gru_scan.cu, lstm_scan.cu, ssm_step.cu,
// scan_dw.cu): dtype conversions, the gate nonlinearity, the lane layout and
// lane sums of the scans, and the forward scans' one body
// (scan_fwd_kernel, with the plan that picks its branch).  Everything here
// sits in an anonymous namespace, so each source that includes it gets its
// own copy and the library exports only the sources' extern "C" entries.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

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

// The scans' layout (the forwards below, the backward sweeps in
// gru_scan.cu and lstm_scan.cu): L lanes per hidden unit, lane l of unit j
// at thread j * L + l, each lane a quarter of every dot product over the
// hidden axis, the quarters added by lane_sum.  Where H <= kScanRegH,
// L = kScanLanes and each lane holds its slices of W_hh in registers
// (kScanRegH / L values of each gate row), in blocks of at most
// kScanRegThreads; else W_hh is read from shared memory while it fits, and
// from device memory past that.  Fewer lanes would mean more W_hh a lane:
// two lanes spill the LSTM sweep's registers.
constexpr int kScanLanes = 4;
constexpr int kScanRegH = 32;
constexpr int kScanRegThreads = kScanRegH * kScanLanes;
constexpr size_t kMaxSweepSmemBytes = 225 * 1024;

// The lanes a scan gives each hidden unit outside the register layout: as
// many as a block of at most max_threads holds, kScanLanes or 1.
inline int scan_lanes(int H, int max_threads) {
  return H * kScanLanes <= max_threads ? kScanLanes : 1;
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

// The step profile of a scan, built only with -DFMDA_PROFILE_SWEEP
// (experiments/torch_scan_sweep_profile.py for the backward sweeps,
// torch_scan_fwd_profile.py for the forwards): the clock cycles each part
// of a step takes, summed over the steps, by the first and the last thread
// of block 0, in g_sweep_prof[0..4] and [8..12] (then the total cycles and
// nanoseconds of the loop).  PROF_MARK(k) ends part k.  A sweep: 0 the gate
// recompute and its lane sums, 1 the gate and cotangent algebra and the
// outputs, 2 the barrier, 3 the dh chain, 4 the loop's own work.  A
// forward: 0 the hidden product and its lane sums, 1 the gate algebra and
// the stores, 2 the barrier, 4 the loop (the next step's loads included).
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


// ---- the forward scans --------------------------------------------------------
//
// One body for the GRU and LSTM forwards (gru_scan.cu, lstm_scan.cu), given
// a Cell: kGates gate blocks of H, kCarriesC (the LSTM's c), kThreadLimit
// (the device-memory branch's block limit), kHiddenLimit, and
// step<T>(x, a, h, c, keep), which takes one row's gate inputs x (xp at
// this unit) and hidden pre-activations a (h . W_hh^T + b_hh at this unit,
// one a gate block) to the new carries, rounded to T, or leaves them where
// keep is false.
//
// Branches (plan_fwd picks one; fmda_<cell>_scan_fwd_plan reports it):
//   kFwdReg      H <= kScanRegH: each lane's slices of W_hh in registers
//   kFwdSmem     W_hh in shared memory, rows padded against bank conflicts
//   kFwdCluster  where W_hh does not fit one block but half of it does: a
//                cluster of two CTAs, each holding the rows of half the
//                units in shared memory and computing those units; each
//                writes its half of the new h into both CTAs' h buffers
//                (distributed shared memory), one cluster barrier a step
//   kFwdDevice   W_hh read from device memory (L2), each lane its k-chunks
//                of its unit's rows, so a lane group reads whole sectors
// Every branch: kScanLanes lanes a unit (1 where the block would pass its
// limit), lane l taking the 4-wide k-chunks l, l + L, ... of every gate row
// of its unit against the same chunks of h, read from shared memory as
// float4s; lane_sum adds the lanes' shares, so every lane holds the whole
// pre-activations and computes the same carries.  A CTA carries R batch
// rows (1, 2 or 4: the fewest with which one wave of CTAs holds the batch),
// each thread the same unit and lane of all R, so one read of W_hh a step
// serves R rows.  h is double-buffered by step parity: one barrier a step.
// The next step's xp (and mask) are loaded before this step's product,
// through a pointer that moves a step at a time, held in T until used.
enum FwdBranch : int {
  kFwdReg = 0,
  kFwdSmem = 1,
  kFwdCluster = 2,
  kFwdDevice = 3
};

// The shared-memory branches' block limit (128 registers a thread).
constexpr int kFwdSmemThreads = 512;
// Shared memory one block may take, and what an SM holds (227, 228 KB).
constexpr size_t kMaxFwdSmemBytes = 232448;
constexpr size_t kSmemPerSm = 233472;
constexpr int kFwdMaxRows = 4;

struct FwdPlan {
  int branch;   // FwdBranch
  int lanes;    // lanes a hidden unit (L)
  int rows;     // batch rows a CTA (R)
  int cluster;  // CTAs a row group: 2 in kFwdCluster, else 1
  int units;    // hidden units a CTA computes: H, or H / 2 in a cluster
  int hp;       // the h buffers' row stride: H rounded up to 4 L (kScanRegH)
  int ws;       // shared W_hh's row stride in elements, 0 outside smem
  int blocks;   // CTAs in the grid
  size_t smem;  // dynamic shared memory a CTA
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A row stride for W_hh in shared memory, at least hp, at which the 4-wide
// chunks one phase of a warp reads (float4 in f32, 8 bytes in bf16) fall in
// distinct banks: chunk l of neighbouring units' rows lies ws apart, so ws
// must be 4 L elements past a multiple of 32 banks.
inline int fwd_w_stride(int hp, int lanes, int itemsize) {
  const int m = 128 / itemsize;  // elements in 32 banks
  return hp + ((4 * lanes - hp) % m + m) % m;
}

// The branch, lanes, rows and grid of a forward of G gate blocks.  R is
// the fewest rows (1, 2, 4) with which one wave of CTAs holds the batch,
// from per_sm(plan), the CTAs of the plan's kernel an SM holds.  The one
// function both the launcher and the plan query call (plan_fwd_of).
template <class PerSm>
FwdPlan plan_fwd(int gates, int B, int H, int itemsize, int device,
                 PerSm&& per_sm) {
  FwdPlan p{};
  p.cluster = 1;
  p.units = H;
  int max_rows = kFwdMaxRows;
  auto w_bytes = [&](int units, int lanes, int hp) {
    return (size_t)gates * units * fwd_w_stride(hp, lanes, itemsize) *
           itemsize;
  };
  auto fits = [&](int units, int lanes, int hp) {
    return 2 * (size_t)kFwdMaxRows * hp * sizeof(float) +
               w_bytes(units, lanes, hp) <=
           kMaxFwdSmemBytes;
  };
  if (H <= kScanRegH) {
    p.branch = kFwdReg;
    p.lanes = kScanLanes;
    p.hp = kScanRegH;
  } else {
    p.lanes = scan_lanes(H, kFwdSmemThreads);
    p.hp = round_up(H, 4 * p.lanes);
    const int half_hp = round_up(H, 4 * kScanLanes);
    if (fits(H, p.lanes, p.hp)) {
      p.branch = kFwdSmem;
    } else if (H % 2 == 0 && H / 2 * kScanLanes <= kFwdSmemThreads &&
               fits(H / 2, kScanLanes, half_hp)) {
      p.branch = kFwdCluster;
      p.cluster = 2;
      p.units = H / 2;
      p.lanes = kScanLanes;
      p.hp = half_hp;
    } else {
      p.branch = kFwdDevice;
      max_rows = 1;
    }
    if (p.lanes == 1) max_rows = 1;
    // four rows only in blocks of half the limit (fwd_block_limit)
    if (p.units * p.lanes > kFwdSmemThreads / 2)
      max_rows = std::min(max_rows, 2);
    if (p.branch != kFwdDevice)
      p.ws = fwd_w_stride(p.hp, p.lanes, itemsize);
  }
  const size_t wb = p.ws ? w_bytes(p.units, p.lanes, p.hp) : 0;
  const int sms = sm_count(device);
  for (p.rows = 1;; p.rows *= 2) {
    p.smem = 2 * (size_t)p.rows * p.hp * sizeof(float) + wb;
    const long long wave_rows =
        (long long)std::max(per_sm(p), 1) * sms / p.cluster * p.rows;
    if (wave_rows >= B || p.rows >= max_rows) break;
  }
  p.blocks = (B + p.rows - 1) / p.rows * p.cluster;
  return p;
}

template <typename T>
struct FwdArgs {
  const T* xp;
  long long sxb, sxt;  // xp's batch and time strides, in elements
  const T *h0, *c0, *w_hh, *b_hh;
  const uint8_t* mask;
  T *hs, *cs, *h_last, *c_last;
  int B, n_steps, H, reverse;
  int units, hp, ws;  // the plan's
  int w_vec;          // W_hh's rows can be read 4 values at a time
};

// Four values of T in one load: 16 bytes in f32, 8 in bf16.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 to_float4(float4 v) { return v; }
__device__ __forceinline__ float4 to_float4(uint2 u) {  // 4 x bf16, exact
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// p[0..3] as floats, from shared memory; p aligned to the load.
template <typename T>
__device__ __forceinline__ float4 lds4(const T* p) {
  return to_float4(*reinterpret_cast<const typename Vec4<T>::type*>(p));
}

// p[0..3] as floats from device memory through the read-only path, 0 past
// index n - k: one load where vec (p aligned and n - k a multiple of 4),
// else four.
template <typename T>
__device__ __forceinline__ float4 ldg4(const T* p, int k, int n, bool vec) {
  using V = typename Vec4<T>::type;
  if (vec) return k < n ? to_float4(__ldg(reinterpret_cast<const V*>(p)))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < n ? to_f32(__ldg(p + i)) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A forward instance's block limit: what its branch may launch, and what
// leaves it its registers (65536 / limit): kScanRegThreads in registers;
// in shared memory kFwdSmemThreads, half that at R = 4 (two rows' more
// accumulators and inputs); in device memory kFwdSmemThreads with four
// lanes, the cell's limit with one.
template <class Cell>
constexpr int fwd_block_limit(int lanes, int rows, int branch) {
  return branch == kFwdReg      ? kScanRegThreads
         : branch == kFwdDevice ? (lanes == 1 ? Cell::kThreadLimit
                                              : kFwdSmemThreads)
         : rows == kFwdMaxRows  ? kFwdSmemThreads / 2
                                : kFwdSmemThreads;
}

// Shared memory: h [2][R][HP] in f32 (values already rounded to T; zero
// past H), then in the shared-memory branches this CTA's units' rows of
// W_hh, [G][units][ws] in T (zero past H).
template <class Cell, typename T, int L, int R, int MODE>
__global__ void __launch_bounds__(fwd_block_limit<Cell>(L, R, MODE), 1)
    scan_fwd_kernel(const FwdArgs<T> a) {
  namespace cg = cooperative_groups;
  constexpr int G = Cell::kGates;
  constexpr int CS = MODE == kFwdCluster ? 2 : 1;
  constexpr bool W_REG = MODE == kFwdReg;
  constexpr bool W_SMEM = MODE == kFwdSmem || MODE == kFwdCluster;
  constexpr int KR = W_REG ? kScanRegH / L : 1;  // register k a gate row
  constexpr int NS = 1 + (Cell::kCarriesC ? 1 : 0);  // hs (, cs)
  constexpr int NO = CS + NS;  // stores a step: h into each CTA, hs (, cs)
  extern __shared__ __align__(16) float fwd_smem[];

  const int H = a.H, n_steps = a.n_steps;
  const int HP = W_REG ? kScanRegH : a.hp;
  float* hbuf = fwd_smem;
  T* w_s = reinterpret_cast<T*>(hbuf + 2 * R * HP);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int ju = tid / L, l = tid - ju * L;
  int q = 0;  // this CTA's rank in its cluster
  if constexpr (CS > 1) q = (int)cg::this_cluster().block_rank();
  const int j = q * a.units + ju;
  const long long b0 = (long long)(blockIdx.x / CS) * R;
  const unsigned wmask = warp_mask();

  float wr[G][KR];
  if constexpr (W_REG) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < KR / 4; ++c) {
        const int k = 4 * (l + L * c);
        const float4 v =
            ldg4(a.w_hh + (long long)(g * H + j) * H + k, k, H, a.w_vec);
        wr[g][4 * c] = v.x;
        wr[g][4 * c + 1] = v.y;
        wr[g][4 * c + 2] = v.z;
        wr[g][4 * c + 3] = v.w;
      }
    }
  }
  if constexpr (W_SMEM) {
    // each gate block's rows of this CTA's units are units * H contiguous
    // values; (i + 0.5) / H in float is exact enough for i < 2^20
    using V = typename Vec4<T>::type;
    const float inv_h = 1.0f / (float)H;
    const int n = a.units * H, pad = HP - H;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* src = a.w_hh + (long long)(g * H + q * a.units) * H;
      T* dst = w_s + (long long)g * a.units * a.ws;
      if (a.w_vec) {
#pragma unroll 4
        for (int i = 4 * tid; i < n; i += 4 * nt) {
          const int u = (int)(((float)i + 0.5f) * inv_h);
          *reinterpret_cast<V*>(dst + u * a.ws + (i - u * H)) =
              __ldg(reinterpret_cast<const V*>(src + i));
        }
      } else {
#pragma unroll 4
        for (int i = tid; i < n; i += nt) {
          const int u = (int)(((float)i + 0.5f) * inv_h);
          dst[u * a.ws + (i - u * H)] = __ldg(src + i);
        }
      }
      for (int i = tid; i < a.units * pad; i += nt) {
        const int u = i / pad;
        dst[u * a.ws + H + (i - u * pad)] = from_f32<T>(0.0f);
      }
    }
  }

  float bias[G];
#pragma unroll
  for (int g = 0; g < G; ++g) bias[g] = to_f32(a.b_hh[g * H + j]);
  // rows past B (the last CTA's) compute on row B - 1's state, store nothing
  float h[R], c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long b = b0 + r < a.B ? b0 + r : a.B - 1;
    h[r] = to_f32(a.h0[b * H + j]);
    c[r] = Cell::kCarriesC ? to_f32(a.c0[b * H + j]) : 0.0f;
  }
  for (int i = tid; i < 2 * R * HP; i += nt) {
    const int row = i / HP, k = i - row * HP;
    const long long b = b0 + row < a.B ? b0 + row : a.B - 1;
    hbuf[i] = row < R && k < H ? to_f32(a.h0[b * H + k]) : 0.0f;
  }

  // The walk: step s is time t0 + s dt; pointers at row b0's next step
  const int dt = a.reverse ? -1 : 1;
  const int t0 = a.reverse ? n_steps - 1 : 0;
  const T* xq = a.xp + b0 * a.sxb + (long long)t0 * a.sxt + j;
  const uint8_t* mq = a.mask ? a.mask + b0 * n_steps + t0 : nullptr;
  long long hq = (b0 * n_steps + t0) * H + j;  // row b0's (b, t, j) in hs
  const long long hrow = (long long)n_steps * H;
  T xr[R][G] = {};
  bool keep[R];
#pragma unroll
  for (int r = 0; r < R; ++r) keep[r] = true;
  auto load = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (b0 + r < a.B) {  // the same for every thread of the CTA
#pragma unroll
        for (int g = 0; g < G; ++g) xr[r][g] = xq[r * a.sxb + g * H];
        if (mq) keep[r] = mq[r * n_steps] != 0;
      }
    }
    xq += dt * a.sxt;
    if (mq) mq += dt;
  };
  if (n_steps > 0) load();

  float* hd0 = hbuf;  // the h buffers the new h goes to: each CTA's
  float* hd1 = hbuf;
  if constexpr (CS > 1) {
    cg::cluster_group cl = cg::this_cluster();
    hd0 = cl.map_shared_rank(hbuf, 0);
    hd1 = cl.map_shared_rank(hbuf, 1);
    cl.sync();  // W_hh and h0 in place, both CTAs running
  } else {
    __syncthreads();
  }

  SWEEP_PROFILE;
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    PROF_MARK(4);
    float x[R][G];
    bool ck[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ck[r] = keep[r];
#pragma unroll
      for (int g = 0; g < G; ++g) x[r][g] = to_f32(xr[r][g]);
    }
    if (s + 1 < n_steps) load();  // prefetch the next step

    // this lane's share of h . W_hh^T for each row and gate
    const float* hc = hbuf + cur * R * HP;
    float acc[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[r][g] = 0.0f;
    auto chunk = [&](int k, const float4 (&w)[G]) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hc + r * HP + k);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float v = fmaf(hv.x, w[g].x, acc[r][g]);
          v = fmaf(hv.y, w[g].y, v);
          v = fmaf(hv.z, w[g].z, v);
          acc[r][g] = fmaf(hv.w, w[g].w, v);
        }
      }
    };
    if constexpr (W_REG) {
#pragma unroll
      for (int cc = 0; cc < KR / 4; ++cc) {
        float4 w[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          w[g] = make_float4(wr[g][4 * cc], wr[g][4 * cc + 1],
                             wr[g][4 * cc + 2], wr[g][4 * cc + 3]);
        chunk(4 * (l + L * cc), w);
      }
    } else {
      const T* wrow = W_SMEM ? w_s + (long long)ju * a.ws
                             : a.w_hh + (long long)j * H;
      const long long gstride =
          W_SMEM ? (long long)a.units * a.ws : (long long)H * H;
      const int kc = HP / (4 * L);
#pragma unroll 2
      for (int cc = 0; cc < kc; ++cc) {
        const int k = 4 * (l + L * cc);
        float4 w[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          w[g] = W_SMEM ? lds4(wrow + g * gstride + k)
                        : ldg4(wrow + g * gstride + k, k, H, a.w_vec);
        chunk(k, w);
      }
    }
    float pre[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        pre[r][g] = lane_sum<L>(acc[r][g], wmask) + bias[g];
    PROF_MARK(0);

#pragma unroll
    for (int r = 0; r < R; ++r)
      Cell::template step<T>(x[r], pre[r], h[r], c[r], ck[r]);
    // Store o (the new h into CTA o's h buffer for o < CS, then hs, then
    // cs) is made by lane o % L, every lane the same number of times
    const int nxt = (cur ^ 1) * R * HP + j;
#pragma unroll
    for (int m = 0; m < (NO + L - 1) / L; ++m) {
      const int o = l + m * L;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (o < CS) {
          (o == 0 ? hd0 : hd1)[nxt + r * HP] = h[r];
        } else if (o < NO && b0 + r < a.B) {
          const bool is_h = o == CS;
          T* d = (!Cell::kCarriesC || is_h) ? a.hs : a.cs;
          d[hq + r * hrow] = from_f32<T>(is_h ? h[r] : c[r]);
        }
      }
    }
    hq += dt * H;
    PROF_MARK(1);
    if constexpr (CS > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    PROF_MARK(2);
  }
  PROF_FLUSH();
  // h_last (and c_last) by lanes 0 (and 1)
#pragma unroll
  for (int m = 0; m < (NS + L - 1) / L; ++m) {
    const int o = l + m * L;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (o < NS && b0 + r < a.B) {
        T* d = o == 0 ? a.h_last : a.c_last;
        d[(b0 + r) * H + j] = from_f32<T>(o == 0 ? h[r] : c[r]);
      }
    }
  }
}

// f(kernel, mode) with the forward instance of a branch, lanes and rows,
// mode its branch as a std::integral_constant.
template <class Cell, typename T, int MODE, int L, class F>
cudaError_t with_fwd_rows(int rows, F&& f) {
  using Mode = std::integral_constant<int, MODE>;
  if constexpr (MODE == kFwdDevice || L == 1) {
    return f(scan_fwd_kernel<Cell, T, L, 1, MODE>, Mode{});
  } else {
    if (rows == 1) return f(scan_fwd_kernel<Cell, T, L, 1, MODE>, Mode{});
    if (rows == 2) return f(scan_fwd_kernel<Cell, T, L, 2, MODE>, Mode{});
    return f(scan_fwd_kernel<Cell, T, L, kFwdMaxRows, MODE>, Mode{});
  }
}

template <class Cell, typename T, class F>
cudaError_t with_fwd_kernel(const FwdPlan& p, F&& f) {
  constexpr int L = kScanLanes;
  switch (p.branch) {
    case kFwdReg:
      return with_fwd_rows<Cell, T, kFwdReg, L>(p.rows, f);
    case kFwdSmem:
      return p.lanes == L ? with_fwd_rows<Cell, T, kFwdSmem, L>(p.rows, f)
                          : with_fwd_rows<Cell, T, kFwdSmem, 1>(p.rows, f);
    case kFwdCluster:
      return with_fwd_rows<Cell, T, kFwdCluster, L>(p.rows, f);
    default:
      return p.lanes == L ? with_fwd_rows<Cell, T, kFwdDevice, L>(p.rows, f)
                          : with_fwd_rows<Cell, T, kFwdDevice, 1>(p.rows, f);
  }
}

// The plan of a forward in T, with the CTAs an SM holds read from the
// occupancy of the instance each candidate plan would launch.
template <class Cell, typename T>
FwdPlan plan_fwd_of(int B, int H, int device) {
  return plan_fwd(
      Cell::kGates, B, H, (int)sizeof(T), device, [](const FwdPlan& p) {
        int n = 0;
        with_fwd_kernel<Cell, T>(p, [&](auto kernel, auto) {
          cudaError_t err = allow_smem(kernel, p.smem);
          if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, kernel, p.units * p.lanes, p.smem);
          return err;
        });
        return n;
      });
}

template <class Cell, typename T>
int launch_fwd(FwdArgs<T> a, int device, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.H > Cell::kHiddenLimit || a.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FwdPlan p = plan_fwd_of<Cell, T>(a.B, a.H, device);
  a.units = p.units;
  a.hp = p.hp;
  a.ws = p.ws;
  a.w_vec = a.H % 4 == 0 &&
            reinterpret_cast<uintptr_t>(a.w_hh) % (4 * sizeof(T)) == 0;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = with_fwd_kernel<Cell, T>(p, [&](auto kernel, auto mode) {
    cudaError_t e = allow_smem(kernel, p.smem);
    if (e != cudaSuccess) return e;
    if constexpr (decltype(mode)::value == kFwdCluster) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 2;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(p.blocks);
      cfg.blockDim = dim3(p.units * p.lanes);
      cfg.dynamicSmemBytes = p.smem;
      cfg.stream = s;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaLaunchKernelEx(&cfg, kernel, a);
      if (e != cudaSuccess) return e;
    } else {
      kernel<<<p.blocks, p.units * p.lanes, p.smem, s>>>(a);
    }
    return cudaGetLastError();
  });
  return (int)err;
}

// The plan query's answer: branch, lanes, rows, cluster, blocks, smem.
template <class Cell>
int report_fwd_plan(int B, int H, int itemsize, int device, int* out) {
  if (B <= 0 || H <= 0 || H > Cell::kHiddenLimit ||
      (itemsize != 4 && itemsize != 2))
    return (int)cudaErrorInvalidValue;
  const FwdPlan p =
      itemsize == 4 ? plan_fwd_of<Cell, float>(B, H, device)
                    : plan_fwd_of<Cell, __nv_bfloat16>(B, H, device);
  const int v[6] = {p.branch, p.lanes, p.rows, p.cluster, p.blocks,
                    (int)p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // namespace
