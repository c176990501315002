// One GRU forward step of the wide scan route in one launch, for NVIDIA
// Hopper (sm_90a): the product h_{t-1} W_hh^T on wgmma, its operands fed by
// TMA, and the gate algebra in the product's epilogue.  Bound to PyTorch
// via ctypes by fmda_tpu_torch/ops/gru_wide_step.py (the library is built
// by fmda_tpu_torch/ops/_cuda_lib.py).
//
// Replaces: no Pallas kernel.  Past pallas_gru.kernel_supported the JAX
// package's select_scan_fn runs lax.scan (fmda_tpu/ops/gru.py::gru_scan,
// its step gru_gates at :47-54): each step one (B, H) x (H, 3 H) product,
// which XLA puts on the matrix unit, and the gate algebra, which XLA fuses
// beside it.  The port's first counterpart runs a step as two launches, a
// cuBLAS addmm into a (B, 3 H) buffer and scan_wide.cu's gru_wide_fwd
// (W1), which reads the buffer back.  This kernel is the whole step:
//
//   gru_wide_step_fwd   h_t = (1 - z) n + z h_{t-1}, r, z = sigmoid(xp_t +
//                       hh_t), n = tanh(xp_t,n + r hh_t,n), hh_t = h_{t-1}
//                       W_hh^T + b_hh rounded to bf16 (as the route's addmm
//                       rounds it, and the backward's recomputed hh); a row
//                       whose mask is 0 keeps h_{t-1}.  hh never reaches
//                       device memory.
//
// The layout.  CTA (m, n) owns batch rows [64 m, 64 m + 64) and hidden
// units [64 n, 64 n + 64).  K = H is walked in k-steps of 64 (one 128-byte
// TMA box row, 128-byte swizzle, K-major, the layout wgmma reads): a copy
// warp keeps a ring of kStages slots filled, each h_{t-1}'s 64 x 64 box
// (the A operand) and W_hh's r, z and n row boxes of the CTA's units one
// after another (the B operand, 192 rows), and one consumer warpgroup
// issues an m64n192k16 product a k16 step on each slot as it lands, so a
// thread's accumulators hold the r, z and n sums of the same (row, unit)
// pairs.  The product done, they go to the ring (free by then), and 8
// epilogue warps, whose operands (xp_t, b_hh, h_{t-1}, the mask) were
// loaded while the product ran, finish 16 units of a row each: b_hh added,
// rounded, the gate algebra, h_t stored 16 bytes at a time.
//
// The plan (step_plan below, mirrored by ops/gru_wide_step.py's
// step_plan) picks one of three cluster layouts by batch:
//   - many batch tiles (B = 512 at H = 1024: 128 CTAs): clusters of 2
//     along the batch share their unit tile, and each CTA loads half of
//     every W_hh box and multicasts it to both, halving the W_hh reads
//     from L2 (48 -> 24 MB a step);
//   - few (B = 1: 16 CTAs): clusters of S along K, each CTA a 1/S of the
//     k-steps, the partial sums reduced through distributed shared memory
//     before the epilogue, so W_hh's read is spread over 16 S SMs;
//   - else one CTA a cluster.
// A step after the first is launched to overlap the one before it
// (programmatic dependent launch): its CTAs take SMs as the previous step's
// leave, and ask for W_hh's first slots and load xp_t before h_{t-1} is
// final; only h_{t-1} waits for the previous grid.
// bf16 only: the tensor cores hold float32 operands only as TF32, short of
// the float32 route's 1e-5, so float32 stays with the pair (addmm + W1).
//
// What bounds it: bytes.  A step at (512, 1024) reads W_hh (6.3 MB), xp_t
// (3.1 MB) and h_{t-1} and writes h_t: 11.5 MB, 3.44 us at 3.35 TB/s; its
// 3.2 GFLOP take 3.26 us at 989 TFLOP/s.  At B = 1 it is W_hh's 6.3 MB.
// On the card each SM's intake of its tile's operands (512 KB a CTA a step
// at B = 512) holds the product, and the gate algebra's latency the
// epilogue (PERF.md, experiments/torch_gru_wide_step.py --profile).
// Every wait traps after 4 s, so a fault in the protocol ends the kernel
// with an error instead of hanging it.  The primitives and the layout rule
// are wide_tc.cuh's, shared with the backward step (gru_wide_bwd_step.cu).

#include "wide_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kStages = 7;
constexpr int kABytes = kTile * kRowBytes;          // h_{t-1}'s box
constexpr int kGateBytes = kTile * kRowBytes;       // one gate's W_hh box
constexpr int kStageBytes = kABytes + 3 * kGateBytes;
constexpr int kSmemBytes = kStages * kStageBytes + kBarrierBytes + kAlignBytes;

using StepPlan = TilePlan;

// The layout of a step at (B, H) in a dtype of `itemsize` bytes: 0 and *p,
// or kPlanRefused where the pair (addmm + W1) keeps it (float32, H not a
// multiple of 64); else wide_tc.cuh's tile_plan over K = H.  A pure
// function of its arguments.
int step_plan(int B, int H, int itemsize, const TileFigures& f,
              StepPlan* p) {
  if (B < 1 || itemsize != 2 || H < kTile || H % kTile) return kPlanRefused;
  *p = tile_plan(B, H, kTile, H / kBoxK, kSmemBytes, f);
  return 0;
}

// Whether `p` lays out (B, H): the fields step_plan would derive from its
// cluster choice.
bool plan_fits(int B, int H, const StepPlan& p) {
  return tile_plan_fits(B, H, kTile, H / kBoxK, kSmemBytes, p);
}

// The step profile's columns (-DFMDA_PROFILE_STEP,
// experiments/torch_gru_wide_step.py --profile): 0 the consumers' start
// (barriers ready), 1 the first slot landed, 2 the product done, 3 the
// epilogue done, 4 the copy warp past its wait for the previous grid, 5
// its last issue, 6 the CTA's end.

// d (64 x 192, float32) += A (64 x 16) B (192 x 16)^T, both bf16 K-major
// in shared memory: one warpgroup's asynchronous m64n192k16, B the r, z
// and n row boxes one after another.  Thread t holds d[i] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (t % 4) + i % 2: d[g 32 + i] is gate g's sum at the same (row, unit)
// for every g, so the gates of a unit meet in one thread.
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// The gate algebra of one (row, unit): W1's (scan_wide.cu), from the
// product's float32 sum of each gate, b_hh, xp_t and h_{t-1}; the sums
// plus b_hh rounded to bf16 first, as the pair's addmm rounds hh.  The
// sigmoids divide approximately (sigmoid_rcp_f32, within 2 ulp of W1's
// IEEE quotient): the exact division's slow path is a call, which keeps
// the compiler from interleaving a thread's 16 units.
__device__ __forceinline__ float gru_unit(float pr, float pz, float pn,
                                          float br, float bz, float bn,
                                          float xr, float xz, float xn,
                                          float hp, bool keep) {
  const float ar = round_bf16(pr + br), az = round_bf16(pz + bz),
              an = round_bf16(pn + bn);
  const float r = sigmoid_rcp_f32(xr + ar);
  const float z = sigmoid_rcp_f32(xz + az);
  const float n = tanhf(xn + r * an);
  return keep ? (1.0f - z) * n + z * hp : hp;
}

// ---- the arguments ---------------------------------------------------------

// The step's operands: xp_t (B, 3 H) rows sx apart, h_{t-1} (B, H) rows sh
// apart (also read by TMA through h_map), W_hh (3 H, H) contiguous (w_map),
// b_hh (3 H), mask a (B,) uint8 column rows sm apart or null, h_t (B, H)
// rows so apart.  xp_t, h_{t-1}, b_hh and h_t are read and written 16
// bytes at a time: 16-byte aligned, row strides multiples of 8.
struct StepArgs {
  CUtensorMap h_map, w_map;
  const bf16 *xp, *h_prev, *b;
  const void* w_base;
  const uint8_t* mask;
  bf16* h_out;
  long long sx, sh, sm, so;
  int B, H;
  // 1 where the grid before this one in the stream is this route's
  // previous step, which writes h_{t-1} alone: W_hh, b_hh, xp_t and the
  // mask are read before it completes (the launch overlaps it)
  int early;
  StepPlan p;
};

// An epilogue thread's strip of 16 units of one row: its operands, loaded
// while the product runs (8 bf16 a uint4: [gate][half] for xp_t and b_hh).
struct Strip {
  uint4 x[3][2], b[3][2], h[2];
  bool keep;
};

// ---- the epilogue ----------------------------------------------------------

// the accumulators' rows in the ring, [gate][row][unit] float32: padded so
// that the fragments' pair stores and the strips' 16-byte reads spread
// over the banks
constexpr int kAccLd = kTile + 4;
constexpr int kAccBytes = 3 * kTile * kAccLd * 4;
static_assert(kAccBytes <= kStages * kStageBytes, "accumulators fit the ring");
// the epilogue's warps: 16 units of a row a thread, 64 x 64 / 256
constexpr int kStrip = 16;
constexpr int kEpilogueWarps = 8;
constexpr int kEpilogueThreads = kEpilogueWarps * 32;
// unit pairs an epilogue thread finishes at most where K is split: 64 rows
// x 32 pairs over 2 or more ranks of 256 threads
constexpr int kMaxPairs = kTile * (kTile / 2) / 2 / kEpilogueThreads;

__device__ __forceinline__ void load_strip(const StepArgs& a, long long b,
                                           int c, Strip& st) {
  const int H = a.H;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      st.x[g][v] = *reinterpret_cast<const uint4*>(a.xp + b * a.sx + g * H +
                                                   c + 8 * v);
      st.b[g][v] = *reinterpret_cast<const uint4*>(a.b + g * H + c + 8 * v);
    }
  st.keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
  griddep_wait();  // h_{t-1} is the previous step's output
#pragma unroll
  for (int v = 0; v < 2; ++v)
    st.h[v] = *reinterpret_cast<const uint4*>(a.h_prev + b * a.sh + c + 8 * v);
}

// A strip's 16 units of row `row` (batch row b, units from c): their r, z,
// n sums from the ring a unit pair at a time, the gate algebra, h_t stored
// 16 bytes at a time.
__device__ __forceinline__ void store_strip(const StepArgs& a,
                                            const float* acc_s, int row,
                                            long long b, int c,
                                            const Strip& st) {
  const float* sums = acc_s + row * kAccLd + c % kTile;
  unsigned packed[kStrip / 2];
#pragma unroll
  for (int w = 0; w < kStrip / 2; ++w) {  // units 2 w, 2 w + 1
    const float2 sr = *reinterpret_cast<const float2*>(sums + 2 * w);
    const float2 sz = *reinterpret_cast<const float2*>(
        sums + kTile * kAccLd + 2 * w);
    const float2 sn = *reinterpret_cast<const float2*>(
        sums + 2 * kTile * kAccLd + 2 * w);
    const unsigned xr = word_of(st.x[0], w), xz = word_of(st.x[1], w),
                   xn = word_of(st.x[2], w), br = word_of(st.b[0], w),
                   bz = word_of(st.b[1], w), bn = word_of(st.b[2], w),
                   hp = word_of(st.h, w);
    const float lo = gru_unit(sr.x, sz.x, sn.x, lo_f(br), lo_f(bz), lo_f(bn),
                              lo_f(xr), lo_f(xz), lo_f(xn), lo_f(hp), st.keep);
    const float hi = gru_unit(sr.y, sz.y, sn.y, hi_f(br), hi_f(bz), hi_f(bn),
                              hi_f(xr), hi_f(xz), hi_f(xn), hi_f(hp), st.keep);
    packed[w] = pack_bf16(lo, hi);
  }
  *reinterpret_cast<uint4*>(a.h_out + b * a.so + c) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
  *reinterpret_cast<uint4*>(a.h_out + b * a.so + c + 8) =
      make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// Where K is split: item j of this rank's share of the tile's (row, unit
// pair)s (row j / P, pair r P + j % P of the row's 32, P = 32 / S), its
// operands loaded; row -1 past the share.
struct Pair {
  int row, col;
  unsigned x[3], b[3], h;
  bool keep;
};

__device__ __forceinline__ void load_pair(const StepArgs& a, const StepPlan& p,
                                          int rank, int rows_valid, int m0,
                                          int u0, int j, Pair& pr) {
  const int per = (kTile / 2) / p.split;
  pr.row = j / per < rows_valid ? j / per : -1;
  if (pr.row < 0) return;
  pr.col = 2 * (rank * per + j % per);
  const long long b = m0 + pr.row;
  const int c = u0 + pr.col, H = a.H;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    pr.x[g] = *reinterpret_cast<const unsigned*>(a.xp + b * a.sx + g * H + c);
    pr.b[g] = *reinterpret_cast<const unsigned*>(a.b + g * H + c);
  }
  pr.keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
  griddep_wait();  // h_{t-1} is the previous step's output
  pr.h = *reinterpret_cast<const unsigned*>(a.h_prev + b * a.sh + c);
}

// A unit pair's r, z, n sums over the cluster's ranks (each rank's ring
// through distributed shared memory, in rank order), the gate algebra, h_t
// stored.
__device__ __forceinline__ void store_pair(const StepArgs& a,
                                           const StepPlan& p,
                                           const float* acc_s, int m0, int u0,
                                           const Pair& pr) {
  float2 v[kMaxSplit][3];
  pcg::cluster_group cluster = pcg::this_cluster();
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r)
    if (r < p.split) {
      const float* src = cluster.map_shared_rank(acc_s, r);
#pragma unroll
      for (int g = 0; g < 3; ++g)
        v[r][g] = *reinterpret_cast<const float2*>(
            src + (g * kTile + pr.row) * kAccLd + pr.col);
    }
  float sums[3][2] = {};
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r)
    if (r < p.split) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        sums[g][0] += v[r][g].x;
        sums[g][1] += v[r][g].y;
      }
    }
  const float lo = gru_unit(sums[0][0], sums[1][0], sums[2][0], lo_f(pr.b[0]),
                            lo_f(pr.b[1]), lo_f(pr.b[2]), lo_f(pr.x[0]),
                            lo_f(pr.x[1]), lo_f(pr.x[2]), lo_f(pr.h), pr.keep);
  const float hi = gru_unit(sums[0][1], sums[1][1], sums[2][1], hi_f(pr.b[0]),
                            hi_f(pr.b[1]), hi_f(pr.b[2]), hi_f(pr.x[0]),
                            hi_f(pr.x[1]), hi_f(pr.x[2]), hi_f(pr.h), pr.keep);
  *reinterpret_cast<unsigned*>(a.h_out + (m0 + pr.row) * a.so + u0 +
                               pr.col) = pack_bf16(lo, hi);
}

// ---- the kernel ------------------------------------------------------------

// Warps 0-3 (warpgroup 0) run the product, warps 4-11 the epilogue, their
// operands loaded while the product runs, warp 12 is the copy warp; each
// role runs in a branch of its own to the kernel's end.
constexpr int kCopyWarp = kConsumerWarps + kEpilogueWarps;
constexpr int kThreads = (kCopyWarp + 1) * 32;

// The accumulators are in place (this CTA's, or where K is split every
// CTA's of the cluster) for the epilogue; the product's and the
// epilogue's warps meet here, the copy warp too where K is split.
__device__ __forceinline__ void accumulators_ready(const StepPlan& p) {
  if (p.split > 1)
    cluster_sync();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCopyWarp * 32) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    gru_wide_step_kernel(const __grid_constant__ StepArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StepPlan& p = a.p;
  const int H = a.H;
  const int rank = (int)(blockIdx.x % p.cluster);
  const int tile = (int)(blockIdx.x / p.split);
  const int tile_m = tile % p.tiles_m, tile_n = tile / p.tiles_m;
  const int m0 = tile_m * kTile, u0 = tile_n * kTile;
  const int rows_valid = min(kTile, a.B - m0);
  // along the batch the cluster's rank is a half of each W_hh box; along K
  // a share of the k-steps
  const int rank_m = p.mcast > 1 ? rank : 0;
  const int k0 = p.split > 1 ? rank * p.k_steps : 0;
  unsigned char* ring =
      smem + ((kAlignBytes - (smem_u32(smem) & (kAlignBytes - 1))) &
              (kAlignBytes - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* acc_s = reinterpret_cast<float*>(ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // full[s]: the copy warp announced slot s's bytes and they landed (this
  // CTA's boxes, and under multicast its peer's halves of W_hh); empty[s]:
  // every consumer warp of every CTA of a multicast cluster read slot s
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps * p.mcast);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.cluster > 1)
    cluster_sync();
  else
    __syncthreads();

  if (warp == kCopyWarp) {
    // the copy warp: h_{t-1}'s box, then this CTA's share of W_hh's r, z
    // and n boxes of its units, a slot a k-step
    if (lane == 0) {
      prefetch_map(&a.h_map);
      prefetch_map(&a.w_map);
      const int share = kTile / p.mcast;
      auto w_boxes = [&](int k) {
        unsigned char* slot = ring + (k % kStages) * kStageBytes;
        for (int g = 0; g < 3; ++g)
          tma_box(slot + kABytes + g * kGateBytes + rank_m * share * kRowBytes,
                  &a.w_map, (k0 + k) * kBoxK, g * H + u0 + rank_m * share,
                  full + k % kStages, p.mcast);
      };
      auto h_box = [&](int k) {
        tma_box(ring + (k % kStages) * kStageBytes, &a.h_map,
                (k0 + k) * kBoxK, m0, full + k % kStages, 1);
      };
      // W_hh's first slots need nothing of the previous step: where the
      // launch overlaps it they are asked for before h_{t-1} is final
      const int pre = a.early ? min(kStages, p.k_steps) : 0;
      for (int k = 0; k < pre; ++k) {
        mbar_expect_tx(full + k, kStageBytes);
        w_boxes(k);
      }
      griddep_wait();
      STEP_STAMP(true, 4);
      for (int k = 0; k < pre; ++k) h_box(k);
      for (int k = pre; k < p.k_steps; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(empty + s, ((k / kStages) & 1u) ^ 1u);
        mbar_expect_tx(full + s, kStageBytes);
        h_box(k);
        w_boxes(k);
      }
      STEP_STAMP(true, 5);
    }
    __syncwarp();
    griddep_launch();
    if (p.split > 1) cluster_sync();
    if (p.cluster > 1) cluster_sync();
  } else if (warp < kConsumerWarps) {
    STEP_STAMP(tid == 0, 0);
    float acc[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.0f;
    for (int k = 0; k < p.k_steps; ++k) {
      const int s = k % kStages;
      mbar_wait(full + s, (k / kStages) & 1u);
      __syncwarp();  // the products are warp-synchronous
      STEP_STAMP(tid == 0 && k == 0, 1);
      fence_acc(acc);
      wgmma_fence();
      const unsigned char* slot = ring + s * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kBoxK / 16; ++kk)
        wgmma_m64n192k16(acc, sw128_desc(slot + kk * 32),
                         sw128_desc(slot + kABytes + kk * 32));
      wgmma_commit();
      fence_acc(acc);
      // the previous k-step's products are done: its slot is free
      if (k > 0) {
        wgmma_wait<1>();
        __syncwarp();
        if (lane < p.mcast)
          mbar_arrive(empty + (k - 1) % kStages, lane, p.mcast);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane < p.mcast)
      mbar_arrive(empty + (p.k_steps - 1) % kStages, lane, p.mcast);
    STEP_STAMP(tid == 0, 2);
    // every consumer warp's products are done with the ring (every slot
    // landed, the multicast halves included): the accumulators go there,
    // [gate][row][unit], valid rows only
    asm volatile("bar.sync 2, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
    const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= rows_valid) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * half;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          *reinterpret_cast<float2*>(acc_s + (g * kTile + row) * kAccLd +
                                     8 * j + cq) =
              make_float2(acc[32 * g + i], acc[32 * g + i + 1]);
      }
    }
    accumulators_ready(p);
    // the product is done: the next step's grid may be launched (its CTAs
    // take SMs as this grid's leave)
    griddep_launch();
    if (p.cluster > 1) cluster_sync();
    STEP_STAMP(tid == 0, 6);
  } else {
    // without a K split each thread takes a strip of 16 units of one row
    // (row e % 64, units 16 (e / 64) on); with one, rank r of the cluster
    // takes the unit pairs [r 32 / S, (r + 1) 32 / S) of every row, and
    // each thread up to kMaxPairs of them.  Their operands are loaded
    // while the product runs.
    const int e = tid - kConsumerWarps * 32;
    const int e_row = e & (kTile - 1), e_strip = e / kTile;
    const bool strip = p.split == 1 && e_row < rows_valid;
    const int c = u0 + kStrip * e_strip;
    Strip st;
    Pair pr[kMaxPairs];
    if (strip) load_strip(a, m0 + e_row, c, st);
    if (p.split > 1) {
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k)
        load_pair(a, p, rank, rows_valid, m0, u0, e + kEpilogueThreads * k,
                  pr[k]);
    }
    accumulators_ready(p);
    griddep_launch();
    if (strip) store_strip(a, acc_s, e_row, m0 + e_row, c, st);
    if (p.split > 1) {
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k)
        if (pr[k].row >= 0) store_pair(a, p, acc_s, m0, u0, pr[k]);
    }
    STEP_STAMP(e == 0, 3);
    if (p.cluster > 1) cluster_sync();
  }
  // (each role ends with the cluster's last barrier where the cluster has
  // more than one CTA: no CTA leaves while its peers may still read its
  // shared memory or arrive on its barriers)
}

// ---- the host side ---------------------------------------------------------

// The card's figures for this kernel, queried once a device.
cudaError_t figures_of(int device, TileFigures* f) {
  return figures_cached<0>(gru_wide_step_kernel, kThreads, kSmemBytes,
                           device, f);
}

// One launch of the step laid out by `plan` (kPlanInts ints in StepPlan's
// order, decided before the call): kPlanRefused where it does not lay out
// (B, H), else cudaGetLastError() after the launch.
int launch(StepArgs a, const int* plan, int device, void* stream) {
  if (plan == nullptr || a.B <= 0 || a.H <= 0)
    return (int)cudaErrorInvalidValue;
  int* fields = reinterpret_cast<int*>(&a.p);
  for (int i = 0; i < kPlanInts; ++i) fields[i] = plan[i];
  if (!plan_fits(a.B, a.H, a.p)) return kPlanRefused;
  // TMA's and the 16-byte accesses' conditions: aligned bases, row
  // strides multiples of 8 elements
  const void* bases[] = {a.h_prev, a.xp, a.b, a.h_out, a.w_base};
  for (const void* q : bases)
    if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  if (a.sh % 8 || a.sx % 8 || a.so % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = encode_map(&a.h_map, a.h_prev, a.H, a.B, a.sh, kTile);
  if (err == cudaSuccess)
    err = encode_map(&a.w_map, a.w_base, a.H, 3LL * a.H, a.H,
                     kTile / a.p.mcast);
  if (err != cudaSuccess) return (int)err;
  // the figures' query sets the kernel's shared-memory limit, once a card
  TileFigures f;
  err = figures_of(device, &f);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = step_attrs(a.p, a.early, attr);
  err = cudaLaunchKernelEx(&cfg, gru_wide_step_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of a step at (B, H) in a dtype of `itemsize` bytes on card
// `device`: out[0] 1 where the kernel lays it out (else 0: the pair keeps
// it), out[1..8] the plan (StepPlan's order), out[9] the card's SMs,
// out[10..13] the resident clusters of 1, 2, 4 and 8 CTAs.  Returns 0 or
// the figures' query's error.
extern "C" int fmda_gru_wide_scan_fwd_plan(int B, int H, int itemsize,
                                           int device, int* out) {
  if (B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  TileFigures f{};
  const cudaError_t err = figures_of(device, &f);
  if (err != cudaSuccess) return (int)err;
  StepPlan p{};
  const bool laid_out = step_plan(B, H, itemsize, f, &p) == 0;
  if (!laid_out) p = StepPlan{};
  const int v[1 + kPlanInts + 5] = {
      laid_out ? 1 : 0, p.tiles_m, p.tiles_n, p.mcast, p.split, p.cluster,
      p.k_steps, p.grid, p.smem, f.sms, f.clusters[0], f.clusters[1],
      f.clusters[2], f.clusters[3]};
  for (int i = 0; i < 1 + kPlanInts + 5; ++i) out[i] = v[i];
  return 0;
}

// Plain C interface for ctypes.  xp_t, h_{t-1} and h_t are the step's row
// 0 of (B, 3 H), (B, H), (B, H) bf16 views, rows sx, sh, so elements apart
// (multiples of 8); W_hh (3 H, H) and b_hh (3 H) contiguous bf16; every
// base 16-byte aligned (TMA reads h_{t-1} and W_hh, the epilogue the rest
// 16 bytes at a time); `mask` a (B,)
// uint8 column rows sm apart, or null; `plan` kPlanInts ints
// (fmda_gru_wide_scan_fwd_plan's); `early` 1 only where the kernel launched
// last on `stream` is this route's previous step (the launch then overlaps
// it: see StepArgs::early).  Returns kPlanRefused (1) where the plan
// does not lay out (B, H), else cudaGetLastError() after the launch (0 =
// success).
extern "C" int fmda_gru_wide_step_fwd_bf16(
    const void* xp, long long sx, const void* h_prev, long long sh,
    const void* w, const void* b, const void* mask, long long sm, void* h_out,
    long long so, const int* plan, int B, int H, int early, int device,
    void* stream) {
  StepArgs a{};
  a.early = early;
  a.xp = static_cast<const bf16*>(xp);
  a.sx = sx;
  a.h_prev = static_cast<const bf16*>(h_prev);
  a.sh = sh;
  a.w_base = w;
  a.b = static_cast<const bf16*>(b);
  a.mask = static_cast<const uint8_t*>(mask);
  a.sm = sm;
  a.h_out = static_cast<bf16*>(h_out);
  a.so = so;
  a.B = B;
  a.H = H;
  return launch(a, plan, device, stream);
}

#ifdef FMDA_PROFILE_STEP
// The step profile of the last launch (kProfCols stamps).
extern "C" int fmda_step_prof(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_step_prof, sizeof(g_step_prof));
}
#endif
