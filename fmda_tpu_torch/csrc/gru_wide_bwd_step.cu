// One GRU backward step of the wide scan route in one launch, for NVIDIA
// Hopper (sm_90a): the product dhh_{t+1} W_hh on wgmma, its operands fed
// by TMA, and the step's gate gradients in the product's epilogue.  Bound
// to PyTorch via ctypes by fmda_tpu_torch/ops/gru_wide_bwd_step.py (the
// library is built by fmda_tpu_torch/ops/_cuda_lib.py).
//
// Replaces: no Pallas kernel.  Past pallas_gru.kernel_supported the JAX
// package's select_scan_fn runs lax.scan (fmda_tpu/ops/gru.py::gru_scan,
// its step gru_gates at :47-54), whose gradient jax.grad makes as one
// reversed scan: each step the gate gradients and one (B, 3 H) x (3 H, H)
// product for the cotangent of h_{t-1}.  The port's first counterpart ran
// a step as two launches, scan_wide.cu's gru_wide_bwd (W2), which read the
// previous step's product back from a (B, H) buffer rounded to bf16, and a
// cuBLAS mm that wrote the next one.  This kernel is the whole step:
//
//   gru_wide_bwd_step   dh = dhs_t + direct + dhh_{t+1} W_hh (float32; the
//                       product never rounded, never written), the gates
//                       recomputed from xp_t, hh_t (the steps'
//                       pre-activations, recomputed in one product before
//                       the sweep) and h_{t-1}; dr, dz, dn = the gate
//                       gradients, gn = dn r, direct = dh z (in place); a
//                       row whose mask is 0 gives zeros and passes dh
//                       through as direct.
//
// Each value is written once.  A step's outputs go to row t of one
// (B, T, 4 H) buffer as [dr, dz, dn, gn]: its first 3 H columns are dxp_t
// and its columns [0, 2 H) and [3 H, 4 H) are dhh_t = [dr, dz, gn], the
// next step's A operand, which the copy warp reads by TMA from there
// (one tensor map over the whole buffer, made once a direction; a step's
// boxes start at column t_next 4 H and skip dn).
//
// The layout.  CTA (m, n) owns batch rows [64 m, 64 m + 64) and N hidden
// units [N n, N n + N), N = 128 where H is a multiple of 128 and the plan
// splits K, else 64.
// K = 3 H is walked in k-steps of 64 (one 128-byte TMA box row, 128-byte
// swizzle, K-major): a copy warp keeps a ring of slots filled, each
// dhh_{t+1}'s 64 x 64 box (the A operand) and W_hh^T's box of the CTA's N
// units (the B operand), and one consumer warpgroup issues an m64nNk16
// product a k16 step on each slot as it lands.  W_hh is (3 H, H),
// N-contiguous for this product; the route makes one transposed copy,
// W_hh^T (H, 3 H), a backward call (6.3 MB at H = 1024, once for T = 30
// steps), so the B operand is K-major and the box code is the forward's.
// The product done, the accumulators go to the ring (free by then), and 8
// epilogue warps, whose operands (xp_t, hh_t, h_{t-1}, dhs_t, the mask,
// then direct) were loaded while the product ran, finish 8 units of a row
// an item: the gate gradients stored 16 bytes at a time.  The epilogue is
// per element: a (row, unit) needs only its own product.
//
// Why N = 128: on the H100 a k-step took ~290 ns at N = 64 whatever its
// bytes (B = 256 without multicast as B = 512 with it; at B = 1 the copy
// warp took ~3 us to issue its 12 slots), so a CTA's time went with its
// k-steps and boxes, not its bytes; a wider tile halves both for the same
// product (experiments/torch_gru_wide_bwd_step.py --profile, PERF.md).
//
// The plan (bwd_step_plan below, mirrored by ops/gru_wide_bwd_step.py's
// bwd_step_plan) is wide_tc.cuh's tile_plan over K = 3 H, the forward's
// rule, at N = 128 where that splits K, else at N = 64 (a K rank's share
// of a tile of 128 is then at most 2 items an epilogue thread; 4, when K
// is not split, spilled at the 128 registers a thread that 13 warps
// leave):
//   - few tiles (at most half the SMs): clusters of S along K, each CTA a
//     1/S of the k-steps, the partial sums reduced through distributed
//     shared memory before the epilogue: B = 512 at H = 1024 makes 8 x 8
//     tiles, S = 2 (128 CTAs, 24 k-steps, 576 KB a CTA a step); B = 1
//     makes 8, S = 8 (6 k-steps).  (Multicasting the boxes over a cluster
//     of 2 x 2 instead would need 32 clusters of 4 at once; the H100 holds
//     30);
//   - many batch tiles (B > 528 at H = 1024: 64 units a tile), an even
//     number: clusters of 2 along the batch share their unit tile, and
//     each CTA loads half of every W_hh^T box and multicasts it to both;
//   - else one CTA a cluster.
// A ragged last batch tile reads zeros past B (TMA) and stores nothing
// there.  The first processed step has no product: its k-steps are 0 and
// only the epilogue runs.
// A step after the first is launched to overlap the one before it
// (programmatic dependent launch): before its wait for the previous grid,
// it asks for W_hh^T's first slots and loads xp_t, hh_t, h_{t-1}, dhs_t
// and the mask, which no step writes; dhh_{t+1}'s boxes and direct wait.
// bf16 only: the tensor cores hold float32 operands only as TF32, short of
// the float32 route's 1e-5, so float32 stays with W2 and a cuBLAS mm.
//
// What bounds it: bytes.  A step at (512, 1024) reads W_hh (6.3 MB),
// dhh_{t+1} (3.1 MB), xp_t and hh_t (3.1 MB each), h_{t-1} and dhs_t, and
// direct, and writes dxp_t, gn and direct: 26.2 MB, 7.8 us at 3.35 TB/s;
// its 3.2 GFLOP take 3.26 us at 989 TFLOP/s (ops/cost.py's
// gru_wide_bwd_step_cost).  Every wait traps after 4 s, so a fault in the
// protocol ends the kernel with an error instead of hanging it.

#include "wide_tc.cuh"

#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 4;  // one warpgroup
constexpr int kABytes = kTile * kRowBytes;  // dhh_{t+1}'s box
constexpr int kBarBytes = 256;  // full[stages], empty[stages]
// an epilogue item: 8 units of one row (16 bytes of each bf16 operand)
constexpr int kChunk = 8;
constexpr int kEpilogueWarps = 8;
constexpr int kEpilogueThreads = kEpilogueWarps * 32;
// items an epilogue thread holds at once
constexpr int kHeld = 2;

// A CTA of kN units (64 or 128; 128 only where K is split, so a K rank's
// epilogue share is kHeld items a thread at most): W_hh^T's box of its
// units, a ring slot, the ring's stages (192 and 216 KB), the shared
// bytes, the accumulators' padded row (the fragments' pair stores spread
// over the banks), a row's items.
template <int kN>
struct Tile {
  static constexpr int kBBytes = kN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kN == 64 ? 12 : 9;
  static constexpr int kSmem =
      kStages * kStageBytes + kBarBytes + kAlignBytes;
  static constexpr int kAccLd = kN + 4;
  static constexpr int kChunks = kN / kChunk;
  static_assert(2 * kStages * 8 <= kBarBytes, "the barriers fit");
  static_assert(kTile * kAccLd * 4 <= kStages * kStageBytes,
                "the accumulators fit the ring");
  static_assert(kTile * kChunks / (kN / kTile) <= kHeld * kEpilogueThreads,
                "a K rank's items fit the epilogue's threads");
};

// The layout of a backward step at (B, H) in a dtype of `itemsize` bytes:
// 0 and *p, or kPlanRefused where W2 and the mm keep it (float32, H not a
// multiple of 64); else tile_plan over K = 3 H in tiles of 128 units
// where H is a multiple of 128 and that layout splits K, else in tiles of
// 64.  `f`: the kernels' figures (one CTA an SM at either width).  A pure
// function of its arguments.
int bwd_step_plan(int B, int H, int itemsize, const TileFigures& f,
                  TilePlan* p) {
  if (B < 1 || itemsize != 2 || H < kTile || H % kTile) return kPlanRefused;
  const int k_total = 3 * H / kBoxK;
  if (H % 128 == 0) {
    const TilePlan wide = tile_plan(B, H, 128, k_total, Tile<128>::kSmem, f);
    if (wide.split > 1) {
      *p = wide;
      return 0;
    }
  }
  *p = tile_plan(B, H, kTile, k_total, Tile<64>::kSmem, f);
  return 0;
}

// The units a CTA of plan `p` takes at H.
int units_of(int H, const TilePlan& p) {
  return p.tiles_n > 0 ? H / p.tiles_n : 0;
}

bool plan_fits(int B, int H, const TilePlan& p) {
  if (B < 1 || H < kTile || H % kTile) return false;
  const int k_total = 3 * H / kBoxK;
  if (H % 128 == 0 && units_of(H, p) == 128)
    return p.split > 1 &&
           tile_plan_fits(B, H, 128, k_total, Tile<128>::kSmem, p);
  return tile_plan_fits(B, H, kTile, k_total, Tile<64>::kSmem, p);
}

// The step profile's columns (-DFMDA_PROFILE_STEP,
// experiments/torch_gru_wide_bwd_step.py --profile): 0 the consumers'
// start (barriers ready), 1 the first slot landed, 2 the product done, 3
// the epilogue done, 4 the copy warp past its wait for the previous grid,
// 5 its last issue, 6 the consumers' end.

// d (64 x 64, float32) += A (64 x 16) B (64 x 16)^T, both bf16 K-major in
// shared memory: one warpgroup's asynchronous m64n64k16.  Thread t holds
// d[i] at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2 (the same for m64n128k16's 64 values).
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16) B (128 x 16)^T: m64n128k16.
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Word i of a uint4 (two bf16); i a constant once unrolled.
__device__ __forceinline__ unsigned word4(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// The gate gradients of one (row, unit): W2's algebra (scan_wide.cu) in
// the plain version's order, dh = (dhs_t + direct) + the product (where
// the step has one).  The sigmoids divide approximately (sigmoid_rcp_f32,
// within 2 ulp of the IEEE quotient), as the fused forward's do.
struct Grads {
  float dr, dz, dn, gn, direct;
};

__device__ __forceinline__ Grads gru_bwd_unit(float prod, bool have_prod,
                                              float xr, float xz, float xn,
                                              float ar, float az, float an,
                                              float hp, float dhs, float dir,
                                              bool keep) {
  float dh = dhs + dir;
  if (have_prod) dh = dh + prod;
  const float r = sigmoid_rcp_f32(xr + ar);
  const float z = sigmoid_rcp_f32(xz + az);
  const float n = tanhf(xn + r * an);
  const float dn_pre = dh * (1.0f - z) * (1.0f - n * n);
  const float dr_pre = dn_pre * an * r * (1.0f - r);
  const float dz_pre = dh * (hp - n) * z * (1.0f - z);
  Grads g;
  g.dr = keep ? dr_pre : 0.0f;
  g.dz = keep ? dz_pre : 0.0f;
  g.dn = keep ? dn_pre : 0.0f;
  g.gn = keep ? dn_pre * r : 0.0f;
  g.direct = keep ? dh * z : dh;
  return g;
}

// ---- the arguments ---------------------------------------------------------

// A step's operands: xp_t and hh_t (B, 3 H) rows sx and shh apart,
// h_{t-1} and dhs_t (B, H) rows sh and sd apart, the mask a (B,) uint8
// column rows sm apart or null, direct (B, H) float32 contiguous, dg_t the
// step's (B, 4 H) row of the output buffer, rows sg apart; a_map the
// buffer as (B, T 4 H), a_col the first column of step t_next's row (-1:
// the first processed step, no product); w_map W_hh^T (H, 3 H).  The bf16
// operands are read and written 16 bytes at a time: 16-byte aligned, row
// strides multiples of 8.
struct BwdArgs {
  CUtensorMap a_map, w_map;
  const bf16 *xp, *hh, *hp, *dhs;
  const uint8_t* mask;
  float* direct;
  bf16* dg;
  long long sx, shh, sh, sd, sm, sg;
  int B, H;
  int a_col;
  // 1 where the grid before this one in the stream is this direction's
  // previous step, which writes dhh_{t+1} and direct alone: W_hh^T, xp_t,
  // hh_t, h_{t-1}, dhs_t and the mask are read before it completes
  int early;
  TilePlan p;
};

// ---- the epilogue ----------------------------------------------------------

struct Item {
  int row, col;  // row in the tile (-1: none), first unit in the tile
  uint4 x[3], g[3], h, d;  // xp_t's and hh_t's r, z, n; h_{t-1}; dhs_t
  float4 dir[2];           // direct
  bool keep;
};

// Item j of K-split rank `rank`'s share of a tile of kN units (row j / P,
// chunk rank P + j % P of the row's kN / 8, P = kN / 8 / S), its operands
// loaded: those no step writes first, then, past the wait for the
// previous grid, direct.
template <int kN>
__device__ __forceinline__ void load_item(const BwdArgs& a, int rank,
                                          int rows_valid, int m0, int u0,
                                          int j, Item& it) {
  const int per = Tile<kN>::kChunks / a.p.split;
  it.row = j / per < rows_valid ? j / per : -1;
  if (it.row < 0) return;
  it.col = kChunk * (rank * per + j % per);
  const long long b = m0 + it.row;
  const int c = u0 + it.col, H = a.H;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    it.x[g] = *reinterpret_cast<const uint4*>(a.xp + b * a.sx + g * H + c);
    it.g[g] = *reinterpret_cast<const uint4*>(a.hh + b * a.shh + g * H + c);
  }
  it.h = *reinterpret_cast<const uint4*>(a.hp + b * a.sh + c);
  it.d = *reinterpret_cast<const uint4*>(a.dhs + b * a.sd + c);
  it.keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
  griddep_wait();  // direct is the previous step's output
  const float* dir = a.direct + b * H + c;
  it.dir[0] = *reinterpret_cast<const float4*>(dir);
  it.dir[1] = *reinterpret_cast<const float4*>(dir + 4);
}

// An item's 8 products summed over the cluster's K ranks (each rank's
// ring through distributed shared memory, in rank order), the gate
// gradients, dg_t's [dr, dz, dn, gn] and direct stored.
template <int kN>
__device__ __forceinline__ void store_item(const BwdArgs& a,
                                           const float* acc_s, int m0, int u0,
                                           bool have_prod, const Item& it) {
  const TilePlan& p = a.p;
  float prod[kChunk] = {};
  if (have_prod) {
    const float* own = acc_s + it.row * Tile<kN>::kAccLd + it.col;
    pcg::cluster_group cluster = pcg::this_cluster();
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < p.split) {
        const float* src = p.split > 1 ? cluster.map_shared_rank(own, r)
                                       : own;
        const float4 v0 = *reinterpret_cast<const float4*>(src);
        const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
        prod[0] += v0.x;
        prod[1] += v0.y;
        prod[2] += v0.z;
        prod[3] += v0.w;
        prod[4] += v1.x;
        prod[5] += v1.y;
        prod[6] += v1.z;
        prod[7] += v1.w;
      }
  }
  const float dir[kChunk] = {it.dir[0].x, it.dir[0].y, it.dir[0].z,
                             it.dir[0].w, it.dir[1].x, it.dir[1].y,
                             it.dir[1].z, it.dir[1].w};
  unsigned dr[4], dz[4], dn[4], gn[4];
  float nd[kChunk];
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // units 2 w, 2 w + 1
    const unsigned xr = word4(it.x[0], w), xz = word4(it.x[1], w),
                   xn = word4(it.x[2], w), ar = word4(it.g[0], w),
                   az = word4(it.g[1], w), an = word4(it.g[2], w),
                   hp = word4(it.h, w), dh = word4(it.d, w);
    const Grads lo = gru_bwd_unit(
        prod[2 * w], have_prod, lo_f(xr), lo_f(xz), lo_f(xn), lo_f(ar),
        lo_f(az), lo_f(an), lo_f(hp), lo_f(dh), dir[2 * w], it.keep);
    const Grads hi = gru_bwd_unit(
        prod[2 * w + 1], have_prod, hi_f(xr), hi_f(xz), hi_f(xn), hi_f(ar),
        hi_f(az), hi_f(an), hi_f(hp), hi_f(dh), dir[2 * w + 1], it.keep);
    dr[w] = pack_bf16(lo.dr, hi.dr);
    dz[w] = pack_bf16(lo.dz, hi.dz);
    dn[w] = pack_bf16(lo.dn, hi.dn);
    gn[w] = pack_bf16(lo.gn, hi.gn);
    nd[2 * w] = lo.direct;
    nd[2 * w + 1] = hi.direct;
  }
  const long long b = m0 + it.row;
  const int c = u0 + it.col, H = a.H;
  bf16* row = a.dg + b * a.sg + c;
  *reinterpret_cast<uint4*>(row) = make_uint4(dr[0], dr[1], dr[2], dr[3]);
  *reinterpret_cast<uint4*>(row + H) = make_uint4(dz[0], dz[1], dz[2], dz[3]);
  *reinterpret_cast<uint4*>(row + 2 * H) =
      make_uint4(dn[0], dn[1], dn[2], dn[3]);
  *reinterpret_cast<uint4*>(row + 3 * H) =
      make_uint4(gn[0], gn[1], gn[2], gn[3]);
  float* dir_out = a.direct + b * H + c;
  *reinterpret_cast<float4*>(dir_out) = make_float4(nd[0], nd[1], nd[2], nd[3]);
  *reinterpret_cast<float4*>(dir_out + 4) =
      make_float4(nd[4], nd[5], nd[6], nd[7]);
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
__device__ __forceinline__ void accumulators_ready(const TilePlan& p) {
  if (p.split > 1)
    cluster_sync();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCopyWarp * 32) : "memory");
}

template <int kN>
__global__ void __launch_bounds__(kThreads, 1)
    gru_wide_bwd_step_kernel(const __grid_constant__ BwdArgs a) {
  using L = Tile<kN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const TilePlan& p = a.p;
  const int H = a.H;
  const int rank = (int)(blockIdx.x % p.cluster);
  const int tile = (int)(blockIdx.x / p.split);
  const int tile_m = tile % p.tiles_m, tile_n = tile / p.tiles_m;
  const int m0 = tile_m * kTile, u0 = tile_n * kN;
  const int rows_valid = min(kTile, a.B - m0);
  // along the batch the cluster's rank is a half of each W_hh^T box; along
  // K a share of the k-steps
  const int rank_m = p.mcast > 1 ? rank : 0;
  const int rank_k = p.split > 1 ? rank : 0;
  const int k0 = rank_k * p.k_steps;
  const bool have_prod = a.a_col >= 0;
  const int k_steps = have_prod ? p.k_steps : 0;
  unsigned char* ring =
      smem + ((kAlignBytes - (smem_u32(smem) & (kAlignBytes - 1))) &
              (kAlignBytes - 1));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + L::kStages * L::kStageBytes);
  uint64_t* empty = full + L::kStages;
  float* acc_s = reinterpret_cast<float*>(ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // full[s]: the copy warp announced slot s's bytes and they landed (this
  // CTA's boxes, and under multicast its peer's halves of W_hh^T);
  // empty[s]: every consumer warp of every CTA of a multicast cluster read
  // slot s
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
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
    // the copy warp: dhh_{t+1}'s box, then this CTA's share of W_hh^T's
    // box of its units, a slot a k-step
    if (lane == 0) {
      prefetch_map(&a.a_map);
      prefetch_map(&a.w_map);
      const int share = kN / p.mcast;
      auto w_box = [&](int k) {
        unsigned char* slot = ring + (k % L::kStages) * L::kStageBytes;
        tma_box(slot + kABytes + rank_m * share * kRowBytes, &a.w_map,
                (k0 + k) * kBoxK, u0 + rank_m * share,
                full + k % L::kStages, p.mcast);
      };
      // K's columns [0, 2 H) are dg's dr and dz, [2 H, 3 H) its gn at
      // [3 H, 4 H): a box never straddles (2 H is a multiple of 64)
      auto a_box = [&](int k) {
        const int c = (k0 + k) * kBoxK;
        tma_box(ring + (k % L::kStages) * L::kStageBytes, &a.a_map,
                a.a_col + c + (c >= 2 * H ? H : 0), m0,
                full + k % L::kStages, 1);
      };
      // W_hh^T's first slots need nothing of the previous step: where the
      // launch overlaps it they are asked for before dhh_{t+1} is final
      const int pre = a.early ? min(L::kStages, k_steps) : 0;
      for (int k = 0; k < pre; ++k) {
        mbar_expect_tx(full + k, L::kStageBytes);
        w_box(k);
      }
      griddep_wait();
      STEP_STAMP(true, 4);
      for (int k = 0; k < pre; ++k) a_box(k);
      for (int k = pre; k < k_steps; ++k) {
        const int s = k % L::kStages;
        if (k >= L::kStages)
          mbar_wait(empty + s, ((k / L::kStages) & 1u) ^ 1u);
        mbar_expect_tx(full + s, L::kStageBytes);
        a_box(k);
        w_box(k);
      }
      STEP_STAMP(true, 5);
    }
    __syncwarp();
    griddep_launch();
    if (p.split > 1) cluster_sync();
    if (p.cluster > 1) cluster_sync();
  } else if (warp < kConsumerWarps) {
    STEP_STAMP(tid == 0, 0);
    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.0f;
    for (int k = 0; k < k_steps; ++k) {
      const int s = k % L::kStages;
      mbar_wait(full + s, (k / L::kStages) & 1u);
      __syncwarp();  // the products are warp-synchronous
      STEP_STAMP(tid == 0 && k == 0, 1);
      fence_acc(acc);
      wgmma_fence();
      const unsigned char* slot = ring + s * L::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kBoxK / 16; ++kk)
        wgmma_tile(acc, sw128_desc(slot + kk * 32),
                   sw128_desc(slot + kABytes + kk * 32));
      wgmma_commit();
      fence_acc(acc);
      // the previous k-step's products are done: its slot is free
      if (k > 0) {
        wgmma_wait<1>();
        __syncwarp();
        if (lane < p.mcast)
          mbar_arrive(empty + (k - 1) % L::kStages, lane, p.mcast);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (k_steps > 0 && lane < p.mcast)
      mbar_arrive(empty + (k_steps - 1) % L::kStages, lane, p.mcast);
    STEP_STAMP(tid == 0, 2);
    // every consumer warp's products are done with the ring (every slot
    // landed, the multicast halves included): the accumulators go there,
    // [row][unit], valid rows only
    asm volatile("bar.sync 2, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
    if (have_prod) {
      const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= rows_valid) continue;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int i = 4 * j + 2 * half;
          *reinterpret_cast<float2*>(acc_s + row * L::kAccLd + 8 * j + cq) =
              make_float2(acc[i], acc[i + 1]);
        }
      }
    }
    accumulators_ready(p);
    // the product is done: the next step's grid may be launched (its CTAs
    // take SMs as this grid's leave)
    griddep_launch();
    STEP_STAMP(tid == 0, 6);
    if (p.cluster > 1) cluster_sync();
  } else {
    // thread e takes items e and e + 256 of its K rank's share: 8 units
    // of a row each.  Their operands are loaded while the product runs.
    const int e = tid - kConsumerWarps * 32;
    Item it[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      load_item<kN>(a, rank_k, rows_valid, m0, u0, e + kEpilogueThreads * i,
                    it[i]);
    accumulators_ready(p);
    griddep_launch();
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (it[i].row >= 0) store_item<kN>(a, acc_s, m0, u0, have_prod, it[i]);
    STEP_STAMP(e == 0, 3);
    if (p.cluster > 1) cluster_sync();
  }
  // (each role ends with the cluster's last barrier where the cluster has
  // more than one CTA: no CTA leaves while its peers may still read its
  // shared memory or arrive on its barriers)
}

// ---- the host side ---------------------------------------------------------

// The card's figures for the kernel of `units` units a tile, queried once
// a device (the query also sets its shared-memory limit).
cudaError_t figures_of(int units, int device, TileFigures* f) {
  if (units == 128)
    return figures_cached<128>(gru_wide_bwd_step_kernel<128>, kThreads,
                               Tile<128>::kSmem, device, f);
  return figures_cached<64>(gru_wide_bwd_step_kernel<64>, kThreads,
                            Tile<64>::kSmem, device, f);
}

// A direction's launches, prepared once: the kernel's arguments at step 0
// (the tensor maps made, the plan checked) and each operand's step stride
// in elements.
struct BwdDirection {
  BwdArgs a;
  long long tx, thh, th, td, tm, tg;
  int T, device;
};
// the bytes a caller keeps a prepared direction in
constexpr int kHandleBytes = 1024;
static_assert(sizeof(BwdDirection) <= kHandleBytes, "a direction fits");

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

// The plan of a backward step at (B, H) in a dtype of `itemsize` bytes on
// card `device`: out[0] 1 where the kernel lays it out (else 0: W2 and the
// mm keep it), out[1..8] the plan (TilePlan's order), out[9] the card's
// SMs, out[10..13] the resident clusters of 1, 2, 4 and 8 CTAs of the
// kernel (of tiles of 128 units: one CTA an SM, as at 64).  Returns 0
// or the figures' query's error.
extern "C" int fmda_gru_wide_bwd_step_plan(int B, int H, int itemsize,
                                           int device, int* out) {
  if (B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  TileFigures f{};
  const cudaError_t err = figures_of(128, device, &f);
  if (err != cudaSuccess) return (int)err;
  TilePlan p{};
  const bool laid_out = bwd_step_plan(B, H, itemsize, f, &p) == 0;
  if (!laid_out) p = TilePlan{};
  const int v[1 + kPlanInts + 5] = {
      laid_out ? 1 : 0, p.tiles_m, p.tiles_n, p.mcast, p.split, p.cluster,
      p.k_steps, p.grid, p.smem, f.sms, f.clusters[0], f.clusters[1],
      f.clusters[2], f.clusters[3]};
  for (int i = 0; i < 1 + kPlanInts + 5; ++i) out[i] = v[i];
  return 0;
}

// Prepare a backward direction of T steps into `handle` (handle_bytes
// bytes, at least kHandleBytes; no launch): xp and hh (B, T, 3 H), h_prevs
// (the state entering each step) and dhs (B, T, H), every one bf16 with
// rows and steps s* and t* elements apart (multiples of 8); the mask
// (B, T) uint8, rows sm and steps tm apart, or null; W_hh^T (H, 3 H)
// contiguous; direct (B, H) float32 contiguous, the cotangent of the last
// processed step's h to begin with; dg the (B, T, 4 H) output, rows sg
// apart (a multiple of 8) and steps 4 H; every base 16-byte aligned;
// `plan` kPlanInts ints (fmda_gru_wide_bwd_step_plan's).  Returns
// kPlanRefused (1) where the plan does not lay out (B, H), else 0 or the
// error that stopped it.
extern "C" int fmda_gru_wide_bwd_scan_prepare_bf16(
    const void* xp, long long sx, long long tx, const void* hh,
    long long shh, long long thh, const void* h_prevs, long long sh,
    long long th, const void* dhs, long long sd, long long td,
    const void* mask, long long sm, long long tm, const void* w_t,
    void* direct, void* dg, long long sg, long long tg, const int* plan,
    int B, int T, int H, int device, void* handle, int handle_bytes) {
  if (handle == nullptr || handle_bytes < kHandleBytes || plan == nullptr ||
      B <= 0 || T <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  BwdDirection d{};
  BwdArgs& a = d.a;
  int* fields = reinterpret_cast<int*>(&a.p);
  for (int i = 0; i < kPlanInts; ++i) fields[i] = plan[i];
  if (!plan_fits(B, H, a.p)) return kPlanRefused;
  // TMA's and the 16-byte accesses' conditions: aligned bases, strides
  // multiples of 8 elements; the buffer's steps 4 H apart (one map over
  // its (B, T 4 H) view, columns within int range)
  const void* bases[] = {xp, hh, h_prevs, dhs, w_t, direct, dg};
  for (const void* q : bases)
    if (!aligned16(q)) return (int)cudaErrorInvalidValue;
  const long long strides[] = {sx, tx, shh, thh, sh, th, sd, td, sg};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  if (tg != 4LL * H || sg < (long long)T * tg ||
      (long long)T * tg >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int units = units_of(H, a.p);
  err = encode_map(&a.a_map, dg, (long long)T * tg, B, sg, kTile);
  if (err == cudaSuccess)
    err = encode_map(&a.w_map, w_t, 3LL * H, H, 3LL * H, units / a.p.mcast);
  if (err != cudaSuccess) return (int)err;
  // the figures' query sets the kernel's shared-memory limit, once a card
  TileFigures f;
  err = figures_of(units, device, &f);
  if (err != cudaSuccess) return (int)err;
  a.xp = static_cast<const bf16*>(xp);
  a.hh = static_cast<const bf16*>(hh);
  a.hp = static_cast<const bf16*>(h_prevs);
  a.dhs = static_cast<const bf16*>(dhs);
  a.mask = static_cast<const uint8_t*>(mask);
  a.direct = static_cast<float*>(direct);
  a.dg = static_cast<bf16*>(dg);
  a.sx = sx;
  a.shh = shh;
  a.sh = sh;
  a.sd = sd;
  a.sm = sm;
  a.sg = sg;
  a.B = B;
  a.H = H;
  d.tx = tx;
  d.thh = thh;
  d.th = th;
  d.td = td;
  d.tm = tm;
  d.tg = tg;
  d.T = T;
  d.device = device;
  memcpy(handle, &d, sizeof d);
  return 0;
}

// One launch: step t of the direction prepared in `handle`, its A operand
// step t_next's row of dg (-1: the first processed step, no product);
// `early` 1 only where the kernel launched last on `stream` is this
// direction's previous step (the launch then overlaps it: see
// BwdArgs::early).  Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int fmda_gru_wide_bwd_step_bf16(const void* handle, int t,
                                           int t_next, int early,
                                           void* stream) {
  if (handle == nullptr) return (int)cudaErrorInvalidValue;
  BwdDirection d;
  memcpy(&d, handle, sizeof d);
  if (t < 0 || t >= d.T || t_next < -1 || t_next >= d.T || t_next == t)
    return (int)cudaErrorInvalidValue;
  BwdArgs a = d.a;
  a.xp += t * d.tx;
  a.hh += t * d.thh;
  a.hp += t * d.th;
  a.dhs += t * d.td;
  if (a.mask != nullptr) a.mask += t * d.tm;
  a.dg += t * d.tg;
  a.a_col = t_next < 0 ? -1 : (int)(t_next * d.tg);
  a.early = early;
  cudaError_t err = cudaSetDevice(d.device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = step_attrs(a.p, early, attr);
  err = units_of(a.H, a.p) == 128
            ? cudaLaunchKernelEx(&cfg, gru_wide_bwd_step_kernel<128>, a)
            : cudaLaunchKernelEx(&cfg, gru_wide_bwd_step_kernel<64>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef FMDA_PROFILE_STEP
// The step profile of the last launch (kProfCols stamps).
extern "C" int fmda_bwd_step_prof(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_step_prof, sizeof(g_step_prof));
}
#endif
