// The flash-attention forward for NVIDIA Hopper (sm_90a), bound to PyTorch
// via ctypes by fmda_tpu_torch/ops/attention_kernel.py (the library is built
// by fmda_tpu_torch/ops/_cuda_lib.py; the backward lives in flash_bwd.cu
// and flash_attn.cu, and the primitives they share in flash_mma.cuh).
//
// Replaces: fmda_tpu/ops/pallas_attention.py::_fwd_kernel, the Pallas TPU
// kernel behind flash_attention_with_lse.  On (B*N, T, D) q, k, v in the I/O
// dtype, with scale = 1/sqrt(D), over key blocks of kBlockKeys (128) keys:
//
//   s = q k^T scale          m' = max(m, rowmax s)      corr = exp(m - m')
//   p = exp(s - m')          l = l corr + rowsum p      acc = acc corr + p v
//   o = acc / l              lse = m + log l
//
// The Pallas arithmetic, kept: the row max moves once a block; masked scores
// are the finite kNeg and their p is forced to exactly 0 (s <= kNeg / 2), so
// a fully masked row gives o = 0 and lse = kNeg; p is rounded to the I/O
// dtype before p v; m, l and acc are float32.  The envelope: any T >= 1 (the
// last tiles ragged and masked), D <= 512, causal or not, an optional (B, T)
// uint8 key mask (0 = the key is hidden from every query of that row).
//
// Design: one pass a key block, in the mma fragment layout.
//   - A warp owns a 16-row query tile (rows g and g + 8 of each mma
//     fragment, g = lane / 4).  For each 128-key block it computes the
//     block's 16 x 128 scores once into registers (16 n-tiles of 8 keys,
//     64 floats a lane), masks them, takes the row max with two quad
//     shuffles, forms p, its row sum and p v from those registers: no
//     recompute pass.
//   - bf16 products run on mma.sync, m16n8k16 with float32
//     accumulation; p goes from the score accumulators straight into the A
//     fragments of p v, and V's B fragments come through ldmatrix.trans.
//     float32 stays float32 (the reference is float32 and the tolerance
//     1e-5): a register-tiled FFMA micro-tile computes the same fragment
//     from shared memory, and reads p back from a per-warp shared buffer.
//     (Three TF32 products of split operands on m16n8k8 were measured
//     against it on the H100: slower at every shape, and outside 1e-5 at
//     T = 1024; PERF.md.)
//   - K and V tiles are staged in shared memory by cp.async (16-byte chunks
//     where the rows allow it), double-buffered when they fit (at D <= 64 a
//     block's K and V as one load, the next block's in flight behind the
//     whole of this one's work), and zero-filled past T and past D.
//   - Short T (T <= 128, D <= 64): a CTA holds up to four whole (b*n)
//     heads, their K and V resident in shared memory, and WPH warps a head
//     walk its query tiles (at the model's (256, 4, 30, 8): 256 CTAs of four
//     heads, two warps a head, one query tile a warp; at T <= 32 a warp
//     holds 32 keys of scores, not 128).  Long T: a CTA owns up to four
//     consecutive query tiles of one head and streams K and V.
//   - D > 64: SPLIT warps share one query tile, each holding DW = 64 dims of
//     q, of acc and of the score product; the partial scores are summed
//     through shared memory in warp order, so every warp of the tile holds
//     the same scores, the same p and the same m and l.
//   - Every output is summed in one fixed order: the same bits every run.
//   - The plan (warps, CTAs, staging and the shared-memory layout) is
//     flash_fwd_plan.cc's, the one place it is decided.
//
// What bounds it.  At the model's (B*N = 1024, T = 30, D = 8) the forward
// reads q, k, v and writes o and lse once: 4.0 MB, 1.2 us at 3.35 TB/s,
// against ~15 MFLOP; so it sits near the launch floor, and the design's job
// there is few, full CTAs.  At (64, 1024, 8) the products are 2.1 GFLOP
// (32 us at the 67 TFLOP/s float32 rate) and the 67M exponentials (about
// 20 us on the SFUs) come close beside them.

#include "flash_fwd_plan.h"
#include "flash_mma.cuh"

namespace {

using fmda_flash::kBlockKeys;
using fmda_flash::kMaxThreads;
using fmda_flash::kPadP;

constexpr float kNeg = -1e30f;

// The launch's plan and the call it runs.
struct Plan : fmda_flash::Geometry {
  int bn, n_heads, t, d, causal, vec;
  float scale;
};

// -- staging -----------------------------------------------------------------

// The plan's tk rows of one head's (T, D) matrix from key0 into a tile
// [tk][ld], and their key flags (flash_mma.cuh's staging).
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int ld,
                                           const T* __restrict__ head,
                                           int key0, const Plan& p) {
  ::stage_rows<T>(dst, ld, head, key0, p.tk, p.t, p.d, p.vec != 0);
}

__device__ __forceinline__ void stage_keep(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ km,
                                           int key0, const Plan& p) {
  ::stage_keep(dst, km, key0, p.tk, p.t);
}

// -- the kernel --------------------------------------------------------------

// grid (plan.grid).  Resident: units * wph warps; CTA c owns heads
// c * units + u, one a unit, and warp w of a unit walks the head's query
// tiles w, w + wph, ...; else units * split warps, and
// CTA c owns head c / per_head and the units' consecutive query tiles from
// row (c % per_head) * units * 16, streaming K and V.
template <typename T, int SPLIT, int DW, int KEYS>
__global__ void __launch_bounds__(kMaxThreads, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ key_mask,
    T* __restrict__ o, float* __restrict__ lse, Plan p) {
  // the keys of a block held in registers: 128, or 32 where T <= 32 (one
  // block, fewer registers and a smaller p buffer)
  constexpr int kScoreTiles = KEYS / 8;  // n-tiles of a block's scores
  constexpr int kLdp = KEYS + kPadP;
  constexpr int kTileKeys = KEYS / SPLIT;  // a streamed tile's keys
  constexpr int kTileN = kTileKeys / 8;          // its score n-tiles
  constexpr int kDimN = DW / 8;                  // a warp's output n-tiles
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // the FFMA micro-tile holds its two q rows in registers at small DW
  constexpr bool kQRegs = !kBf16 && DW <= 16;
  // the f32 products' dim loops unroll in full only at small DW: at DW = 64
  // full unrolling under 16 score tiles runs out of registers
  constexpr int kDimUnroll = DW <= 16 ? DW : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  SWEEP_PROFILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_unit = p.resident ? p.wph : SPLIT;
  const int unit = warp / per_unit;
  const int ws = p.resident ? 0 : warp - unit * SPLIT;  // dims slice
  const int sub = p.resident ? warp - unit * p.wph : 0;  // first q tile
  const int g = lane >> 2, t4 = lane & 3;
  const int dbase = ws * DW;  // the warp's first dim
  const int regions = p.resident ? p.units : 1;
  const int region = p.resident ? unit : 0;
  T* const ks_all = reinterpret_cast<T*>(smem);
  T* const vs_all = reinterpret_cast<T*>(smem + p.off_v);
  uint8_t* const keep_all = smem + p.off_keep;
  T* const qs = reinterpret_cast<T*>(smem + p.off_q) + warp * 16 * p.ldq;
  float* const ps = reinterpret_cast<float*>(smem + p.off_p) + warp * 16 * kLdp;
  float* const red = reinterpret_cast<float*>(smem + p.off_red) + unit * 2048;

  // zero the K and V tiles once where D leaves columns the products read
  if (p.d < SPLIT * DW) {
    for (int e = threadIdx.x; e < p.off_keep / 4; e += blockDim.x)
      reinterpret_cast<float*>(smem)[e] = 0.0f;
    __syncthreads();
  }

  int per_head = 1, head, row_base;
  if (p.resident) {
    head = blockIdx.x * p.units + unit;
    row_base = 0;
  } else {
    per_head = (p.t + p.units * 16 - 1) / (p.units * 16);
    head = blockIdx.x / per_head;
    row_base = (blockIdx.x - head * per_head) * p.units * 16 + unit * 16;
  }
  const bool active = head < p.bn;
  const long long hoff = (long long)(active ? head : 0) * p.t * p.d;
  const uint8_t* km =
      key_mask == nullptr ? nullptr
                          : key_mask + (long long)(active ? head : 0) /
                                           p.n_heads * p.t;

  // resident: every head's K and V (and key flags) once, stage 0, waited
  // for once the first q tile is on its way
  if (p.resident) {
    for (int r = 0; r < regions; ++r) {
      const int h = blockIdx.x * p.units + r;
      if (h >= p.bn) continue;
      const long long off = (long long)h * p.t * p.d;
      stage_rows<T>(ks_all + r * p.tk * p.ldk, p.ldk, k + off, 0, p);
      stage_rows<T>(vs_all + r * p.tk * p.ldv, p.ldv, v + off, 0, p);
      const uint8_t* kmr =
          key_mask == nullptr ? nullptr
                              : key_mask + (long long)(h / p.n_heads) * p.t;
      stage_keep(keep_all + r * p.tk, kmr, 0, p);
    }
    cp_async_commit();
  }
  PROF_MARK(0);

  // resident: this warp's query tiles, no CTA barrier among them;
  // streaming: one tile, the CTA's barriers in step
  const int n_qt = p.resident ? (p.t + 15) / 16 : sub + 1;
  for (int qt = sub; qt < n_qt; qt += p.resident ? p.wph : 1) {
    const int row0 = p.resident ? qt * 16 : row_base;
    // causal: keys past the last row are hidden from all of them (the
    // CTA's last row when streaming: every warp walks the same tiles)
    const int last = p.resident ? row0 + 15
                                : row_base - unit * 16 + p.units * 16 - 1;
    const int k_end = p.causal ? min(p.t, last + 1) : p.t;

    // the streamed loads, in order: with one warp a tile (SPLIT = 1) a
    // block's K and V together, so that the next block's are in flight
    // through both of this block's phases; else a block's K tiles, then
    // its V tiles
    constexpr bool kPairs = SPLIT == 1;
    const int n_blocks = (k_end + kBlockKeys - 1) / kBlockKeys;
    const int last_tiles =
        (k_end - (n_blocks - 1) * kBlockKeys + kTileKeys - 1) / kTileKeys;
    const int n_loads =
        kPairs ? n_blocks : (n_blocks - 1) * 2 * SPLIT + 2 * last_tiles;
    auto issue = [&](int i) {  // load i into stage i % stages
      const int stage = p.stages == 2 ? (i & 1) : 0;
      if (kPairs) {
        const int key0 = i * kBlockKeys;
        stage_rows<T>(ks_all + stage * p.tk * p.ldk, p.ldk, k + hoff, key0, p);
        stage_rows<T>(vs_all + stage * p.tk * p.ldv, p.ldv, v + hoff, key0, p);
        stage_keep(keep_all + stage * p.tk, km, key0, p);
        return;
      }
      const int blk = min(i / (2 * SPLIT), n_blocks - 1);
      const int rem = i - blk * 2 * SPLIT;
      const int nk = blk == n_blocks - 1 ? last_tiles : SPLIT;
      const bool is_v = rem >= nk;
      const int key0 = blk * kBlockKeys + (rem - (is_v ? nk : 0)) * kTileKeys;
      if (is_v) {
        stage_rows<T>(vs_all + stage * p.tk * p.ldv, p.ldv, v + hoff, key0, p);
      } else {
        stage_rows<T>(ks_all + stage * p.tk * p.ldk, p.ldk, k + hoff, key0, p);
        stage_keep(keep_all + stage * p.tk, km, key0, p);
      }
    };
    int load = 0;
    // the buffer of load `load`, waited for; the next load is in flight
    // behind it when there are two stages
    auto acquire = [&]() -> int {
      __syncthreads();  // every reader of the stage refilled next is done
      if (p.stages == 2) {
        if (load + 1 < n_loads) issue(load + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        issue(load);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      return p.stages == 2 ? (load++ & 1) : (load++, 0);
    };
    if (!p.resident && p.stages == 2) {
      issue(0);
      cp_async_commit();
    }

    // this warp's 16 rows x DW dims of q, zero past T and past D
#pragma unroll
    for (int e = lane; e < 16 * DW; e += 32) {
      const int r = e / DW, c = e - r * DW;
      const int row = row0 + r, dim = dbase + c;
      qs[r * p.ldq + c] = (active && row < p.t && dim < p.d)
                              ? q[hoff + (long long)row * p.d + dim]
                              : from_f32<T>(0.0f);
    }
    if (p.resident && qt == sub) {  // the staged heads, once a warp
      cp_async_wait<0>();
      __syncthreads();
    }
    __syncwarp();
    unsigned qa[kBf16 ? DW / 16 : 1][4];
    float qr[2][kQRegs ? DW : 1];
    if constexpr (kQRegs) {
#pragma unroll
      for (int c = 0; c < DW; ++c) {
        qr[0][c] = to_f32(qs[g * p.ldq + c]);
        qr[1][c] = to_f32(qs[(g + 8) * p.ldq + c]);
      }
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk) {
        const T* q0 = qs + g * p.ldq + kk * 16 + 2 * t4;
        const T* q1 = q0 + 8 * p.ldq;
        qa[kk][0] = ld_u32(q0);
        qa[kk][1] = ld_u32(q1);
        qa[kk][2] = ld_u32(q0 + 8);
        qa[kk][3] = ld_u32(q1 + 8);
      }
    }

    PROF_MARK(1);
    float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
    float acc[kDimN][4];
#pragma unroll
    for (int j = 0; j < kDimN; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

    for (int kb = 0; kb < k_end; kb += kBlockKeys) {
      float s[kScoreTiles][4];
      const int nk = min(SPLIT, (k_end - kb + kTileKeys - 1) / kTileKeys);
      // only the n-tiles of keys before k_end hold scores; the rest are
      // hidden (p = 0) and take no work
      const int valid = min(kBlockKeys, k_end - kb);
      const int nv = (valid + 7) >> 3;
      int kv_stage = 0;  // the block's K and V, when they come as a pair
      // -- the block's scores, tile by tile, masked
#pragma unroll
      for (int tb = 0; tb < SPLIT; ++tb) {
        if (tb < nk) {
          const int key0 = kb + tb * kTileKeys;
          int stage = 0;
          if (!p.resident) stage = kv_stage = acquire();
          const T* kt = ks_all + (region * p.stages + stage) * p.tk * p.ldk;
          const uint8_t* keep = keep_all + (region * p.stages + stage) * p.tk +
                                (p.resident ? key0 : 0);
          // the tile's rows in the buffer: key0 - tile base
          const int kbase = p.resident ? key0 : 0;
#pragma unroll
          for (int n = 0; n < kTileN; ++n) {
            float (&c)[4] = s[tb * kTileN + n];
            c[0] = c[1] = c[2] = c[3] = 0.0f;
            if (tb * kTileN + n >= nv) continue;
            const T* krow = kt + (kbase + n * 8) * p.ldk + dbase;
            if constexpr (kBf16) {
#pragma unroll
              for (int kk = 0; kk < DW / 16; ++kk) {
                const T* kp = krow + g * p.ldk + kk * 16 + 2 * t4;
                mma_bf16(c, qa[kk], ld_u32(kp), ld_u32(kp + 8));
              }
            } else {
              const float* q0 =
                  reinterpret_cast<const float*>(qs) + g * p.ldq;
              const float* q1 = q0 + 8 * p.ldq;
              const float* k0 =
                  reinterpret_cast<const float*>(krow) + 2 * t4 * p.ldk;
              const float* k1 = k0 + p.ldk;
#pragma unroll(kDimUnroll / 4)
              for (int d4 = 0; d4 < DW; d4 += 4) {
                float4 a0, a1;
                if constexpr (kQRegs) {
                  a0 = make_float4(qr[0][d4], qr[0][d4 + 1], qr[0][d4 + 2],
                                   qr[0][d4 + 3]);
                  a1 = make_float4(qr[1][d4], qr[1][d4 + 1], qr[1][d4 + 2],
                                   qr[1][d4 + 3]);
                } else {
                  a0 = *reinterpret_cast<const float4*>(q0 + d4);
                  a1 = *reinterpret_cast<const float4*>(q1 + d4);
                }
                const float4 b0 = *reinterpret_cast<const float4*>(k0 + d4);
                const float4 b1 = *reinterpret_cast<const float4*>(k1 + d4);
                c[0] = fmaf(a0.x, b0.x, fmaf(a0.y, b0.y, fmaf(a0.z, b0.z,
                       fmaf(a0.w, b0.w, c[0]))));
                c[1] = fmaf(a0.x, b1.x, fmaf(a0.y, b1.y, fmaf(a0.z, b1.z,
                       fmaf(a0.w, b1.w, c[1]))));
                c[2] = fmaf(a1.x, b0.x, fmaf(a1.y, b0.y, fmaf(a1.z, b0.z,
                       fmaf(a1.w, b0.w, c[2]))));
                c[3] = fmaf(a1.x, b1.x, fmaf(a1.y, b1.y, fmaf(a1.z, b1.z,
                       fmaf(a1.w, b1.w, c[3]))));
              }
            }
          }
          if constexpr (SPLIT > 1) {
            // the partial scores of the tile's dims, summed in warp order
            float4* mine = reinterpret_cast<float4*>(red) + ws * kTileN * 32;
#pragma unroll
            for (int n = 0; n < kTileN; ++n) {
              const float (&c)[4] = s[tb * kTileN + n];
              mine[n * 32 + lane] = make_float4(c[0], c[1], c[2], c[3]);
            }
            __syncthreads();
#pragma unroll
            for (int n = 0; n < kTileN; ++n) {
              float4 sum = reinterpret_cast<float4*>(red)[n * 32 + lane];
              for (int w = 1; w < SPLIT; ++w) {
                const float4 x =
                    reinterpret_cast<float4*>(red)[(w * kTileN + n) * 32 +
                                                   lane];
                sum.x += x.x;
                sum.y += x.y;
                sum.z += x.z;
                sum.w += x.w;
              }
              float (&c)[4] = s[tb * kTileN + n];
              c[0] = sum.x;
              c[1] = sum.y;
              c[2] = sum.z;
              c[3] = sum.w;
            }
          }
          // scale, then mask: past T or k_end, a hidden key, causal; a
          // tile that hides nothing from this warp's rows only scales
          const bool open = key0 + kTileKeys <= k_end && km == nullptr &&
                            (!p.causal || key0 + kTileKeys - 1 <= row0);
#pragma unroll
          for (int n = 0; n < kTileN; ++n) {
            float (&c)[4] = s[tb * kTileN + n];
            if (tb * kTileN + n >= nv) {
              c[0] = c[1] = c[2] = c[3] = kNeg;
              continue;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kl = n * 8 + 2 * t4 + (e & 1);  // key in the tile
              const int key = key0 + kl;
              const int row = row0 + g + (e >> 1) * 8;
              const bool hidden =
                  !open && (key >= k_end || !keep[kl] ||
                            (p.causal && key > row));
              c[e] = hidden ? kNeg : c[e] * p.scale;
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < kTileN; ++n) {
            float (&c)[4] = s[tb * kTileN + n];
            c[0] = c[1] = c[2] = c[3] = kNeg;
          }
        }
      }

      PROF_MARK(2);
      // -- the block's row max, p, its row sum; acc rescaled
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) {
        if (n >= nv) continue;
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float corr[2], lb[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = __expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) {
        if (n >= nv) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          const float pe = x <= kNeg * 0.5f ? 0.0f : __expf(x - m[e >> 1]);
          lb[e >> 1] += pe;
          s[n][e] = round_to<T>(pe);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 1);
        lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 2);
        l[r] = l[r] * corr[r] + lb[r];
      }
#pragma unroll
      for (int j = 0; j < kDimN; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      if constexpr (!kBf16) {
        // the f32 paths read p back by rows: this warp's 16 x 128 block
#pragma unroll
        for (int n = 0; n < kScoreTiles; ++n) {
          if (n >= nv) continue;
          *reinterpret_cast<float2*>(ps + g * kLdp + n * 8 + 2 * t4) =
              make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(ps + (g + 8) * kLdp + n * 8 + 2 * t4) =
              make_float2(s[n][2], s[n][3]);
        }
        __syncwarp();
      }

      PROF_MARK(3);
      // -- p v, tile by tile
#pragma unroll
      for (int tb = 0; tb < SPLIT; ++tb) {
        if (tb >= nk) continue;
        const int key0 = kb + tb * kTileKeys;
        int stage = 0;
        if (!p.resident) stage = kPairs ? kv_stage : acquire();
        const int kbase = p.resident ? key0 : 0;
        const T* vt = vs_all + (region * p.stages + stage) * p.tk * p.ldv +
                      dbase;
        if constexpr (kBf16) {
#pragma unroll
          for (int c16 = 0; c16 < kTileN / 2; ++c16) {
            const int kl = kbase + c16 * 16;
            // p is 0 past k_end, and past the staged rows
            if (tb * kTileKeys + c16 * 16 >= valid || kl >= p.tk) continue;
            const float* s0 = s[tb * kTileN + 2 * c16];
            const float* s1 = s[tb * kTileN + 2 * c16 + 1];
            const unsigned a[4] = {pack_bf16(s0[0], s0[1]),
                                   pack_bf16(s0[2], s0[3]),
                                   pack_bf16(s1[0], s1[1]),
                                   pack_bf16(s1[2], s1[3])};
            const T* vrow = vt + (kl + (lane & 15)) * p.ldv;
#pragma unroll
            for (int j = 0; j < kDimN; ++j) {
              unsigned b0, b1;
              ldmatrix_x2_trans(b0, b1, vrow + j * 8);
              mma_bf16(acc[j], a, b0, b1);
            }
          }
        } else {
          const float* pt = ps + tb * kTileKeys;
          // p comes from shared memory here, so the keys' loop need not
          // unroll in full: a smaller loop body stays in the instruction
          // cache
#pragma unroll 2
          for (int c8 = 0; c8 < kTileN; ++c8) {
            const int kl = kbase + c8 * 8;
            if (tb * kTileKeys + c8 * 8 >= valid || kl >= p.tk) continue;
            const float* p0 = pt + g * kLdp + c8 * 8;
            const float* p1 = p0 + 8 * kLdp;
#pragma unroll(kDimN > 2 ? 1 : 2)
            for (int i4 = 0; i4 < 8; i4 += 4) {
              const float4 pa = *reinterpret_cast<const float4*>(p0 + i4);
              const float4 pb = *reinterpret_cast<const float4*>(p1 + i4);
              const float pav[4] = {pa.x, pa.y, pa.z, pa.w};
              const float pbv[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float* vk = reinterpret_cast<const float*>(vt) +
                                  (kl + i4 + i) * p.ldv + 2 * t4;
#pragma unroll
                for (int j = 0; j < kDimN; ++j) {
                  const float2 x =
                      *reinterpret_cast<const float2*>(vk + j * 8);
                  acc[j][0] = fmaf(pav[i], x.x, acc[j][0]);
                  acc[j][1] = fmaf(pav[i], x.y, acc[j][1]);
                  acc[j][2] = fmaf(pbv[i], x.x, acc[j][2]);
                  acc[j][3] = fmaf(pbv[i], x.y, acc[j][3]);
                }
              }
            }
          }
        }
      }
      if constexpr (!kBf16) __syncwarp();  // ps is rewritten next block
      PROF_MARK(4);
    }

    // -- o = acc / l, lse = m + log l (a fully masked row: o = 0, kNeg)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (!active || row >= p.t) continue;
      const bool empty = l[r] == 0.0f;
      const float inv = 1.0f / (empty ? 1.0f : l[r]);
      T* orow = o + hoff + (long long)row * p.d;
#pragma unroll
      for (int j = 0; j < kDimN; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dim = dbase + j * 8 + 2 * t4 + e;
          if (dim < p.d) orow[dim] = from_f32<T>(acc[j][2 * r + e] * inv);
        }
      }
      if (ws == 0 && t4 == 0)
        lse[(long long)head * p.t + row] =
            empty ? kNeg : m[r] + logf(empty ? 1.0f : l[r]);
    }
    if (p.resident) __syncwarp();  // qs is rewritten for the next tile
    PROF_MARK(4);
  }
  PROF_FLUSH();
}

// -- the launch --------------------------------------------------------------

template <typename T, int SPLIT, int DW, int KEYS = kBlockKeys>
cudaError_t launch_one(const Plan& p, const void* q, const void* k,
                       const void* v, const uint8_t* km, void* o, void* lse,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, SPLIT, DW, KEYS>;
  cudaError_t err = allow_smem(kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  const int warps = p.units * (p.resident ? p.wph : SPLIT);
  kernel<<<p.grid, warps * 32, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), km, static_cast<T*>(o),
      static_cast<float*>(lse), p);
  return cudaGetLastError();
}

// The instance of the plan's (split, dw, keys), or cudaErrorInvalidValue
// where there is none.
template <typename T>
cudaError_t dispatch(const Plan& p, const void* q, const void* k,
                     const void* v, const uint8_t* km, void* o, void* lse,
                     cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (p.split == 1 && p.keys == 32) {  // T <= 32, D <= 16
    if constexpr (!kBf16) {
      if (p.dw == 8) return launch_one<T, 1, 8, 32>(p, q, k, v, km, o, lse, st);
    }
    if (p.dw == 16) return launch_one<T, 1, 16, 32>(p, q, k, v, km, o, lse, st);
  } else if (p.split == 1) {
    if constexpr (!kBf16) {  // bf16's k-step is 16 dims
      if (p.dw == 8) return launch_one<T, 1, 8>(p, q, k, v, km, o, lse, st);
    }
    if (p.dw == 16) return launch_one<T, 1, 16>(p, q, k, v, km, o, lse, st);
    if (p.dw == 32) return launch_one<T, 1, 32>(p, q, k, v, km, o, lse, st);
    if (p.dw == 64) return launch_one<T, 1, 64>(p, q, k, v, km, o, lse, st);
  } else if (p.dw == 64) {
    if (p.split == 2) return launch_one<T, 2, 64>(p, q, k, v, km, o, lse, st);
    if (p.split == 4) return launch_one<T, 4, 64>(p, q, k, v, km, o, lse, st);
    if (p.split == 8) return launch_one<T, 8, 64>(p, q, k, v, km, o, lse, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* key_mask,
           void* o, void* lse, int bn, int n_heads, int t, int d, int causal,
           float scale, int device, void* stream) {
  Plan p;
  const int item = (int)sizeof(T);
  if (fmda_flash::plan(bn, n_heads, t, d, item, &p) != 0)
    return (int)cudaErrorInvalidValue;
  p.bn = bn;
  p.n_heads = n_heads;
  p.t = t;
  p.d = d;
  p.causal = causal != 0;
  p.scale = scale;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  p.vec = (d * item) % 16 == 0 && align % 16 == 0;
  return (int)dispatch<T>(p, q, k, v, static_cast<const uint8_t*>(key_mask),
                          o, lse, reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interface for ctypes.  q, k, v and o are contiguous (B*N, T, D) in
// the I/O dtype, lse contiguous (B*N, T) float32, key_mask a contiguous
// (B, T) uint8 or null; the launch is laid out by fmda_flash::plan.  Returns
// cudaGetLastError() after the launch (0 = success); cudaErrorInvalidValue
// outside the envelope.
extern "C" int fmda_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* o, void* lse,
                                  int bn, int n_heads, int t, int d,
                                  int causal, float scale, int device,
                                  void* stream) {
  return launch<float>(q, k, v, key_mask, o, lse, bn, n_heads, t, d, causal,
                       scale, device, stream);
}

extern "C" int fmda_flash_fwd_bf16(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* o, void* lse, int bn, int n_heads,
                                   int t, int d, int causal, float scale,
                                   int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, key_mask, o, lse, bn, n_heads, t, d,
                               causal, scale, device, stream);
}

#ifdef FMDA_PROFILE_SWEEP
// The forward's clock marks (scan_common.cuh's SweepProfile), per part: 0
// the set-up and resident staging, 1 the q tile, 2 the scores and masks
// (the K tiles' waits included), 3 the softmax, 4 p v and the stores (the V
// tiles' waits included).
extern "C" int fmda_flash_fwd_prof(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_sweep_prof, sizeof(g_sweep_prof));
}
#endif
