// The flash backward's warp-tile steps, shared by the fused kernel
// (flash_bwd.cu) and the dK/dV and dQ sweeps (flash_attn.cu), all on the
// forward's mma fragment layout (flash_mma.cuh).
//
// A warp owns a 16-row tile (rows g and g + 8 of each fragment) of the
// axis it owns and takes the other axis 16 rows at a time:
//   - the dK/dV step computes s^T = k q^T and dp^T = v do^T with keys as
//     rows, so p^T and ds^T land in the accumulator layout and go straight
//     into the A fragments of p^T do and ds^T q (dv, dk);
//   - the dQ step computes s = q k^T and dp = do v^T, and ds goes into the
//     A fragment of ds k (dq).
// bf16: every product is mma.sync m16n8k16 with float32 accumulation (the
// B fragments of do, q and k, taken along their rows, through
// ldmatrix.trans).  float32: an FFMA micro-tile computes the same
// fragments, its A rows from registers (DW <= 16) or shared memory, and
// p and ds go through a per-warp buffer for the second products.  Where D
// > 64, SPLIT warps share a tile, each DW = 64 dims, and sum their partial
// s and dp through shared memory in warp order, so every warp of the tile
// holds the same sums.
//
// The Pallas arithmetic: a hidden score (a key the mask hides, past T,
// after the query under causal) has p = 0, a visible one p = exp(s scale -
// lse) (prob); p and ds = p (dp - delta) scale are rounded to the I/O
// dtype before their products (bf16: by the packing into A fragments, or
// the store of ds, round to nearest even either way); every sum is
// float32 in one fixed order.

#pragma once

#include "flash_bwd_plan.h"
#include "flash_mma.cuh"

namespace fmda_flash_bwd {

constexpr float kLog2e = 1.4426950408889634f;

// The launch's plan and the call it runs; scale_log2 = scale log2 e.
struct Plan : Geometry {
  int bn, n_heads, t, d, causal, vec;
  float scale, scale_log2;
};

// The call's tensors: q, k, v, do and the gradients (B*N, T, D) in T, lse
// and delta (B*N, T) float32, the key mask (B, T) uint8 or null.
template <typename T>
struct Args {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* key_mask;
  T *dq, *dk, *dv;
};

// The plan of a call, its own fields filled in; false outside the
// envelope.  `vec`: rows of whole 16-byte chunks, every matrix aligned.
inline bool make_plan(int bn, int n_heads, int t, int d, int causal,
                      float scale, int item, int sweeps, const void* q,
                      const void* k, const void* v, const void* dout,
                      Plan* p) {
  if (plan(bn, n_heads, t, d, item, sweeps, p) != 0) return false;
  p->bn = bn;
  p->n_heads = n_heads;
  p->t = t;
  p->d = d;
  p->causal = causal != 0;
  p->scale = scale;
  p->scale_log2 = scale * kLog2e;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  p->vec = (d * item) % 16 == 0 && align % 16 == 0;
  return true;
}

// -- staging -----------------------------------------------------------------

__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += blockDim.x)
    reinterpret_cast<float4*>(p)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Entries [row0, row0 + n) of a head's float32 vector (lse, delta) by
// cp.async, zero past T.
__device__ __forceinline__ void stage_vec(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int n, int t) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const bool live = row0 + e < t;
    cp_async4(dst + e, src + (live ? row0 + e : 0), live ? 4 : 0);
  }
}

// The queries that keys g and g + 8 of a warp's tile are visible to:
// [lo, lo + span), the span 0 where the key is hidden or past T; from the
// tile's 16 key flags.
struct KeySpan {
  int lo[2];
  unsigned span[2];
  __device__ __forceinline__ KeySpan(const uint8_t* keep, int key0,
                                     const Plan& p, int lane) {
    const int g = lane >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = p.causal ? key0 + g + 8 * r : 0;
      span[r] = keep[g + 8 * r] ? (unsigned)(p.t - lo[r]) : 0u;
    }
  }
};

// -- the products --------------------------------------------------------------

// A warp's 16 rows of an operand in shared memory, as the score products
// read them: bf16 the A fragments of its DW / 16 k-steps; f32 at DW <= 16
// rows g and g + 8 in registers, wider f32 from shared memory.
template <typename T, int DW>
struct RowsA {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kRegs = !kBf16 && DW <= 16;
  unsigned a[kBf16 ? DW / 16 : 1][4];
  float r[2][kRegs ? DW : 1];
  const float* rows;  // f32: row g at the warp's first dim
  int ld;

  // `tile`: row 0 of the 16 rows at the warp's first dim, rows `ld_`
  // elements apart.
  __device__ __forceinline__ void load(const T* tile, int ld_, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
    ld = ld_;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk) {
        const T* r0 = tile + g * ld + kk * 16 + 2 * t4;
        const T* r1 = r0 + 8 * ld;
        a[kk][0] = ld_u32(r0);
        a[kk][1] = ld_u32(r1);
        a[kk][2] = ld_u32(r0 + 8);
        a[kk][3] = ld_u32(r1 + 8);
      }
    } else {
      rows = reinterpret_cast<const float*>(tile) + g * ld;
      if constexpr (kRegs) {
#pragma unroll
        for (int c = 0; c < DW; ++c) {
          r[0][c] = rows[c];
          r[1][c] = rows[8 * ld + c];
        }
      }
    }
  }
};

// c = rows . cols^T over the warp's DW dims: a 16 x 16 tile as two
// 8-column accumulators.  `cols`: row 0 of 16 rows of a shared tile at the
// warp's first dim, `ld` elements apart.
template <typename T, int DW>
__device__ __forceinline__ void scores16(float (&c)[2][4],
                                         const RowsA<T, DW>& a,
                                         const T* __restrict__ cols, int ld,
                                         int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (RowsA<T, DW>::kBf16) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk) {
        const T* kp = cols + (n * 8 + g) * ld + kk * 16 + 2 * t4;
        mma_bf16(c[n], a.a[kk], ld_u32(kp), ld_u32(kp + 8));
      }
    }
  } else {
    const float* q0 = a.rows;
    const float* q1 = q0 + 8 * a.ld;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float* k0 = reinterpret_cast<const float*>(cols) +
                        (n * 8 + 2 * t4) * ld;
      const float* k1 = k0 + ld;
#pragma unroll(DW <= 16 ? DW / 4 : 4)
      for (int d4 = 0; d4 < DW; d4 += 4) {
        float4 a0, a1;
        if constexpr (RowsA<T, DW>::kRegs) {
          a0 = make_float4(a.r[0][d4], a.r[0][d4 + 1], a.r[0][d4 + 2],
                           a.r[0][d4 + 3]);
          a1 = make_float4(a.r[1][d4], a.r[1][d4 + 1], a.r[1][d4 + 2],
                           a.r[1][d4 + 3]);
        } else {
          a0 = *reinterpret_cast<const float4*>(q0 + d4);
          a1 = *reinterpret_cast<const float4*>(q1 + d4);
        }
        const float4 b0 = *reinterpret_cast<const float4*>(k0 + d4);
        const float4 b1 = *reinterpret_cast<const float4*>(k1 + d4);
        c[n][0] = fmaf(a0.w, b0.w, fmaf(a0.z, b0.z, fmaf(a0.y, b0.y,
                  fmaf(a0.x, b0.x, c[n][0]))));
        c[n][1] = fmaf(a0.w, b1.w, fmaf(a0.z, b1.z, fmaf(a0.y, b1.y,
                  fmaf(a0.x, b1.x, c[n][1]))));
        c[n][2] = fmaf(a1.w, b0.w, fmaf(a1.z, b0.z, fmaf(a1.y, b0.y,
                  fmaf(a1.x, b0.x, c[n][2]))));
        c[n][3] = fmaf(a1.w, b1.w, fmaf(a1.z, b1.z, fmaf(a1.y, b1.y,
                  fmaf(a1.x, b1.x, c[n][3]))));
      }
    }
  }
}

// Entry i of the SPLIT warps' partial sums in `red`, added in warp order
// into c.
template <int SPLIT>
__device__ __forceinline__ void sum_partials(float (&c)[4],
                                             const float4* red, int i,
                                             int lane) {
  float4 sum = red[i * 32 + lane];
  // one partial in flight at a time: unrolled, eight split warps' loads
  // spill the registers dk and dv hold
#pragma unroll 1
  for (int w = 1; w < SPLIT; ++w) {
    const float4 x = red[(w * 4 + i) * 32 + lane];
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  c[0] = sum.x;
  c[1] = sum.y;
  c[2] = sum.z;
  c[3] = sum.w;
}

// The SPLIT warps of a tile each hold s and dp over their dims: sum them
// in warp order through `red` (the unit's [SPLIT][4][32] float4s), so that
// every warp of the tile holds the same sums.  Two CTA barriers; nothing
// where SPLIT = 1.
template <int SPLIT>
__device__ __forceinline__ void split_sum(float (&s)[2][4], float (&dp)[2][4],
                                          float4* red, int ws, int lane) {
  if constexpr (SPLIT > 1) {
    float4* mine = red + ws * 4 * 32;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mine[n * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      mine[(2 + n) * 32 + lane] =
          make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      sum_partials<SPLIT>(s[n], red, n, lane);
      sum_partials<SPLIT>(dp[n], red, 2 + n, lane);
    }
    __syncthreads();  // `red` is rewritten by the next step
  }
}

// The A fragment of a 16 x 16 tile held as two 8-column accumulators.
__device__ __forceinline__ void pack_frag(unsigned (&a)[4],
                                          const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// bf16: acc += A (16 x 16, fragment `a`) times 16 rows of a shared tile at
// the warp's first dim (`b`, `ld` elements apart), its B fragments through
// ldmatrix.trans.
template <typename T, int DW>
__device__ __forceinline__ void mma_rows(float (&acc)[DW / 8][4],
                                         const unsigned (&a)[4],
                                         const T* __restrict__ b, int ld,
                                         int lane) {
  const T* brow = b + (lane & 15) * ld;
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
    unsigned b0, b1;
    ldmatrix_x2_trans(b0, b1, brow + j * 8);
    mma_bf16(acc[j], a, b0, b1);
  }
}

// f32: acc += A (16 x 16: rows g and g + 8 of `a`, `lda` floats apart)
// times 16 rows of a shared tile at the warp's first dim.
template <int DW>
__device__ __forceinline__ void ffma_rows(float (&acc)[DW / 8][4],
                                          const float* __restrict__ a,
                                          int lda,
                                          const float* __restrict__ b, int ld,
                                          int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const float* p0 = a + g * lda;
  const float* p1 = p0 + 8 * lda;
#pragma unroll(DW <= 16 ? 4 : 1)
  for (int i4 = 0; i4 < kTile; i4 += 4) {
    const float4 pa = *reinterpret_cast<const float4*>(p0 + i4);
    const float4 pb = *reinterpret_cast<const float4*>(p1 + i4);
    const float pav[4] = {pa.x, pa.y, pa.z, pa.w};
    const float pbv[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* bk = b + (i4 + i) * ld + 2 * t4;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(bk + j * 8);
        acc[j][0] = fmaf(pav[i], x.x, acc[j][0]);
        acc[j][1] = fmaf(pav[i], x.y, acc[j][1]);
        acc[j][2] = fmaf(pbv[i], x.x, acc[j][2]);
        acc[j][3] = fmaf(pbv[i], x.y, acc[j][3]);
      }
    }
  }
}

// f32: a 16 x 16 tile from its accumulators into rows [16][kLdw] of `w`.
__device__ __forceinline__ void put_tile(float* __restrict__ w,
                                         const float (&x)[2][4], int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    *reinterpret_cast<float2*>(w + g * kLdw + n * 8 + 2 * t4) =
        make_float2(x[n][0], x[n][1]);
    *reinterpret_cast<float2*>(w + (g + 8) * kLdw + n * 8 + 2 * t4) =
        make_float2(x[n][2], x[n][3]);
  }
}

// -- the steps ---------------------------------------------------------------

// p of a visible score (s the raw product q . k) against its query's lse.
// float32 rounds as the plain version does (s scale, minus lse, an
// accurate exp): over T = 1024 keys the float32 sums leave little of the
// 1e-5 tolerance to a faster exp.  bf16 takes 2^x on the SFU, the scale
// and lse folded into one FMA.
template <typename T>
__device__ __forceinline__ float prob(float s, float lse, const Plan& p) {
  if constexpr (std::is_same<T, float>::value)
    return expf(__fsub_rn(__fmul_rn(s, p.scale), lse));
  else
    return ex2_approx(fmaf(s, p.scale_log2, -lse * kLog2e));
}

// One step of dK/dV for the warp's 16 keys against 16 queries: s^T = k q^T
// and dp^T = v do^T, p^T and ds^T, then dv += p^T do and dk += ds^T q.
// `qt`, `dot`: the queries' rows of q and do at the warp's first dim;
// `lse`, `delta`: theirs; `ks`: the queries the warp's keys see.  ds^T
// stays in `ds`, float32 before its rounding to T, for a caller that
// keeps it.
template <typename T, int SPLIT, int DW>
__device__ __forceinline__ void dkv_step(
    const RowsA<T, DW>& ka, const RowsA<T, DW>& va, const T* qt,
    const T* dot, const float* __restrict__ lse,
    const float* __restrict__ delta, int query0, const KeySpan& ks,
    const Plan& p, float (&dk)[DW / 8][4], float (&dv)[DW / 8][4],
    float (&ds)[2][4], float* buf, float4* red, int ws, int lane) {
  const int t4 = lane & 3;
  float s[2][4];
  scores16<T, DW>(s, ka, qt, p.ld, lane);
  scores16<T, DW>(ds, va, dot, p.ld, lane);  // dp^T, until ds^T replaces it
  split_sum<SPLIT>(s, ds, red, ws, lane);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    // this lane's two queries of the n-tile
    const int col = n * 8 + 2 * t4;
    const float2 ls = *reinterpret_cast<const float2*>(lse + col);
    const float2 dl = *reinterpret_cast<const float2*>(delta + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      const bool hidden =
          (unsigned)(query0 + col + odd - ks.lo[r]) >= ks.span[r];
      const float pe =
          hidden ? 0.0f : prob<T>(s[n][e], odd ? ls.y : ls.x, p);
      ds[n][e] = pe * (ds[n][e] - (odd ? dl.y : dl.x)) * p.scale;
      s[n][e] = pe;
    }
  }
  if constexpr (RowsA<T, DW>::kBf16) {
    unsigned a[4];
    pack_frag(a, s);
    mma_rows<T, DW>(dv, a, dot, p.ld, lane);
    pack_frag(a, ds);
    mma_rows<T, DW>(dk, a, qt, p.ld, lane);
  } else {
    float* pb = buf;
    float* db = buf + kTile * kLdw;
    put_tile(pb, s, lane);
    put_tile(db, ds, lane);
    __syncwarp();
    ffma_rows<DW>(dv, pb, kLdw, reinterpret_cast<const float*>(dot), p.ld,
                  lane);
    ffma_rows<DW>(dk, db, kLdw, reinterpret_cast<const float*>(qt), p.ld,
                  lane);
    __syncwarp();  // the buffer is rewritten by the next step
  }
}

// One step of dQ for the warp's 16 queries against 16 keys: s = q k^T and
// dp = do v^T, p and ds as dkv_step's, then dq += ds k.  `kt`, `vt`: the
// keys' rows of k and v at the warp's first dim; `keep`: their flags
// (2-byte aligned); `lse`, `delta`: the warp's rows g and g + 8.
template <typename T, int SPLIT, int DW>
__device__ __forceinline__ void dq_step(
    const RowsA<T, DW>& qa, const RowsA<T, DW>& doa, const T* kt,
    const T* vt, const uint8_t* __restrict__ keep, const float (&lse)[2],
    const float (&delta)[2], int query0, int key0, const Plan& p,
    float (&dq)[DW / 8][4], float* buf, float4* red, int ws, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float s[2][4], ds[2][4];
  scores16<T, DW>(s, qa, kt, p.ld, lane);
  scores16<T, DW>(ds, doa, vt, p.ld, lane);  // dp, until ds replaces it
  split_sum<SPLIT>(s, ds, red, ws, lane);
  // causal: a row sees the columns up to its own query
  int last[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    last[r] = p.causal ? query0 + g + 8 * r - key0 : kTile;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = n * 8 + 2 * t4;
    const unsigned flags = *reinterpret_cast<const uint16_t*>(keep + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, odd = e & 1;
      const bool hidden = !((flags >> (8 * odd)) & 0xffu) ||
                          col + odd > last[r];
      const float pe = hidden ? 0.0f : prob<T>(s[n][e], lse[r], p);
      ds[n][e] = pe * (ds[n][e] - delta[r]) * p.scale;
    }
  }
  if constexpr (RowsA<T, DW>::kBf16) {
    unsigned a[4];
    pack_frag(a, ds);
    mma_rows<T, DW>(dq, a, kt, p.ld, lane);
  } else {
    put_tile(buf, ds, lane);
    __syncwarp();
    ffma_rows<DW>(dq, buf, kLdw, reinterpret_cast<const float*>(kt), p.ld,
                  lane);
    __syncwarp();
  }
}

template <int DW>
__device__ __forceinline__ void zero_acc(float (&acc)[DW / 8][4]) {
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
}

// Rows row0 + g and row0 + g + 8 of a head's (T, D) gradient, at dims
// dbase + ..., from the accumulators; nothing past T or past D.  A lane's
// two neighbouring dims go as one store where D is even (the pair then
// aligned).
template <typename T, int DW>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[DW / 8][4],
                                           int row0, int dbase, const Plan& p,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.t) continue;
    T* o = out + (long long)row * p.d;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int dim = dbase + j * 8 + 2 * t4;
      const float x0 = acc[j][2 * r], x1 = acc[j][2 * r + 1];
      if (p.d % 2 == 0 && dim + 1 < p.d) {
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(o + dim) = make_float2(x0, x1);
        else
          *reinterpret_cast<unsigned*>(o + dim) = pack_bf16(x0, x1);
      } else {
        if (dim < p.d) o[dim] = from_f32<T>(x0);
        if (dim + 1 < p.d) o[dim + 1] = from_f32<T>(x1);
      }
    }
  }
}

}  // namespace fmda_flash_bwd
