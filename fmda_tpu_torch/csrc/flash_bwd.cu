// The flash-attention backward in one launch for NVIDIA Hopper (sm_90a),
// where a CTA holds whole heads (T <= 128, D <= 64: the model's (256, 4,
// 30, 8) among them), bound to PyTorch via ctypes by
// fmda_tpu_torch/ops/attention_kernel.py (the library is built by
// fmda_tpu_torch/ops/_cuda_lib.py).  Elsewhere the same entry runs
// flash_attn.cu's two sweeps; the plan (flash_bwd_plan.cc) decides, by
// shape alone.
//
// Replaces both backward Pallas kernels of
// fmda_tpu/ops/pallas_attention.py, _dkv_kernel and _dq_kernel, with one
// kernel, flash_bwd_kernel: dq, dk and dv of (B*N, T, D) q, k, v in the I/O
// dtype from do, the forward's lse and delta = rowsum(do o) - dlse, with
// scale = 1/sqrt(D):
//
//   p = exp(s - lse)   dv = p^T do   ds = p (do v^T - delta) scale
//   dk = ds^T q        dq = ds k
//
// The arithmetic is the sweeps' (flash_bwd_common.cuh): p of a hidden
// score exactly 0, p and ds rounded to the I/O dtype before their
// products, every sum float32 in one fixed order (no atomics: the same
// bits from run to run).
//
// Design.  The two sweeps each recompute s and p, and each reads q, k, v
// and do.  Here a CTA holds up to four whole (b*n) heads: their q, k, v,
// do, lse, delta and key flags staged once into shared memory (cp.async,
// zero-filled past T and past D), and `wph` warps a head.
//   1. Each warp owns key tiles w, w + wph, ... of its head and walks the
//      query tiles (from its own under causal) with the sweep's dK/dV step:
//      s^T = k q^T and dp^T = v do^T with keys as rows, so p^T and ds^T go
//      from the accumulators into p^T do and ds^T q (mma.sync in bf16, the
//      FFMA micro-tile in float32).  It writes dk and dv, and keeps ds^T in
//      shared memory as ds [query][key], rounded to the I/O dtype.
//   2. After one CTA barrier each warp owns query tiles w, w + wph, ... and
//      forms dq = ds k from the kept ds (its A fragments read straight from
//      the rows of ds, k's B fragments through ldmatrix.trans).
// One launch, one read of the inputs, s and dp computed once.
//
// What bounds it.  At the model's (1024, 30, 8) the backward reads q, k, v,
// do, lse and delta and writes dq, dk and dv once: 7.1 MB, 2.1 us at 3.35
// TB/s, against ~27 MFLOP; so it sits near a CTA's own chain of staging,
// the two phases and the stores, and the design's job is one launch of
// few, full CTAs (256 CTAs of four heads, eight warps, one tile a warp in
// each phase).

#include "flash_bwd_common.cuh"

// flash_attn.cu's sweeps, which this entry runs outside the fused envelope.
extern "C" int fmda_flash_dkv_f32(const void*, const void*, const void*,
                                  const void*, const void*, const void*,
                                  const void*, void*, void*, int, int, int,
                                  int, int, float, int, void*);
extern "C" int fmda_flash_dkv_bf16(const void*, const void*, const void*,
                                   const void*, const void*, const void*,
                                   const void*, void*, void*, int, int, int,
                                   int, int, float, int, void*);
extern "C" int fmda_flash_dq_f32(const void*, const void*, const void*,
                                 const void*, const void*, const void*,
                                 const void*, void*, int, int, int, int, int,
                                 float, int, void*);
extern "C" int fmda_flash_dq_bf16(const void*, const void*, const void*,
                                  const void*, const void*, const void*,
                                  const void*, void*, int, int, int, int, int,
                                  float, int, void*);

namespace {

using namespace fmda_flash_bwd;

// One head's regions in shared memory: q, k, v, do [rows][ld], ds
// [rows][ldd], lse and delta [rows], the key flags [rows].
template <typename T>
struct Head {
  T *q, *k, *v, *dout, *ds;
  float *lse, *delta;
  uint8_t* keep;
  __device__ __forceinline__ Head(unsigned char* smem, const Plan& p,
                                  int unit) {
    q = reinterpret_cast<T*>(smem + unit * p.unit_bytes);
    k = q + p.rows * p.ld;
    v = k + p.rows * p.ld;
    dout = v + p.rows * p.ld;
    ds = dout + p.rows * p.ld;
    lse = reinterpret_cast<float*>(ds + p.rows * p.ldd);
    delta = lse + p.rows;
    keep = reinterpret_cast<uint8_t*>(delta + p.rows);
  }
};

// grid (plan.grid), units * wph warps.  CTA c holds heads c * units + u,
// one a unit; warp w of a unit owns the head's key tiles w, w + wph, ...,
// then its query tiles w, w + wph, ....  At DW = 8 (the model's float32
// heads) two CTAs of 256 threads share an SM: 128 registers a thread, or
// the model's 256 CTAs take two waves.
template <typename T, int DW>
__global__ void __launch_bounds__(kMaxThreads, DW <= 8 ? 2 : 1)
    flash_bwd_kernel(Args<T> a, Plan p) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int unit = warp / p.wph, sub = warp - unit * p.wph;
  const int n_tiles = p.rows / kTile;
  float* const buf = reinterpret_cast<float*>(smem + p.off_buf) +
                     warp * 2 * kTile * kLdw;

  if (p.d < DW) {  // columns past D read as zeros
    zero_smem(smem, p.units * p.unit_bytes);
    __syncthreads();
  }
  for (int r = 0; r < p.units; ++r) {
    const int h = blockIdx.x * p.units + r;
    if (h >= p.bn) continue;
    const Head<T> hs(smem, p, r);
    const long long off = (long long)h * p.t * p.d;
    stage_rows<T>(hs.q, p.ld, a.q + off, 0, p.rows, p.t, p.d, p.vec);
    stage_rows<T>(hs.k, p.ld, a.k + off, 0, p.rows, p.t, p.d, p.vec);
    stage_rows<T>(hs.v, p.ld, a.v + off, 0, p.rows, p.t, p.d, p.vec);
    stage_rows<T>(hs.dout, p.ld, a.dout + off, 0, p.rows, p.t, p.d, p.vec);
    stage_vec(hs.lse, a.lse + (long long)h * p.t, 0, p.rows, p.t);
    stage_vec(hs.delta, a.delta + (long long)h * p.t, 0, p.rows, p.t);
    stage_keep(hs.keep,
               a.key_mask == nullptr
                   ? nullptr
                   : a.key_mask + (long long)(h / p.n_heads) * p.t,
               0, p.rows, p.t);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int head = blockIdx.x * p.units + unit;
  const bool active = head < p.bn;
  const Head<T> hs(smem, p, unit);
  const long long hoff = (long long)(active ? head : 0) * p.t * p.d;

  // 1. dk and dv a key tile, ds kept
  for (int kt = sub; active && kt < n_tiles; kt += p.wph) {
    const int key0 = kt * kTile;
    RowsA<T, DW> ka, va;
    ka.load(hs.k + key0 * p.ld, p.ld, lane);
    va.load(hs.v + key0 * p.ld, p.ld, lane);
    const KeySpan ksp(hs.keep + key0, key0, p, lane);
    float dk[DW / 8][4], dv[DW / 8][4], ds[2][4];
    zero_acc<DW>(dk);
    zero_acc<DW>(dv);
    // causal: no query before the tile's first key sees it
    for (int qt = p.causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      dkv_step<T, 1, DW>(ka, va, hs.q + q0 * p.ld, hs.dout + q0 * p.ld,
                         hs.lse + q0, hs.delta + q0, q0, ksp, p, dk, dv, ds,
                         buf, nullptr, 0, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hs.ds[(q0 + n * 8 + 2 * t4 + (e & 1)) * p.ldd + key0 + g +
                8 * (e >> 1)] = from_f32<T>(ds[n][e]);
      }
    }
    store_rows<T, DW>(a.dk + hoff, dk, key0, 0, p, lane);
    store_rows<T, DW>(a.dv + hoff, dv, key0, 0, p, lane);
  }
  __syncthreads();  // every key tile's ds is kept

  // 2. dq = ds k a query tile
  for (int qt = sub; active && qt < n_tiles; qt += p.wph) {
    const int q0 = qt * kTile;
    float dq[DW / 8][4];
    zero_acc<DW>(dq);
    // causal: no key after the tile's last query is seen by it
    const int k_tiles = p.causal ? qt + 1 : n_tiles;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const T* drow = hs.ds + q0 * p.ldd + kt * kTile;
      const T* krows = hs.k + kt * kTile * p.ld;
      if constexpr (kBf16) {
        const T* d0 = drow + g * p.ldd + 2 * t4;
        const T* d1 = d0 + 8 * p.ldd;
        const unsigned af[4] = {ld_u32(d0), ld_u32(d1), ld_u32(d0 + 8),
                                ld_u32(d1 + 8)};
        mma_rows<T, DW>(dq, af, krows, p.ld, lane);
      } else {
        ffma_rows<DW>(dq, reinterpret_cast<const float*>(drow), p.ldd,
                      reinterpret_cast<const float*>(krows), p.ld, lane);
      }
    }
    store_rows<T, DW>(a.dq + hoff, dq, q0, 0, p, lane);
  }
}

// -- the launch --------------------------------------------------------------

template <typename T, int DW>
cudaError_t launch_one(const Plan& p, const Args<T>& a, cudaStream_t stream) {
  auto kernel = flash_bwd_kernel<T, DW>;
  const cudaError_t err = allow_smem(kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* key_mask,
           void* dq, void* dk, void* dv, int bn, int n_heads, int t, int d,
           int causal, float scale, int device, void* stream, int* fused) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  Plan p;
  if (!make_plan(bn, n_heads, t, d, causal, scale, (int)sizeof(T),
                 /*sweeps=*/0, q, k, v, dout, &p))
    return (int)cudaErrorInvalidValue;
  *fused = p.fused;
  if (!p.fused) {
    const int err = (kBf16 ? fmda_flash_dkv_bf16 : fmda_flash_dkv_f32)(
        q, k, v, dout, lse, delta, key_mask, dk, dv, bn, n_heads, t, d,
        causal, scale, device, stream);
    if (err != 0) return err;
    return (kBf16 ? fmda_flash_dq_bf16 : fmda_flash_dq_f32)(
        q, k, v, dout, lse, delta, key_mask, dq, bn, n_heads, t, d, causal,
        scale, device, stream);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args<T> a{static_cast<const T*>(q),
                  static_cast<const T*>(k),
                  static_cast<const T*>(v),
                  static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const uint8_t*>(key_mask),
                  static_cast<T*>(dq),
                  static_cast<T*>(dk),
                  static_cast<T*>(dv)};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  err = cudaErrorInvalidValue;
  if constexpr (!kBf16) {  // bf16's k-step is 16 dims
    if (p.dw == 8) err = launch_one<T, 8>(p, a, st);
  }
  if (p.dw == 16) err = launch_one<T, 16>(p, a, st);
  if (p.dw == 32) err = launch_one<T, 32>(p, a, st);
  if (p.dw == 64) err = launch_one<T, 64>(p, a, st);
  return (int)err;
}

}  // namespace

// Plain C interface for ctypes: dq, dk and dv in one call.  q, k, v, do and
// the gradients are contiguous (B*N, T, D) in the I/O dtype; lse and delta
// contiguous (B*N, T) float32; key_mask a contiguous (B, T) uint8 or null.
// *fused is set to 1 where the fused kernel ran (one launch), 0 where the
// two sweeps did (two launches).  Returns cudaGetLastError() after the
// launches (0 = success); cudaErrorInvalidValue outside the envelope.
extern "C" int fmda_flash_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* key_mask,
                                  void* dq, void* dk, void* dv, int bn,
                                  int n_heads, int t, int d, int causal,
                                  float scale, int device, void* stream,
                                  int* fused) {
  return launch<float>(q, k, v, dout, lse, delta, key_mask, dq, dk, dv, bn,
                       n_heads, t, d, causal, scale, device, stream, fused);
}

extern "C" int fmda_flash_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* key_mask, void* dq, void* dk,
                                   void* dv, int bn, int n_heads, int t,
                                   int d, int causal, float scale, int device,
                                   void* stream, int* fused) {
  return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, key_mask, dq, dk,
                               dv, bn, n_heads, t, d, causal, scale, device,
                               stream, fused);
}
