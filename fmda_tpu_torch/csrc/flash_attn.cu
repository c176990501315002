// Flash attention's dK/dV and dQ sweeps for NVIDIA Hopper (sm_90a), bound to
// PyTorch via ctypes by fmda_tpu_torch/ops/attention_kernel.py (the library
// is built by fmda_tpu_torch/ops/_cuda_lib.py; the forward, whose o and lse
// they read, is flash_fwd.cu's, and the fused backward that takes their
// place where a CTA holds whole heads is flash_bwd.cu's).
//
// Replaces two Pallas TPU kernels of fmda_tpu/ops/pallas_attention.py:
//   _dkv_kernel  (dK/dV sweep)    -> flash_dkv_kernel
//   _dq_kernel   (dQ sweep)       -> flash_dq_kernel
// on (B*N, T, D) q, k, v in the I/O dtype, with scale = 1/sqrt(D) and
// delta = rowsum(do o) - dlse computed outside:
//
//   p = exp(s - lse)   dv += p^T do   ds = p (dp - delta) scale, dp = do v^T
//   dk += ds^T q       dq += ds k
//
// The same arithmetic as the Pallas kernels (flash_bwd_common.cuh): p of a
// hidden score is exactly 0, p and ds are rounded to the I/O dtype before
// their products, and dk, dv, dq and every product accumulate in float32.
// The envelope is wider than the Pallas kernels' (T % 128 == 0, no mask):
// any T >= 1 (the last tiles ragged and masked), D <= 512, causal or not,
// and an optional (B, T) uint8 key mask (0 = the key is hidden from every
// query of that batch row).
//
// Design.  The TPU kernels walk a sequential (B*N, q block, k block) grid
// and carry their sums across it in VMEM scratch.  Here a CTA owns `units`
// consecutive 16-row tiles of one head, a warp a tile (`split` warps a
// tile where D > 64, each 64 dims), and walks the other axis itself, in
// the forward's fragment layout (flash_bwd_common.cuh's steps):
//   - the dK/dV sweep owns key tiles, holds their k and v as A operands
//     (mma fragments in bf16) and computes s^T = k q^T with keys as rows,
//     so p^T and ds^T feed p^T do and ds^T q from the accumulators; the dQ
//     sweep owns query tiles and forms s = q k^T, then ds k;
//   - the walked rows (q, do, lse and delta; or k, v and the key flags)
//     are staged in chunks by cp.async, double-buffered where they fit,
//     zero-filled past T and past D;
//   - causal CTAs skip the chunks that see none of their rows (the dK/dV
//     sweep starts at its first key, the dQ sweep stops at its last
//     query), and a warp of one tile (split 1) skips the steps that see
//     none of its own;
//   - every output element is owned by one lane and summed in one fixed
//     order: no atomics, the same result from run to run.
// The plan (tiles, warps, chunks, stages, the shared-memory layout) is
// flash_bwd_plan.cc's, the same one the fused kernel's launch reads.
//
// What bounds them.  At the long-context (64, 1024, 8) the work is the
// products: 4 (dK/dV) and 3 (dQ) of 2 D FLOPs a visible pair, 1.1 and 0.8
// GFLOP, 16 and 12 us at the 67 TFLOP/s float32 rate, beside 67M
// exponentials a sweep; float32 runs them on FFMA, bf16 on the tensor
// cores.  At D = 512 the partial scores' sums through shared memory (two
// CTA barriers a step) come beside them.  At the model's (1024, 30, 8) the
// sweeps move ~8 MB, far below a launch: there the fused kernel runs.

#include "flash_bwd_common.cuh"

namespace {

using namespace fmda_flash_bwd;

// The buffer of a sweep's walked chunk `i`: two matrices [rows][ld], then
// the rows' lse and delta, then their key flags.
template <typename T>
struct Stage {
  T* m0;
  T* m1;
  float* lse;
  float* delta;
  uint8_t* keep;
  __device__ __forceinline__ Stage(unsigned char* smem, const Plan& p,
                                   int i) {
    unsigned char* base =
        smem + p.off_walk + (p.stages == 2 ? (i & 1) : 0) * p.stage_bytes;
    m0 = reinterpret_cast<T*>(base);
    m1 = m0 + p.rows * p.ld;
    lse = reinterpret_cast<float*>(m1 + p.rows * p.ld);
    delta = lse + p.rows;
    keep = reinterpret_cast<uint8_t*>(delta + p.rows);
  }
};

// The head a CTA works on and its first own row.
struct Owner {
  int head, row0;
  __device__ __forceinline__ explicit Owner(const Plan& p) {
    const int own = p.units * kTile;
    const int per_head = (p.t + own - 1) / own;
    head = blockIdx.x / per_head;
    row0 = (blockIdx.x - head * per_head) * own;
  }
};

// grid (plan.grid), units * SPLIT warps.  CTA c owns key tiles of head
// c / per_head from key (c % per_head) * units * 16, and warp w the tile
// w / SPLIT, its dims (w % SPLIT) * DW ...; the queries come in chunks of
// `rows`.
template <typename T, int SPLIT, int DW>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_dkv_kernel(Args<T> a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = warp / SPLIT, ws = warp - unit * SPLIT, dbase = ws * DW;
  const int own = p.units * kTile;
  const Owner o(p);
  const int key0 = o.row0 + unit * kTile;  // the warp's first key
  const long long hoff = (long long)o.head * p.t * p.d;
  const long long voff = (long long)o.head * p.t;
  T* const ks = reinterpret_cast<T*>(smem);
  T* const vs = ks + own * p.ld;
  uint8_t* const keep = smem + p.off_vec + 2 * own * 4;
  float* const buf = reinterpret_cast<float*>(smem + p.off_buf) +
                     warp * 2 * kTile * kLdw;
  float4* const red =
      reinterpret_cast<float4*>(smem + p.off_red) + unit * SPLIT * 4 * 32;
  const uint8_t* km =
      a.key_mask == nullptr ? nullptr
                            : a.key_mask + (long long)(o.head / p.n_heads) * p.t;

  if (p.d < SPLIT * DW) {  // columns past D read as zeros
    zero_smem(smem, p.off_buf);
    __syncthreads();
  }
  stage_rows<T>(ks, p.ld, a.k + hoff, o.row0, own, p.t, p.d, p.vec);
  stage_rows<T>(vs, p.ld, a.v + hoff, o.row0, own, p.t, p.d, p.vec);
  stage_keep(keep, km, o.row0, own, p.t);
  cp_async_commit();

  // causal: no query before the CTA's first key sees it
  const int q_begin = p.causal ? o.row0 : 0;
  const int n_chunks = (p.t - q_begin + p.rows - 1) / p.rows;
  auto issue = [&](int i) {
    const Stage<T> st(smem, p, i);
    const int q0 = q_begin + i * p.rows;
    stage_rows<T>(st.m0, p.ld, a.q + hoff, q0, p.rows, p.t, p.d, p.vec);
    stage_rows<T>(st.m1, p.ld, a.dout + hoff, q0, p.rows, p.t, p.d, p.vec);
    stage_vec(st.lse, a.lse + voff, q0, p.rows, p.t);
    stage_vec(st.delta, a.delta + voff, q0, p.rows, p.t);
  };
  if (p.stages == 2) issue(0);
  cp_async_commit();
  cp_async_wait<1>();  // the own rows
  __syncthreads();

  RowsA<T, DW> ka, va;
  ka.load(ks + unit * kTile * p.ld + dbase, p.ld, lane);
  va.load(vs + unit * kTile * p.ld + dbase, p.ld, lane);
  const KeySpan ksp(keep + unit * kTile, key0, p, lane);
  float dk[DW / 8][4], dv[DW / 8][4], ds[2][4];
  zero_acc<DW>(dk);
  zero_acc<DW>(dv);

  for (int i = 0; i < n_chunks; ++i) {
    __syncthreads();  // every reader of the buffer refilled next is done
    if (p.stages == 2) {
      if (i + 1 < n_chunks) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      issue(i);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<T> st(smem, p, i);
    const int q0 = q_begin + i * p.rows;
    const int steps = (min(p.rows, p.t - q0) + kTile - 1) / kTile;
    for (int s = 0; s < steps; ++s) {
      const int qb = q0 + s * kTile;
      // causal, one warp a tile: these queries precede the warp's keys
      if (SPLIT == 1 && p.causal && qb + kTile - 1 < key0) continue;
      dkv_step<T, SPLIT, DW>(ka, va, st.m0 + s * kTile * p.ld + dbase,
                             st.m1 + s * kTile * p.ld + dbase,
                             st.lse + s * kTile, st.delta + s * kTile, qb,
                             ksp, p, dk, dv, ds, buf, red, ws, lane);
    }
  }
  store_rows<T, DW>(a.dk + hoff, dk, key0, dbase, p, lane);
  store_rows<T, DW>(a.dv + hoff, dv, key0, dbase, p, lane);
}

// grid (plan.grid), units * SPLIT warps.  CTA c owns query tiles of head
// c / per_head from query (c % per_head) * units * 16, warp w the tile
// w / SPLIT; the keys come in chunks of `rows`.
template <typename T, int SPLIT, int DW>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_dq_kernel(Args<T> a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int unit = warp / SPLIT, ws = warp - unit * SPLIT, dbase = ws * DW;
  const int own = p.units * kTile;
  const Owner o(p);
  const int query0 = o.row0 + unit * kTile;  // the warp's first query
  const long long hoff = (long long)o.head * p.t * p.d;
  const long long voff = (long long)o.head * p.t;
  T* const qs = reinterpret_cast<T*>(smem);
  T* const dos = qs + own * p.ld;
  float* const lses = reinterpret_cast<float*>(smem + p.off_vec);
  float* const deltas = lses + own;
  float* const buf = reinterpret_cast<float*>(smem + p.off_buf) +
                     warp * 2 * kTile * kLdw;
  float4* const red =
      reinterpret_cast<float4*>(smem + p.off_red) + unit * SPLIT * 4 * 32;
  const uint8_t* km =
      a.key_mask == nullptr ? nullptr
                            : a.key_mask + (long long)(o.head / p.n_heads) * p.t;

  if (p.d < SPLIT * DW) {
    zero_smem(smem, p.off_buf);
    __syncthreads();
  }
  stage_rows<T>(qs, p.ld, a.q + hoff, o.row0, own, p.t, p.d, p.vec);
  stage_rows<T>(dos, p.ld, a.dout + hoff, o.row0, own, p.t, p.d, p.vec);
  stage_vec(lses, a.lse + voff, o.row0, own, p.t);
  stage_vec(deltas, a.delta + voff, o.row0, own, p.t);
  cp_async_commit();

  // causal: no key after the CTA's last query is seen by it
  const int k_end = p.causal ? min(p.t, o.row0 + own) : p.t;
  const int n_chunks = (k_end + p.rows - 1) / p.rows;
  auto issue = [&](int i) {
    const Stage<T> st(smem, p, i);
    const int k0 = i * p.rows;
    stage_rows<T>(st.m0, p.ld, a.k + hoff, k0, p.rows, p.t, p.d, p.vec);
    stage_rows<T>(st.m1, p.ld, a.v + hoff, k0, p.rows, p.t, p.d, p.vec);
    stage_keep(st.keep, km, k0, p.rows, p.t);
  };
  if (p.stages == 2) issue(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  RowsA<T, DW> qa, doa;
  qa.load(qs + unit * kTile * p.ld + dbase, p.ld, lane);
  doa.load(dos + unit * kTile * p.ld + dbase, p.ld, lane);
  const float lse_r[2] = {lses[unit * kTile + g], lses[unit * kTile + g + 8]};
  const float delta_r[2] = {deltas[unit * kTile + g],
                            deltas[unit * kTile + g + 8]};
  float dq[DW / 8][4];
  zero_acc<DW>(dq);

  for (int i = 0; i < n_chunks; ++i) {
    __syncthreads();
    if (p.stages == 2) {
      if (i + 1 < n_chunks) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      issue(i);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<T> st(smem, p, i);
    const int k0 = i * p.rows;
    const int steps = (min(p.rows, k_end - k0) + kTile - 1) / kTile;
    for (int s = 0; s < steps; ++s) {
      const int kb = k0 + s * kTile;
      // causal, one warp a tile: these keys follow the warp's queries
      if (SPLIT == 1 && p.causal && kb > query0 + kTile - 1) continue;
      dq_step<T, SPLIT, DW>(qa, doa, st.m0 + s * kTile * p.ld + dbase,
                            st.m1 + s * kTile * p.ld + dbase,
                            st.keep + s * kTile, lse_r, delta_r, query0, kb,
                            p, dq, buf, red, ws, lane);
    }
  }
  store_rows<T, DW>(a.dq + hoff, dq, query0, dbase, p, lane);
}

// -- the launch --------------------------------------------------------------

// kind 1: dK/dV, 2: dQ.
template <typename T, int SPLIT, int DW>
cudaError_t launch_one(int kind, const Plan& p, const Args<T>& a,
                       cudaStream_t stream) {
  auto kernel = kind == 1 ? flash_dkv_kernel<T, SPLIT, DW>
                          : flash_dq_kernel<T, SPLIT, DW>;
  const cudaError_t err = allow_smem(kernel, (size_t)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

// The instance of the plan's (split, dw), or cudaErrorInvalidValue where
// there is none.
template <typename T>
cudaError_t dispatch(int kind, const Plan& p, const Args<T>& a,
                     cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (p.split == 1) {
    if constexpr (!kBf16) {  // bf16's k-step is 16 dims
      if (p.dw == 8) return launch_one<T, 1, 8>(kind, p, a, st);
    }
    if (p.dw == 16) return launch_one<T, 1, 16>(kind, p, a, st);
    if (p.dw == 32) return launch_one<T, 1, 32>(kind, p, a, st);
    if (p.dw == 64) return launch_one<T, 1, 64>(kind, p, a, st);
  } else if (p.dw == 64) {
    if (p.split == 2) return launch_one<T, 2, 64>(kind, p, a, st);
    if (p.split == 4) return launch_one<T, 4, 64>(kind, p, a, st);
    if (p.split == 8) return launch_one<T, 8, 64>(kind, p, a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(int kind, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta,
           const void* key_mask, void* out0, void* out1, int bn, int n_heads,
           int t, int d, int causal, float scale, int device, void* stream) {
  Plan p;
  if (!make_plan(bn, n_heads, t, d, causal, scale, (int)sizeof(T),
                 /*sweeps=*/1, q, k, v, dout, &p))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args<T> a{static_cast<const T*>(q),      static_cast<const T*>(k),
            static_cast<const T*>(v),      static_cast<const T*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const uint8_t*>(key_mask), nullptr, nullptr, nullptr};
  if (kind == 1) {
    a.dk = static_cast<T*>(out0);
    a.dv = static_cast<T*>(out1);
  } else {
    a.dq = static_cast<T*>(out0);
  }
  return (int)dispatch<T>(kind, p, a, reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interface for ctypes.  q, k, v, do and the outputs are contiguous
// (B*N, T, D) in the I/O dtype; lse and delta contiguous (B*N, T) float32;
// key_mask a contiguous (B, T) uint8 or null.  The launch is laid out by
// fmda_flash_bwd::plan's sweeps.  Returns cudaGetLastError() after the
// launch (0 = success); cudaErrorInvalidValue outside the envelope.
extern "C" int fmda_flash_dkv_f32(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* key_mask,
                                  void* dk, void* dv, int bn, int n_heads,
                                  int t, int d, int causal, float scale,
                                  int device, void* stream) {
  return launch<float>(1, q, k, v, dout, lse, delta, key_mask, dk, dv, bn,
                       n_heads, t, d, causal, scale, device, stream);
}

extern "C" int fmda_flash_dkv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* key_mask, void* dk, void* dv,
                                   int bn, int n_heads, int t, int d,
                                   int causal, float scale, int device,
                                   void* stream) {
  return launch<__nv_bfloat16>(1, q, k, v, dout, lse, delta, key_mask, dk, dv,
                               bn, n_heads, t, d, causal, scale, device,
                               stream);
}

extern "C" int fmda_flash_dq_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* key_mask,
                                 void* dq, int bn, int n_heads, int t, int d,
                                 int causal, float scale, int device,
                                 void* stream) {
  return launch<float>(2, q, k, v, dout, lse, delta, key_mask, dq, nullptr,
                       bn, n_heads, t, d, causal, scale, device, stream);
}

extern "C" int fmda_flash_dq_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* key_mask,
                                  void* dq, int bn, int n_heads, int t, int d,
                                  int causal, float scale, int device,
                                  void* stream) {
  return launch<__nv_bfloat16>(2, q, k, v, dout, lse, delta, key_mask, dq,
                               nullptr, bn, n_heads, t, d, causal, scale,
                               device, stream);
}
