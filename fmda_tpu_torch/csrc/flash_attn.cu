// Flash attention forward, dK/dV and dQ sweeps for NVIDIA Hopper (sm_90a),
// bound to PyTorch via ctypes by fmda_tpu_torch/ops/attention_kernel.py (the
// library is built by fmda_tpu_torch/ops/_cuda_lib.py).
//
// Replaces the three Pallas TPU kernels of fmda_tpu/ops/pallas_attention.py:
//   _fwd_kernel  (flash forward)  -> flash_fwd_kernel
//   _dkv_kernel  (dK/dV sweep)    -> flash_dkv_kernel
//   _dq_kernel   (dQ sweep)       -> flash_dq_kernel
// on (B*N, T, D) q, k, v in the I/O dtype, with scale = 1/sqrt(D):
//
//   forward, over key blocks of kSoftmaxBlock (128) keys:
//     s = q k^T scale          m' = max(m, rowmax s)      corr = exp(m - m')
//     p = exp(s - m')          l = l corr + rowsum p      acc = acc corr + p v
//     o = acc / l              lse = m + log l
//   backward, with delta = rowsum(do o) - dlse computed outside:
//     p = exp(s - lse)   dv += p^T do   ds = p (do v^T - delta) scale
//     dk += ds^T q       dq += ds k
//
// The same arithmetic as the Pallas kernels: masked scores are the finite
// kNeg and their probabilities are forced to exactly 0 (s <= kNeg / 2), so
// a row whose keys are all masked gives o = 0 and lse = kNeg with no NaN; p
// (forward and backward) and ds are rounded to the I/O dtype before their
// products; m, l, acc, dk, dv, dq and every product accumulate in float32.
// The row max moves once per 128-key block, as the Pallas kernel's does.
//
// The envelope is wider than the Pallas kernels' (T % 128 == 0, no mask):
// any T >= 1 (the last key and query tiles are ragged and masked), D <= 512,
// causal or not, and an optional (B, T) uint8 key mask (0 = the key is
// hidden from every query of that batch row).
//
// Design.  The TPU kernels walk a sequential (B*N, q block, k block) grid
// and carry the online state across it in VMEM scratch.  Here each block
// owns one (b*n, tile of `rows` rows) pair and walks the other axis itself:
//   - the forward and the dQ sweep own query rows and walk key tiles; the
//     dK/dV sweep owns key rows and walks query tiles;
//   - a row is held by a group of g lanes (g a power of two, g * DPT >= D),
//     each lane holding dims lane, lane + g, ... (DPT of them) of the row
//     and of its float32 accumulators in registers; a dot product is DPT
//     FMAs and log2(g) shuffles;
//   - the walked side is staged tile by tile in shared memory, converted to
//     float32 and zero-padded to g * DPT dims, so the inner loops have no
//     bounds checks and a warp's reads of one tile row are conflict-free;
//   - the forward needs each 128-key block's row max before its
//     probabilities: it walks the block twice, first for the max, then for
//     p, l and acc, recomputing the scores (the block is loaded once when it
//     fits one tile, as it does for D <= 64);
//   - causal blocks skip the tiles above the diagonal: the forward and dQ
//     stop at their last row's key, the dK/dV sweep starts at its first
//     row's query; inside a tile each entry above the diagonal is masked;
//   - every output element is owned by one thread and summed in one fixed
//     order: no atomics, the same result from run to run.
//
// What bounds it.  At the model's shape (B*N = 1024, T = 30, D = 8) the
// forward moves about 4 MB (1.2 us at 3.35 TB/s) and does 30 MFLOP, the
// backward about 8 MB: far below one launch, so the kernels sit at the
// launch floor and the design only has to keep each pass to one launch.
// At the long-context shape (64, 1024, 8) the work is 2.1 GFLOP forward
// (32 us at the 67 TFLOP/s float32 rate) on scalar FMAs; tensor cores
// (mma/wgmma) are later work.

#include "scan_common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kSoftmaxBlock = 128;
constexpr int kThreads = 128;
// Shared memory the walked side's tiles may take.
constexpr int kSmemBudget = 96 * 1024;

// One launch's geometry, computed on the host by make_shape.
struct Shape {
  int bn;       // B * N
  int n_heads;  // N: the key mask row of b*n is b = bn / N
  int t;        // T
  int d;        // D
  int g;        // lanes per row, a power of two <= 32
  int dp;       // g * DPT: the padded row length in shared memory
  int rows;     // rows a block owns (blockDim.x = rows * g)
  int bcol;     // rows of the walked side per shared-memory tile
  int causal;
  float scale;
};

__device__ __forceinline__ float group_sum(float x, int g) {
  // the g lanes of a row group are consecutive and aligned, and every
  // warp is full (rows * g is a multiple of 32)
  for (int off = g >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// This lane's DPT dims of row `row` of a (T, D) matrix, float32, zero past D
// or past T.
template <typename T, int DPT>
__device__ __forceinline__ void load_row(const T* __restrict__ m, int row,
                                         const Shape& s, int lane,
                                         float (&r)[DPT]) {
  const bool live = row < s.t;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = lane + s.g * i;
    r[i] = (live && c < s.d) ? to_f32(m[(long long)row * s.d + c]) : 0.0f;
  }
}

template <typename T, int DPT>
__device__ __forceinline__ void store_row(T* __restrict__ m, int row,
                                          const Shape& s, int lane,
                                          const float (&r)[DPT]) {
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = lane + s.g * i;
    if (c < s.d) m[(long long)row * s.d + c] = from_f32<T>(r[i]);
  }
}

// Rows [r0, r0 + n) of a (T, D) matrix into tile[n][dp], float32, zero-padded.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ m, int r0,
                                          int n, const Shape& s,
                                          float* __restrict__ tile) {
  for (int e = threadIdx.x; e < n * s.dp; e += blockDim.x) {
    const int r = e / s.dp;
    const int c = e - r * s.dp;
    tile[e] = c < s.d ? to_f32(m[(long long)(r0 + r) * s.d + c]) : 0.0f;
  }
}

// Entries [r0, r0 + n) of a float32 vector (lse, delta) or of the key mask
// (as 1 / 0) into shared memory.
__device__ __forceinline__ void load_vec(const float* __restrict__ x, int r0,
                                         int n, float* __restrict__ out) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[e] = x[r0 + e];
}

__device__ __forceinline__ void load_keep(const uint8_t* __restrict__ km,
                                          int r0, int n,
                                          float* __restrict__ out) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    out[e] = (km == nullptr || km[r0 + e] != 0) ? 1.0f : 0.0f;
}

template <int DPT>
__device__ __forceinline__ float row_dot(const float (&r)[DPT],
                                         const float* __restrict__ col,
                                         int lane, int g) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc = fmaf(r[i], col[lane + g * i], acc);
  return group_sum(acc, g);
}

__device__ __forceinline__ const uint8_t* key_mask_row(const uint8_t* km,
                                                       const Shape& s) {
  return km == nullptr ? nullptr
                       : km + (long long)(blockIdx.x / s.n_heads) * s.t;
}

// grid (B*N, ceil(T / rows)); thread (r, lane) owns query row
// blockIdx.y * rows + r.  Shared memory: K and V tiles [bcol][dp], then the
// tile's key-mask flags [bcol].
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ key_mask,
    T* __restrict__ o, float* __restrict__ lse, Shape s) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + s.bcol * s.dp;
  float* keep = vs + s.bcol * s.dp;

  const long long base = (long long)blockIdx.x * s.t * s.d;
  const int row0 = blockIdx.y * s.rows;
  const int lane = threadIdx.x % s.g;
  const int i = row0 + threadIdx.x / s.g;
  const uint8_t* km = key_mask_row(key_mask, s);

  float qr[DPT], acc[DPT], pv[DPT];
  load_row<T, DPT>(q + base, i, s, lane, qr);
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.0f;
  float m = kNeg, l = 0.0f;

  // causal: no key past the block's last row is visible to it
  const int k_end = s.causal ? min(row0 + s.rows, s.t) : s.t;
  for (int kb = 0; kb < k_end; kb += kSoftmaxBlock) {
    const int kb_end = min(kb + kSoftmaxBlock, k_end);
    const bool one_tile = kb_end - kb <= s.bcol;
    // pass 1: the block's row max
    float mb = kNeg;
    for (int t0 = kb; t0 < kb_end; t0 += s.bcol) {
      const int n = min(s.bcol, kb_end - t0);
      __syncthreads();  // the previous tile's readers are done
      load_tile<T>(k + base, t0, n, s, ks);
      load_keep(km, t0, n, keep);
      if (one_tile) load_tile<T>(v + base, t0, n, s, vs);
      __syncthreads();
      for (int c = 0; c < n; ++c) {
        float sc = row_dot<DPT>(qr, ks + c * s.dp, lane, s.g) * s.scale;
        if (keep[c] == 0.0f || (s.causal && t0 + c > i)) sc = kNeg;
        mb = fmaxf(mb, sc);
      }
    }
    const float m_new = fmaxf(m, mb);
    const float corr = expf(m - m_new);
    // pass 2: p, its row sum and p v
    float lb = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) pv[c] = 0.0f;
    for (int t0 = kb; t0 < kb_end; t0 += s.bcol) {
      const int n = min(s.bcol, kb_end - t0);
      if (!one_tile) {
        __syncthreads();
        load_tile<T>(k + base, t0, n, s, ks);
        load_tile<T>(v + base, t0, n, s, vs);
        load_keep(km, t0, n, keep);
        __syncthreads();
      }
      for (int c = 0; c < n; ++c) {
        float sc = row_dot<DPT>(qr, ks + c * s.dp, lane, s.g) * s.scale;
        if (keep[c] == 0.0f || (s.causal && t0 + c > i)) sc = kNeg;
        const float p = sc <= kNeg * 0.5f ? 0.0f : expf(sc - m_new);
        lb += p;
        const float pr = round_to<T>(p);
        const float* vc = vs + c * s.dp;
#pragma unroll
        for (int e = 0; e < DPT; ++e) pv[e] = fmaf(pr, vc[lane + s.g * e], pv[e]);
      }
    }
    l = l * corr + lb;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[e] = acc[e] * corr + pv[e];
    m = m_new;
  }

  if (i < s.t) {
    const bool empty = l == 0.0f;
    const float l_safe = empty ? 1.0f : l;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[e] = acc[e] / l_safe;
    store_row<T, DPT>(o + base, i, s, lane, acc);
    if (lane == 0)
      lse[(long long)blockIdx.x * s.t + i] = empty ? kNeg : m + logf(l_safe);
  }
}

// grid (B*N, ceil(T / rows)); thread (r, lane) owns key row
// blockIdx.y * rows + r and walks the query tiles.  Shared memory: Q and dO
// tiles [bcol][dp], then the tile's lse and delta [bcol] each.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ key_mask, T* __restrict__ dk,
    T* __restrict__ dv, Shape s) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + s.bcol * s.dp;
  float* lses = dos + s.bcol * s.dp;
  float* deltas = lses + s.bcol;

  const long long base = (long long)blockIdx.x * s.t * s.d;
  const long long rbase = (long long)blockIdx.x * s.t;
  const int row0 = blockIdx.y * s.rows;
  const int lane = threadIdx.x % s.g;
  const int j = row0 + threadIdx.x / s.g;
  const uint8_t* km = key_mask_row(key_mask, s);
  const bool visible = j < s.t && (km == nullptr || km[j] != 0);

  float kr[DPT], vr[DPT], dk_acc[DPT], dv_acc[DPT];
  load_row<T, DPT>(k + base, j, s, lane, kr);
  load_row<T, DPT>(v + base, j, s, lane, vr);
#pragma unroll
  for (int e = 0; e < DPT; ++e) dk_acc[e] = dv_acc[e] = 0.0f;

  // causal: no query before the block's first key sees it
  for (int t0 = s.causal ? row0 : 0; t0 < s.t; t0 += s.bcol) {
    const int n = min(s.bcol, s.t - t0);
    __syncthreads();
    load_tile<T>(q + base, t0, n, s, qs);
    load_tile<T>(dout + base, t0, n, s, dos);
    load_vec(lse + rbase, t0, n, lses);
    load_vec(delta + rbase, t0, n, deltas);
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float* qc = qs + c * s.dp;
      const float* dc = dos + c * s.dp;
      float sc = row_dot<DPT>(kr, qc, lane, s.g) * s.scale;
      if (!visible || (s.causal && j > t0 + c)) sc = kNeg;
      const float p = sc <= kNeg * 0.5f ? 0.0f : expf(sc - lses[c]);
      const float pr = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        dv_acc[e] = fmaf(pr, dc[lane + s.g * e], dv_acc[e]);
      const float dp = row_dot<DPT>(vr, dc, lane, s.g);
      const float ds = round_to<T>(p * (dp - deltas[c]) * s.scale);
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        dk_acc[e] = fmaf(ds, qc[lane + s.g * e], dk_acc[e]);
    }
  }
  if (j < s.t) {
    store_row<T, DPT>(dk + base, j, s, lane, dk_acc);
    store_row<T, DPT>(dv + base, j, s, lane, dv_acc);
  }
}

// grid (B*N, ceil(T / rows)); thread (r, lane) owns query row
// blockIdx.y * rows + r and walks the key tiles.  Shared memory: K and V
// tiles [bcol][dp], then the tile's key-mask flags [bcol].
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const uint8_t* __restrict__ key_mask, T* __restrict__ dq, Shape s) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + s.bcol * s.dp;
  float* keep = vs + s.bcol * s.dp;

  const long long base = (long long)blockIdx.x * s.t * s.d;
  const long long rbase = (long long)blockIdx.x * s.t;
  const int row0 = blockIdx.y * s.rows;
  const int lane = threadIdx.x % s.g;
  const int i = row0 + threadIdx.x / s.g;
  const uint8_t* km = key_mask_row(key_mask, s);

  float qr[DPT], dor[DPT], dq_acc[DPT];
  load_row<T, DPT>(q + base, i, s, lane, qr);
  load_row<T, DPT>(dout + base, i, s, lane, dor);
#pragma unroll
  for (int e = 0; e < DPT; ++e) dq_acc[e] = 0.0f;
  const float lse_i = i < s.t ? lse[rbase + i] : 0.0f;
  const float delta_i = i < s.t ? delta[rbase + i] : 0.0f;

  const int k_end = s.causal ? min(row0 + s.rows, s.t) : s.t;
  for (int t0 = 0; t0 < k_end; t0 += s.bcol) {
    const int n = min(s.bcol, k_end - t0);
    __syncthreads();
    load_tile<T>(k + base, t0, n, s, ks);
    load_tile<T>(v + base, t0, n, s, vs);
    load_keep(km, t0, n, keep);
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float* kc = ks + c * s.dp;
      float sc = row_dot<DPT>(qr, kc, lane, s.g) * s.scale;
      if (keep[c] == 0.0f || (s.causal && t0 + c > i)) sc = kNeg;
      const float p = sc <= kNeg * 0.5f ? 0.0f : expf(sc - lse_i);
      const float dp = row_dot<DPT>(dor, vs + c * s.dp, lane, s.g);
      const float ds = round_to<T>(p * (dp - delta_i) * s.scale);
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        dq_acc[e] = fmaf(ds, kc[lane + s.g * e], dq_acc[e]);
    }
  }
  if (i < s.t) store_row<T, DPT>(dq + base, i, s, lane, dq_acc);
}

// The geometry of a launch, or false outside the envelope.  DPT (dims per
// lane) is 4, 8 or 16; g the fewest lanes that cover D with it.
bool make_shape(int bn, int n_heads, int t, int d, int causal, float scale,
                Shape* s, int* dpt) {
  if (bn <= 0 || n_heads <= 0 || bn % n_heads != 0 || t <= 0 || d <= 0 ||
      d > 512)
    return false;
  *dpt = d <= 4 ? 4 : (d <= 8 ? 8 : 16);
  int g = 1;
  while (g * *dpt < d) g <<= 1;
  // rows: whole warps, no more than T needs (T = 30 takes one warp at g = 1)
  const int per_warp = 32 / g;
  int rows = kThreads / g;
  const int need = (t + per_warp - 1) / per_warp * per_warp;
  if (rows > need) rows = need;
  const int dp = g * *dpt;
  int bcol = kSoftmaxBlock;
  while (bcol > 1 &&
         (2 * bcol * dp + 2 * bcol) * (int)sizeof(float) > kSmemBudget)
    bcol >>= 1;
  *s = Shape{bn, n_heads, t, d, g, dp, rows, bcol, causal != 0, scale};
  return true;
}

size_t smem_bytes(const Shape& s) {
  return (size_t)(2 * s.bcol * s.dp + 2 * s.bcol) * sizeof(float);
}

// kind 0: forward, 1: dK/dV, 2: dQ.
template <typename T, int DPT>
cudaError_t launch_dpt(int kind, const Shape& s, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse_in,
                       const void* delta, const uint8_t* km, void* out0,
                       void* out1, cudaStream_t stream) {
  const dim3 grid((unsigned)s.bn, (unsigned)((s.t + s.rows - 1) / s.rows));
  const dim3 block((unsigned)(s.rows * s.g));
  const size_t smem = smem_bytes(s);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  cudaError_t err;
  if (kind == 0) {
    err = allow_smem(flash_fwd_kernel<T, DPT>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<T, DPT><<<grid, block, smem, stream>>>(
        qp, kp, vp, km, static_cast<T*>(out0), static_cast<float*>(out1), s);
  } else if (kind == 1) {
    err = allow_smem(flash_dkv_kernel<T, DPT>, smem);
    if (err != cudaSuccess) return err;
    flash_dkv_kernel<T, DPT><<<grid, block, smem, stream>>>(
        qp, kp, vp, static_cast<const T*>(dout),
        static_cast<const float*>(lse_in), static_cast<const float*>(delta),
        km, static_cast<T*>(out0), static_cast<T*>(out1), s);
  } else {
    err = allow_smem(flash_dq_kernel<T, DPT>, smem);
    if (err != cudaSuccess) return err;
    flash_dq_kernel<T, DPT><<<grid, block, smem, stream>>>(
        qp, kp, vp, static_cast<const T*>(dout),
        static_cast<const float*>(lse_in), static_cast<const float*>(delta),
        km, static_cast<T*>(out0), s);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(int kind, const void* q, const void* k, const void* v,
           const void* dout, const void* lse_in, const void* delta,
           const void* key_mask, void* out0, void* out1, int bn, int n_heads,
           int t, int d, int causal, float scale, int device, void* stream) {
  Shape s;
  int dpt;
  if (!make_shape(bn, n_heads, t, d, causal, scale, &s, &dpt))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uint8_t* km = static_cast<const uint8_t*>(key_mask);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dpt == 4)
    err = launch_dpt<T, 4>(kind, s, q, k, v, dout, lse_in, delta, km, out0,
                           out1, st);
  else if (dpt == 8)
    err = launch_dpt<T, 8>(kind, s, q, k, v, dout, lse_in, delta, km, out0,
                           out1, st);
  else
    err = launch_dpt<T, 16>(kind, s, q, k, v, dout, lse_in, delta, km, out0,
                            out1, st);
  return (int)err;
}

}  // namespace

// Plain C interface for ctypes.  q, k, v, do and the outputs are contiguous
// (B*N, T, D) in the I/O dtype; lse and delta contiguous (B*N, T) float32;
// key_mask a contiguous (B, T) uint8 or null.  Returns cudaGetLastError()
// after the launch (0 = success); cudaErrorInvalidValue outside the
// envelope.
extern "C" int fmda_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  const void* key_mask, void* o, void* lse,
                                  int bn, int n_heads, int t, int d,
                                  int causal, float scale, int device,
                                  void* stream) {
  return launch<float>(0, q, k, v, nullptr, nullptr, nullptr, key_mask, o,
                       lse, bn, n_heads, t, d, causal, scale, device, stream);
}

extern "C" int fmda_flash_fwd_bf16(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* o, void* lse, int bn, int n_heads,
                                   int t, int d, int causal, float scale,
                                   int device, void* stream) {
  return launch<__nv_bfloat16>(0, q, k, v, nullptr, nullptr, nullptr,
                               key_mask, o, lse, bn, n_heads, t, d, causal,
                               scale, device, stream);
}

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
