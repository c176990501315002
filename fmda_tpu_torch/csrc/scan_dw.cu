// The recurrent weight gradient of the GRU and LSTM backward scans for
// NVIDIA Hopper (sm_90a), bound to PyTorch via ctypes by
// fmda_tpu_torch/ops/scan_dw.py (the library is built by
// fmda_tpu_torch/ops/_cuda_lib.py).
//
// Replaces: the weight-gradient sums inside the time loops of
// fmda_tpu/ops/pallas_gru.py::_gru_bwd_kernel (`dwt_acc`, `db_acc`) and
// fmda_tpu/ops/pallas_lstm.py::_lstm_bwd_kernel.  On one TPU core the grid
// runs in order, so the Pallas kernels add each step's dg^T . h_prev into
// VMEM as they go.  On Hopper that sum is a reduction over all B * T rows
// that nothing in the serial sweep needs, so it runs after the sweep, in
// parallel:
//
//   dW_hh[q][k] = sum over (b, t) of dg[b, t, q] * h_prev[b, t, k]
//   db_hh[q]    = sum over (b, t) of dg[b, t, q]
//
// dg is the sweep's gate gradient, rounded once to the I/O dtype: for the
// LSTM dxp itself; for the GRU dxp's r and z slices and, for the n slice,
// the sweep's (B, T, H) workspace round(dn_pre * r) (`tail`), since the
// hidden projection sees dn_pre through the reset gate.  A masked step's dg
// is 0, so it adds nothing.  h_prev is the hidden state entering step t:
// hs one step earlier in processing order, h0 at the first processed step,
// found by index (no shifted copy).
//
// What bounds it.  At the training shape (256, 30, 32) the reduction is
// 7,680 rows of a (gH x H) outer product: 63 MFLOP for the LSTM, about 1 us
// of the card's float32 rate, and under 5 MB of operands, about 1.5 us at
// 3.35 TB/s.  At that size the latency of a chain of loads costs more than
// either, so the design aims at many rows in flight and no serial tail:
//   - the B * T rows are split over about one block per SM (split-K), each
//     block owning a 128 x 32 tile of (q, k) (all of dW_hh at H = 32) for
//     its rows, 4 x 4 outputs a thread, so every partial sum has one
//     writer: no atomics;
//   - rows arrive 32 at a time into double-buffered shared-memory tiles:
//     in float32 with cp.async (4-byte copies, zero-filled past the ragged
//     edge, so any H, gH, stride or row count is taken), the next tile's
//     copies in flight while the current one is used; in bfloat16 each
//     value is widened to float32 on its way in, after the current tile's
//     products (the other blocks on the SM hide that wait); each row of a
//     tile is two float4 reads for 16 FMAs;
//   - the products are float32 FMAs in both dtypes.  bf16 operands are
//     exact in float32, so this is the Pallas kernel's
//     preferred_element_type=f32 dot.  TF32 tensor cores are not used for
//     float32: they keep 10 mantissa bits, which breaks the 1e-5 agreement
//     the float32 backward is held to;
//   - a second kernel adds the splits' partials, each output by a block of
//     8 warps that take every 8th split and then add their 8 sums, all in
//     a fixed order, so dW_hh and db_hh are the same bits on every run.

#include <limits.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

constexpr int kTileQ = 128;    // the (q, k) tile a block owns
constexpr int kTileK = 32;
constexpr int kChunk = 32;     // rows a staged tile holds
constexpr int kDwThreads = 256;
constexpr int kReduceGroups = 8;  // warps adding one output's splits
constexpr int kBlocksPerSm = 2;   // the splits' target, over the tiles

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Block (split, q tile, k tile): rows [split * rows_per_split, + rows_per_
// split) of the flattened (B, T) axis, outputs q0 + [0, 128) x k0 + [0, 32).
// Thread tid owns q0 + 4 (tid / 8) + [0, 4) x k0 + 4 (tid % 8) + [0, 4) and,
// in the first k tile, db_hh of its four q.  dg's column q < tail_from is
// read from dg (row stride ldg), a later one from tail (row stride
// gH - tail_from).  rows < 2^31.
template <typename T>
__global__ void __launch_bounds__(kDwThreads) scan_dw_kernel(
    const T* __restrict__ dg, int ldg, const T* __restrict__ tail,
    int tail_from, const T* __restrict__ hs, const T* __restrict__ h0,
    int n_steps, int H, int gH, int reverse, int rows, int rows_per_split,
    float* __restrict__ partials) {
  constexpr bool kAsync = std::is_same<T, float>::value;
  __shared__ __align__(16) float a_s[2][kChunk][kTileQ];  // dg
  __shared__ __align__(16) float b_s[2][kChunk][kTileK];  // h_prev
  constexpr int kPerA = kChunk * kTileQ / kDwThreads;     // staged a thread
  constexpr int kPerB = kChunk * kTileK / kDwThreads;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kTileQ, k0 = blockIdx.z * kTileK;
  const int i0 = blockIdx.x * rows_per_split;
  const int i1 = min(rows, i0 + rows_per_split);
  const int n_chunks = i1 > i0 ? (i1 - i0 + kChunk - 1) / kChunk : 0;
  const int ltail = gH - tail_from;

  // element u of this thread's share of chunk c: its row and column in
  // the tile, and its source (nullptr past the ragged edge, read as 0)
  auto a_src = [&](int c, int u, int& r, int& col) -> const T* {
    const int e = tid + u * kDwThreads;
    r = e / kTileQ;
    col = e - r * kTileQ;
    const int i = i0 + c * kChunk + r, q = q0 + col;
    if (i >= i1 || q >= gH) return nullptr;
    return q < tail_from ? dg + (long long)i * ldg + q
                         : tail + (long long)i * ltail + (q - tail_from);
  };
  auto b_src = [&](int c, int u, int& r, int& col) -> const T* {
    const int e = tid + u * kDwThreads;
    r = e / kTileK;
    col = e - r * kTileK;
    const int i = i0 + c * kChunk + r, k = k0 + col;
    if (i >= i1 || k >= H) return nullptr;
    const int b = i / n_steps, t = i - b * n_steps;
    const bool first = reverse ? t == n_steps - 1 : t == 0;
    return first ? h0 + (long long)b * H + k
                 : hs + (long long)(i + (reverse ? 1 : -1)) * H + k;
  };
  // stage chunk c into buffer buf.  float32: cp.async copies, put in
  // flight here and awaited by land(); bfloat16: loaded, widened and
  // stored by land() itself (holding a chunk in registers costs more
  // than the overlap gains)
  auto stage = [&](int c, int buf) {
    int r, col;
#pragma unroll
    for (int u = 0; u < kPerA; ++u) {
      const T* src = a_src(c, u, r, col);
      if constexpr (kAsync)
        cp_async4(&a_s[buf][r][col], src ? src : dg, src != nullptr);
      else
        a_s[buf][r][col] = src ? to_f32(*src) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kPerB; ++u) {
      const T* src = b_src(c, u, r, col);
      if constexpr (kAsync)
        cp_async4(&b_s[buf][r][col], src ? src : hs, src != nullptr);
      else
        b_s[buf][r][col] = src ? to_f32(*src) : 0.0f;
    }
    if constexpr (kAsync) cp_async_commit();
  };
  auto issue = [&](int c, int buf) {
    if constexpr (kAsync) stage(c, buf);
  };
  auto land = [&](int c, int buf) {
    if constexpr (kAsync)
      cp_async_wait_all();
    else
      stage(c, buf);
  };

  const int tq = tid / 8, tk = tid - tq * 8;
  float acc[4][4] = {}, bias[4] = {};
  if (n_chunks > 0) {
    issue(0, 0);
    land(0, 0);
  }
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) issue(c + 1, buf ^ 1);
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[buf][r][4 * tq]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[buf][r][4 * tk]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a4[x], b4[y], acc[x][y]);
        bias[x] += a4[x];
      }
    }
    if (c + 1 < n_chunks) land(c + 1, buf ^ 1);
    __syncthreads();
  }

  float* out = partials + (long long)blockIdx.x * ((long long)gH * H + gH);
  const int q = q0 + 4 * tq, k = k0 + 4 * tk;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (q + x >= gH) continue;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      if (k + y < H) out[(long long)(q + x) * H + k + y] = acc[x][y];
    if (blockIdx.z == 0 && tk == 0) out[(long long)gH * H + q + x] = bias[x];
  }
}

// out[e] = sum over splits of partials[split][e]: block e / 32, warp g adds
// splits g, g + 8, ... in order, then warp 0 adds the 8 sums in order; the
// same bits from run to run.
__global__ void __launch_bounds__(32 * kReduceGroups) reduce_partials_kernel(
    const float* __restrict__ partials, int n_splits, int n,
    float* __restrict__ out) {
  __shared__ float sums[kReduceGroups][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float sum = 0.0f;
  if (e < n)
    for (int i = g; i < n_splits; i += kReduceGroups)
      sum += partials[(long long)i * n + e];
  sums[g][lane] = sum;
  __syncthreads();
  if (g == 0 && e < n) {
    float total = sums[0][lane];
#pragma unroll
    for (int k = 1; k < kReduceGroups; ++k) total += sums[k][lane];
    out[e] = total;
  }
}

int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

// (splits, rows per split): about kBlocksPerSm blocks per SM over the
// tiles, whole chunks per split, at least one split.
void split_rows(int rows, int gH, int H, int device, int* n_splits,
                int* rows_per_split) {
  const int tiles = tiles_of(gH, kTileQ) * tiles_of(H, kTileK);
  const int chunks = (rows + kChunk - 1) / kChunk;
  int want = (sm_count(device) * kBlocksPerSm + tiles - 1) / tiles;
  if (want > chunks) want = chunks;
  if (want < 1) want = 1;
  const int per_split = (chunks + want - 1) / want * kChunk;
  *rows_per_split = per_split;
  *n_splits = rows > 0 ? (rows + per_split - 1) / per_split : 1;
}

template <typename T>
int launch_dw(const void* dg, int ldg, const void* tail, int tail_from,
              const void* hs, const void* h0, int B, int n_steps, int H,
              int gH, int reverse, void* partials, void* dw_db, int device,
              void* stream) {
  if (B <= 0 || H <= 0 || gH <= 0 || n_steps < 0 || ldg < tail_from ||
      tail_from > gH || (tail_from < gH && tail == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * n_steps > INT_MAX) return (int)cudaErrorInvalidValue;
  const int rows = B * n_steps;
  int n_splits, per_split;
  split_rows(rows, gH, H, device, &n_splits, &per_split);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(n_splits, tiles_of(gH, kTileQ), tiles_of(H, kTileK));
  scan_dw_kernel<T><<<grid, kDwThreads, 0, s>>>(
      static_cast<const T*>(dg), ldg, static_cast<const T*>(tail), tail_from,
      static_cast<const T*>(hs), static_cast<const T*>(h0), n_steps, H, gH,
      reverse, rows, per_split, static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = gH * H + gH;
  reduce_partials_kernel<<<(n + 31) / 32, 32 * kReduceGroups, 0, s>>>(
      static_cast<const float*>(partials), n_splits, n,
      static_cast<float*>(dw_db));
  return (int)cudaGetLastError();
}

}  // namespace

// The splits fmda_scan_dw_* uses for B * n_steps rows: the rows of its
// `partials`.
extern "C" int fmda_scan_dw_splits(int B, int n_steps, int H, int gH,
                                   int device) {
  if (B <= 0 || H <= 0 || gH <= 0 || n_steps < 0 ||
      (long long)B * n_steps > INT_MAX)
    return 0;
  int n_splits, per_split;
  split_rows(B * n_steps, gH, H, device, &n_splits, &per_split);
  return n_splits;
}

// dw_db = [dW_hh (gH, H), db_hh (gH)] in float32 from the gate gradient dg
// (B, T, >= tail_from columns, row stride ldg; columns from tail_from on
// come from `tail` (B, T, gH - tail_from), contiguous, when tail_from < gH),
// hs (B, T, H) and h0 (B, H), all contiguous in the I/O dtype.  `partials`
// is float32 scratch of fmda_scan_dw_splits(...) rows of gH * H + gH.
// Returns cudaGetLastError() after the two launches (0 = success).
extern "C" int fmda_scan_dw_f32(const void* dg, int ldg, const void* tail,
                                int tail_from, const void* hs, const void* h0,
                                int B, int n_steps, int H, int gH, int reverse,
                                void* partials, void* dw_db, int device,
                                void* stream) {
  return launch_dw<float>(dg, ldg, tail, tail_from, hs, h0, B, n_steps, H, gH,
                          reverse, partials, dw_db, device, stream);
}

extern "C" int fmda_scan_dw_bf16(const void* dg, int ldg, const void* tail,
                                 int tail_from, const void* hs,
                                 const void* h0, int B, int n_steps, int H,
                                 int gH, int reverse, void* partials,
                                 void* dw_db, int device, void* stream) {
  return launch_dw<__nv_bfloat16>(dg, ldg, tail, tail_from, hs, h0, B,
                                  n_steps, H, gH, reverse, partials, dw_db,
                                  device, stream);
}
