// LSTM forward and backward scans for NVIDIA Hopper (sm_90a), bound to
// PyTorch via ctypes by fmda_tpu_torch/ops/lstm_kernel.py (the library is
// built by fmda_tpu_torch/ops/_cuda_lib.py, together with gru_scan.cu).
//
// ---- forward ----------------------------------------------------------------
// Replaces: fmda_tpu/ops/pallas_lstm.py::_lstm_step_kernel, the Pallas TPU
// kernel behind lstm_scan_pallas.  Same function, not the same blocking:
//
//   s = xp[t] + h . W_hh^T + b_hh                 (gates [i, f, g, o])
//   i = sigmoid(s_i)  f = sigmoid(s_f)  g = tanh(s_g)  o = sigmoid(s_o)
//   c' = f * c + i * g        h' = o * tanh(c')
//
// over precomputed input projections xp (B, T, 4H), giving hs and cs
// (B, T, H) and h_last, c_last (B, H).  The gate algebra runs in float32
// whatever the I/O dtype; c' is computed from the carried c (which holds a
// value of the I/O dtype), h' from the unrounded float32 c', and then both
// are rounded to the I/O dtype, carried, and written to hs and cs (the TPU
// kernel's `.astype(h.dtype)` on each).  cs is written in every mode: the
// backward reads it.  An optional (B, T) uint8 mask carries h and c through
// unchanged where it is 0, and hs and cs repeat the carried values there
// (the lax.scan path's semantics; the Pallas pair has no mask).
//
// As in gru_scan.cu, one thread block owns a tile of batch rows and runs the
// whole time loop, reading xp batch-major through the strides it is given,
// where the TPU kernel walks a time-major copy on a sequential grid.
//
// What bounds it.  At the serving shape (256, 30, 32) f32 the bytes (xp in,
// hs and cs out: about 5.9 MB) take about 1.8 us at 3.35 TB/s and the FLOPs
// less, but the recurrence is a chain of T dependent steps, each a small
// matrix-vector product, five transcendentals and a block barrier: it is
// latency-bound by that chain.  What the design does about it:
//   - W_hh^T (16 KB at H = 32 f32, 128 KB at H = 128 bf16) stays in shared
//     memory for the whole sequence while it fits under kMaxSmemBytes; past
//     that (H = 128 f32 needs 256 KB) each thread reads its four rows of
//     W_hh from device memory, where they stay in L1/L2 after the first step;
//   - h is double-buffered in shared memory, so a step costs one barrier;
//     c never leaves its thread's register: only thread j needs c[j];
//   - the next step's xp is loaded before the current step's dot products;
//   - the batch tile shrinks until the grid covers the SMs (tile_rows).
//
// ---- backward ---------------------------------------------------------------
// Replaces: fmda_tpu/ops/pallas_lstm.py::_lstm_bwd_kernel.  It walks time in
// reverse processing order, takes h_prev and c_prev from h0 and c0 at the
// first processed step and from hs and cs of the previous processed step
// otherwise, recomputes the gates from (h_prev, xp), takes tanh(c) from the
// rounded cs, and carries dh and dc in float32:
//
//   dh += dhs[t];  do = dh tanh(c);  dc += dh o (1 - tanh(c)^2)
//   dgates = [dc g i (1-i), dc c_prev f (1-f), dc i (1-g^2), do o (1-o)],
//     rounded once to the I/O dtype: that one value is dxp[t] and feeds
//   dh <- dgates . W_hh,  dc <- dc f,  dW_hh += dgates^T . h_prev,
//   db_hh += sum_b dgates
//
// dh0 and dc0 are the final dh and dc (float32); dW_hh and db_hh are float32
// sums.  dh_last and dc_last are read, whatever they hold.  A masked step
// (mask 0) passes dh (after adding dhs[t]) and dc through and adds nothing
// to dxp, dW_hh or db_hh: the gradient of the masked forward.
//
// What bounds it.  At the training shape (256, 30, 32) f32 the bytes (xp,
// hs, cs, dhs in, dxp out: about 11.8 MB) take about 3.5 us at 3.35 TB/s and
// the ~200 MFLOP about 3 us at 67 TFLOP/s, but like the forward it is a
// chain of T dependent steps with two barriers each: latency-bound.  The
// design is gru_scan.cu's backward, with four gates and a second carry:
//   - one shared-memory copy of W_hh, rows padded to H + 1, serves the gate
//     recompute (each thread walks its four rows) and the dh chain (each
//     thread walks its column) without bank conflicts; it fits up to H = 128
//     in bfloat16 (132 KB) but not H = 128 in float32 (264 KB), which reads
//     W_hh from device memory;
//   - each block sums its rows' dgates^T . h_prev over all T steps into a
//     float32 partial it alone writes (shared memory when it fits beside
//     W_hh, as at H = 32; else its own slice of the workspace), and the
//     shared reduce_partials kernel adds the blocks' partials in block
//     order: no atomics, the same result from run to run;
//   - h_prev and dgates are double-buffered in shared memory, so a step
//     costs two barriers, and the next step's xp, dhs, h_prev, c_prev and c
//     are loaded before the current step's products.
//
// Registers: the backward keeps four gates, c_prev, tanh(c), dh, dc and a
// step of prefetched inputs live.  Both kernels are bounded at kMaxThreads =
// 512 threads a block, which leaves a thread up to 128 registers, so the
// wrapper takes H <= 512.  The backward also states one block per SM as its
// minimum, so that ptxas may give it all 128: with the thread bound alone
// it held the instances with W_hh in shared memory to 64 registers and
// spilled 16-40 bytes.

#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
// W_hh^T stays in shared memory while it and the carry fit under this.
constexpr size_t kMaxSmemBytes = 200 * 1024;
// The backward's shared-memory budget: under the 227 KB a block may use.
constexpr size_t kMaxBwdSmemBytes = 225 * 1024;

// blockDim.x == rows * H: thread (r, j) owns hidden unit j of batch row
// blockIdx.x * rows + r.  Shared memory: h [2][rows][H] in f32 (holding
// values already rounded to T), then W_hh^T [H][4H] in T when W_SMEM.
template <typename T, bool W_SMEM>
__global__ void __launch_bounds__(kMaxThreads) lstm_scan_fwd_kernel(
    const T* __restrict__ xp, long long sxb, long long sxt,
    const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ w_hh, const T* __restrict__ b_hh,
    const uint8_t* __restrict__ mask, T* __restrict__ hs, T* __restrict__ cs,
    T* __restrict__ h_last, T* __restrict__ c_last, int B, int n_steps,
    int H, int rows, int reverse) {
  extern __shared__ float smem[];
  float* hbuf = smem;
  T* wt = reinterpret_cast<T*>(smem + 2 * rows * H);

  const int tid = threadIdx.x;
  const int r = tid / H;
  const int j = tid - r * H;
  const int b = blockIdx.x * rows + r;
  const bool live = b < B;
  const int H4 = 4 * H;

  if (W_SMEM) {
    // coalesced read of W_hh (4H, H), transposed into [k][g] so that the
    // threads of a warp (consecutive j) read consecutive words
    for (int i = tid; i < H4 * H; i += blockDim.x) {
      const int g = i / H;
      const int k = i - g * H;
      wt[k * H4 + g] = w_hh[i];
    }
  }
  const float bi = to_f32(b_hh[j]);
  const float bf = to_f32(b_hh[H + j]);
  const float bg = to_f32(b_hh[2 * H + j]);
  const float bo = to_f32(b_hh[3 * H + j]);
  float h = live ? to_f32(h0[(long long)b * H + j]) : 0.0f;
  float c = live ? to_f32(c0[(long long)b * H + j]) : 0.0f;
  hbuf[r * H + j] = h;
  __syncthreads();

  const T* xrow = xp + (live ? (long long)b * sxb : 0);
  const uint8_t* mrow = mask ? mask + (live ? (long long)b * n_steps : 0)
                             : nullptr;
  float xi = 0.0f, xf = 0.0f, xg = 0.0f, xo = 0.0f;
  bool keep = true;
  auto load = [&](int t) {
    const T* x = xrow + t * sxt;
    xi = to_f32(x[j]);
    xf = to_f32(x[H + j]);
    xg = to_f32(x[2 * H + j]);
    xo = to_f32(x[3 * H + j]);
    keep = mrow ? mrow[t] != 0 : true;
  };
  if (live && n_steps > 0) load(reverse ? n_steps - 1 : 0);

  int cur = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const float ci = xi, cf = xf, cg = xg, co = xo;
    const bool ck = keep;
    if (live && s + 1 < n_steps) load(reverse ? t - 1 : t + 1);  // prefetch

    const float* hc = hbuf + cur * rows * H + r * H;
    float ai = bi, af = bf, ag = bg, ao = bo;
    if (W_SMEM) {
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hc[k];
        const T* wk = wt + k * H4;
        ai = fmaf(hk, to_f32(wk[j]), ai);
        af = fmaf(hk, to_f32(wk[H + j]), af);
        ag = fmaf(hk, to_f32(wk[2 * H + j]), ag);
        ao = fmaf(hk, to_f32(wk[3 * H + j]), ao);
      }
    } else {
      const T* wi = w_hh + (long long)j * H;
      const T* wf = w_hh + (long long)(H + j) * H;
      const T* wg = w_hh + (long long)(2 * H + j) * H;
      const T* wo = w_hh + (long long)(3 * H + j) * H;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = hc[k];
        ai = fmaf(hk, to_f32(wi[k]), ai);
        af = fmaf(hk, to_f32(wf[k]), af);
        ag = fmaf(hk, to_f32(wg[k]), ag);
        ao = fmaf(hk, to_f32(wo[k]), ao);
      }
    }
    const float ig = sigmoid_f32(ci + ai);
    const float fg = sigmoid_f32(cf + af);
    const float gg = tanhf(cg + ag);
    const float og = sigmoid_f32(co + ao);
    const float c_new = fg * c + ig * gg;
    const float h_new = og * tanhf(c_new);  // from the unrounded c'
    if (ck) {
      h = round_to<T>(h_new);
      c = round_to<T>(c_new);
    }
    if (live) {
      const long long o = ((long long)b * n_steps + t) * H + j;
      hs[o] = from_f32<T>(h);
      cs[o] = from_f32<T>(c);
    }
    hbuf[(cur ^ 1) * rows * H + r * H + j] = h;
    __syncthreads();
    cur ^= 1;
  }
  if (live) {
    h_last[(long long)b * H + j] = from_f32<T>(h);
    c_last[(long long)b * H + j] = from_f32<T>(c);
  }
}

template <typename T>
int launch(const void* xp, long long sxb, long long sxt, const void* h0,
           const void* c0, const void* w_hh, const void* b_hh,
           const void* mask, void* hs, void* cs, void* h_last, void* c_last,
           int B, int n_steps, int H, int reverse, int device, void* stream) {
  if (B <= 0 || H <= 0 || H > kMaxThreads || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rows = tile_rows(B, H, device);
  const size_t h_bytes = 2 * (size_t)rows * H * sizeof(float);
  const size_t w_bytes = 4 * (size_t)H * H * sizeof(T);
  const bool w_smem = h_bytes + w_bytes <= kMaxSmemBytes;
  const size_t smem = h_bytes + (w_smem ? w_bytes : 0);
  const dim3 grid((B + rows - 1) / rows);
  const dim3 block(rows * H);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(xp);
  const T* h = static_cast<const T*>(h0);
  const T* c = static_cast<const T*>(c0);
  const T* w = static_cast<const T*>(w_hh);
  const T* bb = static_cast<const T*>(b_hh);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* hs_out = static_cast<T*>(hs);
  T* cs_out = static_cast<T*>(cs);
  T* hl = static_cast<T*>(h_last);
  T* cl = static_cast<T*>(c_last);
  if (w_smem) {
    err = allow_smem(lstm_scan_fwd_kernel<T, true>, smem);
    if (err != cudaSuccess) return (int)err;
    lstm_scan_fwd_kernel<T, true><<<grid, block, smem, s>>>(
        x, sxb, sxt, h, c, w, bb, m, hs_out, cs_out, hl, cl, B, n_steps, H,
        rows, reverse);
  } else {
    lstm_scan_fwd_kernel<T, false><<<grid, block, smem, s>>>(
        x, sxb, sxt, h, c, w, bb, m, hs_out, cs_out, hl, cl, B, n_steps, H,
        rows, reverse);
  }
  return (int)cudaGetLastError();
}

// -- backward -----------------------------------------------------------------

// blockDim.x == rows * H: thread (r, j) owns hidden unit j of batch row
// blockIdx.x * rows + r, and the weight-gradient entries (g, j) for
// g = r, r + rows, r + 2 rows, ... < 4H (plus bias entries q = tid,
// tid + blockDim.x, ... < 4H), so each partial has one writer.
//
// Shared memory, in order: h_prev [2][rows][H] and dgates [2][rows][4H] in
// f32 (double-buffered by step parity); then, when ACC_SMEM, the block's
// partial [4H * H + 4H] in f32; then, when W_SMEM, W_hh [4H][H + 1] in T.
// Without ACC_SMEM the partial accumulates in place in the block's workspace
// slice; without W_SMEM W_hh is read from device memory.
template <typename T, bool W_SMEM, bool ACC_SMEM>
__global__ void __launch_bounds__(kMaxThreads, 1) lstm_scan_bwd_kernel(
    const T* __restrict__ xp, long long sxb, long long sxt,
    const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ w_hh, const T* __restrict__ b_hh,
    const T* __restrict__ hs, const T* __restrict__ cs,
    const float* __restrict__ dh_last, const float* __restrict__ dc_last,
    const T* __restrict__ dhs, const uint8_t* __restrict__ mask,
    T* __restrict__ dxp, float* __restrict__ dh0, float* __restrict__ dc0,
    float* __restrict__ partials, int B, int n_steps, int H, int rows,
    int reverse) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  const int n_acc = H4 * H + H4;
  float* hbuf = smem;
  float* gbuf = hbuf + 2 * rows * H;
  float* acc_s = gbuf + 2 * rows * H4;
  T* w_s = reinterpret_cast<T*>(acc_s + (ACC_SMEM ? n_acc : 0));
  float* acc = ACC_SMEM ? acc_s : partials + (long long)blockIdx.x * n_acc;
  const T* w = W_SMEM ? w_s : w_hh;
  const int ws = W_SMEM ? H + 1 : H;  // row stride of w

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int r = tid / H;
  const int j = tid - r * H;
  const int b = blockIdx.x * rows + r;
  const bool live = b < B;

  if (W_SMEM) {
    for (int i = tid; i < H4 * H; i += nt) {
      const int g = i / H;
      w_s[g * ws + (i - g * H)] = w_hh[i];
    }
  }
  for (int g = r; g < H4; g += rows) acc[g * H + j] = 0.0f;
  for (int q = tid; q < H4; q += nt) acc[H4 * H + q] = 0.0f;

  const float bi = to_f32(b_hh[j]);
  const float bf = to_f32(b_hh[H + j]);
  const float bg = to_f32(b_hh[2 * H + j]);
  const float bo = to_f32(b_hh[3 * H + j]);
  float dh = live ? dh_last[(long long)b * H + j] : 0.0f;
  float dc = live ? dc_last[(long long)b * H + j] : 0.0f;

  const T* xrow = xp + (live ? (long long)b * sxb : 0);
  const long long row_h = live ? (long long)b * n_steps * H : 0;
  const uint8_t* mrow = mask ? mask + (live ? (long long)b * n_steps : 0)
                             : nullptr;
  // step s of the backward walk: its time index, the step's inputs, and
  // the state entering it (h0/c0 at the forward's first step)
  auto time_of = [&](int s) { return reverse ? s : n_steps - 1 - s; };
  float xi = 0.0f, xf = 0.0f, xg = 0.0f, xo = 0.0f, dhs_t = 0.0f;
  float hprev = 0.0f, cprev = 0.0f, cnew = 0.0f;
  bool keep = true;
  auto load = [&](int s) {
    const int t = time_of(s);
    const T* x = xrow + t * sxt;
    xi = to_f32(x[j]);
    xf = to_f32(x[H + j]);
    xg = to_f32(x[2 * H + j]);
    xo = to_f32(x[3 * H + j]);
    dhs_t = to_f32(dhs[row_h + (long long)t * H + j]);
    cnew = to_f32(cs[row_h + (long long)t * H + j]);
    if (s == n_steps - 1) {
      hprev = to_f32(h0[(long long)b * H + j]);
      cprev = to_f32(c0[(long long)b * H + j]);
    } else {
      const long long tp = row_h + (long long)(reverse ? t + 1 : t - 1) * H;
      hprev = to_f32(hs[tp + j]);
      cprev = to_f32(cs[tp + j]);
    }
    keep = mrow ? mrow[t] != 0 : true;
  };
  if (live && n_steps > 0) load(0);

  int cur = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int t = time_of(s);
    const float ci = xi, cf = xf, cg = xg, co = xo, cd = dhs_t;
    const float cp = cprev, cn = cnew;
    const bool ck = live && keep;
    float* hb = hbuf + cur * rows * H;
    float* gb = gbuf + cur * rows * H4;
    hb[r * H + j] = live ? hprev : 0.0f;
    if (live && s + 1 < n_steps) load(s + 1);  // prefetch the next step
    __syncthreads();

    // gate recompute: h_prev . W_hh^T + b_hh, W_hh read down row g * H + j
    const float* hc = hb + r * H;
    float ai = bi, af = bf, ag = bg, ao = bo;
    const T* wi = w + (long long)j * ws;
    const T* wf = w + (long long)(H + j) * ws;
    const T* wg = w + (long long)(2 * H + j) * ws;
    const T* wo = w + (long long)(3 * H + j) * ws;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = hc[k];
      ai = fmaf(hk, to_f32(wi[k]), ai);
      af = fmaf(hk, to_f32(wf[k]), af);
      ag = fmaf(hk, to_f32(wg[k]), ag);
      ao = fmaf(hk, to_f32(wo[k]), ao);
    }
    const float ig = sigmoid_f32(ci + ai);
    const float fg = sigmoid_f32(cf + af);
    const float gg = tanhf(cg + ag);
    const float og = sigmoid_f32(co + ao);
    const float tc = tanhf(cn);  // from the rounded cs, as the TPU kernel

    dh += cd;
    float di = 0.0f, df = 0.0f, dg = 0.0f, dout = 0.0f;
    if (ck) {
      const float d_o = dh * tc;
      dc += dh * og * (1.0f - tc * tc);
      di = dc * gg * ig * (1.0f - ig);
      df = dc * cp * fg * (1.0f - fg);
      dg = dc * ig * (1.0f - gg * gg);
      dout = d_o * og * (1.0f - og);
    }
    // dgates, rounded once to the I/O dtype (zero for masked and padding
    // rows): dxp, and the operand of the dh chain, dW_hh and db_hh
    float* g = gb + r * H4;
    g[j] = round_to<T>(di);
    g[H + j] = round_to<T>(df);
    g[2 * H + j] = round_to<T>(dg);
    g[3 * H + j] = round_to<T>(dout);
    if (live) {
      T* d = dxp + ((long long)b * n_steps + t) * H4;
      d[j] = from_f32<T>(di);
      d[H + j] = from_f32<T>(df);
      d[2 * H + j] = from_f32<T>(dg);
      d[3 * H + j] = from_f32<T>(dout);
    }
    __syncthreads();

    // dh <- dgates . W_hh (W_hh read across rows, column j); dc <- dc f
    if (ck) {
      float chain = 0.0f;
#pragma unroll 8
      for (int q = 0; q < H4; ++q)
        chain = fmaf(g[q], to_f32(w[(long long)q * ws + j]), chain);
      dh = chain;
      dc *= fg;
    }
    // this block's partials: dW_hh[q][j] += sum_rows dgates[q] h_prev[j],
    // db_hh[q] += sum_rows dgates[q]
    for (int gi = r; gi < H4; gi += rows) {
      float sum = 0.0f;
      for (int rr = 0; rr < rows; ++rr)
        sum = fmaf(gb[rr * H4 + gi], hb[rr * H + j], sum);
      acc[gi * H + j] += sum;
    }
    for (int q = tid; q < H4; q += nt) {
      float sum = 0.0f;
      for (int rr = 0; rr < rows; ++rr) sum += gb[rr * H4 + q];
      acc[H4 * H + q] += sum;
    }
    cur ^= 1;
  }
  if (live) {
    dh0[(long long)b * H + j] = dh;
    dc0[(long long)b * H + j] = dc;
  }
  if (ACC_SMEM) {  // each thread copies the entries it owns
    float* out = partials + (long long)blockIdx.x * n_acc;
    for (int gi = r; gi < H4; gi += rows) out[gi * H + j] = acc[gi * H + j];
    for (int q = tid; q < H4; q += nt) out[H4 * H + q] = acc[H4 * H + q];
  }
}

// The backward's arguments, as the C entry points receive them (rows is
// set by launch_bwd).
struct BwdArgs {
  const void *xp, *h0, *c0, *w_hh, *b_hh, *hs, *cs, *dh_last, *dc_last,
      *dhs, *mask;
  void *dxp, *dh0, *dc0, *partials;
  long long sxb, sxt;
  int B, n_steps, H, rows, reverse;
};

template <typename T, bool W_SMEM, bool ACC_SMEM>
cudaError_t launch_bwd_tile(const BwdArgs& a, dim3 grid, dim3 block,
                            size_t smem, cudaStream_t s) {
  auto kernel = lstm_scan_bwd_kernel<T, W_SMEM, ACC_SMEM>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, s>>>(
      static_cast<const T*>(a.xp), a.sxb, a.sxt, static_cast<const T*>(a.h0),
      static_cast<const T*>(a.c0), static_cast<const T*>(a.w_hh),
      static_cast<const T*>(a.b_hh), static_cast<const T*>(a.hs),
      static_cast<const T*>(a.cs), static_cast<const float*>(a.dh_last),
      static_cast<const float*>(a.dc_last), static_cast<const T*>(a.dhs),
      static_cast<const uint8_t*>(a.mask), static_cast<T*>(a.dxp),
      static_cast<float*>(a.dh0), static_cast<float*>(a.dc0),
      static_cast<float*>(a.partials), a.B, a.n_steps, a.H, a.rows,
      a.reverse);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(BwdArgs a, void* dw_db, int device, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.H > kMaxThreads || a.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int H = a.H;
  a.rows = tile_rows(a.B, H, device);
  const int n_blocks = (a.B + a.rows - 1) / a.rows;
  const int n_acc = 4 * H * H + 4 * H;
  const size_t base =
      (2 * (size_t)a.rows * H + 2 * (size_t)a.rows * 4 * H) * sizeof(float);
  const size_t w_bytes = 4 * (size_t)H * (H + 1) * sizeof(T);
  const size_t acc_bytes = (size_t)n_acc * sizeof(float);
  const bool w_smem = base + w_bytes <= kMaxBwdSmemBytes;
  const bool acc_smem =
      base + (w_smem ? w_bytes : 0) + acc_bytes <= kMaxBwdSmemBytes;
  const size_t smem =
      base + (w_smem ? w_bytes : 0) + (acc_smem ? acc_bytes : 0);
  const dim3 grid(n_blocks);
  const dim3 block(a.rows * H);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (w_smem && acc_smem)
    err = launch_bwd_tile<T, true, true>(a, grid, block, smem, s);
  else if (w_smem)
    err = launch_bwd_tile<T, true, false>(a, grid, block, smem, s);
  else
    err = launch_bwd_tile<T, false, false>(a, grid, block, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(static_cast<const float*>(a.partials), n_blocks,
                              n_acc, static_cast<float*>(dw_db), s);
}

}  // namespace

// Plain C interface for ctypes.  Strides are in elements; xp's last
// dimension, h0, c0, w_hh, b_hh, mask and the outputs are contiguous.
// `mask` may be null.  Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int fmda_lstm_scan_fwd_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w_hh, const void* b_hh, const void* mask,
    void* hs, void* cs, void* h_last, void* c_last, int B, int n_steps,
    int H, int reverse, int device, void* stream) {
  return launch<float>(xp, sxb, sxt, h0, c0, w_hh, b_hh, mask, hs, cs,
                       h_last, c_last, B, n_steps, H, reverse, device,
                       stream);
}

extern "C" int fmda_lstm_scan_fwd_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w_hh, const void* b_hh, const void* mask,
    void* hs, void* cs, void* h_last, void* c_last, int B, int n_steps,
    int H, int reverse, int device, void* stream) {
  return launch<__nv_bfloat16>(xp, sxb, sxt, h0, c0, w_hh, b_hh, mask, hs,
                               cs, h_last, c_last, B, n_steps, H, reverse,
                               device, stream);
}

// The backward.  Strides are in elements; xp's last dimension, h0, c0,
// w_hh, b_hh, hs, cs, dh_last and dc_last (float32), dhs, mask and the
// outputs are contiguous.  `mask` may be null.  dxp (B, T, 4H) comes out in
// the I/O dtype, dh0 and dc0 (B, H) in float32, and dw_db holds dW_hh
// (4H, H) then db_hh (4H) in float32.  `partials` is float32 scratch of
// fmda_lstm_scan_bwd_blocks(B, H, device) rows of 4H * H + 4H.  Returns
// cudaGetLastError() after the launches.
extern "C" int fmda_lstm_scan_bwd_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w_hh, const void* b_hh, const void* hs,
    const void* cs, const void* dh_last, const void* dc_last,
    const void* dhs, const void* mask, void* dxp, void* dh0, void* dc0,
    void* partials, void* dw_db, int B, int n_steps, int H, int reverse,
    int device, void* stream) {
  return launch_bwd<float>(
      BwdArgs{xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs, mask,
              dxp, dh0, dc0, partials, sxb, sxt, B, n_steps, H, 1, reverse},
      dw_db, device, stream);
}

extern "C" int fmda_lstm_scan_bwd_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w_hh, const void* b_hh, const void* hs,
    const void* cs, const void* dh_last, const void* dc_last,
    const void* dhs, const void* mask, void* dxp, void* dh0, void* dc0,
    void* partials, void* dw_db, int B, int n_steps, int H, int reverse,
    int device, void* stream) {
  return launch_bwd<__nv_bfloat16>(
      BwdArgs{xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs, mask,
              dxp, dh0, dc0, partials, sxb, sxt, B, n_steps, H, 1, reverse},
      dw_db, device, stream);
}

// Blocks the backward launches for (B, H): the rows of its `partials`.
extern "C" int fmda_lstm_scan_bwd_blocks(int B, int H, int device) {
  if (B <= 0 || H <= 0) return 0;
  const int rows = tile_rows(B, H, device);
  return (B + rows - 1) / rows;
}
