// GRU forward and backward scans for NVIDIA Hopper (sm_90a), bound to
// PyTorch via ctypes by fmda_tpu_torch/ops/gru_kernel.py (the library is
// built by fmda_tpu_torch/ops/_cuda_lib.py).
//
// ---- forward ----------------------------------------------------------------
// Replaces: fmda_tpu/ops/pallas_gru.py::_gru_step_kernel, the Pallas TPU
// kernel behind gru_scan_pallas.  Same function, not the same blocking:
//
//   hp = h . W_hh^T + b_hh
//   r = sigmoid(xr + hp_r)   z = sigmoid(xz + hp_z)   n = tanh(xn + r * hp_n)
//   h' = (1 - z) * n + z * h       (gates [r, z, n], torch convention)
//
// over precomputed input projections xp (B, T, 3H), giving hs (B, T, H) and
// h_last (B, H).  The TPU kernel walks a time-major (T, B, 3H) copy on a
// sequential grid sized for Mosaic's (8, 128) tiles; here one thread block
// owns a tile of batch rows and runs the whole time loop itself, reading xp
// batch-major through the strides it is given and writing hs in that order.
//
// What bounds it.  At the serving shapes (B <= 256, T = 30, H = 32) the
// bytes (xp in, hs out: about 4 MB at B = 256 f32) take about 1.2 us at
// 3.35 TB/s and the FLOPs less, but the recurrence is a chain of T
// dependent steps, each a small matrix-vector product, a few
// transcendentals and a block barrier.  The kernel is latency-bound by that
// chain, not by bytes or FLOPs.  What the design does about it:
//   - W_hh^T (12 KB at H = 32 f32) and the carry live in shared memory for
//     the whole sequence: no step touches device memory except to read its
//     xp slice and write its hs slice;
//   - the carry is double-buffered, so a step costs one __syncthreads();
//   - the next step's xp is loaded before the current step's dot products,
//     so its device-memory latency hides behind them;
//   - the batch tile shrinks until the grid covers the SMs, so a batch of
//     256 runs as 128 blocks of 2 rows rather than 32 blocks of 8.
//
// dtypes: float32 or bfloat16 I/O, gate algebra and accumulation in float32,
// the carry rounded to the I/O dtype after every step (the TPU kernel's
// `.astype(h.dtype)`).  h0, W_hh and b_hh arrive already in the I/O dtype.
// An optional (B, T) uint8 mask carries h through unchanged where it is 0,
// and hs repeats the carried h there (the lax.scan path's semantics).
//
// ---- backward ---------------------------------------------------------------
// Replaces: fmda_tpu/ops/pallas_gru.py::_gru_bwd_kernel.  It walks time in
// reverse processing order (t = T-1 .. 0 for the forward direction, 0 .. T-1
// for reverse), takes h_prev from h0 at the first processed step and from hs
// of the previous processed step otherwise, recomputes the gates from it and
// carries dh in float32:
//
//   dh += dhs[t];  dn = dh (1 - z);  dz = dh (h_prev - n)
//   dn_pre = dn (1 - n^2);  dr_pre = dn_pre hp_n r (1 - r);  dz_pre = dz z (1 - z)
//   dxp[t] = [dr_pre, dz_pre, dn_pre]                    (I/O dtype)
//   dg_h = [dr_pre, dz_pre, dn_pre r], rounded once to the I/O dtype, feeds
//   dh <- dh z + dg_h . W_hh,  dW_hh += dg_h^T . h_prev,  db_hh += sum_b dg_h
//
// dh0 is the final dh (float32); dW_hh and db_hh are float32 sums.  A masked
// step (mask 0) passes dh through and adds nothing to dxp, dW_hh or db_hh,
// which is the gradient of the masked forward.
//
// What bounds it.  At the training shape (256, 30, 32) f32 the bytes (xp, hs,
// dhs in, dxp out: about 7.9 MB) take about 2.4 us at 3.35 TB/s and the
// ~150 MFLOP about 2.2 us at 67 TFLOP/s, but like the forward it is a chain
// of T dependent steps, now with two block barriers each: it is latency-bound.
// What the design does about it, and about what Hopper lacks against the
// TPU's one-core sequential grid:
//   - one block owns a batch tile and runs the whole reverse time loop, as
//     the forward does, reading xp batch-major through its strides (no
//     time-major copy);
//   - one shared-memory copy of W_hh, rows padded to H + 1, serves both
//     products: in the gate recompute each thread walks its own row (the
//     pad puts a warp's reads on distinct banks), in the dh chain each
//     thread walks its own column; it fits up to H = 128 in float32 (about
//     190 in bfloat16), and past that W_hh is read from device memory;
//   - the weight gradient is a reduction over the batch, which is spread
//     over blocks.  Each block sums its rows' dg_h^T . h_prev over all T
//     steps into a float32 partial (shared memory when it fits beside
//     W_hh, as at H = 32; else, as at H = 128, the block's own slice of
//     the workspace), every entry owned by one thread, so no atomics; a
//     second kernel adds the partials of all blocks in block order.  The
//     result is the same from run to run;
//   - h_prev and dg_h of a step are double-buffered in shared memory, so a
//     step costs two barriers, and the next step's xp, dhs and h_prev are
//     loaded before the current step's products.

#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// W_hh^T stays in shared memory while it and the carry fit under this.
constexpr size_t kMaxSmemBytes = 200 * 1024;
// The backward's shared-memory budget: under the 227 KB a block may use.
constexpr size_t kMaxBwdSmemBytes = 225 * 1024;

// blockDim.x == rows * H: thread (r, j) owns hidden unit j of batch row
// blockIdx.x * rows + r.  Shared memory: the carry [2][rows][H] in f32
// (holding values already rounded to T), then W_hh^T [H][3H] in T when
// W_SMEM.
template <typename T, bool W_SMEM>
__global__ void __launch_bounds__(kMaxThreads) gru_scan_fwd_kernel(
    const T* __restrict__ xp, long long sxb, long long sxt,
    const T* __restrict__ h0, const T* __restrict__ w_hh,
    const T* __restrict__ b_hh, const uint8_t* __restrict__ mask,
    T* __restrict__ hs, T* __restrict__ h_last, int B, int n_steps, int H,
    int rows, int reverse) {
  extern __shared__ float smem[];
  float* hbuf = smem;
  T* wt = reinterpret_cast<T*>(smem + 2 * rows * H);

  const int tid = threadIdx.x;
  const int r = tid / H;
  const int j = tid - r * H;
  const int b = blockIdx.x * rows + r;
  const bool live = b < B;
  const int H3 = 3 * H;

  if (W_SMEM) {
    // coalesced read of W_hh (3H, H), transposed into [k][g] so that the
    // threads of a warp (consecutive j) read consecutive words
    for (int i = tid; i < H3 * H; i += blockDim.x) {
      const int g = i / H;
      const int k = i - g * H;
      wt[k * H3 + g] = w_hh[i];
    }
  }
  const float br = to_f32(b_hh[j]);
  const float bz = to_f32(b_hh[H + j]);
  const float bn = to_f32(b_hh[2 * H + j]);
  float h = live ? to_f32(h0[(long long)b * H + j]) : 0.0f;
  hbuf[r * H + j] = h;
  __syncthreads();

  const T* xrow = xp + (live ? (long long)b * sxb : 0);
  const uint8_t* mrow = mask ? mask + (live ? (long long)b * n_steps : 0)
                             : nullptr;
  float xr = 0.0f, xz = 0.0f, xn = 0.0f;
  bool keep = true;
  if (live && n_steps > 0) {
    const int t = reverse ? n_steps - 1 : 0;
    const T* x = xrow + t * sxt;
    xr = to_f32(x[j]);
    xz = to_f32(x[H + j]);
    xn = to_f32(x[2 * H + j]);
    keep = mrow ? mrow[t] != 0 : true;
  }

  int cur = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const float cr = xr, cz = xz, cn = xn;
    const bool ck = keep;
    if (live && s + 1 < n_steps) {  // prefetch the next step's slice
      const int tn = reverse ? t - 1 : t + 1;
      const T* x = xrow + tn * sxt;
      xr = to_f32(x[j]);
      xz = to_f32(x[H + j]);
      xn = to_f32(x[2 * H + j]);
      keep = mrow ? mrow[tn] != 0 : true;
    }

    const float* hc = hbuf + cur * rows * H + r * H;
    float ar = br, az = bz, an = bn;
    if (W_SMEM) {
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float hk = hc[k];
        const T* wk = wt + k * H3;
        ar = fmaf(hk, to_f32(wk[j]), ar);
        az = fmaf(hk, to_f32(wk[H + j]), az);
        an = fmaf(hk, to_f32(wk[2 * H + j]), an);
      }
    } else {
      const T* wr = w_hh + (long long)j * H;
      const T* wz = w_hh + (long long)(H + j) * H;
      const T* wn = w_hh + (long long)(2 * H + j) * H;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = hc[k];
        ar = fmaf(hk, to_f32(wr[k]), ar);
        az = fmaf(hk, to_f32(wz[k]), az);
        an = fmaf(hk, to_f32(wn[k]), an);
      }
    }
    const float rg = sigmoid_f32(cr + ar);
    const float zg = sigmoid_f32(cz + az);
    const float ng = tanhf(cn + rg * an);
    const float hnew = to_f32(from_f32<T>((1.0f - zg) * ng + zg * h));
    if (ck) h = hnew;
    if (live) hs[((long long)b * n_steps + t) * H + j] = from_f32<T>(h);
    hbuf[(cur ^ 1) * rows * H + r * H + j] = h;
    __syncthreads();
    cur ^= 1;
  }
  if (live) h_last[(long long)b * H + j] = from_f32<T>(h);
}

template <typename T>
int launch(const void* xp, long long sxb, long long sxt, const void* h0,
           const void* w_hh, const void* b_hh, const void* mask, void* hs,
           void* h_last, int B, int n_steps, int H, int reverse, int device,
           void* stream) {
  if (B <= 0 || H <= 0 || H > kMaxThreads || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rows = tile_rows(B, H, device);
  const size_t h_bytes = 2 * (size_t)rows * H * sizeof(float);
  const size_t w_bytes = 3 * (size_t)H * H * sizeof(T);
  const bool w_smem = h_bytes + w_bytes <= kMaxSmemBytes;
  const size_t smem = h_bytes + (w_smem ? w_bytes : 0);
  const dim3 grid((B + rows - 1) / rows);
  const dim3 block(rows * H);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(xp);
  const T* h = static_cast<const T*>(h0);
  const T* w = static_cast<const T*>(w_hh);
  const T* bb = static_cast<const T*>(b_hh);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* out = static_cast<T*>(hs);
  T* last = static_cast<T*>(h_last);
  if (w_smem) {
    err = allow_smem(gru_scan_fwd_kernel<T, true>, smem);
    if (err != cudaSuccess) return (int)err;
    gru_scan_fwd_kernel<T, true><<<grid, block, smem, s>>>(
        x, sxb, sxt, h, w, bb, m, out, last, B, n_steps, H, rows, reverse);
  } else {
    gru_scan_fwd_kernel<T, false><<<grid, block, smem, s>>>(
        x, sxb, sxt, h, w, bb, m, out, last, B, n_steps, H, rows, reverse);
  }
  return (int)cudaGetLastError();
}

// -- backward -----------------------------------------------------------------

// blockDim.x == rows * H: thread (r, j) owns hidden unit j of batch row
// blockIdx.x * rows + r, and the weight-gradient entries (g, j) for
// g = r, r + rows, r + 2 rows, ... < 3H (plus bias entries q = tid,
// tid + blockDim.x, ... < 3H), so each partial has one writer.
//
// Shared memory, in order: h_prev [2][rows][H] and dg_h [2][rows][3H] in f32
// (double-buffered by step parity); then, when ACC_SMEM, the block's partial
// [3H * H + 3H] in f32; then, when W_SMEM, W_hh [3H][H + 1] in T.  Without
// ACC_SMEM the partial accumulates in place in the block's workspace slice;
// without W_SMEM W_hh is read from device memory.
template <typename T, bool W_SMEM, bool ACC_SMEM>
__global__ void __launch_bounds__(kMaxThreads) gru_scan_bwd_kernel(
    const T* __restrict__ xp, long long sxb, long long sxt,
    const T* __restrict__ h0, const T* __restrict__ w_hh,
    const T* __restrict__ b_hh, const T* __restrict__ hs,
    const float* __restrict__ dh_last, const T* __restrict__ dhs,
    const uint8_t* __restrict__ mask, T* __restrict__ dxp,
    float* __restrict__ dh0, float* __restrict__ partials, int B,
    int n_steps, int H, int rows, int reverse) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int n_acc = H3 * H + H3;
  float* hbuf = smem;
  float* gbuf = hbuf + 2 * rows * H;
  float* acc_s = gbuf + 2 * rows * H3;
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
    for (int i = tid; i < H3 * H; i += nt) {
      const int g = i / H;
      w_s[g * ws + (i - g * H)] = w_hh[i];
    }
  }
  for (int g = r; g < H3; g += rows) acc[g * H + j] = 0.0f;
  for (int q = tid; q < H3; q += nt) acc[H3 * H + q] = 0.0f;

  const float br = to_f32(b_hh[j]);
  const float bz = to_f32(b_hh[H + j]);
  const float bn = to_f32(b_hh[2 * H + j]);
  float dh = live ? dh_last[(long long)b * H + j] : 0.0f;

  const T* xrow = xp + (live ? (long long)b * sxb : 0);
  const long long row_h = live ? (long long)b * n_steps * H : 0;
  const uint8_t* mrow = mask ? mask + (live ? (long long)b * n_steps : 0)
                             : nullptr;
  // step s of the backward walk: time index, and the h entering that step
  auto time_of = [&](int s) { return reverse ? s : n_steps - 1 - s; };
  auto load = [&](int s, float& xr, float& xz, float& xn, float& dhs_t,
                  float& hprev, bool& keep) {
    const int t = time_of(s);
    const T* x = xrow + t * sxt;
    xr = to_f32(x[j]);
    xz = to_f32(x[H + j]);
    xn = to_f32(x[2 * H + j]);
    dhs_t = to_f32(dhs[row_h + (long long)t * H + j]);
    const int tp = reverse ? t + 1 : t - 1;
    hprev = s == n_steps - 1 ? to_f32(h0[(long long)b * H + j])
                             : to_f32(hs[row_h + (long long)tp * H + j]);
    keep = mrow ? mrow[t] != 0 : true;
  };

  float xr = 0.0f, xz = 0.0f, xn = 0.0f, dhs_t = 0.0f, hprev = 0.0f;
  bool keep = true;
  if (live && n_steps > 0) load(0, xr, xz, xn, dhs_t, hprev, keep);

  int cur = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int t = time_of(s);
    const float cr = xr, cz = xz, cn = xn, cd = dhs_t;
    const bool ck = live && keep;
    float* hb = hbuf + cur * rows * H;
    float* gb = gbuf + cur * rows * H3;
    hb[r * H + j] = live ? hprev : 0.0f;
    if (live && s + 1 < n_steps)  // prefetch the next step's inputs
      load(s + 1, xr, xz, xn, dhs_t, hprev, keep);
    __syncthreads();

    // gate recompute: hp = h_prev . W_hh^T + b_hh, W_hh read down row
    // g * H + j (stride ws)
    const float* hc = hb + r * H;
    float ar = br, az = bz, an = bn;
    const T* wr = w + (long long)j * ws;
    const T* wz = w + (long long)(H + j) * ws;
    const T* wn = w + (long long)(2 * H + j) * ws;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = hc[k];
      ar = fmaf(hk, to_f32(wr[k]), ar);
      az = fmaf(hk, to_f32(wz[k]), az);
      an = fmaf(hk, to_f32(wn[k]), an);
    }
    const float rg = sigmoid_f32(cr + ar);
    const float zg = sigmoid_f32(cz + az);
    const float ng = tanhf(cn + rg * an);

    dh += cd;
    float dr_pre = 0.0f, dz_pre = 0.0f, dn_pre = 0.0f;
    if (ck) {
      const float dn = dh * (1.0f - zg);
      const float dz = dh * (hc[j] - ng);
      dn_pre = dn * (1.0f - ng * ng);
      const float dr = dn_pre * an;
      dr_pre = dr * rg * (1.0f - rg);
      dz_pre = dz * zg * (1.0f - zg);
    }
    if (live) {
      T* d = dxp + ((long long)b * n_steps + t) * H3;
      d[j] = from_f32<T>(dr_pre);
      d[H + j] = from_f32<T>(dz_pre);
      d[2 * H + j] = from_f32<T>(dn_pre);
    }
    // dg_h, rounded once to the I/O dtype; zero for masked and padding rows
    float* g = gb + r * H3;
    g[j] = to_f32(from_f32<T>(dr_pre));
    g[H + j] = to_f32(from_f32<T>(dz_pre));
    g[2 * H + j] = to_f32(from_f32<T>(dn_pre * rg));
    __syncthreads();

    // dh chain: dh <- dh z + dg_h . W_hh, W_hh read across rows (column j)
    if (ck) {
      float chain = 0.0f;
#pragma unroll 8
      for (int q = 0; q < H3; ++q)
        chain = fmaf(g[q], to_f32(w[(long long)q * ws + j]), chain);
      dh = fmaf(dh, zg, chain);
    }
    // this block's partials: dW_hh[g][j] += sum_rows dg_h[g] h_prev[j],
    // db_hh[q] += sum_rows dg_h[q]
    for (int gi = r; gi < H3; gi += rows) {
      float sum = 0.0f;
      for (int rr = 0; rr < rows; ++rr)
        sum = fmaf(gb[rr * H3 + gi], hb[rr * H + j], sum);
      acc[gi * H + j] += sum;
    }
    for (int q = tid; q < H3; q += nt) {
      float sum = 0.0f;
      for (int rr = 0; rr < rows; ++rr) sum += gb[rr * H3 + q];
      acc[H3 * H + q] += sum;
    }
    cur ^= 1;
  }
  if (live) dh0[(long long)b * H + j] = dh;
  if (ACC_SMEM) {  // each thread copies the entries it owns
    float* out = partials + (long long)blockIdx.x * n_acc;
    for (int gi = r; gi < H3; gi += rows) out[gi * H + j] = acc[gi * H + j];
    for (int q = tid; q < H3; q += nt) out[H3 * H + q] = acc[H3 * H + q];
  }
}

template <typename T, bool W_SMEM, bool ACC_SMEM>
cudaError_t launch_bwd_tile(dim3 grid, dim3 block, size_t smem,
                            cudaStream_t s, const T* x, long long sxb,
                            long long sxt, const T* h, const T* w,
                            const T* bb, const T* hs, const float* dhl,
                            const T* dhs, const uint8_t* m, T* dxp,
                            float* dh0, float* partials, int B, int n_steps,
                            int H, int rows, int reverse) {
  auto kernel = gru_scan_bwd_kernel<T, W_SMEM, ACC_SMEM>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, s>>>(x, sxb, sxt, h, w, bb, hs, dhl, dhs, m,
                                   dxp, dh0, partials, B, n_steps, H, rows,
                                   reverse);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* xp, long long sxb, long long sxt, const void* h0,
               const void* w_hh, const void* b_hh, const void* hs,
               const void* dh_last, const void* dhs, const void* mask,
               void* dxp, void* dh0, void* partials, void* dw_db, int B,
               int n_steps, int H, int reverse, int device, void* stream) {
  if (B <= 0 || H <= 0 || H > kMaxThreads || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rows = tile_rows(B, H, device);
  const int n_blocks = (B + rows - 1) / rows;
  const int n_acc = 3 * H * H + 3 * H;
  const size_t base = (2 * (size_t)rows * H + 2 * (size_t)rows * 3 * H) *
                      sizeof(float);
  const size_t w_bytes = 3 * (size_t)H * (H + 1) * sizeof(T);
  const size_t acc_bytes = (size_t)n_acc * sizeof(float);
  const bool w_smem = base + w_bytes <= kMaxBwdSmemBytes;
  const bool acc_smem =
      base + (w_smem ? w_bytes : 0) + acc_bytes <= kMaxBwdSmemBytes;
  const size_t smem =
      base + (w_smem ? w_bytes : 0) + (acc_smem ? acc_bytes : 0);
  const dim3 grid(n_blocks);
  const dim3 block(rows * H);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(xp);
  const T* h = static_cast<const T*>(h0);
  const T* w = static_cast<const T*>(w_hh);
  const T* bb = static_cast<const T*>(b_hh);
  const T* hsp = static_cast<const T*>(hs);
  const float* dhl = static_cast<const float*>(dh_last);
  const T* dhsp = static_cast<const T*>(dhs);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* dx = static_cast<T*>(dxp);
  float* d0 = static_cast<float*>(dh0);
  float* part = static_cast<float*>(partials);
  if (w_smem && acc_smem)
    err = launch_bwd_tile<T, true, true>(grid, block, smem, s, x, sxb, sxt,
                                         h, w, bb, hsp, dhl, dhsp, m, dx, d0,
                                         part, B, n_steps, H, rows, reverse);
  else if (w_smem)
    err = launch_bwd_tile<T, true, false>(grid, block, smem, s, x, sxb, sxt,
                                          h, w, bb, hsp, dhl, dhsp, m, dx, d0,
                                          part, B, n_steps, H, rows, reverse);
  else
    err = launch_bwd_tile<T, false, false>(grid, block, smem, s, x, sxb, sxt,
                                           h, w, bb, hsp, dhl, dhsp, m, dx,
                                           d0, part, B, n_steps, H, rows,
                                           reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(part, n_blocks, n_acc,
                              static_cast<float*>(dw_db), s);
}

}  // namespace

// Plain C interface for ctypes.  Strides are in elements; xp's last
// dimension, h0, w_hh, b_hh, mask, hs and h_last are contiguous.  `mask`
// may be null.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int fmda_gru_scan_fwd_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* w_hh, const void* b_hh, const void* mask, void* hs,
    void* h_last, int B, int n_steps, int H, int reverse, int device,
    void* stream) {
  return launch<float>(xp, sxb, sxt, h0, w_hh, b_hh, mask, hs, h_last, B,
                       n_steps, H, reverse, device, stream);
}

extern "C" int fmda_gru_scan_fwd_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* w_hh, const void* b_hh, const void* mask, void* hs,
    void* h_last, int B, int n_steps, int H, int reverse, int device,
    void* stream) {
  return launch<__nv_bfloat16>(xp, sxb, sxt, h0, w_hh, b_hh, mask, hs, h_last,
                               B, n_steps, H, reverse, device, stream);
}

// The backward.  Strides are in elements; xp's last dimension, h0, w_hh,
// b_hh, hs, dh_last (float32), dhs, mask and the outputs are contiguous.
// `mask` may be null.  dxp (B, T, 3H) comes out in the I/O dtype, dh0 (B, H)
// in float32, and dw_db holds dW_hh (3H, H) then db_hh (3H) in float32.
// `partials` is float32 scratch of fmda_gru_scan_bwd_blocks(B, H, device)
// rows of 3H * H + 3H.  Returns cudaGetLastError() after the launches.
extern "C" int fmda_gru_scan_bwd_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* w_hh, const void* b_hh, const void* hs, const void* dh_last,
    const void* dhs, const void* mask, void* dxp, void* dh0, void* partials,
    void* dw_db, int B, int n_steps, int H, int reverse, int device,
    void* stream) {
  return launch_bwd<float>(xp, sxb, sxt, h0, w_hh, b_hh, hs, dh_last, dhs,
                           mask, dxp, dh0, partials, dw_db, B, n_steps, H,
                           reverse, device, stream);
}

extern "C" int fmda_gru_scan_bwd_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* w_hh, const void* b_hh, const void* hs, const void* dh_last,
    const void* dhs, const void* mask, void* dxp, void* dh0, void* partials,
    void* dw_db, int B, int n_steps, int H, int reverse, int device,
    void* stream) {
  return launch_bwd<__nv_bfloat16>(xp, sxb, sxt, h0, w_hh, b_hh, hs, dh_last,
                                   dhs, mask, dxp, dh0, partials, dw_db, B,
                                   n_steps, H, reverse, device, stream);
}

// Blocks the backward launches for (B, H): the rows of its `partials`.
extern "C" int fmda_gru_scan_bwd_blocks(int B, int H, int device) {
  if (B <= 0 || H <= 0) return 0;
  const int rows = tile_rows(B, H, device);
  return (B + rows - 1) / rows;
}

// The message of a code any kernel of the library returns.
extern "C" const char* fmda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
