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
// Replaces: fmda_tpu/ops/pallas_gru.py::_gru_bwd_kernel, in two kernels:
// this file's serial sweep, and scan_dw.cu's weight gradient.  The sweep
// walks time in reverse processing order (t = T-1 .. 0 for the forward
// direction, 0 .. T-1 for reverse), takes h_prev from h0 at the first
// processed step and from hs of the previous processed step otherwise,
// recomputes the gates from it and carries dh in float32:
//
//   dh += dhs[t];  dn = dh (1 - z);  dz = dh (h_prev - n)
//   dn_pre = dn (1 - n^2);  dr_pre = dn_pre hp_n r (1 - r);  dz_pre = dz z (1 - z)
//   dxp[t] = [dr_pre, dz_pre, dn_pre]                    (I/O dtype)
//   dg_h = [dr_pre, dz_pre, dn_pre r], rounded once to the I/O dtype, feeds
//   dh <- dh z + dg_h . W_hh, and its n slice is written to dgn[t]
//
// dh0 is the final dh (float32).  dW_hh = sum dg_h^T . h_prev and db_hh =
// sum dg_h come from dxp's r and z slices and dgn in scan_dw.cu: nothing in
// the recurrence needs them, so they are out of the serial loop (the TPU
// kernel sums them in it, where its grid runs in order on one core anyway).
// A masked step (mask 0) passes dh through and writes zeros to dxp and dgn,
// so it adds nothing to dW_hh or db_hh: the gradient of the masked forward.
//
// What bounds it.  At the training shape (256, 30, 32) f32 the sweep's bytes
// (xp, hs, dhs in; dxp, dgn out: about 9 MB) take about 2.7 us at 3.35 TB/s
// and its ~100 MFLOP about 1.5 us at 67 TFLOP/s, but it is a chain of T
// dependent steps, each two small matrix-vector products, three
// transcendentals and a block barrier: latency-bound.  The design shortens
// the step (layout in scan_common.cuh):
//   - one block per batch row, L = 4 lanes per hidden unit: a lane does a
//     quarter of each dot product (of k in the gate recompute, of q in the
//     dh chain) and two butterfly shuffles add the quarters, so a step's
//     serial FMA chains are L times shorter and a row has L times the warps;
//   - at H <= 32 each lane holds its slices of W_hh in registers for the
//     whole sequence (24 values of the three gate rows it recomputes, 24 of
//     the column it chains) and reads h_prev and dg_h from shared memory as
//     float4s; wider, W_hh is read from shared memory (rows padded to H + L)
//     while it fits, as at H = 128 f32, and from device memory past that;
//   - the next step's h_prev is read from hs a step ahead and published by
//     the barrier that exchanges this step's dg_h, so a step has one barrier
//     (both buffers double-buffered by step parity); the next step's xp and
//     dhs are loaded before this step's products, through pointers that
//     move a step at a time, and held in the I/O dtype until used;
//   - each lane writes the same number of outputs, chosen by select, so the
//     stores do not diverge; the gate sigmoids use an approximate
//     reciprocal (sigmoid_rcp_f32), whose call-free code keeps the kernel
//     from spilling;
//   - the per-step weight-gradient partials of the earlier design (48
//     shared-memory read-modify-writes a thread a step, and a barrier) are
//     out of the loop.
// What is left is the step's chain of dependent latencies: the lane sums'
// shuffles, the transcendentals, the barrier and the dh chain's shared-
// memory reads (PERF.md has the measured split of a step).

#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// W_hh^T stays in shared memory while it and the carry fit under this.
constexpr size_t kMaxSmemBytes = 200 * 1024;

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

// -- backward: the serial sweep ------------------------------------------------

// Block b sweeps batch row b with blockDim.x == H * L: lane l of hidden unit
// j is thread j * L + l.  Shared memory: h_prev [2][HP] and dg_h [2][QP] in
// f32 (by step parity; HP = QP / 3 = 32 with W_REG, whose pads stay 0), then
// W_hh [3H][H + L] in T when W_SMEM.
//
// With W_REG (L == kSweepLanes, H <= 32) lane l holds the float4 chunks
// l, l + L, ... of the k axis of its unit's three gate rows (wr, wz, wn) and
// of the q axis of its unit's column (wc), 0 past H and 3H.  Otherwise lane
// l takes k = l, l + L, ... and q = l, l + L, ... and reads W_hh from w.
template <typename T, int L, bool W_REG, bool W_SMEM>
__global__ void __launch_bounds__(W_REG ? kSweepRegThreads : kMaxThreads)
    gru_scan_sweep_kernel(const T* __restrict__ xp, long long sxb,
                          long long sxt, const T* __restrict__ h0,
                          const T* __restrict__ w_hh,
                          const T* __restrict__ b_hh,
                          const T* __restrict__ hs,
                          const float* __restrict__ dh_last,
                          const T* __restrict__ dhs,
                          const uint8_t* __restrict__ mask,
                          T* __restrict__ dxp, T* __restrict__ dgn,
                          float* __restrict__ dh0, int n_steps, int H,
                          int reverse) {
  extern __shared__ __align__(16) float sweep_smem[];
  constexpr int KR = W_REG ? kSweepRegH / L : 1;  // register k a gate row
  constexpr int QR = W_REG ? 3 * KR : 1;           // register q a column
  const int H3 = 3 * H;
  const int HP = W_REG ? L * KR : H;
  const int QP = W_REG ? L * QR : H3;
  float* hbuf = sweep_smem;
  float* gbuf = hbuf + 2 * HP;
  T* w_s = reinterpret_cast<T*>(gbuf + 2 * QP);
  const T* w = W_SMEM ? w_s : w_hh;
  const int ws = W_SMEM ? H + L : H;  // row stride of w

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int j = tid / L;
  const int l = tid - j * L;
  const long long b = blockIdx.x;
  const unsigned wmask = warp_mask();

  float wr[KR], wz[KR], wn[KR], wc[QR];
  if constexpr (W_REG) {
#pragma unroll
    for (int c = 0; c < KR; ++c) {
      const int k = 4 * (l + L * (c / 4)) + c % 4;
      const bool in = k < H;
      wr[c] = in ? to_f32(w_hh[(long long)j * H + k]) : 0.0f;
      wz[c] = in ? to_f32(w_hh[(long long)(H + j) * H + k]) : 0.0f;
      wn[c] = in ? to_f32(w_hh[(long long)(2 * H + j) * H + k]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < QR; ++c) {
      const int q = 4 * (l + L * (c / 4)) + c % 4;
      wc[c] = q < H3 ? to_f32(w_hh[(long long)q * H + j]) : 0.0f;
    }
    for (int i = tid; i < 2 * (HP + QP); i += nt) sweep_smem[i] = 0.0f;
  }
  if constexpr (W_SMEM) {
    for (int i = tid; i < H3 * H; i += nt) {
      const int g = i / H;
      w_s[g * ws + (i - g * H)] = w_hh[i];
    }
  }
  const float br = to_f32(b_hh[j]);
  const float bz = to_f32(b_hh[H + j]);
  const float bn = to_f32(b_hh[2 * H + j]);
  float dh = dh_last[b * H + j];

  // The walk: step s is time t = T-1-s (forward direction) or s (reverse),
  // and the next step's time is t + dt.  The h entering step s is the
  // forward's at the time of step s + 1, or h0 at the last step.  Loads run
  // a step ahead through pointers that move by dt, held in T until used so
  // that no conversion waits on a load.
  const int dt = reverse ? 1 : -1;
  const int t0 = reverse ? 0 : n_steps - 1;
  const T* xq = xp + b * sxb + (long long)t0 * sxt;  // the next step's xp
  long long hq = (b * n_steps + t0) * H + j;         // ... its (b, t, j)
  const uint8_t* mq = mask ? mask + b * n_steps + t0 : nullptr;
  int left = n_steps;                                // steps not loaded
  T xr{}, xz{}, xn{}, dhs_t{}, hprev{};
  bool keep = true;
  auto load = [&]() {
    xr = xq[j];
    xz = xq[H + j];
    xn = xq[2 * H + j];
    dhs_t = dhs[hq];
    hprev = --left == 0 ? h0[b * H + j] : hs[hq + dt * H];
    if (mq) {
      keep = *mq != 0;
      mq += dt;
    }
    xq += dt * sxt;
    hq += dt * H;
  };
  if (n_steps > 0) load();
  __syncthreads();  // the zeroed pads and W_hh before h_prev
  if (l == 0) hbuf[j] = to_f32(hprev);
  __syncthreads();
  // this step's dxp row and dgn entry at this lane's unit
  T* dq = dxp + (b * n_steps + t0) * H3 + j;
  T* nq = dgn + (b * n_steps + t0) * H + j;

  SWEEP_PROFILE;
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    PROF_MARK(4);
    const float cr = to_f32(xr), cz = to_f32(xz), cn = to_f32(xn);
    const float cd = to_f32(dhs_t), ch = to_f32(hprev);
    const bool ck = keep;
    if (s + 1 < n_steps) load();  // prefetch the next step

    // gate recompute: this lane's share of h_prev . W_hh^T, then the lanes'
    // shares added
    const float* hc = hbuf + cur * HP;
    float ar = 0.0f, az = 0.0f, an = 0.0f;
    if constexpr (W_REG) {
#pragma unroll
      for (int c = 0; c < KR / 4; ++c) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hc + 4 * (l + L * c));
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          ar = fmaf(hk[v], wr[4 * c + v], ar);
          az = fmaf(hk[v], wz[4 * c + v], az);
          an = fmaf(hk[v], wn[4 * c + v], an);
        }
      }
    } else {
      const T* wrow = w + (long long)j * ws;
      const long long gstride = (long long)H * ws;
#pragma unroll 4
      for (int k = l; k < H; k += L) {
        const float hk = hc[k];
        ar = fmaf(hk, to_f32(wrow[k]), ar);
        az = fmaf(hk, to_f32(wrow[gstride + k]), az);
        an = fmaf(hk, to_f32(wrow[2 * gstride + k]), an);
      }
    }
    ar = lane_sum<L>(ar, wmask) + br;
    az = lane_sum<L>(az, wmask) + bz;
    an = lane_sum<L>(an, wmask) + bn;
    PROF_MARK(0);
    const float rg = sigmoid_rcp_f32(cr + ar);
    const float zg = sigmoid_rcp_f32(cz + az);
    const float ng = tanhf(cn + rg * an);

    dh += cd;
    float dr_pre = 0.0f, dz_pre = 0.0f, dn_pre = 0.0f;
    if (ck) {
      const float dn = dh * (1.0f - zg);
      const float dz = dh * (ch - ng);
      dn_pre = dn * (1.0f - ng * ng);
      dr_pre = dn_pre * an * rg * (1.0f - rg);
      dz_pre = dz * zg * (1.0f - zg);
    }
    // dg_h = [dr_pre, dz_pre, dn_pre r] rounded once to T, and dn_pre.
    // Output o (dg_h's three slices, the third also to dgn; dn_pre to
    // dxp's n slice) is written by lane o % L, every lane the same number,
    // selected rather than branched to
    float* g = gbuf + cur * QP;
#pragma unroll
    for (int n = 0; n < 4 / L; ++n) {
      const int o = l + n * L;
      const float v = round_to<T>(o == 0   ? dr_pre
                                  : o == 1 ? dz_pre
                                  : o == 2 ? dn_pre * rg
                                           : dn_pre);
      if (o < 3) g[o * H + j] = v;
      *(o == 2 ? nq : dq + (o == 3 ? 2 : o) * H) = from_f32<T>(v);
    }
    dq += dt * H3;
    nq += dt * H;
    PROF_MARK(1);
    if (l == 0 && s + 1 < n_steps) hbuf[(cur ^ 1) * HP + j] = to_f32(hprev);
    __syncthreads();
    PROF_MARK(2);

    // dh chain: dh <- dh z + dg_h . W_hh[:, j], this lane's share of q
    if (ck) {
      float chain;
      if constexpr (W_REG) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < QR / 4; ++c) {
          const float4 gq =
              *reinterpret_cast<const float4*>(g + 4 * (l + L * c));
          acc[0] = fmaf(gq.x, wc[4 * c], acc[0]);
          acc[1] = fmaf(gq.y, wc[4 * c + 1], acc[1]);
          acc[2] = fmaf(gq.z, wc[4 * c + 2], acc[2]);
          acc[3] = fmaf(gq.w, wc[4 * c + 3], acc[3]);
        }
        chain = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      } else {
        chain = 0.0f;
#pragma unroll 4
        for (int q = l; q < H3; q += L)
          chain = fmaf(g[q], to_f32(w[(long long)q * ws + j]), chain);
      }
      dh = fmaf(dh, zg, lane_sum<L>(chain, wmask));
    }
    PROF_MARK(3);
  }
  PROF_FLUSH();
  if (l == 0) dh0[b * H + j] = dh;
}

// The sweep's arguments, as the C entry points receive them.
struct SweepArgs {
  const void *xp, *h0, *w_hh, *b_hh, *hs, *dh_last, *dhs, *mask;
  void *dxp, *dgn, *dh0;
  long long sxb, sxt;
  int B, n_steps, H, reverse;
};

template <typename T, int L, bool W_REG, bool W_SMEM>
cudaError_t launch_sweep_as(const SweepArgs& a, size_t smem, cudaStream_t s) {
  auto kernel = gru_scan_sweep_kernel<T, L, W_REG, W_SMEM>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, a.H * L, smem, s>>>(
      static_cast<const T*>(a.xp), a.sxb, a.sxt, static_cast<const T*>(a.h0),
      static_cast<const T*>(a.w_hh), static_cast<const T*>(a.b_hh),
      static_cast<const T*>(a.hs), static_cast<const float*>(a.dh_last),
      static_cast<const T*>(a.dhs), static_cast<const uint8_t*>(a.mask),
      static_cast<T*>(a.dxp), static_cast<T*>(a.dgn),
      static_cast<float*>(a.dh0), a.n_steps, a.H, a.reverse);
  return cudaGetLastError();
}

template <typename T>
int launch_sweep(const SweepArgs& a, int device, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.H > kMaxThreads || a.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int H = a.H;
  constexpr int L = kSweepLanes;
  if (H <= kSweepRegH) {
    const size_t smem = 2 * (size_t)kSweepRegH * (1 + 3) * sizeof(float);
    return (int)launch_sweep_as<T, L, true, false>(a, smem, s);
  }
  const int lanes = sweep_lanes(H, kMaxThreads);
  const size_t base = 2 * (size_t)(H + 3 * H) * sizeof(float);
  const size_t w_bytes = 3 * (size_t)H * (H + lanes) * sizeof(T);
  const bool w_smem = base + w_bytes <= kMaxSweepSmemBytes;
  const size_t smem = base + (w_smem ? w_bytes : 0);
  // one lane a unit only past H = kMaxThreads / L, where W_hh never fits
  if (lanes == 1) return (int)launch_sweep_as<T, 1, false, false>(a, smem, s);
  err = w_smem ? launch_sweep_as<T, L, false, true>(a, smem, s)
               : launch_sweep_as<T, L, false, false>(a, smem, s);
  return (int)err;
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

// The backward's serial sweep.  Strides are in elements; xp's last
// dimension, h0, w_hh, b_hh, hs, dh_last (float32), dhs, mask and the
// outputs are contiguous.  `mask` may be null.  dxp (B, T, 3H) and dgn
// (B, T, H), dg_h's n slice round(dn_pre * r), come out in the I/O dtype,
// dh0 (B, H) in float32; fmda_scan_dw_* takes dxp and dgn to dW_hh and
// db_hh.  Returns cudaGetLastError() after the launch.
extern "C" int fmda_gru_scan_sweep_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* w_hh, const void* b_hh, const void* hs, const void* dh_last,
    const void* dhs, const void* mask, void* dxp, void* dgn, void* dh0,
    int B, int n_steps, int H, int reverse, int device, void* stream) {
  return launch_sweep<float>(
      SweepArgs{xp, h0, w_hh, b_hh, hs, dh_last, dhs, mask, dxp, dgn, dh0,
                sxb, sxt, B, n_steps, H, reverse},
      device, stream);
}

extern "C" int fmda_gru_scan_sweep_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* w_hh, const void* b_hh, const void* hs, const void* dh_last,
    const void* dhs, const void* mask, void* dxp, void* dgn, void* dh0,
    int B, int n_steps, int H, int reverse, int device, void* stream) {
  return launch_sweep<__nv_bfloat16>(
      SweepArgs{xp, h0, w_hh, b_hh, hs, dh_last, dhs, mask, dxp, dgn, dh0,
                sxb, sxt, B, n_steps, H, reverse},
      device, stream);
}
// The message of a code any kernel of the library returns.
extern "C" const char* fmda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef FMDA_PROFILE_SWEEP
extern "C" int fmda_gru_sweep_prof(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_sweep_prof, sizeof(g_sweep_prof));
}
#endif
