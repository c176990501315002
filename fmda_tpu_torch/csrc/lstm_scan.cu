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
// As in gru_scan.cu, a CTA owns one to four batch rows and runs the whole
// time loop, reading xp batch-major through the strides it is given, where
// the TPU kernel walks a time-major copy on a sequential grid; the body is
// scan_common.cuh's scan_fwd_kernel with this file's LstmFwdCell.
//
// What bounds it.  At the serving shape (256, 30, 32) f32 the bytes (xp in,
// hs and cs out: about 5.9 MB) take about 1.8 us at 3.35 TB/s and the FLOPs
// less, but the recurrence is a chain of T dependent steps, each a small
// matrix-vector product, five transcendentals and a barrier: latency-bound.
// The design is gru_scan.cu's with four gates and a second carry:
//   - four lanes a unit, W_hh in registers at H <= 32 (32 values a lane),
//     in padded shared memory while it fits (128 KB + pads at H = 128
//     bf16), h read as float4s, one barrier a step; c never leaves its
//     lanes' registers: only unit j needs c[j];
//   - H = 128 f32, whose W_hh (256 KB) fits no block: a cluster of two
//     CTAs on neighbouring SMs, each holding the rows of half the units
//     (147 KB with pads) and computing those units for four rows a CTA at
//     B = 256; each writes its half of the new h into both CTAs' h buffers
//     through distributed shared memory and the step ends at one cluster
//     barrier;
//   - wider still (up to H = 512), W_hh from device memory in 4-wide
//     k-chunks, one lane a unit past H = 128.
//
// ---- backward ---------------------------------------------------------------
// Replaces: fmda_tpu/ops/pallas_lstm.py::_lstm_bwd_kernel, in two kernels:
// this file's serial sweep, and scan_dw.cu's weight gradient.  The sweep
// walks time in reverse processing order, takes h_prev and c_prev from h0
// and c0 at the first processed step and from hs and cs of the previous
// processed step otherwise, recomputes the gates from (h_prev, xp), takes
// tanh(c) from the rounded cs, and carries dh and dc in float32:
//
//   dh += dhs[t];  do = dh tanh(c);  dc += dh o (1 - tanh(c)^2)
//   dgates = [dc g i (1-i), dc c_prev f (1-f), dc i (1-g^2), do o (1-o)],
//     rounded once to the I/O dtype: that one value is dxp[t] and feeds
//   dh <- dgates . W_hh,  dc <- dc f
//
// dh0 and dc0 are the final dh and dc (float32).  dW_hh = sum dgates^T .
// h_prev and db_hh = sum dgates come from dxp in scan_dw.cu, after the
// sweep: nothing in the recurrence needs them.  dh_last and dc_last are
// read, whatever they hold.  A masked step (mask 0) passes dh (after adding
// dhs[t]) and dc through and writes zeros to dxp, so it adds nothing to
// dW_hh or db_hh: the gradient of the masked forward.
//
// What bounds it.  At the training shape (256, 30, 32) f32 the sweep's bytes
// (xp, hs, cs, dhs in, dxp out: about 11.8 MB) take about 3.5 us at
// 3.35 TB/s and its ~130 MFLOP about 2 us at 67 TFLOP/s, but like the
// forward it is a chain of T dependent steps: latency-bound.  The design is
// gru_scan.cu's sweep with four gates and a second carry (layout in
// scan_common.cuh):
//   - one block per batch row, L = 4 lanes per hidden unit, each lane a
//     quarter of every dot product, the quarters added by two butterfly
//     shuffles;
//   - at H <= 32 each lane holds 64 values of W_hh in registers (a quarter
//     of its unit's four gate rows, and of its column); wider, W_hh is read
//     from shared memory (rows padded to H + L) while it fits, as at H = 128
//     in bfloat16 (133 KB), and from device memory past that, as at H = 128
//     in float32 (266 KB);
//   - the next step's h_prev is read from hs a step ahead and published by
//     the barrier that exchanges this step's dgates: one barrier a step; c
//     never leaves its lanes' registers: only unit j needs c[j]; loads,
//     stores and the gate sigmoids as in gru_scan.cu's sweep;
//   - the per-step weight-gradient partials of the earlier design (64
//     shared-memory read-modify-writes a thread a step, and a barrier) are
//     out of the loop.
//
// Registers: the sweep's blocks outside the register layout and the
// forward's device-memory branch with one lane a unit are bounded at
// kMaxThreads = 512 threads, which leaves a thread up to 128 registers, so
// the wrapper takes H <= 512; the sweep's blocks inside the register
// layout are bounded at kScanRegThreads = 128 threads, the forward's other
// blocks as fwd_block_limit (scan_common.cuh) says.

#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 512;

// The forward's cell for scan_fwd_kernel (scan_common.cuh): gates
// [i, f, g, o]; c' from the carried (rounded) c, h' from the unrounded c'.
struct LstmFwdCell {
  static constexpr int kGates = 4;
  static constexpr bool kCarriesC = true;
  static constexpr int kThreadLimit = kMaxThreads;
  static constexpr int kHiddenLimit = kMaxThreads;
  template <typename T>
  __device__ __forceinline__ static void step(const float* x, const float* a,
                                              float& h, float& c, bool keep) {
    const float ig = sigmoid_rcp_f32(x[0] + a[0]);
    const float fg = sigmoid_rcp_f32(x[1] + a[1]);
    const float gg = tanhf(x[2] + a[2]);
    const float og = sigmoid_rcp_f32(x[3] + a[3]);
    const float c_new = fg * c + ig * gg;
    const float h_new = og * tanhf(c_new);
    h = keep ? round_to<T>(h_new) : h;
    c = keep ? round_to<T>(c_new) : c;
  }
};

template <typename T>
int launch(const void* xp, long long sxb, long long sxt, const void* h0,
           const void* c0, const void* w_hh, const void* b_hh,
           const void* mask, void* hs, void* cs, void* h_last, void* c_last,
           int B, int n_steps, int H, int reverse, int device, void* stream) {
  FwdArgs<T> a{};
  a.xp = static_cast<const T*>(xp);
  a.sxb = sxb;
  a.sxt = sxt;
  a.h0 = static_cast<const T*>(h0);
  a.c0 = static_cast<const T*>(c0);
  a.w_hh = static_cast<const T*>(w_hh);
  a.b_hh = static_cast<const T*>(b_hh);
  a.mask = static_cast<const uint8_t*>(mask);
  a.hs = static_cast<T*>(hs);
  a.cs = static_cast<T*>(cs);
  a.h_last = static_cast<T*>(h_last);
  a.c_last = static_cast<T*>(c_last);
  a.B = B;
  a.n_steps = n_steps;
  a.H = H;
  a.reverse = reverse;
  return launch_fwd<LstmFwdCell, T>(a, device, stream);
}

// -- backward: the serial sweep ------------------------------------------------

// Block b sweeps batch row b with blockDim.x == H * L: lane l of hidden unit
// j is thread j * L + l.  Shared memory: h_prev [2][HP] and dgates [2][QP]
// in f32 (by step parity; HP = QP / 4 = 32 with W_REG, whose pads stay 0),
// then W_hh [4H][H + L] in T when W_SMEM.  The lanes' shares of W_hh are
// laid out as in gru_scan.cu's sweep, with four gate rows (wi, wf, wg, wo).
template <typename T, int L, bool W_REG, bool W_SMEM>
__global__ void __launch_bounds__(W_REG ? kScanRegThreads : kMaxThreads)
    lstm_scan_sweep_kernel(const T* __restrict__ xp, long long sxb,
                           long long sxt, const T* __restrict__ h0,
                           const T* __restrict__ c0,
                           const T* __restrict__ w_hh,
                           const T* __restrict__ b_hh,
                           const T* __restrict__ hs, const T* __restrict__ cs,
                           const float* __restrict__ dh_last,
                           const float* __restrict__ dc_last,
                           const T* __restrict__ dhs,
                           const uint8_t* __restrict__ mask,
                           T* __restrict__ dxp, float* __restrict__ dh0,
                           float* __restrict__ dc0, int n_steps, int H,
                           int reverse) {
  extern __shared__ __align__(16) float sweep_smem[];
  constexpr int KR = W_REG ? kScanRegH / L : 1;
  constexpr int QR = W_REG ? 4 * KR : 1;
  const int H4 = 4 * H;
  const int HP = W_REG ? L * KR : H;
  const int QP = W_REG ? L * QR : H4;
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

  float wi[KR], wf[KR], wg[KR], wo[KR], wc[QR];
  if constexpr (W_REG) {
#pragma unroll
    for (int c = 0; c < KR; ++c) {
      const int k = 4 * (l + L * (c / 4)) + c % 4;
      const bool in = k < H;
      wi[c] = in ? to_f32(w_hh[(long long)j * H + k]) : 0.0f;
      wf[c] = in ? to_f32(w_hh[(long long)(H + j) * H + k]) : 0.0f;
      wg[c] = in ? to_f32(w_hh[(long long)(2 * H + j) * H + k]) : 0.0f;
      wo[c] = in ? to_f32(w_hh[(long long)(3 * H + j) * H + k]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < QR; ++c) {
      const int q = 4 * (l + L * (c / 4)) + c % 4;
      wc[c] = q < H4 ? to_f32(w_hh[(long long)q * H + j]) : 0.0f;
    }
    for (int i = tid; i < 2 * (HP + QP); i += nt) sweep_smem[i] = 0.0f;
  }
  if constexpr (W_SMEM) {
    for (int i = tid; i < H4 * H; i += nt) {
      const int g = i / H;
      w_s[g * ws + (i - g * H)] = w_hh[i];
    }
  }
  const float bi = to_f32(b_hh[j]);
  const float bf = to_f32(b_hh[H + j]);
  const float bg = to_f32(b_hh[2 * H + j]);
  const float bo = to_f32(b_hh[3 * H + j]);
  float dh = dh_last[b * H + j];
  float dc = dc_last[b * H + j];

  // The walk: step s is time t = T-1-s (forward direction) or s (reverse),
  // and the next step's time is t + dt.  The state entering step s is the
  // forward's at the time of step s + 1, or h0/c0 at the last step.  Loads
  // run a step ahead through pointers that move by dt, held in T until
  // used so that no conversion waits on a load.
  const int dt = reverse ? 1 : -1;
  const int t0 = reverse ? 0 : n_steps - 1;
  const T* xq = xp + b * sxb + (long long)t0 * sxt;  // the next step's xp
  long long hq = (b * n_steps + t0) * H + j;         // ... its (b, t, j)
  const uint8_t* mq = mask ? mask + b * n_steps + t0 : nullptr;
  int left = n_steps;                                // steps not loaded
  T xi{}, xf{}, xg{}, xo{}, dhs_t{}, hprev{}, cprev{}, cnew{};
  bool keep = true;
  auto load = [&]() {
    xi = xq[j];
    xf = xq[H + j];
    xg = xq[2 * H + j];
    xo = xq[3 * H + j];
    dhs_t = dhs[hq];
    cnew = cs[hq];
    const bool first = --left == 0;  // the forward's first step
    hprev = first ? h0[b * H + j] : hs[hq + dt * H];
    cprev = first ? c0[b * H + j] : cs[hq + dt * H];
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
  // this step's dxp row at this lane's unit
  T* dq = dxp + (b * n_steps + t0) * H4 + j;

  SWEEP_PROFILE;
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    PROF_MARK(4);
    const float ci = to_f32(xi), cf = to_f32(xf), cg = to_f32(xg);
    const float co = to_f32(xo), cd = to_f32(dhs_t);
    const float cp = to_f32(cprev), cn = to_f32(cnew);
    const bool ck = keep;
    if (s + 1 < n_steps) load();  // prefetch the next step

    // gate recompute: this lane's share of h_prev . W_hh^T, then the lanes'
    // shares added
    const float* hc = hbuf + cur * HP;
    float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
    if constexpr (W_REG) {
#pragma unroll
      for (int c = 0; c < KR / 4; ++c) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hc + 4 * (l + L * c));
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          ai = fmaf(hk[v], wi[4 * c + v], ai);
          af = fmaf(hk[v], wf[4 * c + v], af);
          ag = fmaf(hk[v], wg[4 * c + v], ag);
          ao = fmaf(hk[v], wo[4 * c + v], ao);
        }
      }
    } else {
      const T* wrow = w + (long long)j * ws;
      const long long gstride = (long long)H * ws;
#pragma unroll 4
      for (int k = l; k < H; k += L) {
        const float hk = hc[k];
        ai = fmaf(hk, to_f32(wrow[k]), ai);
        af = fmaf(hk, to_f32(wrow[gstride + k]), af);
        ag = fmaf(hk, to_f32(wrow[2 * gstride + k]), ag);
        ao = fmaf(hk, to_f32(wrow[3 * gstride + k]), ao);
      }
    }
    ai = lane_sum<L>(ai, wmask);
    af = lane_sum<L>(af, wmask);
    ag = lane_sum<L>(ag, wmask);
    ao = lane_sum<L>(ao, wmask);
    PROF_MARK(0);
    const float ig = sigmoid_rcp_f32(ci + (ai + bi));
    const float fg = sigmoid_rcp_f32(cf + (af + bf));
    const float gg = tanhf(cg + (ag + bg));
    const float og = sigmoid_rcp_f32(co + (ao + bo));
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
    // dgates rounded once to T (zero for masked steps): dxp, and the
    // operand of the dh chain.  Gate o is written by lane o % L, every lane
    // the same number, selected rather than branched to
    float* g = gbuf + cur * QP;
#pragma unroll
    for (int n = 0; n < 4 / L; ++n) {
      const int o = l + n * L;
      const float v = round_to<T>(o == 0 ? di : o == 1 ? df : o == 2 ? dg
                                                                     : dout);
      g[o * H + j] = v;
      dq[o * H] = from_f32<T>(v);
    }
    dq += dt * H4;
    PROF_MARK(1);
    if (l == 0 && s + 1 < n_steps) hbuf[(cur ^ 1) * HP + j] = to_f32(hprev);
    __syncthreads();
    PROF_MARK(2);

    // dh <- dgates . W_hh[:, j], this lane's share of q; dc <- dc f
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
        for (int q = l; q < H4; q += L)
          chain = fmaf(g[q], to_f32(w[(long long)q * ws + j]), chain);
      }
      dh = lane_sum<L>(chain, wmask);
      dc *= fg;
    }
    PROF_MARK(3);
  }
  PROF_FLUSH();
  if (l == 0) {
    dh0[b * H + j] = dh;
    dc0[b * H + j] = dc;
  }
}

// The sweep's arguments, as the C entry points receive them.
struct SweepArgs {
  const void *xp, *h0, *c0, *w_hh, *b_hh, *hs, *cs, *dh_last, *dc_last,
      *dhs, *mask;
  void *dxp, *dh0, *dc0;
  long long sxb, sxt;
  int B, n_steps, H, reverse;
};

template <typename T, int L, bool W_REG, bool W_SMEM>
cudaError_t launch_sweep_as(const SweepArgs& a, size_t smem, cudaStream_t s) {
  auto kernel = lstm_scan_sweep_kernel<T, L, W_REG, W_SMEM>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, a.H * L, smem, s>>>(
      static_cast<const T*>(a.xp), a.sxb, a.sxt, static_cast<const T*>(a.h0),
      static_cast<const T*>(a.c0), static_cast<const T*>(a.w_hh),
      static_cast<const T*>(a.b_hh), static_cast<const T*>(a.hs),
      static_cast<const T*>(a.cs), static_cast<const float*>(a.dh_last),
      static_cast<const float*>(a.dc_last), static_cast<const T*>(a.dhs),
      static_cast<const uint8_t*>(a.mask), static_cast<T*>(a.dxp),
      static_cast<float*>(a.dh0), static_cast<float*>(a.dc0), a.n_steps,
      a.H, a.reverse);
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
  constexpr int L = kScanLanes;
  if (H <= kScanRegH) {
    const size_t smem = 2 * (size_t)kScanRegH * (1 + 4) * sizeof(float);
    return (int)launch_sweep_as<T, L, true, false>(a, smem, s);
  }
  const int lanes = scan_lanes(H, kMaxThreads);
  const size_t base = 2 * (size_t)(H + 4 * H) * sizeof(float);
  const size_t w_bytes = 4 * (size_t)H * (H + lanes) * sizeof(T);
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

// How the forward would run (B, H) in a dtype of `itemsize` bytes, as the
// launcher decides it (the layout of fmda_gru_scan_fwd_plan's out).
extern "C" int fmda_lstm_scan_fwd_plan(int B, int H, int itemsize,
                                       int device, int* out) {
  return report_fwd_plan<LstmFwdCell>(B, H, itemsize, device, out);
}

// The backward's serial sweep.  Strides are in elements; xp's last
// dimension, h0, c0, w_hh, b_hh, hs, cs, dh_last and dc_last (float32), dhs,
// mask and the outputs are contiguous.  `mask` may be null.  dxp (B, T, 4H)
// comes out in the I/O dtype, dh0 and dc0 (B, H) in float32;
// fmda_scan_dw_* takes dxp to dW_hh and db_hh.  Returns cudaGetLastError()
// after the launch.
extern "C" int fmda_lstm_scan_sweep_f32(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w_hh, const void* b_hh, const void* hs,
    const void* cs, const void* dh_last, const void* dc_last,
    const void* dhs, const void* mask, void* dxp, void* dh0, void* dc0,
    int B, int n_steps, int H, int reverse, int device, void* stream) {
  return launch_sweep<float>(
      SweepArgs{xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs, mask,
                dxp, dh0, dc0, sxb, sxt, B, n_steps, H, reverse},
      device, stream);
}

extern "C" int fmda_lstm_scan_sweep_bf16(
    const void* xp, long long sxb, long long sxt, const void* h0,
    const void* c0, const void* w_hh, const void* b_hh, const void* hs,
    const void* cs, const void* dh_last, const void* dc_last,
    const void* dhs, const void* mask, void* dxp, void* dh0, void* dc0,
    int B, int n_steps, int H, int reverse, int device, void* stream) {
  return launch_sweep<__nv_bfloat16>(
      SweepArgs{xp, h0, c0, w_hh, b_hh, hs, cs, dh_last, dc_last, dhs, mask,
                dxp, dh0, dc0, sxb, sxt, B, n_steps, H, reverse},
      device, stream);
}

#ifdef FMDA_PROFILE_SWEEP
extern "C" int fmda_lstm_sweep_prof(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_sweep_prof, sizeof(g_sweep_prof));
}
#endif
