// The SSM family's O(1) serve tick for NVIDIA Hopper (sm_90a), bound to
// PyTorch via ctypes by fmda_tpu_torch/ops/ssm_kernel.py (the library is
// built by fmda_tpu_torch/ops/_cuda_lib.py).
//
// Replaces: fmda_tpu/ops/pallas_ssm.py::_ssm_step_kernel, the Pallas TPU
// kernel behind ssm_cell_step_pallas.  One tick of the (s, ema_fast,
// ema_slow) serving cache over a precomputed projection xp (B, 3H) packed
// [z, v, g]:
//
//   a = sigmoid(zp + a_base)     s' = a s + (1 - a) vp
//   h = s' silu(gp) + d vp
//   ef' = sigmoid(rho_f) ef + (1 - sigmoid(rho_f)) h    (es' with rho_s)
//
// Two kernels here call one __device__ function for that arithmetic:
//
// - ssm_step_kernel keeps the Pallas kernel's contract exactly (xp in, the
//   four outputs out): one thread owns one (b, j) element of B x H, in
//   blocks of 256, reading xp through its row stride so a gathered or
//   sliced projection is not copied first.  Ten (B, H) tensors and four
//   (H,) vectors move once: at B = 128, H = 32, f32 164,352 bytes, ~0.05 us
//   at 3.35 TB/s, so it sits at the launch floor (a few us) whatever it
//   does.
// - ssm_tick_kernel is the whole serve tick, the counterpart of the
//   reference's one jitted pool step (fmda_tpu/runtime/session_pool.py:219):
//   gather the lane's norms and normalize, round x to the I/O dtype; per
//   layer the projection x W_ih^T + b_ih (float32 sums, rounded once) and
//   the step, h feeding the next layer; the EMA head over [h, ema_fast,
//   ema_slow] rounded to the I/O dtype, sigmoid in float32; the new state
//   written in place at the lane's slot and pos[slot] += 1.  One CTA owns
//   one lane and sums every dot in one fixed order, so a lane's result does
//   not depend on B or on the other lanes: a session gets the same bits
//   alone or in any bucket.  A lane's slot is live in at most one lane; the
//   padding slot may repeat, and its lanes' racing reads and writes land in
//   state nothing reads (their probabilities are garbage the caller drops).
//   A slot outside [0, S) gets NaN probabilities and touches no state.
//
// What bounds the tick: the rows, the lanes' norm rows, every layer's
// weights and the head read once, the lanes' state read and written once,
// pos and the probabilities: at bucket 64, H = 32, F = 108, one layer, f32
// about 178 KB, ~0.05 us at 3.35 TB/s, against ~1.4 MFLOP (~0.02 us).  So
// the tick too sits at the launch floor; what the fusion buys is the ~25
// other device ops (and their host dispatch) a flush no longer needs.
//
// dtypes: float32 or bfloat16 I/O; rows and norms are float32; the carries
// and the vectors arrive in the I/O dtype (as the Pallas wrapper casts
// them); all algebra in float32 with expf, sigmoid(x) = 1 / (1 + expf(-x)),
// silu(x) = x sigmoid(x); each output rounded once to the I/O dtype.

#include "scan_common.cuh"

namespace {

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// One (lane, unit) element of the tick, from the projection's three gates,
// the unit's carry and its four vectors, all as float32: every result
// unrounded.  Both kernels call it, so the step's arithmetic exists once.
struct CellOut {
  float h, s, ef, es;
};

__device__ __forceinline__ CellOut ssm_cell(float zp, float vp, float gp,
                                            float s, float ef, float es,
                                            float a_base, float d,
                                            float rho_f, float rho_s) {
  const float a = sigmoid_f32(zp + a_base);
  const float s_new = a * s + (1.0f - a) * vp;
  const float h = s_new * (gp * sigmoid_f32(gp)) + d * vp;
  const float rf = sigmoid_f32(rho_f);
  const float rs = sigmoid_f32(rho_s);
  return {h, s_new, rf * ef + (1.0f - rf) * h, rs * es + (1.0f - rs) * h};
}

template <typename T>
__global__ void ssm_step_kernel(const T* __restrict__ xp, long long sxb,
                                const T* __restrict__ s,
                                const T* __restrict__ ef,
                                const T* __restrict__ es,
                                const T* __restrict__ a_base,
                                const T* __restrict__ d,
                                const T* __restrict__ rho_f,
                                const T* __restrict__ rho_s,
                                T* __restrict__ h_out, T* __restrict__ s_out,
                                T* __restrict__ ef_out,
                                T* __restrict__ es_out, int B, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * H) return;
  const int b = (int)(i / H);
  const int j = (int)(i - (long long)b * H);
  const T* x = xp + b * sxb;
  const CellOut o = ssm_cell(
      to_f32(x[j]), to_f32(x[H + j]), to_f32(x[2 * H + j]), to_f32(s[i]),
      to_f32(ef[i]), to_f32(es[i]), to_f32(a_base[j]), to_f32(d[j]),
      to_f32(rho_f[j]), to_f32(rho_s[j]));
  h_out[i] = from_f32<T>(o.h);
  s_out[i] = from_f32<T>(o.s);
  ef_out[i] = from_f32<T>(o.ef);
  es_out[i] = from_f32<T>(o.es);
}

// The whole serve tick of a session pool's flush (or of a solo core's
// tick), every layer, in one launch.  grid (B): one CTA a lane.  Shared
// memory: the layer's input x [max(F, H)], the projection xp [3H] and the
// head's input [h, ema_fast, ema_slow] [3H], all float32 holding values
// rounded to T; then, when stage_w, the layer's W_ih^T, copied in by all
// threads at once so that the loads overlap (read straight from device
// memory, a k at a time, each load waits out its latency: most of the
// tick at the model's F = 108).  weights is the packed buffer of
// pack_tick_weights (per layer W_ih transposed (F_in, 3H), b_ih, a_base,
// d, rho_f, rho_s; then the head's (C, 3H) and (C,)); state (L, 3, S, H)
// and pos (S,) are updated in place at the lane's slot.
template <typename T>
__global__ void ssm_tick_kernel(const float* __restrict__ rows,
                                const int* __restrict__ slots,
                                const float* __restrict__ x_min,
                                const float* __restrict__ x_range,
                                int norm_rows, const T* __restrict__ weights,
                                T* __restrict__ state,
                                long long* __restrict__ pos,
                                float* __restrict__ probs, int S, int F,
                                int H, int C, int L, int stage_w) {
  extern __shared__ __align__(16) float tick_smem[];
  const int G = 3 * H;
  float* x = tick_smem;
  float* xp = x + max(F, H);
  float* cat = xp + G;
  T* w_smem = reinterpret_cast<T*>(tick_smem + align4(max(F, H) + 6 * H));
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int slot = slots[b];
  if (slot < 0 || slot >= S) {  // refused: NaN out, no state touched
    for (int c = tid; c < C; c += nt)
      probs[(long long)b * C + c] = __int_as_float(0x7fc00000);
    return;
  }
  // normalize and round to T, as the solo core's cast does
  const long long nrow = norm_rows == 1 ? 0 : slot;
  for (int f = tid; f < F; f += nt)
    x[f] = round_to<T>((rows[(long long)b * F + f] - x_min[nrow * F + f]) /
                       x_range[nrow * F + f]);
  __syncthreads();
  const T* w = weights;
  const long long plane = (long long)S * H;
  for (int l = 0; l < L; ++l) {
    const int in = l == 0 ? F : H;
    const T* wt = w;  // (in, 3H): thread j's loads coalesce across j
    const T* bias = wt + (long long)in * G;
    const T* a_base = bias + G;
    const T* d = a_base + H;
    const T* rho_f = d + H;
    const T* rho_s = rho_f + H;
    w = rho_s + H;
    const T* wk = wt;
    if (stage_w) {
      const int n = in * G;
      if ((reinterpret_cast<uintptr_t>(wt) & 15) == 0 &&
          n * sizeof(T) % 16 == 0) {
        const int4* src = reinterpret_cast<const int4*>(wt);
        int4* dst = reinterpret_cast<int4*>(w_smem);
#pragma unroll 8
        for (int e = tid; e < (int)(n * sizeof(T) / 16); e += nt)
          dst[e] = src[e];
      } else {
#pragma unroll 8
        for (int e = tid; e < n; e += nt) w_smem[e] = wt[e];
      }
      __syncthreads();
      wk = w_smem;
    }
    // the projection: one thread an entry, float32 sums in k order,
    // rounded once as F.linear's output is
    for (int j = tid; j < G; j += nt) {
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < in; ++k)
        acc = fmaf(x[k], to_f32(wk[(long long)k * G + j]), acc);
      xp[j] = round_to<T>(acc + to_f32(bias[j]));
    }
    __syncthreads();  // xp complete; x and w_smem are free
    T* sl = state + 3 * l * plane + (long long)slot * H;
    T* efl = sl + plane;
    T* esl = efl + plane;
    for (int j = tid; j < H; j += nt) {
      const CellOut o = ssm_cell(
          xp[j], xp[H + j], xp[2 * H + j], to_f32(sl[j]), to_f32(efl[j]),
          to_f32(esl[j]), to_f32(a_base[j]), to_f32(d[j]), to_f32(rho_f[j]),
          to_f32(rho_s[j]));
      const T h = from_f32<T>(o.h), s_new = from_f32<T>(o.s);
      const T ef_new = from_f32<T>(o.ef), es_new = from_f32<T>(o.es);
      sl[j] = s_new;
      efl[j] = ef_new;
      esl[j] = es_new;
      x[j] = to_f32(h);  // the next layer's input
      cat[j] = to_f32(h);
      cat[H + j] = to_f32(ef_new);
      cat[2 * H + j] = to_f32(es_new);
    }
    __syncthreads();
  }
  // the EMA head: a warp a class, lane-strided float32 sums joined by a
  // butterfly (the same bits in every lane), rounded to T, then sigmoid
  const T* hw = w;
  const T* hb = hw + (long long)C * G;
  const int lane = tid & 31;
  for (int c = tid >> 5; c < C; c += nt >> 5) {
    float acc = 0.0f;
    for (int k = lane; k < G; k += 32)
      acc = fmaf(cat[k], to_f32(hw[(long long)c * G + k]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      probs[(long long)b * C + c] =
          sigmoid_f32(round_to<T>(acc + to_f32(hb[c])));
  }
  if (tid == 0) pos[slot] += 1;
}

constexpr int kTickMaxThreads = 256;
// The most shared memory a layer's staged W_ih^T may take; past it the
// projection reads W_ih from device memory.
constexpr size_t kTickStageBytes = 96 * 1024;

template <typename T>
int launch_tick(const void* rows, const void* slots, const void* x_min,
                const void* x_range, int norm_rows, const void* weights,
                void* state, void* pos, void* probs, int B, int S, int F,
                int H, int C, int L, int device, void* stream) {
  if (B <= 0 || S <= 0 || F <= 0 || H <= 0 || C <= 0 || L <= 0 ||
      (norm_rows != 1 && norm_rows != S))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // whole warps, at most one thread an xp entry
  const int threads = std::min(kTickMaxThreads, (3 * H + 31) / 32 * 32);
  const size_t w_bytes = (size_t)std::max(F, H) * 3 * H * sizeof(T);
  const int stage_w = w_bytes <= kTickStageBytes;
  const size_t smem = (size_t)align4(std::max(F, H) + 6 * H) * sizeof(float) +
                      (stage_w ? w_bytes : 0);
  err = allow_smem(ssm_tick_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssm_tick_kernel<T><<<B, threads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(slots),
      static_cast<const float*>(x_min), static_cast<const float*>(x_range),
      norm_rows, static_cast<const T*>(weights), static_cast<T*>(state),
      static_cast<long long*>(pos), static_cast<float*>(probs), S, F, H, C,
      L, stage_w);
  return (int)cudaGetLastError();
}

constexpr int kStepThreads = 256;

template <typename T>
int launch_step(const void* xp, long long sxb, const void* s, const void* ef,
                const void* es, const void* a_base, const void* d,
                const void* rho_f, const void* rho_s, void* h_out,
                void* s_out, void* ef_out, void* es_out, int B, int H,
                int device, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H;
  const dim3 grid((unsigned)((n + kStepThreads - 1) / kStepThreads));
  ssm_step_kernel<T><<<grid, kStepThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), sxb, static_cast<const T*>(s),
      static_cast<const T*>(ef), static_cast<const T*>(es),
      static_cast<const T*>(a_base), static_cast<const T*>(d),
      static_cast<const T*>(rho_f), static_cast<const T*>(rho_s),
      static_cast<T*>(h_out), static_cast<T*>(s_out),
      static_cast<T*>(ef_out), static_cast<T*>(es_out), B, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  sxb is xp's row stride in elements; xp's
// last dimension and every other tensor are contiguous, all in the I/O
// dtype.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int fmda_ssm_step_f32(const void* xp, long long sxb, const void* s,
                                 const void* ef, const void* es,
                                 const void* a_base, const void* d,
                                 const void* rho_f, const void* rho_s,
                                 void* h_out, void* s_out, void* ef_out,
                                 void* es_out, int B, int H, int device,
                                 void* stream) {
  return launch_step<float>(xp, sxb, s, ef, es, a_base, d, rho_f, rho_s,
                            h_out, s_out, ef_out, es_out, B, H, device,
                            stream);
}

extern "C" int fmda_ssm_step_bf16(const void* xp, long long sxb,
                                  const void* s, const void* ef,
                                  const void* es, const void* a_base,
                                  const void* d, const void* rho_f,
                                  const void* rho_s, void* h_out, void* s_out,
                                  void* ef_out, void* es_out, int B, int H,
                                  int device, void* stream) {
  return launch_step<__nv_bfloat16>(xp, sxb, s, ef, es, a_base, d, rho_f,
                                    rho_s, h_out, s_out, ef_out, es_out, B,
                                    H, device, stream);
}

// The fused tick.  rows (B, F) float32, slots (B,) int32, x_min and x_range
// (norm_rows, F) float32 with norm_rows 1 (one norm for every lane) or S
// (a lane reads its slot's row), weights the packed buffer in the I/O
// dtype, state (L, 3, S, H) in the I/O dtype and pos (S,) int64 (both
// updated in place), probs (B, C) float32; all contiguous.
extern "C" int fmda_ssm_tick_f32(const void* rows, const void* slots,
                                 const void* x_min, const void* x_range,
                                 int norm_rows, const void* weights,
                                 void* state, void* pos, void* probs, int B,
                                 int S, int F, int H, int C, int L,
                                 int device, void* stream) {
  return launch_tick<float>(rows, slots, x_min, x_range, norm_rows, weights,
                            state, pos, probs, B, S, F, H, C, L, device,
                            stream);
}

extern "C" int fmda_ssm_tick_bf16(const void* rows, const void* slots,
                                  const void* x_min, const void* x_range,
                                  int norm_rows, const void* weights,
                                  void* state, void* pos, void* probs, int B,
                                  int S, int F, int H, int C, int L,
                                  int device, void* stream) {
  return launch_tick<__nv_bfloat16>(rows, slots, x_min, x_range, norm_rows,
                                    weights, state, pos, probs, B, S, F, H,
                                    C, L, device, stream);
}
