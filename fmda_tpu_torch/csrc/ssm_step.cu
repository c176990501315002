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
// The TPU kernel is one grid-less invocation with every operand resident in
// VMEM.  Here one thread owns one (b, j) element of B x H, in blocks of 256:
// it reads xp[b, j], xp[b, H + j], xp[b, 2H + j] (neighbouring threads on
// neighbouring j, so a warp's loads coalesce), s, ef, es at [b, j] and the
// four (H,) vectors at j, and writes h, s', ef', es' at [b, j].  No shared
// memory, so H is unbounded.
//
// What bounds it.  Ten (B, H) tensors move once (xp's three, the three
// carries in, four outputs) plus four (H,) vectors: at the pool's largest
// bucket (B = 128, H = 32, f32) 164,352 bytes, about 0.05 us at 3.35 TB/s,
// and about 20 operations per element.  So the kernel sits at the launch
// floor (a few us) whatever it does: the design keeps it to one launch per
// layer per tick, reading xp through its row stride so a gathered or sliced
// projection is not copied first.
//
// dtypes: float32 or bfloat16 I/O; the carries and the four vectors arrive
// already in the I/O dtype (as the Pallas wrapper casts them); all algebra
// in float32 with expf, sigmoid(x) = 1 / (1 + expf(-x)), silu(x) =
// x sigmoid(x); each output rounded once to the I/O dtype.

#include "scan_common.cuh"

namespace {

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
  const float zp = to_f32(x[j]);
  const float vp = to_f32(x[H + j]);
  const float gp = to_f32(x[2 * H + j]);
  const float a = sigmoid_f32(zp + to_f32(a_base[j]));
  const float s_new = a * to_f32(s[i]) + (1.0f - a) * vp;
  const float h = s_new * (gp * sigmoid_f32(gp)) + to_f32(d[j]) * vp;
  const float rf = sigmoid_f32(to_f32(rho_f[j]));
  const float rs = sigmoid_f32(to_f32(rho_s[j]));
  h_out[i] = from_f32<T>(h);
  s_out[i] = from_f32<T>(s_new);
  ef_out[i] = from_f32<T>(rf * to_f32(ef[i]) + (1.0f - rf) * h);
  es_out[i] = from_f32<T>(rs * to_f32(es[i]) + (1.0f - rs) * h);
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
