// The wide scan route's fused gate kernels for NVIDIA Hopper (sm_90a), GRU
// and LSTM, forward and backward, bound to PyTorch via ctypes by
// fmda_tpu_torch/ops/wide_scan.py (the library is built by
// fmda_tpu_torch/ops/_cuda_lib.py).
//
// Replaces: no Pallas kernel.  Outside the fused kernels' envelope
// (fmda_tpu/ops/pallas_gru.py::kernel_supported, pallas_lstm.py's) the JAX
// package's select_scan_fn and select_lstm_scan_fn run lax.scan
// (fmda_tpu/ops/gru.py::gru_scan, lstm.py::lstm_scan): each step one
// (B, H) x (H, G H) product, which XLA hands to the matrix unit, and the
// gate algebra, which XLA fuses into one element-wise pass.  The port's
// counterpart of that route (ops/wide_scan.py) runs these kernels as the
// fused pass, one launch a step, beside a cuBLAS product (torch.addmm, one a
// step) wherever its plans hand the step back: the GRU forward's product
// and gates run as one launch of gru_wide_step.cu's kernel wherever its
// plan lays the step out (bf16, H a multiple of 64), and the LSTM's scans
// as lstm_persist.cu's wherever theirs does:
//
//   gru_wide_fwd     xp_t, hh_t = h_{t-1} W_hh^T + b_hh, h_{t-1} -> h_t
//   lstm_wide_fwd    xp_t, hh_t, h_{t-1}, c_{t-1} -> h_t, c_t
//   gru_wide_bwd     the step's cotangent dh = direct + prod + dhs_t, where
//                    prod = dhh_{t+1} W_hh is the previous step's product,
//                    and the recomputed gates -> dxp_t, dhh_t (the gate
//                    gradients the product sees: [dr, dz, dn r]) and the
//                    direct part of dh_{t-1} (dh z)
//   lstm_wide_bwd    the same with c: dh, dc -> dxp_t (= dhh_t) and
//                    dc_{t-1} = dc_t f; h enters a step only through the
//                    product, so dh_{t-1} has a direct part only where a
//                    mask holds a row (dh passed through): the kernel
//                    reads `direct` only where it is given (dh_last at the
//                    first processed step, or under a mask) and writes it
//                    only under a mask
//
// Gate algebra and cotangents in float32, as the kernel pair's
// (gru_scan.cu, lstm_scan.cu); the carries rounded to the I/O dtype on
// store, the gate gradients rounded once to it (the product's operand);
// the direct part and dc carried in float32.  A masked step (mask 0)
// carries h (and c) through and, backward, writes zero gradients and
// passes dh (and dc) through: the semantics of the reference's masked
// lax.scan.
//
// Each reads only what its function needs: the LSTM forward reads h_{t-1}
// only under a mask (a held row keeps it), the LSTM backward its direct
// part as above.
//
// What bounds them: bytes.  A forward step at (512, 1024) bf16 reads xp_t
// and hh_t (3H each) and h_{t-1} and writes h_t, 8 B H values = 8.4 MB,
// 2.5 us at 3.35 TB/s; its ~10 operations a (row, unit), 5 MFLOP, take
// 0.08 us at 67 TFLOP/s.  So the design is a coalesced pass that reads
// every operand once: one thread a (row, 4 units), each operand one 16-byte
// (f32) or 8-byte (bf16) load where H and every row stride are multiples
// of 4 and every pointer is aligned to the load, else one thread a (row,
// unit) with scalar loads; neighbouring threads take neighbouring units, so
// a warp reads whole sectors.  Nothing is reused, so nothing is staged in
// shared memory.  Where it runs, each step's launch follows its product
// on the stream: that per-step floor is a product and a launch, and its
// times sit in PERF.md beside kernel 1's device branch and cuDNN's.

#include "scan_common.cuh"

namespace {

constexpr int kWideThreads = 256;

// U values at p as floats: one vector load at U = 4 (p aligned), else one.
template <typename T, int U>
__device__ __forceinline__ void load_u(const T* p, float* v) {
  if constexpr (U == 4) {
    const float4 f =
        to_float4(*reinterpret_cast<const typename Vec4<T>::type*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = to_f32(p[0]);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(v));
}

// v[0..U) rounded to T and stored at p: one vector store at U = 4.
template <typename T, int U>
__device__ __forceinline__ void store_u(T* p, const float* v) {
  if constexpr (U == 4) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 u;
      u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
      u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
      *reinterpret_cast<uint2*>(p) = u;
    }
  } else {
    p[0] = from_f32<T>(v[0]);
  }
}

// One step's operands: row b of each (B, ...) operand starts at base + b *
// its row stride (in elements); hh, xp, dxp and dhh hold G gate blocks of
// H.  prod, direct and dc are contiguous (B, H); prod may be null (the
// first processed step of a backward: no product yet), and so may the
// LSTM's direct (no direct part: read as 0, not written); mask, a column
// of the (B, T) uint8 mask, may be null.
template <typename T>
struct WideArgs {
  const T *xp, *hh, *h_prev, *c_prev, *c_t, *prod, *dhs;
  const uint8_t* mask;
  T *h_out, *c_out, *dxp, *dhh;
  float *direct, *dc;
  long long sx, shh, sh, sc, sct, sd, sm, so, sco, sdx, sdh;
  int B, H;
};

// This thread's row and first unit; false past the last (row, unit).
template <int U>
__device__ __forceinline__ bool wide_site(int B, int H, int& b, int& j) {
  const int per_row = H / U;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * per_row) return false;
  b = (int)(idx / per_row);
  j = (int)(idx - (long long)b * per_row) * U;
  return true;
}

template <typename T, int U>
__global__ void __launch_bounds__(kWideThreads)
    gru_wide_fwd_kernel(const WideArgs<T> a) {
  int b, j;
  if (!wide_site<U>(a.B, a.H, b, j)) return;
  const int H = a.H;
  const T* x = a.xp + b * a.sx + j;
  const T* hh = a.hh + b * a.shh + j;
  float xr[U], xz[U], xn[U], ar[U], az[U], an[U], hp[U], h[U];
  load_u<T, U>(x, xr);
  load_u<T, U>(x + H, xz);
  load_u<T, U>(x + 2 * H, xn);
  load_u<T, U>(hh, ar);
  load_u<T, U>(hh + H, az);
  load_u<T, U>(hh + 2 * H, an);
  load_u<T, U>(a.h_prev + b * a.sh + j, hp);
  const bool keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float r = sigmoid_f32(xr[u] + ar[u]);
    const float z = sigmoid_f32(xz[u] + az[u]);
    const float n = tanhf(xn[u] + r * an[u]);
    h[u] = keep ? (1.0f - z) * n + z * hp[u] : hp[u];
  }
  store_u<T, U>(a.h_out + b * a.so + j, h);
}

template <typename T, int U>
__global__ void __launch_bounds__(kWideThreads)
    lstm_wide_fwd_kernel(const WideArgs<T> a) {
  int b, j;
  if (!wide_site<U>(a.B, a.H, b, j)) return;
  const int H = a.H;
  const T* x = a.xp + b * a.sx + j;
  const T* hh = a.hh + b * a.shh + j;
  float s[4][U], t[U], hp[U] = {}, cp[U], h[U], c[U];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    load_u<T, U>(x + g * H, s[g]);
    load_u<T, U>(hh + g * H, t);
#pragma unroll
    for (int u = 0; u < U; ++u) s[g][u] += t[u];
  }
  load_u<T, U>(a.c_prev + b * a.sc + j, cp);
  // h_{t-1} only where a mask may hold the row: a step that runs makes h
  // from its gates and c alone
  if (a.mask != nullptr) load_u<T, U>(a.h_prev + b * a.sh + j, hp);
  const bool keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float i = sigmoid_f32(s[0][u]);
    const float f = sigmoid_f32(s[1][u]);
    const float g = tanhf(s[2][u]);
    const float o = sigmoid_f32(s[3][u]);
    const float c_new = f * cp[u] + i * g;
    h[u] = keep ? o * tanhf(c_new) : hp[u];
    c[u] = keep ? c_new : cp[u];
  }
  store_u<T, U>(a.h_out + b * a.so + j, h);
  store_u<T, U>(a.c_out + b * a.sco + j, c);
}

// dh = direct + prod + dhs_t at this thread's units (a null direct or
// prod reads as 0).
template <typename T, int U>
__device__ __forceinline__ void step_cotangent(const WideArgs<T>& a, int b,
                                               int j, float* dh) {
  float p[U] = {}, d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) dh[u] = 0.0f;
  if (a.direct != nullptr)
    load_u<float, U>(a.direct + (long long)b * a.H + j, dh);
  load_u<T, U>(a.dhs + b * a.sd + j, d);
  if (a.prod != nullptr) load_u<T, U>(a.prod + (long long)b * a.H + j, p);
#pragma unroll
  for (int u = 0; u < U; ++u) dh[u] += p[u] + d[u];
}

template <typename T, int U>
__global__ void __launch_bounds__(kWideThreads)
    gru_wide_bwd_kernel(const WideArgs<T> a) {
  int b, j;
  if (!wide_site<U>(a.B, a.H, b, j)) return;
  const int H = a.H;
  const T* x = a.xp + b * a.sx + j;
  const T* hh = a.hh + b * a.shh + j;
  float xr[U], xz[U], xn[U], ar[U], az[U], an[U], hp[U], dh[U];
  load_u<T, U>(x, xr);
  load_u<T, U>(x + H, xz);
  load_u<T, U>(x + 2 * H, xn);
  load_u<T, U>(hh, ar);
  load_u<T, U>(hh + H, az);
  load_u<T, U>(hh + 2 * H, an);
  load_u<T, U>(a.h_prev + b * a.sh + j, hp);
  step_cotangent<T, U>(a, b, j, dh);
  const bool keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
  float gr[U], gz[U], gn[U], gh[U], direct[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float r = sigmoid_f32(xr[u] + ar[u]);
    const float z = sigmoid_f32(xz[u] + az[u]);
    const float n = tanhf(xn[u] + r * an[u]);
    const float dn_pre = dh[u] * (1.0f - z) * (1.0f - n * n);
    const float dr_pre = dn_pre * an[u] * r * (1.0f - r);
    const float dz_pre = dh[u] * (hp[u] - n) * z * (1.0f - z);
    gr[u] = keep ? dr_pre : 0.0f;
    gz[u] = keep ? dz_pre : 0.0f;
    gn[u] = keep ? dn_pre : 0.0f;
    gh[u] = keep ? dn_pre * r : 0.0f;
    direct[u] = keep ? dh[u] * z : dh[u];
  }
  T* dx = a.dxp + b * a.sdx + j;
  T* dg = a.dhh + b * a.sdh + j;
  store_u<T, U>(dx, gr);
  store_u<T, U>(dx + H, gz);
  store_u<T, U>(dx + 2 * H, gn);
  store_u<T, U>(dg, gr);
  store_u<T, U>(dg + H, gz);
  store_u<T, U>(dg + 2 * H, gh);
  store_u<float, U>(a.direct + (long long)b * H + j, direct);
}

template <typename T, int U>
__global__ void __launch_bounds__(kWideThreads)
    lstm_wide_bwd_kernel(const WideArgs<T> a) {
  int b, j;
  if (!wide_site<U>(a.B, a.H, b, j)) return;
  const int H = a.H;
  const T* x = a.xp + b * a.sx + j;
  const T* hh = a.hh + b * a.shh + j;
  float s[4][U], t[U], cp[U], ct[U], dh[U], dc[U];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    load_u<T, U>(x + g * H, s[g]);
    load_u<T, U>(hh + g * H, t);
#pragma unroll
    for (int u = 0; u < U; ++u) s[g][u] += t[u];
  }
  load_u<T, U>(a.c_prev + b * a.sc + j, cp);
  load_u<T, U>(a.c_t + b * a.sct + j, ct);
  load_u<float, U>(a.dc + (long long)b * H + j, dc);
  step_cotangent<T, U>(a, b, j, dh);
  const bool keep = a.mask == nullptr || a.mask[b * a.sm] != 0;
  float d[4][U], direct[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float i = sigmoid_f32(s[0][u]);
    const float f = sigmoid_f32(s[1][u]);
    const float g = tanhf(s[2][u]);
    const float o = sigmoid_f32(s[3][u]);
    const float tc = tanhf(ct[u]);
    const float dct = dc[u] + dh[u] * o * (1.0f - tc * tc);
    d[0][u] = keep ? dct * g * i * (1.0f - i) : 0.0f;
    d[1][u] = keep ? dct * cp[u] * f * (1.0f - f) : 0.0f;
    d[2][u] = keep ? dct * i * (1.0f - g * g) : 0.0f;
    d[3][u] = keep ? dh[u] * tc * o * (1.0f - o) : 0.0f;
    direct[u] = keep ? 0.0f : dh[u];
    dc[u] = keep ? dct * f : dc[u];
  }
  T* dx = a.dxp + b * a.sdx + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) store_u<T, U>(dx + g * H, d[g]);
  // the direct part is 0 wherever the step ran: stored only under a mask
  if (a.mask != nullptr)
    store_u<float, U>(a.direct + (long long)b * H + j, direct);
  store_u<float, U>(a.dc + (long long)b * H + j, dc);
}

// Every pointer aligned to a 4-value load of T (or of float: direct, dc)
// and every row stride a multiple of 4: the vector layout's conditions.
template <typename T>
bool wide_vec(const WideArgs<T>& a) {
  if (a.H % 4) return false;
  const void* ptrs[] = {a.xp,  a.hh,  a.h_prev, a.c_prev, a.c_t,
                        a.prod, a.dhs, a.h_out, a.c_out,  a.dxp,
                        a.dhh};
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)))
      return false;
  const void* fptrs[] = {a.direct, a.dc};
  for (const void* p : fptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  const long long strides[] = {a.sx,  a.shh, a.sh, a.sc,  a.sct, a.sd,
                               a.so,  a.sco, a.sdx, a.sdh};
  for (long long s : strides)
    if (s % 4) return false;
  return true;
}

#define FMDA_WIDE_LAUNCHER(NAME)                                           \
  template <typename T>                                                    \
  int launch_##NAME(const WideArgs<T>& a, int device, void* stream) {      \
    if (a.B <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;           \
    cudaError_t err = cudaSetDevice(device);                               \
    if (err != cudaSuccess) return (int)err;                               \
    const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);         \
    const bool vec = wide_vec(a);                                          \
    const long long sites = (long long)a.B * (vec ? a.H / 4 : a.H);        \
    const int blocks = (int)((sites + kWideThreads - 1) / kWideThreads);   \
    if (vec)                                                               \
      NAME##_kernel<T, 4><<<blocks, kWideThreads, 0, s>>>(a);              \
    else                                                                   \
      NAME##_kernel<T, 1><<<blocks, kWideThreads, 0, s>>>(a);              \
    return (int)cudaGetLastError();                                        \
  }

FMDA_WIDE_LAUNCHER(gru_wide_fwd)
FMDA_WIDE_LAUNCHER(lstm_wide_fwd)
FMDA_WIDE_LAUNCHER(gru_wide_bwd)
FMDA_WIDE_LAUNCHER(lstm_wide_bwd)

#undef FMDA_WIDE_LAUNCHER

// The entries' bodies: the step's operands into WideArgs, then the launch.
template <typename T>
int gru_wide_fwd(const void* xp, long long sx, const void* hh, long long shh,
                 const void* h_prev, long long sh, const void* mask,
                 long long sm, void* h_out, long long so, int B, int H,
                 int device, void* stream) {
  WideArgs<T> a{};
  a.B = B;
  a.H = H;
  a.xp = static_cast<const T*>(xp);
  a.sx = sx;
  a.hh = static_cast<const T*>(hh);
  a.shh = shh;
  a.h_prev = static_cast<const T*>(h_prev);
  a.sh = sh;
  a.mask = static_cast<const uint8_t*>(mask);
  a.sm = sm;
  a.h_out = static_cast<T*>(h_out);
  a.so = so;
  return launch_gru_wide_fwd<T>(a, device, stream);
}

template <typename T>
int lstm_wide_fwd(const void* xp, long long sx, const void* hh, long long shh,
                  const void* h_prev, long long sh, const void* c_prev,
                  long long sc, const void* mask, long long sm, void* h_out,
                  long long so, void* c_out, long long sco, int B, int H,
                  int device, void* stream) {
  WideArgs<T> a{};
  a.B = B;
  a.H = H;
  a.xp = static_cast<const T*>(xp);
  a.sx = sx;
  a.hh = static_cast<const T*>(hh);
  a.shh = shh;
  a.h_prev = static_cast<const T*>(h_prev);
  a.sh = sh;
  a.c_prev = static_cast<const T*>(c_prev);
  a.sc = sc;
  a.mask = static_cast<const uint8_t*>(mask);
  a.sm = sm;
  a.h_out = static_cast<T*>(h_out);
  a.so = so;
  a.c_out = static_cast<T*>(c_out);
  a.sco = sco;
  return launch_lstm_wide_fwd<T>(a, device, stream);
}

template <typename T>
int gru_wide_bwd(const void* xp, long long sx, const void* hh, long long shh,
                 const void* h_prev, long long sh, const void* prod,
                 const void* dhs, long long sd, const void* mask,
                 long long sm, void* direct, void* dxp, long long sdx,
                 void* dhh, long long sdh, int B, int H, int device,
                 void* stream) {
  WideArgs<T> a{};
  a.B = B;
  a.H = H;
  a.xp = static_cast<const T*>(xp);
  a.sx = sx;
  a.hh = static_cast<const T*>(hh);
  a.shh = shh;
  a.h_prev = static_cast<const T*>(h_prev);
  a.sh = sh;
  a.prod = static_cast<const T*>(prod);
  a.dhs = static_cast<const T*>(dhs);
  a.sd = sd;
  a.mask = static_cast<const uint8_t*>(mask);
  a.sm = sm;
  a.direct = static_cast<float*>(direct);
  a.dxp = static_cast<T*>(dxp);
  a.sdx = sdx;
  a.dhh = static_cast<T*>(dhh);
  a.sdh = sdh;
  return launch_gru_wide_bwd<T>(a, device, stream);
}

template <typename T>
int lstm_wide_bwd(const void* xp, long long sx, const void* hh, long long shh,
                  const void* c_prev, long long sc, const void* c_t,
                  long long sct, const void* prod, const void* dhs,
                  long long sd, const void* mask, long long sm, void* direct,
                  void* dc, void* dxp, long long sdx, int B, int H,
                  int device, void* stream) {
  WideArgs<T> a{};
  a.B = B;
  a.H = H;
  a.xp = static_cast<const T*>(xp);
  a.sx = sx;
  a.hh = static_cast<const T*>(hh);
  a.shh = shh;
  a.c_prev = static_cast<const T*>(c_prev);
  a.sc = sc;
  a.c_t = static_cast<const T*>(c_t);
  a.sct = sct;
  a.prod = static_cast<const T*>(prod);
  a.dhs = static_cast<const T*>(dhs);
  a.sd = sd;
  a.mask = static_cast<const uint8_t*>(mask);
  a.sm = sm;
  a.direct = static_cast<float*>(direct);
  a.dc = static_cast<float*>(dc);
  a.dxp = static_cast<T*>(dxp);
  a.sdx = sdx;
  return launch_lstm_wide_bwd<T>(a, device, stream);
}

}  // namespace

// Plain C interface for ctypes.  Pointers are the step's row 0 of each
// operand; strides are row strides in elements; prod, direct and dc are
// contiguous (B, H).  `mask` (a column of the (B, T) uint8 mask, row stride
// sm) may be null, and so may `prod` and, with no mask, the LSTM
// backward's `direct`.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int fmda_gru_wide_fwd_f32(const void* xp, long long sx,
                                     const void* hh, long long shh,
                                     const void* h_prev, long long sh,
                                     const void* mask, long long sm,
                                     void* h_out, long long so, int B, int H,
                                     int device, void* stream) {
  return gru_wide_fwd<float>(xp, sx, hh, shh, h_prev, sh, mask, sm, h_out,
                             so, B, H, device, stream);
}

extern "C" int fmda_gru_wide_fwd_bf16(const void* xp, long long sx,
                                      const void* hh, long long shh,
                                      const void* h_prev, long long sh,
                                      const void* mask, long long sm,
                                      void* h_out, long long so, int B, int H,
                                      int device, void* stream) {
  return gru_wide_fwd<__nv_bfloat16>(xp, sx, hh, shh, h_prev, sh, mask, sm,
                                     h_out, so, B, H, device, stream);
}

extern "C" int fmda_lstm_wide_fwd_f32(
    const void* xp, long long sx, const void* hh, long long shh,
    const void* h_prev, long long sh, const void* c_prev, long long sc,
    const void* mask, long long sm, void* h_out, long long so, void* c_out,
    long long sco, int B, int H, int device, void* stream) {
  return lstm_wide_fwd<float>(xp, sx, hh, shh, h_prev, sh, c_prev, sc, mask,
                              sm, h_out, so, c_out, sco, B, H, device,
                              stream);
}

extern "C" int fmda_lstm_wide_fwd_bf16(
    const void* xp, long long sx, const void* hh, long long shh,
    const void* h_prev, long long sh, const void* c_prev, long long sc,
    const void* mask, long long sm, void* h_out, long long so, void* c_out,
    long long sco, int B, int H, int device, void* stream) {
  return lstm_wide_fwd<__nv_bfloat16>(xp, sx, hh, shh, h_prev, sh, c_prev,
                                      sc, mask, sm, h_out, so, c_out, sco, B,
                                      H, device, stream);
}

extern "C" int fmda_gru_wide_bwd_f32(
    const void* xp, long long sx, const void* hh, long long shh,
    const void* h_prev, long long sh, const void* prod, const void* dhs,
    long long sd, const void* mask, long long sm, void* direct, void* dxp,
    long long sdx, void* dhh, long long sdh, int B, int H, int device,
    void* stream) {
  return gru_wide_bwd<float>(xp, sx, hh, shh, h_prev, sh, prod, dhs, sd,
                             mask, sm, direct, dxp, sdx, dhh, sdh, B, H,
                             device, stream);
}

extern "C" int fmda_gru_wide_bwd_bf16(
    const void* xp, long long sx, const void* hh, long long shh,
    const void* h_prev, long long sh, const void* prod, const void* dhs,
    long long sd, const void* mask, long long sm, void* direct, void* dxp,
    long long sdx, void* dhh, long long sdh, int B, int H, int device,
    void* stream) {
  return gru_wide_bwd<__nv_bfloat16>(xp, sx, hh, shh, h_prev, sh, prod, dhs,
                                     sd, mask, sm, direct, dxp, sdx, dhh, sdh,
                                     B, H, device, stream);
}

extern "C" int fmda_lstm_wide_bwd_f32(
    const void* xp, long long sx, const void* hh, long long shh,
    const void* c_prev, long long sc, const void* c_t, long long sct,
    const void* prod, const void* dhs, long long sd, const void* mask,
    long long sm, void* direct, void* dc, void* dxp, long long sdx, int B,
    int H, int device, void* stream) {
  return lstm_wide_bwd<float>(xp, sx, hh, shh, c_prev, sc, c_t, sct, prod,
                              dhs, sd, mask, sm, direct, dc, dxp, sdx, B, H,
                              device, stream);
}

extern "C" int fmda_lstm_wide_bwd_bf16(
    const void* xp, long long sx, const void* hh, long long shh,
    const void* c_prev, long long sc, const void* c_t, long long sct,
    const void* prod, const void* dhs, long long sd, const void* mask,
    long long sm, void* direct, void* dc, void* dxp, long long sdx, int B,
    int H, int device, void* stream) {
  return lstm_wide_bwd<__nv_bfloat16>(xp, sx, hh, shh, c_prev, sc, c_t, sct,
                                      prod, dhs, sd, mask, sm, direct, dc,
                                      dxp, sdx, B, H, device, stream);
}
