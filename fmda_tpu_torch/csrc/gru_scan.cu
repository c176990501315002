// GRU forward scan for NVIDIA Hopper (sm_90a), bound to PyTorch via ctypes
// by fmda_tpu_torch/ops/gru_kernel.py.
//
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTileThreads = 256;
// W_hh^T stays in shared memory while it and the carry fit under this.
constexpr size_t kMaxSmemBytes = 200 * 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      n <= 0)
    n = 132;
  return n;
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
  // rows per block: at most kTileThreads / H, and few enough that the grid
  // covers the SMs before a block takes more than one row
  const int max_rows = H >= kTileThreads ? 1 : kTileThreads / H;
  const int sms = sm_count(device);
  int rows = (B + sms - 1) / sms;
  if (rows > max_rows) rows = max_rows;
  if (rows < 1) rows = 1;
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
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(gru_scan_fwd_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    gru_scan_fwd_kernel<T, true><<<grid, block, smem, s>>>(
        x, sxb, sxt, h, w, bb, m, out, last, B, n_steps, H, rows, reverse);
  } else {
    gru_scan_fwd_kernel<T, false><<<grid, block, smem, s>>>(
        x, sxb, sxt, h, w, bb, m, out, last, B, n_steps, H, rows, reverse);
  }
  return (int)cudaGetLastError();
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

extern "C" const char* fmda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
