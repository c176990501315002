// The primitives the flash kernels share (flash_fwd.cu; flash_attn.cu and
// flash_bwd.cu through flash_bwd_common.cuh): cp.async staging, the bf16
// tensor-core product mma.sync m16n8k16 with float32 accumulation, ldmatrix
// for its transposed B fragments, and the staging of a head's rows into a
// shared tile.
//
// The m16n8k16 fragments, for lane = 4 g + t4 (g = lane / 4, t4 = lane % 4):
//   A (16 x 16, rows by k):  a0 = (g, 2t4..2t4+1)  a1 = (g+8, 2t4..)
//                            a2 = (g, 2t4+8..)     a3 = (g+8, 2t4+8..)
//   B (16 x 8, k by cols):   b0 = (2t4..2t4+1, g)  b1 = (2t4+8.., g)
//   C (16 x 8, float32):     c0, c1 = (g, 2t4..2t4+1)  c2, c3 = (g+8, ..)
// so the accumulators of two 8-column tiles, rounded and packed in pairs,
// are the A fragment of the next product over those 16 columns.

#pragma once

#include "scan_common.cuh"

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
// One float32 (or any 4 bytes), zero-filled where src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld_u32(const void* p) {
  return *static_cast<const unsigned*>(p);
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned& r0, unsigned& r1,
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(s));
}

// 2^x on the SFU (x * log2 e folded into the operands makes it exp).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows [row0, row0 + n) of one head's (T, D) matrix into a tile [n][ld]:
// cp.async 16-byte chunks when `vec` (rows of whole chunks, 16-byte
// aligned), zero-filled past T, else plain loads.  Columns past D keep the
// zeros the caller gave them once.
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst, int ld,
                                           const T* __restrict__ head,
                                           int row0, int n, int t, int d,
                                           bool vec) {
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T);
    const int per_row = d / kChunk;
    for (int e = threadIdx.x; e < n * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * kChunk;
      const bool live = row0 + r < t;
      cp_async16(dst + r * ld + c,
                 head + (long long)(live ? row0 + r : 0) * d + c,
                 live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
      const int r = e / d, c = e - r * d;
      dst[r * ld + c] = row0 + r < t ? head[(long long)(row0 + r) * d + c]
                                     : from_f32<T>(0.0f);
    }
  }
}

// The flags of keys [key0, key0 + n): 1 where the key exists (< T) and the
// key mask (null: none) shows it.
__device__ __forceinline__ void stage_keep(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ km,
                                           int key0, int n, int t) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int key = key0 + r;
    dst[r] = key < t && (km == nullptr || km[key] != 0);
  }
}
