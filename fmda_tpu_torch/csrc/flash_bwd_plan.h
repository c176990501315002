// The flash backward's plan: how flash_bwd.cu's fused kernel and
// flash_attn.cu's dK/dV and dQ sweeps lay out one call on the card.  Plain
// C++ with no CUDA in it, so that the plan (defined in flash_bwd_plan.cc) is
// built into the port's library beside the kernels and can also be built
// alone by a host compiler and checked on a machine without a card.

#pragma once

#include "flash_fwd_plan.h"

namespace fmda_flash_bwd {

using fmda_flash::kBlockKeys;
using fmda_flash::kMaxD;
using fmda_flash::kPlanRefused;
using fmda_flash::kResidentSmem;
using fmda_flash::kSmemLimit;

constexpr int kMaxThreads = 256;
// Rows of a warp's tile: the mma's m16.
constexpr int kTile = 16;
// The float32 products read p and ds back from a per-warp buffer of two
// 16 x 16 tiles, rows kLdw floats apart so that 8 rows fall in distinct
// banks.
constexpr int kLdw = kTile + 4;
// The ints fmda_flash_bwd_plan reports: Geometry's first fields, in order.
constexpr int kPlanFields = 12;

// fused (T <= 128, D <= 64 unless the sweeps are asked for): one launch for
// dq, dk and dv.  A CTA holds `units` whole (b*n) heads in shared memory (q,
// k, v, do, lse, delta, the key flags, and ds as the kernel forms it), and
// `wph` warps a head: each warp owns the head's key tiles w, w + wph, ...
// (dk and dv, keeping ds), then its query tiles w, w + wph, ... (dq = ds k).
// `rows`: the heads' rows, T rounded up to a tile.
//
// Else the two sweeps, each a launch: a CTA owns `units` consecutive tiles
// of 16 rows of one head (keys for dK/dV, queries for dQ), `split` warps a
// tile when D > 64, each holding `dw` dims, and walks the other axis in
// chunks of `rows` rows through `stages` buffers.
//
// `ld`: the row stride of the q, k, v and do tiles, in elements; `ldd`: the
// fused kernel's ds rows (0 in the sweeps); `grid`: CTAs; `smem`: bytes a
// CTA; `threads`: a CTA's.  The byte offsets: the fused kernel's heads lie
// `unit_bytes` apart from 0; the sweeps' own rows from 0, their vectors at
// `off_vec`, the walked stages of `stage_bytes` from `off_walk`; then the
// float32 buffers at `off_buf` and the split warps' partial scores at
// `off_red`.
struct Geometry {
  int fused, split, dw, units, wph, rows, stages, ld, ldd, grid, smem,
      threads;
  int unit_bytes, off_vec, off_walk, stage_bytes, off_buf, off_red;
};

// The plan of (B*N, T, D) in an I/O dtype of `item` bytes (4 float32, 2
// bfloat16), fused where it can be unless `sweeps`: 0 and *g, or
// kPlanRefused outside the envelope.
int plan(int bn, int n_heads, int t, int d, int item, int sweeps,
         Geometry* g);

}  // namespace fmda_flash_bwd

// The plan as the launch takes it: kPlanFields ints into `out` (fused,
// split, dw, units, wph, rows, stages, ld, ldd, grid, smem, threads);
// returns 0, or kPlanRefused outside the envelope.
extern "C" int fmda_flash_bwd_plan(int bn, int n_heads, int t, int d,
                                   int itemsize, int sweeps, int* out);
