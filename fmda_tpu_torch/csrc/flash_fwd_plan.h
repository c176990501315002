// The flash forward's plan: how flash_fwd.cu's kernel lays out one call on
// the card.  Plain C++ with no CUDA in it, so that the plan (defined in
// flash_fwd_plan.cc) is built into the port's library beside the kernel and
// can also be built alone by a host compiler and checked on a machine
// without a card.

#pragma once

namespace fmda_flash {

constexpr int kBlockKeys = 128;  // keys a softmax block
constexpr int kMaxD = 512;       // the largest head dimension
constexpr int kMaxThreads = 256;
// The f32 p buffer: a warp's 16 x keys block, rows keys + kPadP apart so
// that the fragment reads of 8 rows fall in distinct banks.
constexpr int kPadP = 4;
// Shared memory one CTA may take on the H100, and what a plan whose K and V
// stay resident keeps to, so that two CTAs share an SM.
constexpr int kSmemLimit = 227 * 1024;
constexpr int kResidentSmem = 100 * 1024;
// The ints fmda_flash_fwd_plan reports: Geometry's first fields, in order.
constexpr int kPlanFields = 13;
// The plan's refusal: cudaErrorInvalidValue's code.
constexpr int kPlanRefused = 1;

// A warp owns a 16-row query tile; `split` warps share one when D > 64,
// each holding `dw` dims.  Resident (T <= 128, D <= 64): a CTA holds
// `units` whole (b*n) heads whose K and V stay in shared memory, and `wph`
// warps a head walk its query tiles.  Else a CTA holds `units` consecutive
// query tiles of one head (wph = 1), and K and V stream through `stages`
// buffers of `tk` keys.  `keys`: the keys of a block a warp holds scores
// for, 128, or 32 where the whole window is (T <= 32, dw <= 16).  `ldq`,
// `ldk`, `ldv`: the shared tiles' row strides in elements; `grid`: CTAs;
// `smem`: the bytes a CTA takes, and the byte offsets of its regions.
struct Geometry {
  int split, dw, units, wph, resident, keys, tk, stages, ldq, ldk, ldv, grid,
      smem;
  int off_v, off_keep, off_q, off_p, off_red;
};

// The plan of (B*N, T, D) in an I/O dtype of `item` bytes (4 float32, 2
// bfloat16): 0 and *g, or kPlanRefused outside the envelope.
int plan(int bn, int n_heads, int t, int d, int item, Geometry* g);

}  // namespace fmda_flash

// The plan as the launch takes it: kPlanFields ints into `out` (split, dw,
// units, wph, resident, keys, tk, stages, ldq, ldk, ldv, grid, smem);
// returns 0, or kPlanRefused outside the envelope.
extern "C" int fmda_flash_fwd_plan(int bn, int n_heads, int t, int d,
                                   int itemsize, int* out);
