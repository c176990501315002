// The flash forward's plan (flash_fwd_plan.h): the one place where a call's
// warps, CTAs, staging and shared-memory layout are decided.  The launch in
// flash_fwd.cu calls plan(); fmda_flash_fwd_plan reports the same plan to
// the host.

#include "flash_fwd_plan.h"

namespace fmda_flash {
namespace {

int align16(int x) { return (x + 15) & ~15; }
int cdiv(int a, int b) { return (a + b - 1) / b; }
int min_int(int a, int b) { return a < b ? a : b; }

// The offsets of each region of shared memory, in the kernel's order: the
// K and V tiles, the key flags, each warp's q tile, the f32 p buffers, the
// split warps' partial scores.  Returns the total.
int layout(Geometry* g, int item) {
  const int regions = g->resident ? g->units : 1;
  const int warps = g->units * (g->resident ? g->wph : g->split);
  const int k_bytes = regions * g->stages * g->tk * g->ldk * item;
  g->off_v = align16(k_bytes);
  g->off_keep =
      align16(g->off_v + regions * g->stages * g->tk * g->ldv * item);
  g->off_q = align16(g->off_keep + regions * g->stages * g->tk);
  g->off_p = align16(g->off_q + warps * 16 * g->ldq * item);
  g->off_red = align16(
      g->off_p + (item == 4 ? warps * 16 * (g->keys + kPadP) * 4 : 0));
  g->smem =
      align16(g->off_red + (g->split > 1 ? g->units * 2048 * 4 : 0));
  return g->smem;
}

}  // namespace

int plan(int bn, int n_heads, int t, int d, int item, Geometry* g) {
  if (bn < 1 || n_heads < 1 || bn % n_heads || t < 1 || d < 1 || d > kMaxD ||
      (item != 2 && item != 4))
    return kPlanRefused;
  const bool bf16 = item == 2;
  Geometry p{};
  p.split = 1;
  while (p.split * 64 < d) p.split *= 2;
  // dims a warp: whole mma k-steps (16 bf16, 8 f32), a power of two
  p.dw = 64;
  if (p.split == 1) {
    const int need = d > (bf16 ? 16 : 8) ? d : (bf16 ? 16 : 8);
    for (p.dw = 8; p.dw < need;) p.dw *= 2;
  }
  const int dims = p.split * p.dw;
  // rows apart in banks: 8 rows of K or q 4 words apart; bf16 V the same
  // for ldmatrix, f32 V 4 rows 8 words apart
  const int pad = bf16 ? 8 : 4;
  p.ldq = p.dw + pad;
  p.ldk = dims + pad;
  p.ldv = bf16 || dims % 16 == 0 ? dims + 8 : dims;
  if (p.split == 1 && t <= kBlockKeys) {
    // up to four heads a CTA, eight warps, a head's query tiles shared by
    // its warps
    p.resident = 1;
    p.tk = align16(t);
    p.stages = 1;
    p.keys = t <= 32 && p.dw <= 16 ? 32 : kBlockKeys;
    const int n_tiles = cdiv(t, 16);
    for (p.units = 4;; p.units /= 2) {
      p.wph = min_int(n_tiles, 8 / p.units);
      if (p.units == 1 || layout(&p, item) <= kResidentSmem) break;
    }
    p.grid = cdiv(bn, p.units);
  } else {
    // four query tiles a CTA share each streamed K and V tile (D > 64: one
    // tile of `split` warps); two buffers where they fit
    p.resident = 0;
    p.wph = 1;
    p.keys = kBlockKeys;
    p.tk = kBlockKeys / p.split;
    p.units = 4 / p.split > 1 ? 4 / p.split : 1;
    p.stages = 2;
    if (layout(&p, item) > kSmemLimit) p.stages = 1;
    p.grid = bn * cdiv(t, 16 * p.units);
  }
  if (layout(&p, item) > kSmemLimit) return kPlanRefused;
  *g = p;
  return 0;
}

}  // namespace fmda_flash

extern "C" int fmda_flash_fwd_plan(int bn, int n_heads, int t, int d,
                                   int itemsize, int* out) {
  fmda_flash::Geometry g;
  const int err = fmda_flash::plan(bn, n_heads, t, d, itemsize, &g);
  if (err != 0) return err;
  const int report[fmda_flash::kPlanFields] = {
      g.split, g.dw,  g.units, g.wph, g.resident, g.keys, g.tk,
      g.stages, g.ldq, g.ldk, g.ldv, g.grid, g.smem};
  for (int i = 0; i < fmda_flash::kPlanFields; ++i) out[i] = report[i];
  return 0;
}
