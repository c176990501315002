// The flash backward's plan (flash_bwd_plan.h): the one place where a
// call's branch (fused or the two sweeps), warps, CTAs, staging and
// shared-memory layout are decided.  The launches in flash_bwd.cu and
// flash_attn.cu call plan(); fmda_flash_bwd_plan reports the same plan to
// the host.

#include "flash_bwd_plan.h"

namespace fmda_flash_bwd {
namespace {

int align16(int x) { return (x + 15) & ~15; }
int cdiv(int a, int b) { return (a + b - 1) / b; }
int min_int(int a, int b) { return a < b ? a : b; }
int max_int(int a, int b) { return a > b ? a : b; }

// The float32 products' per-warp p and ds buffers, then the split warps'
// partial scores (s and dp, two 8-column tiles each, a float4 a lane) from
// `off`; returns the total.
int tail(Geometry* g, int item, int off) {
  const int warps = g->threads / 32;
  g->off_buf = align16(off);
  g->off_red = align16(
      g->off_buf + (item == 4 ? warps * 2 * kTile * kLdw * 4 : 0));
  g->smem = align16(
      g->off_red + (g->split > 1 ? warps * 4 * 32 * 16 : 0));
  return g->smem;
}

// The fused kernel's regions: each head's q, k, v and do [rows][ld], ds
// [rows][ldd], lse and delta [rows] float32, the key flags [rows].
int fused_layout(Geometry* g, int item) {
  g->threads = g->units * g->wph * 32;
  g->unit_bytes = align16((4 * g->ld + g->ldd) * g->rows * item +
                          2 * g->rows * 4 + g->rows);
  g->off_vec = g->off_walk = g->stage_bytes = 0;
  return tail(g, item, g->units * g->unit_bytes);
}

// The sweeps' regions: the CTA's own rows of two matrices [units * 16][ld]
// (k and v, or q and do), their lse and delta and key flags; then `stages`
// buffers of the walked rows: two matrices [rows][ld] (q and do, or k and
// v), their lse and delta, their key flags.
int sweep_layout(Geometry* g, int item) {
  const int own = g->units * kTile;
  g->threads = g->units * g->split * 32;
  g->unit_bytes = 0;
  g->off_vec = align16(2 * own * g->ld * item);
  g->off_walk = align16(g->off_vec + 2 * own * 4 + own);
  g->stage_bytes = align16(2 * g->rows * g->ld * item + 2 * g->rows * 4 +
                           g->rows);
  return tail(g, item, g->off_walk + g->stages * g->stage_bytes);
}

}  // namespace

int plan(int bn, int n_heads, int t, int d, int item, int sweeps,
         Geometry* g) {
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
    const int need = max_int(d, bf16 ? 16 : 8);
    for (p.dw = 8; p.dw < need;) p.dw *= 2;
  }
  const int dims = p.split * p.dw;
  const int n_tiles = cdiv(t, kTile);
  // 8 rows of a tile 4 words apart in the banks (and 16-byte rows)
  const int pad = bf16 ? 8 : 4;
  p.ld = dims + pad;
  if (!sweeps && p.split == 1 && t <= kBlockKeys) {
    // up to four heads a CTA, eight warps, a head's tiles shared by its
    // warps; fewer heads where four would pass the resident budget
    p.fused = 1;
    p.stages = 1;
    p.rows = n_tiles * kTile;
    p.ldd = p.rows + pad;
    for (p.units = 4;; p.units /= 2) {
      p.wph = min_int(n_tiles, 8 / p.units);
      if (p.units == 1 || fused_layout(&p, item) <= kResidentSmem) break;
    }
    p.grid = cdiv(bn, p.units);
    if (fused_layout(&p, item) <= kSmemLimit) {
      *g = p;
      return 0;
    }
  }
  // the sweeps: four tiles a CTA (D > 64: one of `split` warps), no more
  // than T needs; chunks of up to 64 walked rows, 2048 dims in all; two
  // buffers where they fit
  p.fused = 0;
  p.wph = 0;
  p.ldd = 0;
  p.units = min_int(max_int(1, 4 / p.split), n_tiles);
  p.rows = min_int(max_int(kTile, min_int(64, 2048 / dims)), n_tiles * kTile);
  p.stages = 2;
  if (sweep_layout(&p, item) > kSmemLimit) p.stages = 1;
  if (sweep_layout(&p, item) > kSmemLimit) return kPlanRefused;
  p.grid = bn * cdiv(t, kTile * p.units);
  *g = p;
  return 0;
}

}  // namespace fmda_flash_bwd

extern "C" int fmda_flash_bwd_plan(int bn, int n_heads, int t, int d,
                                   int itemsize, int sweeps, int* out) {
  fmda_flash_bwd::Geometry g;
  const int err =
      fmda_flash_bwd::plan(bn, n_heads, t, d, itemsize, sweeps, &g);
  if (err != 0) return err;
  const int report[fmda_flash_bwd::kPlanFields] = {
      g.fused, g.split, g.dw,   g.units, g.wph,  g.rows,
      g.stages, g.ld,   g.ldd,  g.grid,  g.smem, g.threads};
  for (int i = 0; i < fmda_flash_bwd::kPlanFields; ++i) out[i] = report[i];
  return 0;
}
