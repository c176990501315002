// The persistent LSTM scans' plan (lstm_persist_plan.h): the one place
// where a scan's partition, cluster, warp tiles and shared-memory layout
// are decided.  The launches in lstm_persist.cu run a plan only where
// fits() holds; fmda_lstm_persist_plan reports plan()'s choice to the
// host, and _cuda_lib.persist_plan repeats it in Python.

#include "lstm_persist_plan.h"

namespace fmda_persist {
namespace {

int cdiv(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int m) { return cdiv(a, m) * m; }
int min_int(int a, int b) { return a < b ? a : b; }

int log2_of(int c) {
  int k = 0;
  while ((1 << k) < c) ++k;
  return k;
}

// The smallest m16 row tiles a forward consumer warp (a warp a column
// block of kUnitGroup units and its four gates) that keep the warps
// within kConsumerWarps, or 0.
int mt_of(int rows_pad, int units) {
  const int mtiles = rows_pad / 16, blocks = units / kUnitGroup;
  for (int m = 1; m <= kMaxMt; m *= 2)
    if (cdiv(mtiles, m) * blocks <= kConsumerWarps) return m;
  return 0;
}

// The same backward, where a warp takes every unit of the slice (U / 8
// n-tiles, so each staged row is read by one warp), its tile at most
// kMaxBwdTiles m16 x n8 tiles, or 0.
int mt_bwd_of(int rows_pad, int units) {
  const int mtiles = rows_pad / 16, nt = units / kUnitGroup;
  for (int m = 1; m <= kMaxMt && m * nt <= kMaxBwdTiles; m *= 2)
    if (cdiv(mtiles, m) <= kConsumerWarps) return m;
  return 0;
}

int ring_off_of(int H, int units, int item) {
  // the forward's 4 U rows of H + pad hold more than the backward's U rows
  // of 4 H + pad: one layout serves both; the ring starts on a swizzle atom
  return round_up(4 * units * (H + row_pad(item)) * item, kAlignBytes);
}

// A chunk's bytes in the ring: its boxes of R_pad rows.
int slot_of(int chunk, int rows_pad, int item) {
  return chunk * item / kBoxBytes * rows_pad * kBoxBytes;
}

// The K-split's scratch (bf16 only): the larger of the forward's (its
// warps a column block and MT row tiles, 16 MT floats a lane: four gates'
// n-tiles) and the backward's (MT_bwd row tiles, U / 8 n-tiles).
int scratch_of(int rows_pad, int units, int mt, int mt_bwd, int item) {
  if (item != 2) return 0;  // the K-split runs in bf16 only
  const int mtiles = rows_pad / 16, nt = units / kUnitGroup;
  const int fwd = scratch_bytes(cdiv(mtiles, mt) * nt, 16 * mt);
  const int bwd = scratch_bytes(cdiv(mtiles, mt_bwd), 4 * mt_bwd * nt);
  return fwd > bwd ? fwd : bwd;
}

int smem_of(int ring_off, int stages, int slot, int scratch) {
  return ring_off + stages * slot + kBarrierBytes + scratch + kAlignBytes;
}

bool chunk_ok(int chunk, int item) {
  const int boxes = chunk * item / kBoxBytes;
  return chunk * item % kBoxBytes == 0 &&
         (boxes == 1 || boxes == 2 || boxes == kMaxBoxes);
}

// c beats b: more CTAs, then more batch tiles, then a smaller cluster
// (on the H100 one CTA a cluster ran no slower than two at every shape
// measured, 4 and 8 up to 1.7x slower: the bytes through each SM's shared
// memory limit a step, not the L2's reads).
bool better(const Plan& c, const Plan& b) {
  if (c.grid != b.grid) return c.grid > b.grid;
  if (c.tiles != b.tiles) return c.tiles > b.tiles;
  return c.cluster < b.cluster;
}

}  // namespace

bool fits(int B, int H, int item, const Figures& f, const Plan& p) {
  if (B < 1 || H < kUnitGroup || (item != 2 && item != 4)) return false;
  const int c = p.cluster;
  if (c != 1 && c != 2 && c != 4 && c != 8) return false;
  if (p.units < kUnitGroup || p.units % kUnitGroup ||
      p.slices * p.units != H || p.slices % c)
    return false;
  if (!chunk_ok(p.chunk, item) || H % p.chunk) return false;
  if (p.rows < 1 || p.tiles != cdiv(B, p.rows) ||
      p.rows_pad != round_up(p.rows, 16) || p.rows_pad / c > kMaxBoxRows)
    return false;
  if (p.grid != p.tiles * p.slices || p.grid > f.clusters[log2_of(c)] * c)
    return false;
  if (p.mt == 0 || p.mt != mt_of(p.rows_pad, p.units) || p.mt_bwd == 0 ||
      p.mt_bwd != mt_bwd_of(p.rows_pad, p.units))
    return false;
  if (p.stages < kMinStages || p.stages > kMaxStages) return false;
  if (p.ring_off != ring_off_of(H, p.units, item)) return false;
  return p.smem == smem_of(p.ring_off, p.stages,
                          slot_of(p.chunk, p.rows_pad, item),
                          scratch_of(p.rows_pad, p.units, p.mt, p.mt_bwd,
                                     item)) &&
         p.smem <= f.smem;
}

int plan(int B, int H, int item, const Figures& f, Plan* p) {
  if (B < 1 || H < kUnitGroup || H % kUnitGroup || (item != 2 && item != 4))
    return kPlanRefused;
  if (H % (kBoxBytes / item)) return kPlanRefused;
  bool found = false;
  Plan best{};
  for (int c : kClusterSizes) {
    const int cap = f.clusters[log2_of(c)] * c;
    for (int u = kUnitGroup; u <= H; u += kUnitGroup) {
      if (H % u) continue;
      const int q = H / u;
      if (q % c || q > cap) continue;
      Plan n{};
      // at most what the grid holds, at least 16 rows a tile, none empty
      n.rows = cdiv(B, min_int(cap / q, cdiv(B, 16)));
      n.tiles = cdiv(B, n.rows);
      n.slices = q;
      n.units = u;
      n.cluster = c;
      n.rows_pad = round_up(n.rows, 16);
      if (n.rows_pad / c > kMaxBoxRows) continue;
      n.mt = mt_of(n.rows_pad, u);
      n.mt_bwd = mt_bwd_of(n.rows_pad, u);
      if (n.mt == 0 || n.mt_bwd == 0) continue;
      n.ring_off = ring_off_of(H, u, item);
      const int scratch = scratch_of(n.rows_pad, u, n.mt, n.mt_bwd, item);
      const int room = f.smem - smem_of(n.ring_off, 0, 0, scratch);
      for (int boxes = kMaxBoxes; boxes >= 1 && n.chunk == 0; boxes /= 2) {
        const int chunk = boxes * kBoxBytes / item;
        const int slot = slot_of(chunk, n.rows_pad, item);
        const int stages = room < 0 ? 0 : min_int(kMaxStages, room / slot);
        if (H % chunk == 0 && stages >= (boxes > 1 ? 3 : kMinStages)) {
          n.chunk = chunk;
          n.stages = stages;
        }
      }
      if (n.chunk == 0) continue;
      n.smem = smem_of(n.ring_off, n.stages,
                       slot_of(n.chunk, n.rows_pad, item), scratch);
      n.grid = n.tiles * n.slices;
      if (!found || better(n, best)) {
        best = n;
        found = true;
      }
    }
  }
  if (!found) return kPlanRefused;
  *p = best;
  return 0;
}

}  // namespace fmda_persist
