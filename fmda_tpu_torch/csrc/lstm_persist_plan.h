// The persistent LSTM scans' plan: how lstm_persist.cu lays one scan
// direction out over the card.  Plain C++ with no CUDA in it, so that the
// plan (defined in lstm_persist_plan.cc) is built into the port's library
// beside the kernels, can be built alone by a host compiler, and is
// mirrored line for line by fmda_tpu_torch/ops/_cuda_lib.py's
// persist_plan, which takes the same card figures as arguments.
//
// The partition: P batch tiles x Q hidden-unit slices, one CTA an SM, the
// whole grid resident (a cooperative launch).  CTA (p, q) owns the U = H/Q
// units U_q and rows [p R, p R + R) of the batch; it keeps its slice of
// W_hh in shared memory for the whole scan (forward: the 4 U gate rows of
// U_q; backward: the 4 H-long columns W_hh[:, U_q]) and streams the
// step's shared operand (h_{t-1} forward, the previous step's gate
// gradients backward) through a ring of `stages` K-chunks of `chunk`
// elements: 1, 2 or 4 TMA boxes of 128 bytes a row, each laid out by the
// 128-byte swizzle.  Clusters of C CTAs run along Q: they share a batch
// tile, so each CTA loads R_pad / C of its rows and multicasts them to the
// cluster, and every chunk is read from L2 once a cluster.

#pragma once

// The helpers below run on the host (the plan) and in the kernels.
#ifdef __CUDACC__
#define FMDA_HD __host__ __device__
#else
#define FMDA_HD
#endif

namespace fmda_persist {

constexpr int kConsumerWarps = 8;  // the product and the gate algebra
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one copy warp
constexpr int kUnitGroup = 8;      // units a consumer warp's column block
constexpr int kMaxMt = 4;          // m16 row tiles a consumer warp
// the backward's warp tile at most: m16 row tiles x n8 unit groups
constexpr int kMaxBwdTiles = 4;
constexpr int kMinStages = 2;
constexpr int kMaxStages = 16;
constexpr int kBoxBytes = 128;     // a TMA box's row: the swizzle's span
constexpr int kMaxBoxRows = 256;   // a TMA box's rows at most
constexpr int kMaxBoxes = 4;       // boxes a chunk at most
// the ring's barriers (2 x kMaxStages x 8 bytes), and the slack that
// aligns the shared block to the 128-byte swizzle's 1024-byte atoms
constexpr int kBarrierBytes = 256;
constexpr int kAlignBytes = 1024;

// Where a step's product needs fewer consumer warps than there are (small
// batches), in bf16, the idle ones split its K: ksplit(w) groups of w warps each
// take every ksplit-th k-step, and the groups' partial sums meet in a
// shared scratch of (ksplit - 1) w warps x 32 lanes x `floats` a lane.
FMDA_HD inline int ksplit(int warps) {
  int k = 1;
  while (2 * k * warps <= kConsumerWarps) k *= 2;
  return k;
}
FMDA_HD inline int scratch_bytes(int warps, int floats) {
  return (ksplit(warps) - 1) * warps * 32 * floats * 4;
}
// cluster sizes in the order the plan tries them; Figures::clusters is
// indexed by log2 of the size
constexpr int kClusterSizes[4] = {8, 4, 2, 1};
// The ints fmda_lstm_persist_plan reports: the plan's fields, then the
// card's figures it was made from.
constexpr int kPlanFields = 14;
constexpr int kFigureFields = 6;
// The plan's refusal (no layout fits: the per-step route keeps the scan):
// cudaErrorInvalidValue's code, as the flash plans'.
constexpr int kPlanRefused = 1;

// What the card offers the kernels: SMs, the shared memory one CTA may
// opt in to, and how many clusters of 1, 2, 4 and 8 CTAs can be resident
// at once with one CTA an SM (cudaOccupancyMaxActiveClusters: clusters are
// placed within a GPC, so 132 SMs need not hold 132 / 8 of 8).
struct Figures {
  int sms, smem, clusters[4];
};

struct Plan {
  int tiles;     // P, batch tiles
  int slices;    // Q, hidden-unit slices (Q % cluster == 0)
  int units;     // U = H / Q, a multiple of kUnitGroup
  int cluster;   // C, CTAs a cluster along Q
  int chunk;     // K-chunk of the staged operand, in elements (its boxes)
  int stages;    // the ring's chunks
  int mt;        // m16 row tiles a forward consumer warp (1, 2 or 4)
  int mt_bwd;    // the same backward, where a warp takes all U / 8 n-tiles
  int rows;      // R = ceil(B / P), batch rows a tile
  int rows_pad;  // R rounded up to 16 (the product's m16 tiles)
  int smem;      // bytes a CTA: W_hh's slice, the ring, the barriers, the
                 // K-split's scratch
  int grid;      // P * Q CTAs
  int ring_off;  // byte offset of the ring (after W_hh's slice)
};

// W_hh's slice's row stride in elements (K = H forward, 4 H backward):
// padded by 16 bytes so that the rows of an 8 x 8 fragment fall in
// distinct banks.  (The ring's rows are the swizzle's 128 bytes.)
inline int row_pad(int item) { return 16 / item; }

// The plan of a scan direction at (B, H) in an I/O dtype of `item` bytes
// (4 float32, 2 bfloat16) on a card of figures `f`: 0 and *p, or
// kPlanRefused.  Of the layouts that fit (W_hh's slice and at least
// kMinStages ring chunks in f.smem, at most kConsumerWarps consumer warps
// at kMaxMt row tiles each, a CTA's share of a box at most kMaxBoxRows,
// P Q CTAs resident), it takes the one with the most CTAs, then the most
// batch tiles (fewer staged rows a CTA), then the smallest cluster (a
// larger one only where a CTA's share of a box needs it); its chunk is
// the most boxes (fewer waits a step) that leave at least three stages,
// or one box.
int plan(int B, int H, int item, const Figures& f, Plan* p);

// Whether `p` is a layout of (B, H) in `item` bytes that the kernels can
// run on a card of figures `f`: every field what the layout rules above
// make of its slices, cluster, chunk, rows, mt and stages, the grid
// resident and the shared memory within f.smem.  The launches run only
// such a plan (the one plan() picks, or another, for measurements).
bool fits(int B, int H, int item, const Figures& f, const Plan& p);

// A plan as the launches take it: ints in Plan's order.
constexpr int kLaunchFields = 13;

}  // namespace fmda_persist

// The plan as the launches take it, on card `device`: kPlanFields ints
// (persistent 1 or 0, then Plan's fields in order: tiles, slices, units,
// cluster, chunk, stages, mt, mt_bwd, rows, rows_pad, smem, grid,
// ring_off; all 0 but the flag when the plan refuses)
// and then kFigureFields (sms, smem, clusters of 1, 2, 4, 8) into `out`.
// Returns 0, or a CUDA error code of the figures' query.
extern "C" int fmda_lstm_persist_plan(int B, int H, int itemsize, int device,
                                      int* out);
