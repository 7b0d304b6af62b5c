// Fused masked local SGD for the FedAR client MLP (784 -> H -> 10), one
// thread-block cluster per client, in two forms built from one template.
// This header holds the template; local_sgd.cu instantiates the narrow plan
// (H <= 256) and the C interface, local_sgd_wide.cu the wide instance,
// local_sgd_tiled.cu the tiled plan, local_sgd_general.cu the general
// instance (four translation units, so that nvcc builds them side by side).
// The C interface takes the first of them that takes the shape:
//
//   narrow   H <= 256, I a multiple of 4, C <= 16, two x tiles of the whole
//            batch within a CTA's shared memory (B <= 20 at I = 784)
//   wide     256 < H <= 1,024 at the same I and C, B <= 20
//   tiled    H <= 256 at the same I and C, a batch the narrow plan cannot
//            hold (every B > 20 at I = 784), where its plan fits a CTA and
//            I <= 1,024 (2,048 at 8-column slices)
//   general  every other shape (C > 16, I not a multiple of 4, H > 1,024,
//            H > 256 at B > 20, what the tiled plan cannot fit)
//
// The forms (the same for the wide and the general instance's kernels):
//
//   local_sgd_kernel<false>  the dense (R, npad) sample rectangle
//   local_sgd_kernel<true>   the ragged batch-tile buffer of the packed
//                            layout: client r walks its own nb[r] tiles
//                            from tile off[r]
//
// Replaces: src/repro/kernels/local_sgd.py:148 local_sgd_fused (Pallas TPU;
// body _sgd_kernel and _batch_body) and :243 local_sgd_fused_ragged (body
// _ragged_kernel).  Each client runs E epochs x its batches of forward,
// hand-written backward and SGD update; the hidden activation is ReLU or
// softmax per client (Table II); the loss gradient is
// (softmax - onehot) * m / max(sum m, 1); a batch whose mask count is zero
// is skipped, like pl.when(cnt > 0).  fp32 on the CUDA cores throughout.
//
// What bounds it on an H100: a client's SGD steps are a chain, each step
// reading the weights the previous one wrote, so the kernel's time is the
// longest client's chain (E x its live batches, up to 350 steps) times the
// latency of one step.  One step is ~4*B*I*H = 8 MFLOP at B = 20, H = 128:
// ~16 us on one SM's share of the 67 TFLOP/s fp32 peak.  fp32 w1 at H = 128
// (401 KB) does not fit one SM's 227 KB of shared memory, so a block that
// owns the whole client streams w1 from L2 every step.
//
// What the design does about it:
// - One client per cluster of K CTAs (K = 8 at H = 128, 16 at H = 256; K
//   depends on (I, H, C, B) only, never on R, so a client's sums run in the
//   same order in both forms and at any fleet size).  CTA `rank` owns the HS
//   hidden columns [rank*HS, (rank+1)*HS): its slice of w1 (784 x 16 fp32 =
//   50 KB, stored transposed with an odd 16-byte row stride so that float4
//   reads are free of bank conflicts), of b1 and its rows of w2 stay in
//   shared memory for the whole chain and go to `out` once at the end.  The
//   forward x @ w1[:, slice], the activation, dh[:, slice], the w2-slice
//   update and the x^T dh update of the w1 slice are all local.
// - Register tiles sized for shared-memory traffic, the limit of an fp32
//   product this small: 8 warps, two on each SM sub-partition.  In the
//   forward a warp owns 5 batch rows x 8 hidden columns and its lanes split
//   I in 4-row groups, so a lane's 40 sums take 52 floats read for 160 FMAs;
//   a reduce-scatter over the lanes (40 shuffles) leaves each output on one
//   lane.  In the w1 update a thread owns 8 columns x two 4-row groups of I
//   and walks the batch; whole warps past those tiles take b1.
// - What crosses the slices goes through distributed shared memory: each
//   CTA stores its partial (h_slice @ w2[slice], B x C; for softmax-hidden
//   clients also the row max / exp-sum and, backward, the row dot sum
//   dh.h) into its own slot of every CTA's buffer, one cluster barrier,
//   then every CTA sums the K slots in rank order.  So every CTA holds
//   bit-identical logits, d-logits and b2 updates.  The buffers alternate
//   with a running count, so one barrier per reduction is enough: a buffer
//   is written again only after the next reduction's barrier, which every
//   reader has passed.  w2 is double-buffered by step parity, so its update
//   runs beside dh, which reads the old rows.
// - The batch's x tile (B x I contiguous fp32, 62,720 B at B = 20) comes in
//   by bulk copy (cp.async.bulk, multicast to every CTA of the cluster; each
//   rank issues 1/K of the bytes, so L2 serves the tile once), completing
//   on a per-slot mbarrier.  Two slots: the next live batch's tile is
//   issued right after the current step's logits barrier (by then every
//   CTA has finished the previous step, the last reader of that slot) and
//   lands during the backward pass.  The mask row and labels of the next
//   live batch are read ahead by one warp (its loads overlap the forward
//   product); an all-masked batch is never loaded at all.
// - The wrapper orders clusters longest chain first (an int32 order
//   computed on the card), so the longest chain starts in the first wave.
// What bounds it now: the chain's step latency: the forward and the w1
// update (shared-memory reads), then short latency-bound phases (the
// logits' partials, the cluster barrier, d logits, dh) and 4 block
// barriers; a softmax-hidden step adds two cluster reductions.
//
// Layouts (all fp32 unless noted, row-major, contiguous):
//   g      (D,)          global params, flat order b1 | b2 | w1 | w2
//   dense:  x (R, npad, I) samples, npad = nb * B (zero-padded tail);
//           y (R, npad) int32 labels; mask (R, npad) validity
//   ragged: x (T, B, I) batch tiles; y (T, B) int32; mask (T, B);
//           nb, off (R,) int32 batch count and first tile of each client
//   act    (R,)          int32, 1 = softmax hidden, else ReLU
//   order  (R,)          int32, cluster c trains client order[c]
//   out    (R, D)        post-SGD params, same flat order as g
// The narrow plan, the wide instance and the tiled plan need I a multiple
// of 4 (16-byte rows for the bulk copy and float4 reads), C at most 16, H
// at most 1,024 (past 256, B at most 20) and a plan within a block's shared
// memory; every other shape goes to the general instance (below the
// template).
//
// Hidden widths.  Where H splits into at most 8 slices of 8 or 16 columns
// (H one of 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128) the plan is
// that split, unpadded, on a portable cluster.  Any other H up to 256 is
// padded up to Hp = K * HS columns, HS = 16 (8 for H < 8), K = ceil(H /
// HS) <= 16: H = 100 takes 7 x 16, 200 takes 13 x 16, 256 takes 16 x 16
// (209,152 shared bytes a CTA at I = 784, B = 20).  A cluster of more than
// 8 CTAs is non-portable (cudaFuncAttributeNonPortableClusterSizeAllowed)
// and must fit one GPC, so fewer clusters are resident at once.  Above 256
// a slice would have to be wider than 16 columns: 24 fit a CTA's shared
// memory only up to 12 CTAs (H = 288; the cluster's partial buffers grow
// with K), 32 at no K (I = 784, B = 20).
//
// The wide instance (256 < H <= 1,024, B <= 20; local_sgd_wide_kernel, after
// the general instance): w1 streamed from L2 through a ring in shared
// memory.  The slice's working copy is the client's own output row, out[r]'s
// w1 columns [h0, h0 + HS), read and written in place, as the Pallas kernel
// keeps its parameters in its output tiles.  That row starts at float H + C
// of a row D floats long (D = 646,345 at H = 813: D * 4 is no multiple of
// 16), so neither 16-byte copies nor a TMA tensor map can address it for
// general H; the other choice, an aligned workspace of padded pitch, would
// take R * I * Hp * 4 bytes (1.6 GB at R = 512, H = 1,024) and one more pass.
// What bounded its first design (a lane owning one w1 column of a 15-16 CTA
// cluster, 16 rows in flight in registers), measured on an H100 with clock64
// stamps (PERF.md section 7): a step took 28.0 us at H = 512 and 40.2 at 813,
// the pass over w1 13.5 and 23.3 of it: each float4 of x, read from shared
// memory, fed 4 FMAs, and only 7 clusters were resident.  What it does now:
// - Portable clusters of K <= 8 CTAs with slices of HS = 64 columns up to H
//   = 512 and 128 past it (8 x 64 at 512, 7 x 128 at 813 and 879, 8 x 128 at
//   1,024; the last slice padded): 15-22 clusters resident against 7, at
//   twice the work a CTA.
// - A ring of 3-4 slots of 16 KB (wide_plan; 8 KB where shared memory is
//   short): chunk c holds 64 (HS = 64) or 32 rows of the slice, copied in by
//   4-byte cp.async, a warp on neighbouring columns, each column at wpos so
//   that a thread's tile columns are one float4; an updated chunk goes back
//   by coalesced 4-byte stores with the same thread mapping two turns later,
//   just before its slot is refilled.  A turn is one block barrier.
// - Two roles of 4 warps, each thread a register tile of 4 columns x 4 rows
//   of I (a quad): the update warps hold d hpre of their tile's columns for
//   all 20 batch rows (80 registers) and update the tile, w - lr * sum_b
//   x[b][i] d[b][h] (b in order), back into the slot; the forward warps,
//   one turn behind, sum the next step's x @ w1 on the updated tile for all
//   20 rows (80 registers), folded over the lane rows by shuffles and met
//   over (at most two) warp rows in shared memory, in order, plus b1.  Each
//   float4 of x read from shared memory feeds 16 FMAs, each w1 value all 20
//   batch rows.  One thread holding both (160 registers) spilled or, without
//   spills, stalled; split, 210-220 registers and no spill.
// - The step's short phases spread over the CTA: a warp a batch row for the
//   softmax hidden layer's row max and exp-sum and its backward dot, a
//   column a thread group for dh and the w2 gradient (held in registers
//   until w2's last reader this step has passed).
// What bounds it now (PERF.md section 7): the pass, ~25 us at H = 512 and
// ~49 at 813 against 7.9 and 15.7 us of FMA time; the short phases ~11-14
// us.  Stripped copies of the kernel timed on the card put the pass's excess
// on the ring's 4-byte copies (an instruction, and a shared load too on the
// way back, an element), not on the slice's 0.4-0.8 MB through L2: without
// the copies it ran 29% (H = 512) and 33% (813) faster, without either
// role's FMAs 11-15%.  Every sum runs in an order fixed by the
// shapes, so the ragged form is bit-equal to the dense and no row depends on
// the client order (tests/test_torch_kernels.py writes the order out).
//
// The tiled plan (kTiled; H <= 256 and a batch whose two x tiles do not
// fit, so B > 20 at I = 784).  What bounds it is what bounds the narrow
// plan: the chain's step latency, not the 16-column slice's FMA work (a
// 20-row sub-tile is ~1.0 MFLOP a CTA at I = 784, H = 128, ~2 us at an SM's
// share of the fp32 peak, against the ~12 us a narrow step at B = 20 takes
// on the card: PERF.md section 6).  A step of B rows on the narrow plan's 8
// CTAs would need ~2 x B x 784 x 4 bytes of x slots; the general instance,
// which stood in for it, streamed every product through L2 on 2 CTAs a
// client.  The tiled plan keeps the narrow plan's whole layout -- its K and
// HS, the w1 slice, b1 and the w2 rows in shared memory for the whole
// chain, the distributed-shared-memory reductions, the multicast bulk
// copies -- and takes the batch through in sub-tiles of Bp = 20 rows (fewer
// where shared memory is short), x slots of Bp rows.  Each sub-tile runs
// the narrow step's forward, softmax hidden layer, logits and d logits (the
// batch's mask count, staged with its mask and labels before the first
// sub-tile, scales them), dh and the softmax backward on its own rows: a
// row's backward needs only its own logits, so the cluster's buffers stay
// sub-tile-sized.  Its x tile, still in shared memory, feeds its share of
// the w1 gradient, so x is read once a step.  The gradients are summed over
// the sub-tiles in sub-tile order: w1's in the update threads' registers
// (each thread owns one tile of 8 columns x 8 rows of I for the whole
// chain, utiles <= 256, so the sum over b runs as the narrow plan's does,
// one fmaf chain in row order), w2's, b2's and b1's in shared memory, each
// sub-tile's share summed as the narrow plan sums a step's; the last
// sub-tile applies them.  w1, b1, b2 and the w2 parity change only then, so
// every sub-tile of a step reads the step's parameters.  The next
// sub-tile's tile (or the next live batch's first) is issued after each
// sub-tile's logits barrier, as the narrow plan issues the next batch's;
// the rows past a partial last sub-tile are a previous sub-tile's, summed
// in the forward and dropped.  A step of B rows costs ceil(B / Bp) narrow
// steps' latency, so on a fleet of n samples a client the kernel takes
// about what the narrow plan takes at B = 20.
//
// Pad columns (h >= H, only in the last CTA's slice) are not the model's:
// their w1 columns, b1 entries and w2 rows start at zero in shared memory
// (in the wide instance the ring's copies zero-fill their w1 instead of
// reading out, where they would alias the next row's first columns) and are
// never written to `out`; D and every offset into g and out use the true H.  Under ReLU a
// pad column's pre-activation is exactly 0, so its h, its dh and every
// update it feeds stay 0.  A softmax hidden layer maps 0
// to 1/sum, not 0, so the slice's row max and exp-sum take only the real
// columns and a pad column's h is set to 0; with h = 0 and its w2 row 0,
// its dh, its share of the row dot sum(dh * h) and its w2 update are 0
// too.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // 8 warps: two on each SM sub-partition
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 5;        // batch rows of a warp's forward tile
constexpr int kCols = 8;        // hidden columns of a forward / update tile
constexpr int kMaxPortable = 8;  // the portable cluster size
constexpr int kMaxCluster = 16;  // the non-portable limit on Hopper
constexpr int kBT = 20;            // the wide instance's batch rows in registers
constexpr int kSubRows = 20;       // the tiled plan's largest sub-tile
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory a block may opt into
static_assert(kRows * kCols == 40, "a forward tile: 32 outputs + 8 outputs");

// Shared-memory plan of one CTA; computed on the host, passed by value.
// Offsets are in floats, all multiples of 4 (16 bytes).
struct Plan {
  int K, HS, Bp, W, RB;
  int o_x, o_w1, o_hpre, o_hact, o_dh, o_dhp, o_w2, o_b1, o_b2, o_lg, o_red, o_ms, o_ys,
      o_misc, o_bar, bytes;
  // the tiled plan: a step's batch in nsub sub-tiles of Bp rows, MB staged
  // mask and label rows a step (Bp elsewhere), the sub-tiles' gradients of
  // w2, b2 and b1
  int tiled, nsub, MB, o_gw2, o_gb2, o_gb1;
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// The shapes the bulk-copy plans (narrow, wide, tiled) take: rows of whole
// 16-byte units, at most 16 classes.
inline bool bulk_shapes(int I, int H, int C, int B) {
  return I >= 4 && I % 4 == 0 && H >= 1 && C >= 1 && C <= 16 && B >= 1;
}

// K: the largest portable cluster whose slices are 8 or 16 columns wide;
// else H padded to K slices of HS columns, K <= 16; K = 0 past H = 256
// (the wide instance has its own plan, wide_plan).  BT > 0: the tiled
// plan's sub-tiles of BT rows (a multiple of kRows), with the narrow plan's
// K and HS.  A function of the shapes only.
Plan make_plan(int I, int H, int C, int B, int BT = 0) {
  Plan p{};
  for (int k = kMaxPortable; k >= 1; --k)
    if (H % k == 0 && (H / k == 8 || H / k == 16)) {
      p.K = k;
      p.HS = H / k;
      break;
    }
  if (p.K == 0) {
    p.HS = H < 8 ? 8 : 16;
    p.K = (H + p.HS - 1) / p.HS;
    if (p.K > kMaxCluster) p.K = 0;
  }
  if (p.K == 0) return p;
  // the tiled plan's x slots hold BT rows of a sub-tile
  p.tiled = BT > 0;
  p.Bp = p.tiled ? BT : (B + kRows - 1) / kRows * kRows;
  p.nsub = p.tiled ? (B + BT - 1) / BT : 1;
  p.MB = p.tiled ? B : p.Bp;
  p.W = 4 * ((up4(I) / 4) | 1);  // odd count of 16-byte units: conflict-free rows
  p.RB = up4(p.Bp * C > 2 * p.Bp ? p.Bp * C : 2 * p.Bp);
  int off = 0;
  auto take = [&off](int n) {
    int o = off;
    off += up4(n);
    return o;
  };
  p.o_x = take(2 * p.Bp * I);
  p.o_w1 = take(p.HS * p.W);
  p.o_hpre = take(p.Bp * p.HS);
  p.o_hact = take(p.Bp * p.HS);
  p.o_dh = take(p.Bp * p.HS);
  p.o_dhp = take(p.Bp * p.HS);
  p.o_w2 = take(2 * p.HS * C);
  p.o_b1 = take(p.HS);
  p.o_b2 = take(C);
  p.o_lg = take(p.Bp * C);
  p.o_red = take(2 * p.K * p.RB);
  p.o_ms = take(2 * p.MB);
  p.o_ys = take(2 * p.MB);
  p.o_gw2 = take(p.tiled ? p.HS * C : 0);
  p.o_gb2 = take(p.tiled ? C : 0);
  p.o_gb1 = take(p.tiled ? p.HS : 0);
  p.o_misc = take(8);  // next live step (3), mask counts (2)
  off = (off + 1) & ~1;  // 8-byte aligned mbarriers
  p.o_bar = off;
  off += 2 * 2;  // two 8-byte barriers
  p.bytes = off * 4;
  return p;
}

// The tiled plan: the largest sub-tile (20, 15, 10 or 5 rows, fewer than
// B) whose plan fits a CTA's shared memory and gives each update thread at
// most one w1 tile (its gradient lives in that thread's registers); K = 0
// if none.
Plan tiled_plan(int I, int H, int C, int B) {
  if (!bulk_shapes(I, H, C, B)) return Plan{};
  for (int bt = kSubRows; bt >= kRows; bt -= kRows) {
    if (bt >= B) continue;
    const Plan p = make_plan(I, H, C, B, bt);
    if (p.K == 0) break;
    const int utiles = (I / 4 + 1) / 2 * (p.HS / kCols);
    if (p.bytes <= kMaxSmemBytes && utiles <= kThreads) return p;
  }
  return Plan{};
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.  A wait
// that outlasts ~10 s of SM clock traps (a launch error) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000ll) __trap();
  }
}

// One CTA's share of a batch tile: bytes [rank * chunk, ...) of the tile,
// multicast into the same offsets of every CTA of the cluster, each
// completing on that CTA's barrier of the slot.  The issuing thread first
// arms its own barrier for the whole tile (peers' bytes may land before
// that: the transaction count may go negative within a phase).
__device__ __forceinline__ void issue_tile(const float* src, float* dst, uint64_t* bar,
                                           uint32_t tile_bytes, int rank, int K) {
  const uint32_t b = smem_addr(bar);
  mbar_expect_tx(b, tile_bytes);
  const uint32_t chunk = (tile_bytes / 16 + K - 1) / K * 16;
  const uint32_t lo = rank * chunk;
  if (lo >= tile_bytes) return;
  const uint32_t n = tile_bytes - lo < chunk ? tile_bytes - lo : chunk;
  const uint32_t d = smem_addr(reinterpret_cast<char*>(dst) + lo);
  const char* s = reinterpret_cast<const char*>(src) + lo;
  if (K > 1) {
    const uint16_t mask = (uint16_t)((1u << K) - 1);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(d),
        "l"(s), "r"(n), "r"(b), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(d),
        "l"(s), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Reduce-scatter by recursive halving, one level per lane bit below N (8 or
// 32): lane l returns the sum of v[l % N] over the lanes that differ from it
// only in those bits, in a fixed order.
template <int O, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  if constexpr (N >= 32) halve<16>(v, lane);
  if constexpr (N >= 16) halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// A forward tile's 40 sums over the warp: lane l returns output l for
// l < 32 (reduce-scatter), and every lane returns output 32 + (l & 7)
// (reduce-scatter over lane bits 0-2, then a butterfly over bits 3-4).
__device__ __forceinline__ void reduce_tile(float (&acc)[40], int lane, float& lo,
                                            float& hi) {
  float a[32], b[8];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = acc[j];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = acc[32 + j];
  lo = reduce_scatter(a, lane);
  float v = reduce_scatter(b, lane);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  hi = v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Sum and max over the 8 lanes of a quarter warp.
__device__ __forceinline__ float quarter_sum(float v) {
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quarter_max(float v) {
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum over b < n of a[b * sa] * b_[b * sb] (b_ = nullptr: of a alone), in
// four interleaved partial sums so that the loads overlap, combined as
// (s0 + s1) + (s2 + s3).
__device__ __forceinline__ float dot4(const float* a, int sa, const float* b_, int sb, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    s0 += a[k * sa] * (b_ ? b_[k * sb] : 1.f);
    s1 += a[(k + 1) * sa] * (b_ ? b_[(k + 1) * sb] : 1.f);
    s2 += a[(k + 2) * sa] * (b_ ? b_[(k + 2) * sb] : 1.f);
    s3 += a[(k + 3) * sa] * (b_ ? b_[(k + 3) * sb] : 1.f);
  }
  for (; k < n; ++k) s0 += a[k * sa] * (b_ ? b_[k * sb] : 1.f);
  return (s0 + s1) + (s2 + s3);
}

// Warp-wide: the mask count of the batch at sample row row0, summed in
// batch-row order.
__device__ __forceinline__ float batch_count(const float* mask, long long row0, int B,
                                             int lane) {
  float cnt = 0.f;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const float v = b0 + lane < B ? mask[row0 + b0 + lane] : 0.f;
    const int n = B - b0 < 32 ? B - b0 : 32;
    for (int j = 0; j < n; ++j) cnt += __shfl_sync(0xffffffffu, v, j);
  }
  return cnt;
}

// Warp-wide: the first step t' >= t (t' < total) whose batch has a mask
// count > 0, else total; one epoch of candidates is enough to know.  Stages
// that batch's mask row, labels and count into ms / ys / cnt.
__device__ int stage_next_live(const float* mask, const int* y, long long first, int nb,
                               int B, int t, int total, float* ms, int* ys, float* cnt,
                               int lane) {
  for (int k = 0; k < nb && t < total; ++k, ++t) {
    const long long row0 = first + (long long)(t % nb) * B;
    const float c = batch_count(mask, row0, B, lane);
    if (c > 0.f) {
      for (int b = lane; b < B; b += 32) {
        ms[b] = mask[row0 + b];
        ys[b] = y[row0 + b];
      }
      if (lane == 0) *cnt = c;
      return t;
    }
  }
  return total;
}

// A CTA's partial v for element j goes into slot `rank` of buffer `buf`
// (K slots of RB floats) in every CTA of the cluster: remote stores, posted,
// made visible by the next cluster barrier.
__device__ __forceinline__ void push(cg::cluster_group& cluster, float* buf, int RB, int rank,
                                     int K, int j, float v) {
  for (int rk = 0; rk < K; ++rk) cluster.map_shared_rank(buf, rk)[rank * RB + j] = v;
}

// After the barrier: the K slots of element j summed in rank order.
__device__ __forceinline__ float gather_sum(const float* buf, int RB, int K, int j) {
  float s = buf[j];
  for (int rk = 1; rk < K; ++rk) s += buf[rk * RB + j];
  return s;
}

// A w1-update tile's gradient: ga[k][e] += sum over b < rows of x[b][4 qa
// + e] * dhp[b][c0 + k] (gb: 4 qb + e, when hasb), in row order.
__device__ __forceinline__ void accumulate_tile(const float* xt, int I, const float* dhp,
                                                int HS, int c0, int qa, int qb, bool hasb,
                                                int rows, float (&ga)[kCols][4],
                                                float (&gb)[kCols][4]) {
  for (int b = 0; b < rows; ++b) {
    const float4 xa = ld4(xt + b * I + 4 * qa);
    const float4 xb = hasb ? ld4(xt + b * I + 4 * qb) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 d0 = ld4(dhp + b * HS + c0), d1 = ld4(dhp + b * HS + c0 + 4);
    const float d[kCols] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      ga[k][0] = fmaf(xa.x, d[k], ga[k][0]);
      ga[k][1] = fmaf(xa.y, d[k], ga[k][1]);
      ga[k][2] = fmaf(xa.z, d[k], ga[k][2]);
      ga[k][3] = fmaf(xa.w, d[k], ga[k][3]);
      gb[k][0] = fmaf(xb.x, d[k], gb[k][0]);
      gb[k][1] = fmaf(xb.y, d[k], gb[k][1]);
      gb[k][2] = fmaf(xb.z, d[k], gb[k][2]);
      gb[k][3] = fmaf(xb.w, d[k], gb[k][3]);
    }
  }
}

// w1s -= lr * the tile's gradient (w1s[h * W + i] = w1[i][h0 + h]).
__device__ __forceinline__ void apply_tile(float* w1s, int W, int c0, int qa, int qb,
                                           bool hasb, float lr, const float (&ga)[kCols][4],
                                           const float (&gb)[kCols][4]) {
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    float4* wa = reinterpret_cast<float4*>(w1s + (c0 + k) * W + 4 * qa);
    float4 w = *wa;
    w.x -= lr * ga[k][0];
    w.y -= lr * ga[k][1];
    w.z -= lr * ga[k][2];
    w.w -= lr * ga[k][3];
    *wa = w;
    if (hasb) {
      float4* wb = reinterpret_cast<float4*>(w1s + (c0 + k) * W + 4 * qb);
      w = *wb;
      w.x -= lr * gb[k][0];
      w.y -= lr * gb[k][1];
      w.z -= lr * gb[k][2];
      w.w -= lr * gb[k][3];
      *wb = w;
    }
  }
}

template <bool kRagged, int kHS, bool kTiled = false>
__global__ void __launch_bounds__(kThreads, 1)
local_sgd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 const int* __restrict__ y, const int* __restrict__ act,
                 const float* __restrict__ mask, const int* __restrict__ nbs,
                 const int* __restrict__ offs, const int* __restrict__ order,
                 float* __restrict__ out, int npad, int I, int H, int C, int B,
                 int epochs, float lr, Plan p) {
  static_assert(kHS == 8 || kHS == 16, "a slice is one or two 8-column groups");
  const int HS = kHS;
  constexpr int colg = kHS / kCols;  // 8-column groups
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, Bp = p.Bp, W = p.W, RB = p.RB;
  const int rank = (int)cluster.block_rank();
  const int r = order[blockIdx.x / K];
  const int tid = threadIdx.x;
  constexpr int nthr = kThreads;
  constexpr int nwarps = kWarps;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane >> 4, l16 = lane & 15;
  const int h0 = rank * HS;
  const int nreal = H - h0 < HS ? H - h0 : HS;  // the slice's model columns
  const int quads = I / 4;
  const int npairs = (quads + 1) / 2;
  const int utiles = npairs * colg;  // w1-update thread tiles
  const int MB = kTiled ? p.MB : Bp;  // staged mask and label rows a step
  const long long D = (long long)H + C + (long long)I * H + (long long)H * C;

  float* xs = smem + p.o_x;       // 2 slots of Bp x I (rows >= B stay zero)
  float* w1s = smem + p.o_w1;     // w1s[hl * W + i] = w1[i][h0 + hl]
  float* hpre = smem + p.o_hpre;  // B x HS
  float* hact = smem + p.o_hact;  // B x HS
  float* dh = smem + p.o_dh;      // B x HS (softmax-hidden clients)
  float* dhp = smem + p.o_dhp;    // B x HS, d hpre
  float* w2b = smem + p.o_w2;     // 2 x HS x C, rows h0.. of w2, by step parity
  float* b1s = smem + p.o_b1;     // HS
  float* b2s = smem + p.o_b2;     // C
  float* lg = smem + p.o_lg;      // B x C, logits then d logits
  float* red = smem + p.o_red;    // 2 x K x RB cluster partials, a slot a rank
  float* ms = smem + p.o_ms;      // 2 x MB staged mask rows
  int* ys = reinterpret_cast<int*>(smem + p.o_ys);        // 2 x MB labels
  float* gw2s = smem + p.o_gw2;   // tiled: HS x C, w2's gradient over the sub-tiles
  float* gb2s = smem + p.o_gb2;   // tiled: C
  float* gb1s = smem + p.o_gb1;   // tiled: HS
  int* s_next = reinterpret_cast<int*>(smem + p.o_misc);  // next live step
  float* cnts = smem + p.o_misc + 4;                      // 2 staged mask counts
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);

  const float* gb1 = g;
  const float* gb2 = g + H;
  const float* gw1 = g + H + C;
  const float* gw2 = gw1 + (long long)I * H;
  for (int k = tid; k < I * HS; k += nthr) {
    const int i = k / HS, hl = k % HS;
    w1s[hl * W + i] = hl < nreal ? gw1[(long long)i * H + h0 + hl] : 0.f;
  }
  for (int k = tid; k < HS * C; k += nthr)
    w2b[k] = k < nreal * C ? gw2[(long long)h0 * C + k] : 0.f;
  for (int k = tid; k < HS; k += nthr) b1s[k] = k < nreal ? gb1[h0 + k] : 0.f;
  for (int k = tid; k < C; k += nthr) b2s[k] = gb2[k];
  for (int k = B * I + tid; k < Bp * I; k += nthr) {
    xs[k] = 0.f;
    xs[Bp * I + k] = 0.f;
  }
  const bool soft = act[r] == 1;
  // the client's batch count and the sample row its batch 0 starts at
  const int nb = kRagged ? nbs[r] : npad / B;
  const long long first = kRagged ? (long long)offs[r] * B : (long long)r * npad;
  const int total = epochs * nb;
  const uint32_t tile_bytes = (uint32_t)B * I * 4;  // a whole batch's x tile
  // the bytes of the tiled plan's x tile whose first batch row is b
  auto sub_bytes = [&](int b) { return (uint32_t)(B - b < Bp ? B - b : Bp) * I * 4; };
  const bool stager = warp == 0;  // the forward's fastest warp (measured)
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (stager) {
    const int t0 = stage_next_live(mask, y, first, nb, B, 0, total, ms, ys, &cnts[0], lane);
    if (lane == 0) s_next[2] = t0;
  }
  cluster.sync();  // every barrier of the cluster initialised, params staged
  int t = s_next[2];
  if (tid == 0 && t < total)
    issue_tile(x + (first + (long long)(t % nb) * B) * I, xs, &bars[0],
               kTiled ? sub_bytes(0) : tile_bytes, rank, K);

  // the tiled plan: sub-tile `sub` of step t, the step's parity bpar (its
  // staged mask and labels, its w2 rows), and each update thread's w1
  // gradient over the step's sub-tiles (its one tile: utiles <= nthr)
  int use = 0, nred = 0, sub = 0, bpar = 0;
  float ua[kCols][4], ub[kCols][4];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) ua[k][e] = ub[k][e] = 0.f;
  while (t < total) {
    const int cur = use & 1, nxt = cur ^ 1;
    const int bp = kTiled ? bpar & 1 : cur;  // the step's parity
    const bool sfirst = !kTiled || sub == 0, slast = !kTiled || sub == p.nsub - 1;
    const int tb0 = kTiled ? sub * Bp : 0;                      // the sub-tile's first row
    const int bt = kTiled ? (B - tb0 < Bp ? B - tb0 : Bp) : B;  // and its rows
    const float* xt = xs + cur * Bp * I;
    // --- the next live batch's mask row and labels, read ahead by the
    // stager warp (in a step's first sub-tile): the first candidate's loads
    // are issued before the forward product and consumed after it
    float mv = 0.f;
    int yv = 0;
    if (stager && sfirst && t + 1 < total && B <= 32) {
      const long long rowc = first + (long long)((t + 1) % nb) * B;
      if (lane < B) {
        mv = mask[rowc + lane];
        yv = y[rowc + lane];
      }
    }
    mbar_wait(smem_addr(&bars[cur]), (use >> 1) & 1);
    // --- forward: a warp's tile is kRows batch rows x kCols hidden columns;
    // lane l sums the 4-row groups q = l, l + 32, ... of I, then the warp
    // reduce-scatters the 40 sums (rows past bt, zero or a previous
    // sub-tile's, are summed and dropped)
    const int ftiles =  // forward warp tiles
        (kTiled ? (bt + kRows - 1) / kRows : Bp / kRows) * colg;
    for (int tile = warp; tile < ftiles; tile += nwarps) {
      const int r0 = tile / colg * kRows, c0 = tile % colg * kCols;
      float acc[kRows * kCols];
#pragma unroll
      for (int j = 0; j < kRows * kCols; ++j) acc[j] = 0.f;
      for (int q = lane; q < quads; q += 32) {
        float4 xv[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) xv[j] = ld4(xt + (r0 + j) * I + 4 * q);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float4 w = ld4(w1s + (c0 + k) * W + 4 * q);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            float a = acc[j * kCols + k];
            a = fmaf(xv[j].x, w.x, a);
            a = fmaf(xv[j].y, w.y, a);
            a = fmaf(xv[j].z, w.z, a);
            acc[j * kCols + k] = fmaf(xv[j].w, w.w, a);
          }
        }
      }
      float lo, hi;
      reduce_tile(acc, lane, lo, hi);
      const int h = c0 + lane % kCols;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int b = r0 + (part ? kRows - 1 : lane / kCols);
        if (b < bt && (part == 0 || lane < kCols)) {
          const float hp = (part ? hi : lo) + b1s[h];
          hpre[b * HS + h] = hp;
          if (!soft) hact[b * HS + h] = fmaxf(hp, 0.f);
        }
      }
    }
    if (stager && sfirst) {
      const int np = bp ^ 1;  // the next step's parity
      int tn = total;
      if (t + 1 < total) {
        if (B <= 32) {
          float cnt = 0.f;
          for (int j = 0; j < B; ++j) cnt += __shfl_sync(0xffffffffu, mv, j);
          if (cnt > 0.f) {
            tn = t + 1;
            if (lane < B) {
              ms[np * MB + lane] = mv;
              ys[np * MB + lane] = yv;
            }
            if (lane == 0) cnts[np] = cnt;
          } else {
            tn = stage_next_live(mask, y, first, nb, B, t + 2, total, ms + np * MB,
                                 ys + np * MB, &cnts[np], lane);
          }
        } else {
          tn = stage_next_live(mask, y, first, nb, B, t + 1, total, ms + np * MB,
                               ys + np * MB, &cnts[np], lane);
        }
      }
      if (lane == 0) s_next[bp] = tn;
    }
    __syncthreads();
    const int tn = s_next[bp];
    const float* w2s = w2b + bp * HS * C;  // this step's w2 rows
    float* w2n = w2b + (bp ^ 1) * HS * C;  // the next step's
    // --- softmax hidden layer: each CTA's row max and exp-sum over its
    // slice's model columns; one barrier; then a half warp per row takes the
    // global max and sum over the K slices (rank order) and the row's h (0
    // in a pad column)
    if (soft) {
      float* buf = red + (nred & 1) * K * RB;
      for (int b = tid; b < bt; b += nthr) {
        const float* hp = hpre + b * HS;
        float m = -INFINITY;
#pragma unroll
        for (int hl = 0; hl < HS; ++hl)
          if (hl < nreal) m = fmaxf(m, hp[hl]);
        float sum = 0.f;
#pragma unroll
        for (int hl = 0; hl < HS; ++hl)
          if (hl < nreal) sum += expf(hp[hl] - m);
        push(cluster, buf, RB, rank, K, 2 * b, m);
        push(cluster, buf, RB, rank, K, 2 * b + 1, sum);
      }
      cluster.sync();
      for (int b = 2 * warp + half; b < bt; b += 2 * nwarps) {
        float m = -INFINITY;
        for (int rk = 0; rk < K; ++rk) m = fmaxf(m, buf[rk * RB + 2 * b]);
        float sum = 0.f;
        for (int rk = 0; rk < K; ++rk)
          sum += buf[rk * RB + 2 * b + 1] * expf(buf[rk * RB + 2 * b] - m);
        for (int hl = l16; hl < HS; hl += 16) {  // a lane a column
          const int k = b * HS + hl;
          hact[k] = hl < nreal ? expf(hpre[k] - m) / sum : 0.f;
        }
      }
      ++nred;
      __syncthreads();
    }
    // --- logits: each CTA's h_slice @ w2[slice] to every CTA, one barrier,
    // then a quarter warp per batch row sums the K slices in rank order,
    // adds b2 and turns the row into d logits = (softmax - onehot) * m /
    // max(cnt, 1), lane l holding classes l and l + 8 (C <= 16)
    {
      float* buf = red + (nred & 1) * K * RB;
      for (int k = tid; k < bt * C; k += nthr) {
        const int b = k / C, c = k % C;
        push(cluster, buf, RB, rank, K, k, dot4(hact + b * HS, 1, w2s + c, C, HS));
      }
      cluster.sync();
      // every CTA of the cluster has finished the previous sub-tile: the
      // other slot is free everywhere, so the next tile goes out now (the
      // step's next sub-tile, else the next live batch's first)
      const int tu = kTiled && !slast ? t : tn;
      const int bu = kTiled && !slast ? tb0 + Bp : 0;
      if (tid == nthr - 1 && tu < total)
        issue_tile(x + (first + (long long)(tu % nb) * B + bu) * I, xs + nxt * Bp * I,
                   &bars[nxt], kTiled ? sub_bytes(bu) : tile_bytes, rank, K);
      const float* mrow = ms + bp * MB + tb0;
      const int* yrow = ys + bp * MB + tb0;
      const float cnt = fmaxf(cnts[bp], 1.f);
      for (int b0 = 4 * warp; b0 < bt; b0 += 4 * nwarps) {
        const int b = b0 + (lane >> 3), l8 = lane & 7;
        float lv[2], e[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = l8 + 8 * j;
          lv[j] = b < bt && c < C ? gather_sum(buf, RB, K, b * C + c) + b2s[c] : -INFINITY;
        }
        const float mx = quarter_max(fmaxf(lv[0], lv[1]));
#pragma unroll
        for (int j = 0; j < 2; ++j) e[j] = b < bt && l8 + 8 * j < C ? expf(lv[j] - mx) : 0.f;
        const float sum = quarter_sum(e[0] + e[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = l8 + 8 * j;
          if (b < bt && c < C)
            lg[b * C + c] = (e[j] / sum - (c == yrow[b] ? 1.f : 0.f)) * (mrow[b] / cnt);
        }
      }
      ++nred;
    }
    __syncthreads();
    // --- dh[:, slice] = d logits @ w2[slice]^T, two columns a thread (a ReLU
    // hidden layer passes it where hpre > 0); beside it, on the threads
    // past those, the next step's w2[slice] = w2 - lr * h^T @ d logits and
    // b2 -= lr * sum_b d logits (b2 identical in every CTA).  The tiled
    // plan sums a gradient over the step's sub-tiles in sub-tile order,
    // each sub-tile's share as the narrow plan sums a step's, and its last
    // sub-tile applies it.
    {
      const int ndh = bt * HS / 2;
      const int spare0 = ndh < nthr ? ndh : 0;
      for (int k = tid; k < ndh; k += nthr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * k + e;
          const float acc = dot4(lg + j / HS * C, 1, w2s + j % HS * C, 1, C);
          if (soft) dh[j] = acc;
          else dhp[j] = hpre[j] > 0.f ? acc : 0.f;
        }
      }
      if (tid >= spare0) {
        for (int k = tid - spare0; k < HS * C + C; k += nthr - spare0) {
          if (k < HS * C) {
            const int hl = k / C, c = k % C;
            float gs = dot4(hact + hl, HS, lg + c, C, bt);
            if (!sfirst) gs = gw2s[k] + gs;
            if (slast) w2n[k] = w2s[k] - lr * gs;
            else gw2s[k] = gs;
          } else {
            const int c = k - HS * C;
            float gs = dot4(lg + c, C, nullptr, 0, bt);
            if (!sfirst) gs = gb2s[c] + gs;
            if (slast) b2s[c] -= lr * gs;
            else gb2s[c] = gs;
          }
        }
      }
    }
    __syncthreads();
    if (soft) {
      // softmax backward: the row dot sum(dh * h) over all H (the slices'
      // partials in rank order), then d hpre = h * (dh - dot)
      float* buf = red + (nred & 1) * K * RB;
      for (int b = tid; b < bt; b += nthr)
        push(cluster, buf, RB, rank, K, b, dot4(dh + b * HS, 1, hact + b * HS, 1, HS));
      cluster.sync();
      for (int b = 2 * warp + half; b < bt; b += 2 * nwarps) {
        const float dot = gather_sum(buf, RB, K, b);
        for (int hl = l16; hl < HS; hl += 16) {
          const int k = b * HS + hl;
          dhp[k] = hact[k] * (dh[k] - dot);
        }
      }
      ++nred;
      __syncthreads();
    }
    // --- w1[:, slice] -= lr * x^T @ d hpre and b1[slice] -= lr * sum_b d hpre
    if constexpr (kTiled) {
      // the narrow plan's tiles, each thread's w1 gradient in registers
      // and b1's in shared memory, summed over the step's sub-tiles; the
      // last sub-tile applies them
      int spare0 = (utiles + 31) / 32 * 32;
      if (spare0 >= nthr) spare0 = 0;
      if (tid >= spare0)
        for (int k = tid - spare0; k < HS; k += nthr - spare0) {
          float gs = dot4(dhp + k, HS, nullptr, 0, bt);
          if (!sfirst) gs = gb1s[k] + gs;
          if (slast) b1s[k] -= lr * gs;
          else gb1s[k] = gs;
        }
      if (tid < utiles) {
        const int c0 = tid / npairs * kCols, qa = tid % npairs, qb = qa + npairs;
        accumulate_tile(xt, I, dhp, HS, c0, qa, qb, qb < quads, bt, ua, ub);
        if (slast) {
          apply_tile(w1s, W, c0, qa, qb, qb < quads, lr, ua, ub);
#pragma unroll
          for (int k = 0; k < kCols; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) ua[k][e] = ub[k][e] = 0.f;
        }
      }
    } else {
      // a thread's tile is kCols columns x the 4-row groups q and q + npairs
      // of I; b1 on the whole warps past those tiles (no warp runs both)
      int spare0 = (utiles + 31) / 32 * 32;
      if (spare0 >= nthr) spare0 = 0;
      if (tid >= spare0)
        for (int k = tid - spare0; k < HS; k += nthr - spare0)
          b1s[k] -= lr * dot4(dhp + k, HS, nullptr, 0, B);
      for (int u = tid; u < utiles; u += nthr) {
        const int c0 = u / npairs * kCols, qa = u % npairs, qb = qa + npairs;
        float ga[kCols][4], gb[kCols][4];
#pragma unroll
        for (int k = 0; k < kCols; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) ga[k][e] = gb[k][e] = 0.f;
        accumulate_tile(xt, I, dhp, HS, c0, qa, qb, qb < quads, B, ga, gb);
        apply_tile(w1s, W, c0, qa, qb, qb < quads, lr, ga, gb);
      }
    }
    // the next step's forward reads w1 and b1 (written here by other
    // threads) only after the block barrier that follows it
    __syncthreads();
    ++use;
    if (slast) {
      t = tn;
      sub = 0;
      ++bpar;
    } else {
      ++sub;
    }
  }
  __syncthreads();
  float* orow = out + (long long)r * D;
  for (int k = tid; k < nreal; k += nthr) orow[h0 + k] = b1s[k];
  if (rank == 0)
    for (int k = tid; k < C; k += nthr) orow[H + k] = b2s[k];
  float* ow1 = orow + H + C;
  for (int k = tid; k < I * HS; k += nthr) {
    const int i = k / HS, hl = k % HS;
    if (hl < nreal) ow1[(long long)i * H + h0 + hl] = w1s[hl * W + i];
  }
  float* ow2 = ow1 + (long long)I * H;
  const float* w2s = w2b + ((kTiled ? bpar : use) & 1) * HS * C;
  for (int k = tid; k < nreal * C; k += nthr) ow2[(long long)h0 * C + k] = w2s[k];
  cluster.sync();  // no CTA leaves while a peer may still read its partials
}

// The plan's dynamic shared bytes and, for a cluster of more than 8 CTAs,
// permission to launch a non-portable cluster size.
template <typename Kernel>
cudaError_t set_attributes(Kernel kernel, const Plan& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err == cudaSuccess && p.K > kMaxPortable)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <bool kRagged, int kHS, bool kTiled = false>
int launch(const Plan& p, const float* g, const float* x, const int* y, const int* act,
           const float* mask, const int* nb, const int* off, const int* order, float* out,
           int R, int npad, int I, int H, int C, int B, int epochs, float lr, void* stream) {
  auto kernel = local_sgd_kernel<kRagged, kHS, kTiled>;
  cudaError_t err = set_attributes(kernel, p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * p.K));
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g, x, y, act, mask, nb, off, order, out, npad, I, H,
                           C, B, epochs, lr, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers and spilled bytes a thread of the dense instance, and how many
// clusters of the plan's K CTAs fit on the card at once.
template <int kHS, bool kTiled = false>
int attrs(const Plan& p, int* regs, int* local_bytes, int* max_clusters) {
  auto kernel = local_sgd_kernel<false, kHS, kTiled>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  err = set_attributes(kernel, p);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.K);
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
}


// ------------------------------------------------------------------------
// The general instance: every shape the other three refuse -- any class
// count, any input width, H past 1,024, batches past 20 at H past 256 and
// what the tiled plan cannot fit -- so, with them, every shape of the
// reference's envelope (repro/kernels/local_sgd.py:57 fused_fits_vmem).
// Simple before fast: one cluster of K <= 8 CTAs a
// client (K = ceil(H / 64) up to H = 512, else 8), CTA `rank` owning the
// model columns [h0, h0 + nreal) of the hidden layer, with no pad column.
// A step is five block-wide products (x w1, h w2, dl w2^T, h^T dl, x^T
// dhp), each a tiled loop over global memory (`block_gemm`); the batch goes
// through in sub-tiles of BT <= 64 rows, their w1, w2, b1, b2 gradients
// summed before one update, so x is never held whole.  The client's output
// row is the parameters' working copy, read and written in place as in the
// wide instance.  Per-row temporaries (hpre, h, dh: BT x HS a CTA; the
// logits' K shares and d logits: BT x C) and the summed gradients live in
// the cluster's slot of a workspace in global memory, one slot for each
// cluster of the grid; the grid is as many clusters as fit on the card at
// once, each walking clients order[c], order[c + G], ....  What crosses the
// slices (a row's logits, the softmax hidden layer's row max and sum and
// its backward dot) goes through the slot, the cluster barrier between
// writer and reader.  Every sum runs in an order fixed by the shapes, so
// rows do not depend on the client order and the ragged form's rows are
// the dense form's.  What bounds it: a product's 32-term chunk loop, at 8
// warps an SM, waits on shared-memory reads, and each phase on an L2 round
// trip or a cluster barrier (PERF.md section 6 has its times).

constexpr int kTM = 64, kTN = 64, kTK = 32;  // a product's output tile, k chunk
constexpr int kLoads = kTM * kTK / kThreads;  // elements of a chunk a thread loads
constexpr int kLD = kTM + 4;                 // smem row pitch (16-byte rows)
constexpr int kGemmFloats = 2 * kTK * kLD;   // a chunk of A and of B
constexpr int kGeneralSlice = 64;            // columns a CTA up to H = 512
constexpr int kMaxRows = 64;                 // batch rows of a sub-tile
constexpr long long kRowFloats = 1 << 17;    // K x rows x max(C, HS) at most
constexpr long long kMaxSlotFloats = (1ll << 31) - 1;

// The general instance's plan: cluster size, slice width, batch rows a
// sub-tile (BT) and sub-tiles a batch, and the layout of one cluster's
// workspace slot in floats (offsets multiples of 4).  A function of the
// shapes only.
struct GPlan {
  int K, HS, BT, nsub;
  long long o_lpart, o_dl, o_stat, o_dot, o_gb2, o_cta, cta;  // a slot
  long long c_hpre, c_hact, c_dh, c_gw1, c_gw2, c_gb1;        // a CTA's region
  long long slot;                                              // 0: refused
  int bytes;                                                   // dynamic smem
};

inline long long up4ll(long long v) { return (v + 3) & ~3ll; }

GPlan make_general_plan(int I, int H, int C, int B) {
  GPlan p{};
  if (I < 1 || H < 1 || C < 1 || B < 1) return p;
  if (H <= kMaxPortable * kGeneralSlice) {
    p.HS = H < kGeneralSlice ? H : kGeneralSlice;
  } else {
    p.HS = (H + kMaxPortable - 1) / kMaxPortable;
  }
  p.K = (H + p.HS - 1) / p.HS;
  const long long wide = (long long)p.K * (C > p.HS ? C : p.HS);
  long long bt = kRowFloats / wide;
  if (bt < 1) bt = 1;
  if (bt > kMaxRows) bt = kMaxRows;
  if (bt > B) bt = B;
  p.BT = (int)bt;
  p.nsub = (B + p.BT - 1) / p.BT;
  const bool acc = p.nsub > 1;  // gradients summed over sub-tiles
  long long off = 0;
  auto take = [&off](long long n) {
    const long long o = off;
    off += up4ll(n);
    return o;
  };
  p.o_lpart = take((long long)p.K * p.BT * C);
  p.o_dl = take((long long)p.BT * C);
  p.o_stat = take(2ll * p.K * p.BT);
  p.o_dot = take((long long)p.K * p.BT);
  p.o_gb2 = take(acc ? C : 0);
  p.o_cta = off;
  long long c = 0;
  auto tk = [&c](long long n) {
    const long long o = c;
    c += up4ll(n);
    return o;
  };
  p.c_hpre = tk((long long)p.BT * p.HS);
  p.c_hact = tk((long long)p.BT * p.HS);
  p.c_dh = tk((long long)p.BT * p.HS);
  p.c_gw1 = tk(acc ? (long long)I * p.HS : 0);
  p.c_gw2 = tk(acc ? (long long)p.HS * C : 0);
  p.c_gb1 = tk(acc ? p.HS : 0);
  p.cta = c;
  p.slot = off + p.K * c;
  const long long D = (long long)H + C + (long long)I * H + (long long)H * C;
  if (p.slot > kMaxSlotFloats || D > kMaxSlotFloats) {
    p.K = 0;
    p.slot = 0;
  }
  p.bytes = (kGemmFloats + 4) * 4;  // the ring of chunks, the mask counts
  return p;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A butterfly: every lane ends with the same sum (each pair adds the same
// two values).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The general instance's loads and stores of the workspace and the output
// row: L2 only (ld / st.global.cg), since other CTAs of the cluster read
// and write them; volatile, so they keep their order among themselves and
// around the barriers, but no "memory" clobber (unlike __stcg), so a store
// does not hold back the loads that follow it.
__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_l2(float* p, float v) {
  asm volatile("st.global.cg.f32 [%0], %1;" ::"l"(p), "f"(v));
}

// One thread's share of a product's next chunk: elements e = tid + 256 j
// (j < 8) of the 64 x 32 A chunk and the 32 x 64 B chunk at (m0, n0, k0),
// 0 past the edges, into registers.  A chunk's threads walk the operand's
// contiguous axis, so neighbouring lanes read neighbouring addresses.
template <bool kAk, bool kBk>
__device__ __forceinline__ void gemm_load(const float* A, long long sa, const float* Bm,
                                          long long sb, int M, int N, int Kd, int m0, int n0,
                                          int k0, float (&ra)[kLoads], float (&rb)[kLoads]) {
  constexpr int dm = kThreads / kTK, dk = kThreads / kTM;  // rows, terms a j
  const int tid = threadIdx.x;
  // A(m, k): kAk: m = tid / 32 + 8 j, k = tid % 32; else m = tid % 64,
  // k = tid / 64 + 4 j
  const int am = m0 + (kAk ? tid / kTK : tid % kTM), ak = k0 + (kAk ? tid % kTK : tid / kTM);
  const int bn = n0 + (kBk ? tid / kTK : tid % kTN), bk = k0 + (kBk ? tid % kTK : tid / kTN);
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int m = kAk ? am + dm * j : am, k = kAk ? ak : ak + dk * j;
    ra[j] = m < M && k < Kd ? ld_l2(A + (kAk ? (long long)m * sa + k : (long long)k * sa + m))
                            : 0.f;
    const int n = kBk ? bn + dm * j : bn, kb = kBk ? bk : bk + dk * j;
    rb[j] = n < N && kb < Kd ? ld_l2(Bm + (kBk ? (long long)n * sb + kb : (long long)kb * sb + n))
                             : 0.f;
  }
}

// One block's C = A @ B over M x N outputs and Kd terms.  A(m, k) = A[m *
// sa + k] when kAk (rows along k), else A[k * sa + m]; B(k, n) = B[n * sb +
// k] when kBk, else B[k * sb + n].  Operands are read from L2, in 64 x 64
// output tiles and 32-term chunks through shared memory, the next chunk's
// loads in flight during this one's FMAs; a thread owns 4 x 4 outputs and
// sums its terms in k order, so every output's rounding depends on the
// shapes alone.  Each output is finished in two passes over the thread's
// 16: pre(m, n) loads what the output needs (a float2), then post(m, n,
// sum, pre) stores it, so the loads of a read-modify-write overlap.  Ends
// on a block barrier.
template <bool kAk, bool kBk, typename Pre, typename Post>
__device__ __forceinline__ void block_gemm(const float* A, long long sa, const float* Bm,
                                           long long sb, int M, int N, int Kd, float* sm,
                                           Pre pre, Post post) {
  // opaque to the compiler: the address arithmetic stays in each product
  // instead of being hoisted out of the chain's loop for all five at once
  asm volatile("" : "+l"(A), "+l"(Bm));
  float* As = sm;              // As[k * kLD + m]
  float* Bs = sm + kTK * kLD;  // Bs[k * kLD + n]
  constexpr int dm = kThreads / kTK, dk = kThreads / kTM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // where this thread's loaded elements go in the chunk
  const int sam = kAk ? tid / kTK : tid % kTM, sak = kAk ? tid % kTK : tid / kTM;
  const int sbn = kBk ? tid / kTK : tid % kTN, sbk = kBk ? tid % kTK : tid / kTN;
  for (int tm = 0; tm < M; tm += kTM)
    for (int tn = 0; tn < N; tn += kTN) {
      int m0 = tm, n0 = tn;
      asm volatile("" : "+r"(m0), "+r"(n0));  // nothing of a tile is hoisted
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      float ra[kLoads], rb[kLoads];
      gemm_load<kAk, kBk>(A, sa, Bm, sb, M, N, Kd, m0, n0, 0, ra, rb);
      for (int k0 = 0; k0 < Kd; k0 += kTK) {
        __syncthreads();  // the previous chunk's readers are done
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          As[(kAk ? sak : sak + dk * j) * kLD + (kAk ? sam + dm * j : sam)] = ra[j];
          Bs[(kBk ? sbk : sbk + dk * j) * kLD + (kBk ? sbn + dm * j : sbn)] = rb[j];
        }
        __syncthreads();
        if (k0 + kTK < Kd) gemm_load<kAk, kBk>(A, sa, Bm, sb, M, N, Kd, m0, n0, k0 + kTK, ra, rb);
#pragma unroll
        for (int k = 0; k < kTK; ++k) {
          const float4 a = ld4(As + k * kLD + 4 * ty);
          const float4 b = ld4(Bs + k * kLD + 4 * tx);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      float2 pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + 4 * ty + i, n = n0 + 4 * tx + j;
          pv[i][j] = m < M && n < N ? pre(m, n) : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + 4 * ty + i, n = n0 + 4 * tx + j;
          if (m < M && n < N) post(m, n, acc[i][j], pv[i][j]);
        }
    }
  __syncthreads();
}

// Nothing to load before an output's store.
struct NoPre {
  __device__ float2 operator()(int, int) const { return make_float2(0.f, 0.f); }
};

// The row helpers below take a row's n values at lane, lane + 32, ... in
// groups of four loads in flight, since an L2 round trip, not the
// arithmetic, is what a warp waits for.

// out[h] = f(h, a[h], b[h]) (b = nullptr: 0), every load of a group before
// its stores (out may be a or b).
template <typename F>
__device__ __forceinline__ void map_row(const float* a, const float* b, float* out, int n,
                                        int lane, F f) {
  for (int h0 = lane; h0 < n; h0 += 128) {
    float va[4], vb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = h0 + 32 * q;
      va[q] = h < n ? ld_l2(a + h) : 0.f;
      vb[q] = h < n && b ? ld_l2(b + h) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (h0 + 32 * q < n) st_l2(out + h0 + 32 * q, f(h0 + 32 * q, va[q], vb[q]));
  }
}

// acc = f(acc, a[h], b[h]) over the lane's h in order (b = nullptr: 0).
template <typename F>
__device__ __forceinline__ float fold_row(const float* a, const float* b, int n, int lane,
                                          float acc, F f) {
  for (int h0 = lane; h0 < n; h0 += 128) {
    float va[4], vb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int h = h0 + 32 * q;
      va[q] = h < n ? ld_l2(a + h) : 0.f;
      vb[q] = h < n && b ? ld_l2(b + h) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (h0 + 32 * q < n) acc = f(acc, va[q], vb[q]);
  }
  return acc;
}

// sum over m < n of p[m * stride], in m order, eight loads in flight.
__device__ __forceinline__ float sum_col(const float* p, long long stride, int n) {
  float s = 0.f;
  for (int m0 = 0; m0 < n; m0 += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = m0 + q < n ? ld_l2(p + (m0 + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (m0 + q < n) s += v[q];
  }
  return s;
}

// The K (<= 8) ranks' values p[k * stride], all loads in flight at once.
__device__ __forceinline__ void load_ranks(const float* p, long long stride, int K,
                                           float (&v)[kMaxPortable]) {
#pragma unroll
  for (int k = 0; k < kMaxPortable; ++k) v[k] = k < K ? ld_l2(p + k * stride) : 0.f;
}

// A sum over a batch's sub-tiles: the first sub-tile starts it from 0.
__device__ __forceinline__ float carried(const float* acc, long long k, bool first) {
  return first ? 0.f : ld_l2(acc + k);
}

template <bool kRagged>
__global__ void __launch_bounds__(kThreads, 1)
local_sgd_general_kernel(const float* __restrict__ g, const float* __restrict__ x,
                         const int* __restrict__ y, const int* __restrict__ act,
                         const float* __restrict__ mask, const int* __restrict__ nbs,
                         const int* __restrict__ offs, const int* __restrict__ order,
                         float* __restrict__ out, float* __restrict__ ws, int R, int npad,
                         int I, int H, int C, int B, int epochs, float lr, GPlan p) {
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, HS = p.HS, BT = p.BT;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = rank * HS;
  const int nreal = H - h0 < HS ? H - h0 : HS;
  const long long D = (long long)H + C + (long long)I * H + (long long)H * C;
  const int nclusters = gridDim.x / K;
  float* const slot0 = ws + (long long)(blockIdx.x / K) * p.slot;
  float* gsm = smem;
  float* s_cnt = smem + kGemmFloats;  // the batch's mask count, by step parity

  for (int cl = blockIdx.x / K; cl < R; cl += nclusters) {
    const int r = order[cl];
    float* const orow0 = out + (long long)r * D;
    // the client's parameters start as the global row (b2's classes on
    // their owner ranks)
    {
      float* ob1 = orow0 + h0;
      float* ob2 = orow0 + H;
      float* ow1 = orow0 + H + C + h0;
      float* ow2 = orow0 + H + C + (long long)I * H + (long long)h0 * C;
      const float* src1 = g + H + C + h0;
      const float* src2 = g + H + C + (long long)I * H + (long long)h0 * C;
      for (long long k = tid; k < (long long)I * nreal; k += kThreads) {
        const long long i = k / nreal, hl = k % nreal;
        ow1[i * H + hl] = src1[i * H + hl];
      }
      for (long long k = tid; k < (long long)nreal * C; k += kThreads) ow2[k] = src2[k];
      for (int k = tid; k < nreal; k += kThreads) ob1[k] = g[h0 + k];
      for (int c = rank + K * tid; c < C; c += K * kThreads) ob2[c] = g[H + c];
    }
    const bool soft = act[r] == 1;
    const int nb = kRagged ? nbs[r] : npad / B;
    const long long first = kRagged ? (long long)offs[r] * B : (long long)r * npad;
    const int total = epochs * nb;
    cluster.sync();  // b2 in place before any rank reads it

    for (int t = 0; t < total; ++t) {
      const long long row0 = first + (long long)(t % nb) * B;
      if (warp == 0) {
        const float c = batch_count(mask, row0, B, lane);
        if (lane == 0) s_cnt[t & 1] = c;
      }
      __syncthreads();
      const float cnt = s_cnt[t & 1];
      if (!(cnt > 0.f)) continue;  // every rank skips the same batches
      const float cntc = fmaxf(cnt, 1.f);
      for (int s = 0; s < p.nsub; ++s) {
        const int b0 = s * BT, bt = B - b0 < BT ? B - b0 : BT;
        const bool sfirst = s == 0, slast = s == p.nsub - 1;
        const float* xs = x + (row0 + b0) * I;
        // the slot's and the output row's pointers, made anew each sub-tile
        // (opaque to the compiler: not hoisted out of the chain's loop, where
        // they would hold registers the products need)
        float* slot = slot0;
        float* orow = orow0;
        asm volatile("" : "+l"(slot), "+l"(orow));
        float* lpart = slot + p.o_lpart;  // K x BT x C logits' shares, a slice each
        float* dl = slot + p.o_dl;        // BT x C: logits, then d logits
        float* stat = slot + p.o_stat;    // K x BT x 2: a slice's row max and exp-sum
        float* dotp = slot + p.o_dot;     // K x BT: a slice's row sum(dh * h)
        float* gb2 = slot + p.o_gb2;      // C: b2's gradient, class c summed by rank c % K
        float* mine = slot + p.o_cta + rank * p.cta;
        float* hpre = mine + p.c_hpre;  // BT x HS
        float* hact = mine + p.c_hact;  // BT x HS
        float* dh = mine + p.c_dh;      // BT x HS: dh, then d hpre
        float* gw1 = mine + p.c_gw1;    // I x HS, the sub-tiles' w1 gradient
        float* gw2 = mine + p.c_gw2;    // HS x C
        float* gb1 = mine + p.c_gb1;    // HS
        float* ob1 = orow + h0;
        float* ob2 = orow + H;
        float* ow1 = orow + H + C + h0;  // w1[i][h0 + h] at ow1[i * H + h]
        float* ow2 = orow + H + C + (long long)I * H + (long long)h0 * C;
        // --- hpre = x @ w1[:, slice] + b1 (ReLU: h beside it)
        block_gemm<true, false>(
            xs, I, ow1, H, bt, nreal, I, gsm,
            [&](int, int n) { return make_float2(ld_l2(ob1 + n), 0.f); },
            [&](int m, int n, float a, float2 v) {
              const float hp = a + v.x;
              st_l2(hpre + m * HS + n, hp);
              if (!soft) st_l2(hact + m * HS + n, fmaxf(hp, 0.f));
            });
        // --- softmax hidden layer: each slice's row max and exp-sum, one
        // barrier, then every rank combines the K slices in rank order
        if (soft) {
          for (int m = warp; m < bt; m += kWarps) {
            const float* hp = hpre + m * HS;
            const float mx = warp_max(fold_row(hp, nullptr, nreal, lane, -INFINITY,
                                               [](float a, float v, float) { return fmaxf(a, v); }));
            const float sum = warp_sum(fold_row(hp, nullptr, nreal, lane, 0.f,
                                                [&](float a, float v, float) {
                                                  return a + expf(v - mx);
                                                }));
            if (lane == 0) {
              st_l2(stat + 2 * ((long long)rank * BT + m), mx);
              st_l2(stat + 2 * ((long long)rank * BT + m) + 1, sum);
            }
          }
          cluster.sync();
          for (int m = warp; m < bt; m += kWarps) {
            float ms[kMaxPortable], ss[kMaxPortable];
            load_ranks(stat + 2 * m, 2ll * BT, K, ms);
            load_ranks(stat + 2 * m + 1, 2ll * BT, K, ss);
            float mx = -INFINITY;
#pragma unroll
            for (int k = 0; k < kMaxPortable; ++k)
              if (k < K) mx = fmaxf(mx, ms[k]);
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < kMaxPortable; ++k)
              if (k < K) sum += ss[k] * expf(ms[k] - mx);
            map_row(hpre + m * HS, nullptr, hact + m * HS, nreal, lane,
                    [&](int, float v, float) { return expf(v - mx) / sum; });
          }
          __syncthreads();
        }
        // --- this slice's share of the logits, h @ w2[slice], to the slot;
        // one barrier; then each rank's rows (m = rank mod K, a warp a row)
        // sum the K shares in rank order, add b2 and become d logits =
        // (softmax - onehot) * m / max(cnt, 1)
        block_gemm<true, false>(hact, HS, ow2, C, bt, C, nreal, gsm, NoPre(),
                                [&](int m, int n, float a, float2) {
                                  st_l2(lpart + ((long long)rank * BT + m) * C + n, a);
                                });
        cluster.sync();
        for (int m = rank + K * warp; m < bt; m += K * kWarps) {
          const long long row = row0 + b0 + m;
          const float sc = mask[row] / cntc;
          const int yb = y[row];
          float* lrow = dl + (long long)m * C;
          float mx = -INFINITY;
          for (int c = lane; c < C; c += 32) {
            float v[kMaxPortable];
            load_ranks(lpart + (long long)m * C + c, (long long)BT * C, K, v);
            float l = v[0];
#pragma unroll
            for (int k = 1; k < kMaxPortable; ++k)
              if (k < K) l += v[k];
            l += ld_l2(ob2 + c);
            st_l2(lrow + c, l);
            mx = fmaxf(mx, l);
          }
          mx = warp_max(mx);
          const float sum = warp_sum(fold_row(lrow, nullptr, C, lane, 0.f,
                                              [&](float a, float l, float) {
                                                return a + expf(l - mx);
                                              }));
          map_row(lrow, nullptr, lrow, C, lane, [&](int c, float l, float) {
            return (expf(l - mx) / sum - (c == yb ? 1.f : 0.f)) * sc;
          });
        }
        cluster.sync();
        // --- dh[:, slice] = d logits @ w2[slice]^T (ReLU: d hpre, 0 where
        // hpre <= 0)
        block_gemm<true, true>(
            dl, C, ow2, C, bt, nreal, C, gsm,
            [&](int m, int n) {
              return make_float2(soft ? 1.f : ld_l2(hpre + m * HS + n), 0.f);
            },
            [&](int m, int n, float a, float2 v) {
              st_l2(dh + m * HS + n, v.x > 0.f ? a : 0.f);
            });
        // --- w2[slice] -= lr * h^T @ d logits, summed over the sub-tiles
        block_gemm<false, false>(
            hact, HS, dl, C, nreal, C, bt, gsm,
            [&](int m, int n) {
              const long long k = (long long)m * C + n;
              return make_float2(carried(gw2, k, sfirst), slast ? ld_l2(ow2 + k) : 0.f);
            },
            [&](int m, int n, float a, float2 v) {
              const long long k = (long long)m * C + n;
              if (slast) st_l2(ow2 + k, v.y - lr * (v.x + a));
              else st_l2(gw2 + k, v.x + a);
            });
        // b2 -= lr * sum_b d logits, class c on rank c % K
        for (int c = rank + K * tid; c < C; c += K * kThreads) {
          const float gsum = carried(gb2, c, sfirst) + sum_col(dl + c, C, bt);
          if (slast) st_l2(ob2 + c, ld_l2(ob2 + c) - lr * gsum);
          else st_l2(gb2 + c, gsum);
        }
        // --- softmax backward: the row sum(dh * h) over all H (the slices'
        // shares in rank order), then d hpre = h * (dh - dot)
        if (soft) {
          for (int m = warp; m < bt; m += kWarps) {
            const float d = warp_sum(fold_row(dh + m * HS, hact + m * HS, nreal, lane, 0.f,
                                              [](float a, float u, float v) { return a + u * v; }));
            if (lane == 0) st_l2(dotp + (long long)rank * BT + m, d);
          }
          cluster.sync();
          for (int m = warp; m < bt; m += kWarps) {
            float v[kMaxPortable];
            load_ranks(dotp + m, BT, K, v);
            float dot = 0.f;
#pragma unroll
            for (int k = 0; k < kMaxPortable; ++k)
              if (k < K) dot += v[k];
            map_row(dh + m * HS, hact + m * HS, dh + m * HS, nreal, lane,
                    [&](int, float u, float h) { return h * (u - dot); });
          }
          __syncthreads();
        }
        // --- w1[:, slice] -= lr * x^T @ d hpre and b1 -= lr * sum_b d hpre,
        // summed over the sub-tiles
        block_gemm<false, false>(
            xs, I, dh, HS, I, nreal, bt, gsm,
            [&](int m, int n) {
              return make_float2(carried(gw1, (long long)m * HS + n, sfirst),
                                 slast ? ld_l2(ow1 + (long long)m * H + n) : 0.f);
            },
            [&](int m, int n, float a, float2 v) {
              if (slast) st_l2(ow1 + (long long)m * H + n, v.y - lr * (v.x + a));
              else st_l2(gw1 + (long long)m * HS + n, v.x + a);
            });
        for (int h = tid; h < nreal; h += kThreads) {
          const float gsum = carried(gb1, h, sfirst) + sum_col(dh + h, HS, bt);
          if (slast) st_l2(ob1 + h, ld_l2(ob1 + h) - lr * gsum);
          else st_l2(gb1 + h, gsum);
        }
        __syncthreads();  // the next sub-tile overwrites hpre, hact, dh
      }
    }
    // the next client's first writes to the slot follow its first barrier,
    // which every rank reaches only after this client's last reads
  }
}

template <bool kRagged>
int launch_general(const GPlan& p, const float* g, const float* x, const int* y,
                   const int* act, const float* mask, const int* nb, const int* off,
                   const int* order, float* out, float* ws, int nclusters, int R, int npad,
                   int I, int H, int C, int B, int epochs, float lr, void* stream) {
  auto kernel = local_sgd_general_kernel<kRagged>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nclusters * p.K));
  cfg.blockDim = dim3((unsigned)kThreads);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g, x, y, act, mask, nb, off, order, out, ws, R, npad,
                           I, H, C, B, epochs, lr, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------------
// The wide instance (257 <= H <= 1,024; the header's notes give the design
// and what it is for): one cluster of K <= 8 CTAs a client, CTA `rank`
// owning the slice [rank * HS, rank * HS + HS) of the hidden layer, HS = 64
// or 128; w1 in place in the client's output row, streamed through a ring
// of row chunks in shared memory once a step.

constexpr int kWideThreads = 256;                // 8 warps: two on each SM sub-partition
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kRoleWarps = kWideWarps / 2;       // 4 update warps, then 4 forward warps
constexpr int kBlockCols = 32;                   // a warp's block of columns in a pass
constexpr int kTileFloats = kRoleWarps * 32 * 16;  // a role's 4 x 4 tiles: one quad a row lane
constexpr int kMaxRing = 4;                      // ring slots at most
constexpr int kMaxWideC = 16;

// The wide instance's plan: K, HS, ring slots NS and chunks a pass, and
// one CTA's shared-memory layout in floats (offsets multiples of 4).
struct WPlan {
  int K, HS, NS, QT, nch, RB;
  int o_x, o_part, o_hpre, o_hact, o_dpp, o_w2, o_b1, o_b2, o_lg, o_red, o_ms, o_ys, o_misc,
      o_bar, o_ring, bytes;
};

// The narrowest slice of 64 or 128 columns whose cluster is portable (K =
// ceil(H / HS) <= 8: 64 up to H = 512, else 128); chunks of QT = 2 quads a
// row lane (16 KB), else 1, and as many ring slots (3-4) as the shared
// bytes leave; K = 0 for a shape it does not take.  A function of the
// shapes only.
WPlan wide_plan(int I, int H, int C, int B) {
  WPlan p{};
  if (!bulk_shapes(I, H, C, B) || H <= 256 || H > 1024 || B > kBT) return p;
  p.HS = (H + 63) / 64 <= kMaxPortable ? 64 : 128;
  p.K = (H + p.HS - 1) / p.HS;
  const int nwr = kRoleWarps / (p.HS / kBlockCols);  // a role's warps on a column
  p.RB = up4(kBT * C > 2 * kBT ? kBT * C : 2 * kBT);
  int off = 0;
  auto take = [&off](int n) {
    int o = off;
    off += up4(n);
    return o;
  };
  p.o_x = take(2 * kBT * I);
  p.o_part = take((nwr - 1) * kBT * p.HS);
  p.o_hpre = take(kBT * p.HS);
  p.o_hact = take(kBT * p.HS);
  p.o_dpp = take(kBT * p.HS);
  p.o_w2 = take(p.HS * C);
  p.o_b1 = take(p.HS);
  p.o_b2 = take(C);
  p.o_lg = take(kBT * C);
  p.o_red = take(2 * p.K * p.RB);
  p.o_ms = take(2 * kBT);
  p.o_ys = take(2 * kBT);
  p.o_misc = take(8);
  p.o_bar = take(4);  // two 8-byte barriers
  p.o_ring = off;
  for (p.QT = 2; p.QT >= 1; --p.QT) {
    p.NS = (kMaxSmemBytes / 4 - off) / (p.QT * kTileFloats);
    if (p.NS > kMaxRing) p.NS = kMaxRing;
    if (p.NS >= 3) break;
  }
  if (p.QT < 1) {
    p.K = 0;
    return p;
  }
  p.nch = (I / 4 + 4 * nwr * p.QT - 1) / (4 * nwr * p.QT);
  p.bytes = (off + p.NS * p.QT * kTileFloats) * 4;
  return p;
}

// A slice column's position in a ring row and in dpp: the 32 columns of a
// warp's block laid out so that a lane's four (tcg, tcg + 8, + 16, + 24)
// are one float4.
__device__ __forceinline__ int wpos(int hl) {
  return (hl & ~31) | ((hl & 7) << 2) | ((hl >> 3) & 3);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// The whole block at the pass's barrier (named barrier 1: the two roles
// reach it from their own loops).
__device__ __forceinline__ void bar_all() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWideThreads) : "memory");
}

// The slice's w1 rows of chunk c (w1o: the slice's column 0 of w1's row 0
// in the output row, row stride H) to or from a ring slot, a column at wpos
// in a row of kHS floats: 8 elements a thread a quad of the chunk (qt), its
// column fixed and its row stepping by kWideThreads / kHS, a warp on
// neighbouring columns of a row; only rows before I and the slice's model
// columns.  `kIn`: 4-byte cp.async copies in (the row is not 16-byte
// aligned for general H), zero elsewhere; else stores out.  Copies in and
// out use one thread mapping, so a thread's copy out of a slot comes before
// its copy into it in program order.
template <int kHS, bool kIn>
__device__ __forceinline__ void ring_copy(float* slot, float* w1o, long long H, int c, int qt,
                                          int I, int nreal) {
  constexpr int kStep = kWideThreads / kHS, kPer = kTileFloats / kWideThreads;
  const int rows = kTileFloats / kHS * qt;  // rows of a chunk
  const int col = threadIdx.x & (kHS - 1), rr = threadIdx.x / kHS;
  const int i0 = rows * c + rr;
  float* sp = slot + rr * kHS + wpos(col);
  float* gp = w1o + (long long)i0 * H + col;
  const bool live = col < nreal, whole = rows * (c + 1) <= I;
  for (int m0 = 0; m0 < kPer * qt; m0 += kPer) {
#pragma unroll
    for (int m = m0; m < m0 + kPer; ++m) {
      const bool valid = live && (whole || i0 + kStep * m < I);
      if constexpr (kIn) cp_async4(sp + kStep * kHS * m, valid ? gp : w1o, valid);
      else if (valid) *gp = sp[kStep * kHS * m];
      gp += kStep * H;
    }
  }
}

// Chunk c's ring slot (NS is 3 or 4).
__device__ __forceinline__ int slot_of(int c, int NS) { return NS == 4 ? c & 3 : c % 3; }

// The ring's state in a pass: slots, chunks, the slice's w1 in the output
// row, and whether chunks go back (an update pass).
struct Ring {
  float* slots;
  float* w1o;
  long long H;
  int NS, QT, nch, I, nreal;
  bool back;
  __device__ float* slot(int c) const { return slots + slot_of(c, NS) * QT * kTileFloats; }
};

// Ring chunks 0 .. NS - 3 of the next pass (its w1 rows written before the
// last barrier), a cp.async group each.
template <int kHS>
__device__ __forceinline__ void prefetch_ring(const Ring& g) {
  for (int c = 0; c < g.NS - 2; ++c) {
    if (c < g.nch) ring_copy<kHS, true>(g.slot(c), g.w1o, g.H, c, g.QT, g.I, g.nreal);
    cp_commit();
  }
}

// Turn s of a pass, every thread: chunk s has landed (at most NS - 3
// groups in flight) and every thread has left turn s - 1 (the barrier);
// chunk s - 2, which no role reads any more, goes back to the output row
// (an update pass) and chunk s + NS - 2 comes into its slot.
template <int kHS>
__device__ __forceinline__ void ring_turn(const Ring& g, int s) {
  if (g.NS >= 4) asm volatile("cp.async.wait_group 1;" ::: "memory");
  else asm volatile("cp.async.wait_group 0;" ::: "memory");
  bar_all();
  const int co = s - 2, ci = s + g.NS - 2;
  if (g.back && co >= 0 && co < g.nch)
    ring_copy<kHS, false>(g.slot(co), g.w1o, g.H, co, g.QT, g.I, g.nreal);
  if (ci < g.nch) ring_copy<kHS, true>(g.slot(ci), g.w1o, g.H, ci, g.QT, g.I, g.nreal);
  cp_commit();
}

// After a pass's `turns` turns: one barrier, then the chunks not yet back.
template <int kHS>
__device__ __forceinline__ void ring_tail(const Ring& g, int turns) {
  bar_all();
  if (g.back)
    for (int c = turns - 2 > 0 ? turns - 2 : 0; c < g.nch; ++c)
      ring_copy<kHS, false>(g.slot(c), g.w1o, g.H, c, g.QT, g.I, g.nreal);
}

// A role's 4 x 4 tile: warp rw (0-3 within the role) takes the column block
// cb = rw % (HS / 32) and row lanes 4 (rw / (HS / 32)) .. + 3 (lane bits
// 3-4), lane bits 0-2 the columns tcg + 8 k (k < 4) of the block; in chunk
// c a row lane takes quads q = (c QT + u) nrl + rl of I (u < QT), rows 4 (u
// nrl + rl) .. + 3 of the slot: a lane's quads in increasing order.
template <int kHS>
struct Tile {
  static constexpr int ncb = kHS / kBlockCols, nwr = kRoleWarps / ncb, nrl = 4 * nwr;
  int rl, tp;
  __device__ Tile(int rw, int lane)
      : rl(4 * (rw / ncb) + (lane >> 3)), tp(kBlockCols * (rw % ncb) + 4 * (lane & 7)) {}
};

// The update role's pass (`upd`; else it only turns the ring): each weight
// of its tile becomes w - lr * sum_b xu[b][i] d[b][h] (b in order; d hpre of
// the tile's columns held in registers for the pass), back into its slot
// in turn c; the forward role reads it in turn c + lag.  Each float4 of x
// read from shared memory feeds 16 FMAs.
template <int kHS>
__device__ __forceinline__ void update_role(const Ring& g, int turns, bool upd, const float* xu,
                                            const float* dpp, float lr) {
  const Tile<kHS> t(threadIdx.x >> 5, threadIdx.x & 31);
  const int quads = g.I / 4;
  float d[kBT][4];
#pragma unroll
  for (int b = 0; b < kBT; ++b) {
    const float4 v = upd ? ld4(dpp + b * kHS + t.tp) : make_float4(0.f, 0.f, 0.f, 0.f);
    d[b][0] = v.x;
    d[b][1] = v.y;
    d[b][2] = v.z;
    d[b][3] = v.w;
  }
  for (int s = 0; s < turns; ++s) {
    ring_turn<kHS>(g, s);
    if (!upd || s >= g.nch) continue;
    for (int u = 0; u < g.QT; ++u) {
      const int q = (s * g.QT + u) * t.nrl + t.rl;
      if (q >= quads) break;
      float* ws = g.slot(s) + 4 * (u * t.nrl + t.rl) * kHS + t.tp;
      float w[4][4], gq[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = ld4(ws + e * kHS);
        w[e][0] = v.x;
        w[e][1] = v.y;
        w[e][2] = v.z;
        w[e][3] = v.w;
#pragma unroll
        for (int k = 0; k < 4; ++k) gq[e][k] = 0.f;
      }
      const float* xb = xu + 4 * q;
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        const float4 xv = ld4(xb + b * g.I);
        const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < 4; ++k) gq[e][k] = fmaf(xe[e], d[b][k], gq[e][k]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[e][k] -= lr * gq[e][k];
        *reinterpret_cast<float4*>(ws + e * kHS) = make_float4(w[e][0], w[e][1], w[e][2], w[e][3]);
      }
    }
  }
  ring_tail<kHS>(g, turns);
}

// The forward role's pass (`fwd`; else it only turns the ring): in turn s
// its tile of chunk s - lag (updated by then), acc[4 b + k] += sum_i
// xf[b][i] w[i][k] over the tile's rows in order; then the four lane rows
// of each column summed (lane bit 4, then bit 3: a fixed tree) into the kBT
// sums a lane keeps, v[j] row 10 * bit4 + 5 * bit3 + j / 4 of column
// (block) + tcg + 8 * (j % 4).  Each float4 of x feeds 16 FMAs, each weight
// all kBT batch rows.
template <int kHS>
__device__ __forceinline__ void forward_role(const Ring& g, int turns, int lag, bool fwd,
                                             const float* xf, float (&v)[kBT]) {
  const int lane = threadIdx.x & 31;
  const Tile<kHS> t((threadIdx.x >> 5) - kRoleWarps, lane);
  const int quads = g.I / 4;
  float acc[4 * kBT];
#pragma unroll
  for (int j = 0; j < 4 * kBT; ++j) acc[j] = 0.f;
  for (int s = 0; s < turns; ++s) {
    ring_turn<kHS>(g, s);
    const int c = s - lag;
    if (!fwd || c < 0 || c >= g.nch) continue;
    for (int u = 0; u < g.QT; ++u) {
      const int q = (c * g.QT + u) * t.nrl + t.rl;
      if (q >= quads) break;
      const float* ws = g.slot(c) + 4 * (u * t.nrl + t.rl) * kHS + t.tp;
      float w[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = ld4(ws + e * kHS);
        w[e][0] = v.x;
        w[e][1] = v.y;
        w[e][2] = v.z;
        w[e][3] = v.w;
      }
      const float* xb = xf + 4 * q;
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        const float4 xv = ld4(xb + b * g.I);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float a = acc[4 * b + k];
          a = fmaf(xv.x, w[0][k], a);
          a = fmaf(xv.y, w[1][k], a);
          a = fmaf(xv.z, w[2][k], a);
          acc[4 * b + k] = fmaf(xv.w, w[3][k], a);
        }
      }
    }
  }
  ring_tail<kHS>(g, turns);
  float u[2 * kBT];
  const bool up16 = lane & 16, up8 = lane & 8;
#pragma unroll
  for (int j = 0; j < 2 * kBT; ++j) {
    const float send = up16 ? acc[j] : acc[j + 2 * kBT];
    const float keep = up16 ? acc[j + 2 * kBT] : acc[j];
    u[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int j = 0; j < kBT; ++j) {
    const float send = up8 ? u[j] : u[j + kBT];
    const float keep = up8 ? u[j + kBT] : u[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
}

template <bool kRagged, int kHS>
__global__ void __launch_bounds__(kWideThreads, 1)
local_sgd_wide_kernel(const float* __restrict__ g, const float* __restrict__ x,
                      const int* __restrict__ y, const int* __restrict__ act,
                      const float* __restrict__ mask, const int* __restrict__ nbs,
                      const int* __restrict__ offs, const int* __restrict__ order,
                      float* __restrict__ out, int npad, int I, int H, int C, int B,
                      int epochs, float lr, WPlan p) {
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int HS = kHS, nthr = kWideThreads, nwarps = kWideWarps;
  const int K = p.K, RB = p.RB, NS = p.NS, nch = p.nch;
  const int rank = (int)cluster.block_rank();
  const int r = order[blockIdx.x / K];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = rank * HS;
  const int nreal = H - h0 < HS ? H - h0 : HS;  // the slice's model columns
  const long long D = (long long)H + C + (long long)I * H + (long long)H * C;
  // the forward role's tile (forward_role): its warps on a column, this
  // warp's row of them (-1: an update warp), the lane's first column and
  // first batch row of its sums
  constexpr int ncb = HS / kBlockCols, nwr = kRoleWarps / ncb;
  const bool fwarp = warp >= kRoleWarps;
  const int wr = fwarp ? (warp - kRoleWarps) / ncb : -1;
  const int hc = kBlockCols * (warp % kRoleWarps % ncb) + (lane & 7);
  const int fb = 10 * ((lane >> 4) & 1) + 5 * ((lane >> 3) & 1);

  float* xs = smem + p.o_x;       // 2 slots of kBT x I (rows >= B stay zero)
  float* part = smem + p.o_part;  // (nwr - 1) x kBT x HS: the forward warps' sums
  float* hpre = smem + p.o_hpre;  // kBT x HS
  float* dh = hpre;  // kBT x HS, softmax-hidden clients (whose h is made by then)
  float* hact = smem + p.o_hact;  // kBT x HS
  float* dpp = smem + p.o_dpp;    // kBT x HS, d hpre at wpos (rows >= B stay zero)
  float* w2s = smem + p.o_w2;     // HS x C, rows h0.. of w2
  float* b1s = smem + p.o_b1;     // HS
  float* b2s = smem + p.o_b2;     // C
  float* lg = smem + p.o_lg;      // B x C, logits then d logits
  float* red = smem + p.o_red;    // 2 x K x RB cluster partials, a slot a rank
  float* ms = smem + p.o_ms;      // 2 x kBT staged mask rows
  int* ys = reinterpret_cast<int*>(smem + p.o_ys);        // 2 x kBT labels
  int* s_next = reinterpret_cast<int*>(smem + p.o_misc);  // next live step
  float* cnts = smem + p.o_misc + 4;                      // 2 staged mask counts
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);

  const float* gw1 = g + H + C;
  const float* gw2 = gw1 + (long long)I * H;
  float* w1o = out + (long long)r * D + H + C + h0;  // the slice's w1, row stride H
  for (int k = tid; k < I * nreal; k += nthr) {
    const int i = k / nreal, hl = k % nreal;
    w1o[(long long)i * H + hl] = gw1[(long long)i * H + h0 + hl];
  }
  for (int k = tid; k < HS * C; k += nthr)
    w2s[k] = k < nreal * C ? gw2[(long long)h0 * C + k] : 0.f;
  for (int k = tid; k < HS; k += nthr) b1s[k] = k < nreal ? g[h0 + k] : 0.f;
  for (int k = tid; k < C; k += nthr) b2s[k] = g[H + k];
  for (int k = tid; k < kBT * HS; k += nthr) dpp[k] = 0.f;
  for (int k = B * I + tid; k < kBT * I; k += nthr) {
    xs[k] = 0.f;
    xs[kBT * I + k] = 0.f;
  }
  const bool soft = act[r] == 1;
  const int nb = kRagged ? nbs[r] : npad / B;
  const long long first = kRagged ? (long long)offs[r] * B : (long long)r * npad;
  const int total = epochs * nb;
  const uint32_t tile_bytes = (uint32_t)B * I * 4;
  const bool stager = warp == 0;
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (stager) {
    const int t0 = stage_next_live(mask, y, first, nb, B, 0, total, ms, ys, &cnts[0], lane);
    if (lane == 0) s_next[2] = t0;
  }
  cluster.sync();  // every barrier of the cluster initialised, params staged
  int t = s_next[2];
  if (tid == 0 && t < total)
    issue_tile(x + (first + (long long)(t % nb) * B) * I, xs, &bars[0], tile_bytes, rank, K);
  Ring ring{smem + p.o_ring, w1o, H, NS, p.QT, nch, I, nreal, false};
  if (t < total) prefetch_ring<kHS>(ring);
  // a pass over the ring, the update warps and the forward warps in their
  // own loops (the forward one chunk behind the update when it follows
  // it); the forward warps' sums of each output, the first row of them (wr
  // = 0) keeping its own in registers, the others in part
  float mine[kBT];
  auto pass = [&](bool upd, bool fwd, const float* xu, const float* xf) {
    const int lag = upd && fwd ? 1 : 0, turns = nch + lag;
    ring.back = upd;
    if (!fwarp) {
      update_role<kHS>(ring, turns, upd, xu, dpp, lr);
    } else {
      forward_role<kHS>(ring, turns, lag, fwd, xf, mine);
      if (fwd && wr > 0)
#pragma unroll
        for (int j = 0; j < kBT; ++j)
          part[((wr - 1) * kBT + fb + j / 4) * HS + hc + 8 * (j % 4)] = mine[j];
    }
  };
  // after the barrier: the sums met in warp order, plus b1 (ReLU: h too)
  auto meet = [&]() {
    if (wr == 0)
#pragma unroll
      for (int j = 0; j < kBT; ++j) {
        const int b = fb + j / 4, h = hc + 8 * (j % 4);
        float s = mine[j];
        for (int w = 1; w < nwr; ++w) s += part[((w - 1) * kBT + b) * HS + h];
        const float hp = s + b1s[h];
        hpre[b * HS + h] = hp;
        if (!soft) hact[b * HS + h] = fmaxf(hp, 0.f);
      }
  };

  int use = 0, nred = 0;
  constexpr int tpc = nthr / HS, ngw = (kMaxWideC + tpc - 1) / tpc;  // threads a column
  float gw[ngw];  // this thread's w2 gradients (classes c0 + tpc m), applied before the pass
  while (t < total) {
    const int cur = use & 1, nxt = cur ^ 1;
    const float* xt = xs + cur * kBT * I;
    // --- the next live batch's mask row and labels, read ahead by the
    // stager warp: the first candidate's loads in flight during the wait
    float mv = 0.f;
    int yv = 0;
    if (stager && t + 1 < total && B <= 32) {
      const long long rowc = first + (long long)((t + 1) % nb) * B;
      if (lane < B) {
        mv = mask[rowc + lane];
        yv = y[rowc + lane];
      }
    }
    mbar_wait(smem_addr(&bars[cur]), (use >> 1) & 1);
    // --- the chain's first live step runs its forward alone; a later
    // step's came with the previous step's update
    if (use == 0) {
      pass(false, true, xt, xt);
      __syncthreads();
      meet();
      prefetch_ring<kHS>(ring);
    }
    if (stager) {
      int tn = total;
      if (t + 1 < total) {
        if (B <= 32) {
          float cnt = 0.f;
          for (int j = 0; j < B; ++j) cnt += __shfl_sync(0xffffffffu, mv, j);
          if (cnt > 0.f) {
            tn = t + 1;
            if (lane < B) {
              ms[nxt * kBT + lane] = mv;
              ys[nxt * kBT + lane] = yv;
            }
            if (lane == 0) cnts[nxt] = cnt;
          } else {
            tn = stage_next_live(mask, y, first, nb, B, t + 2, total, ms + nxt * kBT,
                                 ys + nxt * kBT, &cnts[nxt], lane);
          }
        } else {
          tn = stage_next_live(mask, y, first, nb, B, t + 1, total, ms + nxt * kBT,
                               ys + nxt * kBT, &cnts[nxt], lane);
        }
      }
      if (lane == 0) s_next[cur] = tn;
    }
    __syncthreads();
    const int tn = s_next[cur];
    // --- softmax hidden layer: a warp a row takes its slice's row max and
    // exp-sum over the model columns (butterflies), lanes < K send them to
    // every rank; one barrier; then the K slices' in rank order
    if (soft) {
      float* buf = red + (nred & 1) * K * RB;
      for (int b = warp; b < B; b += nwarps) {
        const float* hp = hpre + b * HS;
        float m = -INFINITY;
        for (int hl = lane; hl < nreal; hl += 32) m = fmaxf(m, hp[hl]);
        m = warp_max(m);
        float s = 0.f;
        for (int hl = lane; hl < nreal; hl += 32) s += expf(hp[hl] - m);
        s = warp_sum(s);
        if (lane < K) {
          float* dst = cluster.map_shared_rank(buf, lane) + rank * RB + 2 * b;
          dst[0] = m;
          dst[1] = s;
        }
      }
      cluster.sync();
      for (int b = warp; b < B; b += nwarps) {
        float m = -INFINITY;
        for (int rk = 0; rk < K; ++rk) m = fmaxf(m, buf[rk * RB + 2 * b]);
        float s = 0.f;
        for (int rk = 0; rk < K; ++rk) s += buf[rk * RB + 2 * b + 1] * expf(buf[rk * RB + 2 * b] - m);
        for (int hl = lane; hl < HS; hl += 32) {
          const int k = b * HS + hl;
          hact[k] = hl < nreal ? expf(hpre[k] - m) / s : 0.f;
        }
      }
      ++nred;
      __syncthreads();
    }
    // --- logits: each CTA's h_slice @ w2[slice] to every CTA, one barrier,
    // then a quarter warp a batch row sums the K slices in rank order, adds
    // b2 and turns the row into d logits (as in the narrow plan)
    {
      float* buf = red + (nred & 1) * K * RB;
      for (int k = tid; k < B * C; k += nthr) {
        const int b = k / C, c = k % C;
        push(cluster, buf, RB, rank, K, k, dot4(hact + b * HS, 1, w2s + c, C, HS));
      }
      cluster.sync();
      // every CTA has finished the previous step: the other x slot is free
      if (tid == nthr - 1 && tn < total)
        issue_tile(x + (first + (long long)(tn % nb) * B) * I, xs + nxt * kBT * I, &bars[nxt],
                   tile_bytes, rank, K);
      const float* mrow = ms + cur * kBT;
      const int* yrow = ys + cur * kBT;
      const float cnt = fmaxf(cnts[cur], 1.f);
      for (int b0 = 4 * warp; b0 < B; b0 += 4 * nwarps) {
        const int b = b0 + (lane >> 3), l8 = lane & 7;
        float lv[2], e[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = l8 + 8 * j;
          lv[j] = b < B && c < C ? gather_sum(buf, RB, K, b * C + c) + b2s[c] : -INFINITY;
        }
        const float mx = quarter_max(fmaxf(lv[0], lv[1]));
#pragma unroll
        for (int j = 0; j < 2; ++j) e[j] = b < B && l8 + 8 * j < C ? expf(lv[j] - mx) : 0.f;
        const float sum = quarter_sum(e[0] + e[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = l8 + 8 * j;
          if (b < B && c < C)
            lg[b * C + c] = (e[j] / sum - (c == yrow[b] ? 1.f : 0.f)) * (mrow[b] / cnt);
        }
      }
      ++nred;
    }
    __syncthreads();
    // --- dh[:, slice] = d logits @ w2[slice]^T (ReLU: d hpre, at wpos),
    // the w2 rows' gradient h^T @ d logits into registers (applied after
    // the last reader of w2 this step) and b2 -= lr * sum_b d logits: a
    // column a thread group, each sum in a fixed order
    {
      const int hl = tid % HS, c0 = tid / HS;
      float w2r[kMaxWideC];
#pragma unroll
      for (int c = 0; c < kMaxWideC; ++c) w2r[c] = c < C ? w2s[hl * C + c] : 0.f;
#pragma unroll 4
      for (int b = c0; b < B; b += tpc) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxWideC; ++c)
          if (c < C) a = fmaf(lg[b * C + c], w2r[c], a);
        if (soft) dh[b * HS + hl] = a;
        else dpp[b * HS + wpos(hl)] = hpre[b * HS + hl] > 0.f ? a : 0.f;
      }
#pragma unroll
      for (int m = 0; m < ngw; ++m) gw[m] = 0.f;
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        const float h = hact[b * HS + hl];
#pragma unroll
        for (int m = 0; m < ngw; ++m) {
          const int c = c0 + tpc * m;
          if (c < C) gw[m] = fmaf(h, lg[b * C + c], gw[m]);
        }
      }
      if (tid < C) b2s[tid] -= lr * dot4(lg + tid, C, nullptr, 0, B);
    }
    __syncthreads();
    if (soft) {
      // softmax backward: the row dot sum(dh * h) over all H (the slices'
      // shares in rank order), then d hpre = h * (dh - dot)
      float* buf = red + (nred & 1) * K * RB;
      for (int b = warp; b < B; b += nwarps) {
        float d = 0.f;
        for (int hl = lane; hl < HS; hl += 32) d = fmaf(dh[b * HS + hl], hact[b * HS + hl], d);
        d = warp_sum(d);
        if (lane < K) cluster.map_shared_rank(buf, lane)[rank * RB + b] = d;
      }
      cluster.sync();
      for (int b = warp; b < B; b += nwarps) {
        const float dot = gather_sum(buf, RB, K, b);
        for (int hl = lane; hl < HS; hl += 32) {
          const int k = b * HS + hl;
          dpp[b * HS + wpos(hl)] = hact[k] * (dh[k] - dot);
        }
      }
      ++nred;
      __syncthreads();
    }
    // --- w2 and b1 updates (w2 and b1 have no reader until the next step)
    {
      const int hl = tid % HS, c0 = tid / HS;
#pragma unroll
      for (int m = 0; m < ngw; ++m) {
        const int c = c0 + tpc * m;
        if (c < C) w2s[hl * C + c] -= lr * gw[m];
      }
      if (tid < HS) b1s[tid] -= lr * dot4(dpp + wpos(tid), HS, nullptr, 0, B);
    }
    // --- w1[:, slice] -= lr * x^T @ d hpre through the ring; with a next
    // live step, that step's forward on the updated rows (its tile, issued
    // after the logits barrier, lands during the backward), met after the
    // barrier, and the next pass's first chunks issued
    const bool fwd = tn < total;
    if (fwd) mbar_wait(smem_addr(&bars[nxt]), ((use + 1) >> 1) & 1);
    pass(true, fwd, xt, xs + nxt * kBT * I);
    __syncthreads();
    if (fwd) {
      meet();
      prefetch_ring<kHS>(ring);
    }
    ++use;
    t = tn;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  float* orow = out + (long long)r * D;
  for (int k = tid; k < nreal; k += nthr) orow[h0 + k] = b1s[k];
  if (rank == 0)
    for (int k = tid; k < C; k += nthr) orow[H + k] = b2s[k];
  float* ow2 = orow + H + C + (long long)I * H;
  for (int k = tid; k < nreal * C; k += nthr) ow2[(long long)h0 * C + k] = w2s[k];
  cluster.sync();  // no CTA leaves while a peer may still read its partials
}

}  // namespace

// The wide instance, built in local_sgd_wide.cu: launch it for
// wide_plan(I, H, C, B), or report its resources, as launch<> / attrs<>.
int local_sgd_wide_launch(bool ragged, const float* g, const float* x, const int* y,
                          const int* act, const float* mask, const int* nb, const int* off,
                          const int* order, float* out, int R, int npad, int I, int H, int C,
                          int B, int epochs, float lr, void* stream);
int local_sgd_wide_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                         int* max_clusters);

// The tiled plan (H <= 256, a step's batch in sub-tiles), built in
// local_sgd_tiled.cu: launch it for tiled_plan(I, H, C, B), or report its
// resources, as launch<> / attrs<>.
int local_sgd_tiled_launch(bool ragged, const float* g, const float* x, const int* y,
                           const int* act, const float* mask, const int* nb, const int* off,
                           const int* order, float* out, int R, int npad, int I, int H, int C,
                           int B, int epochs, float lr, void* stream);
int local_sgd_tiled_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                          int* max_clusters);

// The general instance, built in local_sgd_general.cu: launch it on
// `nclusters` clusters (each walks clients cl, cl + nclusters, ... of
// `order`, on its own slot of `ws`), or report its resources.
int local_sgd_general_launch(bool ragged, const float* g, const float* x, const int* y,
                             const int* act, const float* mask, const int* nb, const int* off,
                             const int* order, float* out, float* ws, int nclusters, int R,
                             int npad, int I, int H, int C, int B, int epochs, float lr,
                             void* stream);
int local_sgd_general_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                            int* max_clusters);
