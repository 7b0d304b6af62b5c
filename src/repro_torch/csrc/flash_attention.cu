// Causal (optionally sliding-window) softmax attention with an online
// softmax, for the LM trunk's prefill:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * hd^-1/2) v[b, j, g]
// over the live keys j (j <= i when causal, j > i - window when window > 0),
// with g = h / (H / KH) the kv head of query head h (GQA).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// TPU; body _flash_kernel).
//
// What bounds it on an H100: operations.  At zamba2-7b's prefill shape
// (B, S, H, hd) = (4, 2048, 32, 112) it reads and writes 4 x 58.7 MB in
// bf16 but does 2 x 2 x hd FLOPs for each of the B H S^2 / 2 live scores,
// 1.2e11 FLOPs: about 300 FLOPs per byte, above the bf16 ridge, so only the
// tensor cores (989 TFLOP/s bf16) come near the bound.
//
// Two instances:
//
// bf16 (the path's dtype): tensor cores fed by TMA.
// - One block per (query tile of 128 rows, batch x head), 384 threads: two
//   consumer warpgroups, each owning 64 query rows (wgmma's M), and a
//   producer warpgroup whose first warp issues the loads.  `setmaxnreg`
//   moves registers from the producer (24 a thread) to the consumers (240:
//   at HDP = 128, 64 fp32 of scores, 64 of O and P in bf16; at HDP = 256,
//   32 of scores, 128 of O).  The grid's y axis walks the query tiles last
//   to first, so the blocks with the most key tiles start first.
// - The producer's one thread loads the Q tile once, then the K and V tiles
//   of kBKey keys (128; 64 at HDP = 256) into a ring of two stages, K and V
//   each behind its own `mbarrier` (so the scores start before V lands);
//   the consumers release a stage through a third.  Only the live key tiles
//   are loaded: up to the diagonal when causal, from the window's first key
//   when windowed.  Shared bytes: Q 16 KB and a K or V stage 16 KB per 64
//   columns of HDP at 128 keys, so 128-key tiles at HDP = 256 would need
//   321 KB; 64-key tiles need 193 KB of the 227 KB a block may take.
// - Each tensor is read in place through a 4-D tensor map (hd, heads, S, B)
//   with 64-column boxes and 128-byte swizzle; kv head g is a coordinate,
//   so GQA repeats nothing.  hd is padded to 64, 128 or 256 (HDP) by the
//   boxes' out-of-bounds zero fill, and so are the rows past S: zero
//   columns add nothing to Q K^T, and the output columns at or past hd are
//   not stored.  TMA needs byte strides that are multiples of 16, hence
//   hd % 8 == 0.
// - S = Q K^T: wgmma m64n{kBKey}k16 with both operands K-major in shared
//   memory, ceil(hd / 16) steps; the fp32 scores stay in registers.
// - Online softmax on the accumulator fragments (thread t of warp w holds
//   rows 16 w + t / 4 and + 8, columns in pairs), in base 2 with the scale
//   folded into one multiply.  Masked scores are -inf.  A row whose keys are
//   all masked so far keeps m = -inf, and the exponent's offset is then 0,
//   not m: the kernel never computes exp(-inf - (-inf)), and its first live
//   key rescales the empty accumulator by exp(-inf) = 0.  The reference
//   masks with -1e30 instead; both give exactly zero weight to every masked
//   key of a row that has a live key, and the diagonal key is always live.
//   Row sums stay per thread until the end.
// - O += P V: P is rounded to bf16 in registers and is wgmma's A operand
//   from registers (the accumulator's layout is the A fragment's); V is B,
//   read MN-major (transposed) from the swizzled tile, N = HDP (at 256, two
//   m64n128k16 halves over the tile's first and last two column boxes).  O
//   stays fp32 in registers and is divided by the row sum once, then stored
//   bf16 with the row check.
//
// fp32 (the route checks' dtype, and that of every reduced() config): FMAs
// on the CUDA cores, since TF32 tensor cores would not hold the route
// checks' 1e-4.  It is bound by operations (67 TFLOP/s of fp32 FMAs).  An
// SM issues 4 warp FMAs a cycle but serves one 128-byte shared wavefront a
// cycle, and a warp's 16-byte shared read takes 4 wavefronts even as a
// broadcast (a 4-key score tile ran at just that rate), so the design keeps
// both pipes within their limits: register tiles with 16 FMAs a 16-byte
// read.
// - One block per (query tile, batch x head, part of the tile's key
//   tiles), 256 threads (8 warps, the most that 255 registers a thread
//   allow).  Three instances (Fp32Tile): hd <= 64 and hd <= 128 give a
//   thread 8 rows x 8 keys of scores (64 registers) and 8 rows x 8 output
//   columns (64), against 256 x 64 and 128 x 128 (query x key) tiles;
//   hd <= 256 gives 4 x 4 and 4 x 16 against 64 x 64.
// - Q K^T: per float4 of hd a thread reads 8 float4s of K and 8 of Q for
//   256 FMAs.  A row group's lanes share their rows (Q reads broadcast) and
//   read distinct keys whose rows start in distinct bank groups (the row
//   pitch is an odd number of float4s).
// - P passes to P V through shared memory, 32 keys at a time within the
//   warp, in rows of 32 + L floats so that the row groups' stores fall in
//   distinct banks, and is read back as float4s of 4 keys; V rows are read
//   as float4s, L lanes across the columns.  Per 4 keys: 8 + 8 reads for
//   256 FMAs at the hd <= 128 instances.
// - Copies are cp.async: 16 bytes where hd % 4 == 0 and every pointer is
//   16-byte aligned, else 4; rows at or past S and the columns from hd to a
//   multiple of 4 are zero-filled.  K and V have a buffer each.  V of tile
//   t is queued a unit at a time inside the tile's score loop and K of tile
//   t + 1 inside its P V loop, so the copies neither stall every warp at
//   once nor wait for a barrier of their own: two barriers a key tile.
//   Shared bytes: 4 ((BQ + 2 BK) pitch + BQ (32 + L + 2)): 228,352 at hd =
//   128, 203,776 at 112, 147,456 at 64, 212,480 at 256, of the 232,448 a
//   block may take.  A second stage of K and V would add 135,168 bytes at
//   hd = 128 and 133,120 at 256, and does not fit; each copy has a compute
//   phase of several microseconds to land in.
// - Key split: where B H ceil(S / BQ) blocks would leave SMs idle (gemma3-
//   1b's route check: 64 blocks), the plan (kernels/flash_attention.py::
//   fp32_plan) splits each query tile's live key tiles into `parts`
//   contiguous parts.  Each part writes its unnormalized rows and (m, l) to
//   a workspace, and a merge kernel combines them in part order, with no
//   atomics: the same input gives the same bits.  A part in which a row
//   has no live key carries m = -inf, l = 0, and weighs 0.
// - GQA: each query head reads its kv head's tiles from L2.  Heads that
//   share a kv head do not share a tile in a block: the copies overlap the
//   FMAs that bound the kernel, and a shared tile would cost a query
//   tile's worth of shared memory or halve each head's rows.
// - A warp whose rows lie wholly before a tile's keys (causal), past them
//   (window) or at or past S skips the tile.  Masked scores are -inf and
//   the softmax runs in base 2, as in the bf16 instance.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------------- bf16

constexpr int kBQ = 128;                 // query rows per block
constexpr int kStages = 2;               // K / V ring depth
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kTcThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kRowBytes = 128;           // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int HDP>
struct TcSmem {
  static constexpr int kChunks = HDP / 64;           // 64-column boxes
  static constexpr int kBKey = HDP == 256 ? 64 : 128;  // keys per tile
  static constexpr int kQ = kChunks * kBQ * kRowBytes;
  static constexpr int kKV = kChunks * kBKey * kRowBytes;  // K or V, one stage
  static constexpr int kBytes = kQ + kStages * 2 * kKV + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.  K-major: SBO = 1024 (the
// next 8 rows), LBO unused.  MN-major: SBO = 1024 (the next 8 rows of K),
// LBO = the next 64 columns of MN.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins accumulator registers at this point: the compiler must not move
// their reads above the wgmma wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128, fp32) (+)= A(64 x 16) B(16 x 128); A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, fp32) (+)= A(64 x 16) B(16 x 64); A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, fp32) += A(64 x 16, registers) B(16 x 128); B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16, registers) B(16 x 64); B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (+)= Q K^T over 16 columns of hd, N = the key tile
template <int BKEY>
__device__ __forceinline__ void wgmma_qk(float (&d)[BKEY / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BKEY == 128) {
    wgmma_ss_m64n128(d, da, db, scale_d);
  } else {
    wgmma_ss_m64n64(d, da, db, scale_d);
  }
}

// O += P V over 16 keys: the keys' rows of V start at shared address `sv`
// in its first 64-column box, N = HDP.  A box of V is `box` bytes; at HDP
// = 256 the two halves of O (accumulator registers 0-63 and 64-127 hold
// columns 0-127 and 128-255) each take two boxes.
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], const uint32_t (&a)[4],
                                         uint32_t sv, uint32_t box) {
  if constexpr (HDP == 256) {
    wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, sw128_desc(sv, box, 1024));
    wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                     sw128_desc(sv + 2 * box, box, 1024));
  } else if constexpr (HDP == 128) {
    wgmma_rs_m64n128(o, a, sw128_desc(sv, box, 1024));
  } else {
    wgmma_rs_m64n64(o, a, sw128_desc(sv, box, 1024));
  }
}

// q, o: (B, S, H, hd); k, v: (B, S, KH, hd); the maps' boxes are 64 x 1 x
// rows x 1 (rows = 128 for q, the instance's kBKey for k and v).
template <int HDP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int S, int H, int KH, int hd,
                       int causal, int window, float scale_log2) {
  using L = TcSmem<HDP>;
  constexpr int kBKey = L::kBKey;
  extern __shared__ unsigned char smem_raw[];
  // q_full, k_full[stage], v_full[stage], empty[stage]
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t s_kv = s_q + L::kQ;  // stage s: K at s_kv + 2 s kKV, V after it
  const uint32_t q_full = smem_addr(&bars[0]);
  auto k_full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_addr(&bars[1 + kStages + s]); };
  auto empty = [&](int s) { return smem_addr(&bars[1 + 2 * kStages + s]); };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / KH);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ;
  // live key tiles of this query tile
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kBKey * kBKey : 0;
  const int n_tiles = (k_end - k_first + kBKey - 1) / kBKey;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // producer warpgroup: it gives its registers to the consumers, and one
    // thread of its first warp issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_4d(s_q + c * kBQ * kRowBytes, &tq, q_full, c * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int use = t / kStages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const int k0 = k_first + t * kBKey;
        const uint32_t sk = s_kv + s * 2 * L::kKV;
        mbar_expect_tx(k_full(s), L::kKV);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_4d(sk + c * kBKey * kRowBytes, &tk, k_full(s), c * 64, g, k0, b);
        mbar_expect_tx(v_full(s), L::kKV);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_4d(sk + L::kKV + c * kBKey * kRowBytes, &tv, v_full(s), c * 64, g, k0, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = warp / 4;
    const int w_row = q0 + 64 * wg;
    const int row0 = w_row + 16 * (warp % 4) + lane / 4;  // and row0 + 8
    const int cpair = 2 * (lane % 4);
    const int ksteps = (hd + 15) / 16;
    const uint32_t q_rows = s_q + wg * 64 * kRowBytes;

    float oacc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) oacc[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int k0 = k_first + t * kBKey;
      const uint32_t sk = s_kv + s * 2 * L::kKV;
      const uint32_t sv = sk + L::kKV;
      if (causal && k0 > w_row + 63) {
        // every key of the tile lies past this warpgroup's rows (a 64-key
        // tile's last one, beside the other warpgroup's diagonal): release
        // the stage unread; the other warpgroup's wait keeps it loaded
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        continue;
      }

      // S = Q K^T over hd in steps of 16
      float sacc[kBKey / 2];
#pragma unroll
      for (int i = 0; i < kBKey / 2; ++i) sacc[i] = 0.f;
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        if (kk < ksteps) {
          const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
          const uint64_t da = sw128_desc(q_rows + (kk / 4) * kBQ * kRowBytes + col, 16, 1024);
          const uint64_t db = sw128_desc(sk + (kk / 4) * kBKey * kRowBytes + col, 16, 1024);
          wgmma_qk<kBKey>(sacc, da, db, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // mask (only where this warpgroup's rows meet the diagonal, the window's
      // edge or S), then the online softmax in base 2
      const bool masked = (causal && k0 + kBKey - 1 > w_row) || k0 + kBKey > S ||
                          (window > 0 && k0 <= w_row + 63 - window);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kBKey / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sacc[4 * i + j] * scale_log2;
          if (masked) {
            const int col = k0 + 8 * i + cpair + (j & 1);
            const int row = row0 + 8 * (j >> 1);
            const bool live = col < S && (!causal || col <= row) &&
                              (window <= 0 || col > row - window);
            x = live ? x : -CUDART_INF_F;
          }
          sacc[4 * i + j] = x;
          if (j < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float off0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float off1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      const float corr0 = exp2f(m0 - off0), corr1 = exp2f(m1 - off1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBKey / 8; ++i) {
        sacc[4 * i + 0] = exp2f(sacc[4 * i + 0] - off0);
        sacc[4 * i + 1] = exp2f(sacc[4 * i + 1] - off0);
        sacc[4 * i + 2] = exp2f(sacc[4 * i + 2] - off1);
        sacc[4 * i + 3] = exp2f(sacc[4 * i + 3] - off1);
        rs0 += sacc[4 * i + 0] + sacc[4 * i + 1];
        rs1 += sacc[4 * i + 2] + sacc[4 * i + 3];
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        oacc[4 * i + 0] *= corr0;
        oacc[4 * i + 1] *= corr0;
        oacc[4 * i + 2] *= corr1;
        oacc[4 * i + 3] *= corr1;
      }
      // P as wgmma's A fragments: keys 16 t .. 16 t + 15 are the score
      // columns of n8 blocks 2 t and 2 t + 1
      uint32_t pa[kBKey / 16][4];
#pragma unroll
      for (int t16 = 0; t16 < kBKey / 16; ++t16) {
        pa[t16][0] = pack_bf16(sacc[8 * t16 + 0], sacc[8 * t16 + 1]);
        pa[t16][1] = pack_bf16(sacc[8 * t16 + 2], sacc[8 * t16 + 3]);
        pa[t16][2] = pack_bf16(sacc[8 * t16 + 4], sacc[8 * t16 + 5]);
        pa[t16][3] = pack_bf16(sacc[8 * t16 + 6], sacc[8 * t16 + 7]);
      }

      // O += P V over the tile's keys in steps of 16 (V rows 16 t16 ..)
      mbar_wait(v_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int t16 = 0; t16 < kBKey / 16; ++t16)
        wgmma_pv<HDP>(oacc, pa[t16], sv + t16 * 16 * kRowBytes, kBKey * kRowBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    const long long stride = (long long)H * hd;
    __nv_bfloat16* o0 = o + ((long long)b * S + row0) * stride + (long long)h * hd;
    __nv_bfloat16* o1 = o0 + 8 * stride;
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int col = 8 * i + cpair;
      if (col < hd) {
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
              __floats2bfloat162_rn(oacc[4 * i + 0] * inv0, oacc[4 * i + 1] * inv0);
        if (row0 + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
              __floats2bfloat162_rn(oacc[4 * i + 2] * inv1, oacc[4 * i + 3] * inv1);
      }
    }
  }
}

// ----------------------------------------------------------------- fp32

constexpr int kThreads32 = 256;  // 8 warps
constexpr int kPChunk = 32;      // keys of P that pass through shared memory at once
constexpr int kMaxHd = 256;
constexpr int kMaxParts = 16;
constexpr int kMaxGridY = 65535;

// The fp32 instances, by the largest hd they take.  L lanes share a row
// group (G groups a warp); a thread holds R rows x KT keys of scores and R
// rows x C4 float4 columns of the output.  Per float4 of hd the scores
// take R + KT shared reads for 4 R KT FMAs, and P V per 4 keys R + 4 C4
// reads for 16 R C4 FMAs: at R = KT = 8, C4 = 2, both 16 FMAs a read.
//   hd <=  64: L  8, R 8, KT 8, C4 2: 64-key tiles, 256 query rows
//   hd <= 128: L 16, R 8, KT 8, C4 2: 128-key tiles, 128 query rows
//   hd <= 256: L 16, R 4, KT 4, C4 4: 64-key tiles, 64 query rows (the
//              output's 64 accumulators a thread leave no registers for
//              a larger score tile)
template <int HDP>
struct Fp32Tile {
  static constexpr int kL = HDP == 64 ? 8 : 16;
  static constexpr int kG = 32 / kL;
  static constexpr int kR = HDP == 256 ? 4 : 8;
  static constexpr int kKT = HDP == 256 ? 4 : 8;
  static constexpr int kC4 = HDP / (4 * kL);
  static constexpr int kBK = kL * kKT;      // keys a tile
  static constexpr int kBQ = 8 * kG * kR;   // query rows a tile
  static constexpr int kPP = kPChunk + kL;  // floats a row of P: row groups kL banks apart
};

// Floats of a shared row of Q, K or V: hd rounded up to 4 and then to an
// odd number of float4s, so that 8 consecutive rows start in 8 distinct
// 16-byte bank groups.
__host__ __device__ __forceinline__ int fp32_pitch(int hd) { return 4 * (((hd + 3) / 4) | 1); }

template <int HDP>
int fp32_smem_bytes(int hd) {
  using T = Fp32Tile<HDP>;
  return 4 * ((T::kBQ + 2 * T::kBK) * fp32_pitch(hd) + T::kBQ * (T::kPP + 2));
}

// 16 bytes, or zeros when !valid (src is then not read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// A tile's copy, queued a unit at a time (a unit: one float4 with VEC,
// else one float of the row padded to 4 ceil(hd / 4)) from inside the
// compute loops, so that its cp.async instructions spread over the tile's
// FMAs instead of stalling every warp at once.  `start` aims it at rows
// [r0, r0 + rows) of one head (row stride `stride` floats from `src`) and
// the tile at shared address `dst` (row pitch `pitch` floats); `step`
// queues this thread's next unit, `rest` the ones left.  Rows at or past
// S, and without VEC the columns from hd to the next multiple of 4, are
// written as zeros.  A thread advances by 256 units without a division.
template <bool VEC>
struct TileCopy {
  int S, hd, pitch, width, dr, dc;
  long long stride;
  uint32_t dst;
  const float* src;
  int r0, rows, r, c;

  __device__ __forceinline__ TileCopy(int S_, int hd_, int pitch_, long long stride_)
      : S(S_), hd(hd_), pitch(pitch_), stride(stride_) {
    width = VEC ? hd / 4 : 4 * ((hd + 3) / 4);
    dr = kThreads32 / width;
    dc = kThreads32 - dr * width;
  }

  __device__ __forceinline__ void start(uint32_t dst_, const float* src_, int r0_, int rows_) {
    dst = dst_;
    src = src_;
    r0 = r0_;
    rows = rows_;
    r = threadIdx.x / width;
    c = threadIdx.x - r * width;
  }

  __device__ __forceinline__ void step() {
    if (r >= rows) return;
    const int s = r0 + r;
    if (VEC) {
      const bool ok = s < S;
      cp16(dst + 4u * (r * pitch + 4 * c), ok ? src + s * stride + 4 * c : src, ok);
    } else {
      const bool ok = s < S && c < hd;
      cp4(dst + 4u * (r * pitch + c), ok ? src + s * stride + c : src, ok);
    }
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }

  __device__ __forceinline__ void rest() {
    while (r < rows) step();
  }
};

template <int N>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per (query tile, batch x head, part of the tile's live key
// tiles), 256 threads.  Lane l of warp w owns query rows G R w + l / L +
// G i (i < R), score columns l % L + L j (j < KT) and output float4
// columns l % L + L c (c < C4): a row group holds all the keys and all
// the columns of its rows, so a row's max and sum over a tile are log2 L
// shuffles each, and P passes from the scores to P V through shared memory
// within the warp (kPChunk keys at a time, behind __syncwarp).  Each row's
// running max and sum wait in shared memory too, sparing 16 of the 255
// registers a thread may hold: lane 0 of the row group rewrites them after
// each tile.  Output columns past hd are computed from whatever the shared
// rows hold past it and never stored.  The grid's y walks the query tiles
// last to first, the parts of a tile side by side.  With parts == 1 the
// block writes o; else its unnormalized output rows to part_o and (m, l)
// to part_ml, for the merge kernel (m in base 2; an empty part writes only
// (-inf, 0)).
template <int HDP, bool VEC>
__global__ void __launch_bounds__(kThreads32, 1)
flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ part_o, float2* __restrict__ part_ml, int S,
                            int H, int KH, int hd, int causal, int window, int parts,
                            float scale_log2) {
  using T = Fp32Tile<HDP>;
  constexpr int L = T::kL, G = T::kG, R = T::kR, KT = T::kKT, C4 = T::kC4;
  constexpr int BK = T::kBK, BQ = T::kBQ, PP = T::kPP;
  extern __shared__ __align__(16) float smem32[];
  const int pitch = fp32_pitch(hd);
  const int pitch4 = pitch / 4;
  float* sq = smem32;            // BQ x pitch
  float* sk = sq + BQ * pitch;   // BK x pitch
  float* sv = sk + BK * pitch;   // BK x pitch
  float* sp = sv + BK * pitch;   // BQ x PP: a chunk of P
  float* sml = sp + BQ * PP;     // BQ x 2: each row's running max and sum

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / KH);
  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.y / parts;
  const int part = (int)blockIdx.y - (nq - 1 - qt) * parts;
  const int q0 = qt * BQ;
  // this part's share of the query tile's live key tiles
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = (k_end + BK - 1) / BK - t_first;
  const int t_lo = t_first + part * n_tiles / parts;
  const int t_hi = t_first + (part + 1) * n_tiles / parts;
  const long long id = ((long long)bh * nq + qt) * parts + part;  // this block's partials

  if (t_lo == t_hi) {
    for (int r = threadIdx.x; r < BQ; r += kThreads32)
      part_ml[id * BQ + r] = make_float2(-CUDART_INF_F, 0.f);
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tx = lane % L;
  const int lr0 = G * R * warp + lane / L;  // local rows lr0 + G i
  const int w_lo = q0 + G * R * warp;       // the warp's rows w_lo .. w_hi
  const int w_hi = w_lo + G * R - 1;
  const int nd4 = (hd + 3) / 4;

  const long long qstride = (long long)H * hd;
  const long long kvstride = (long long)KH * hd;
  const float* qb = q + (long long)b * S * qstride + (long long)h * hd;
  const float* kb = k + (long long)b * S * kvstride + (long long)g * hd;
  const float* vb = v + (long long)b * S * kvstride + (long long)g * hd;
  const uint32_t s_k = static_cast<uint32_t>(__cvta_generic_to_shared(sk));
  const uint32_t s_v = static_cast<uint32_t>(__cvta_generic_to_shared(sv));
  {
    TileCopy<VEC> qc(S, hd, pitch, qstride);
    qc.start(static_cast<uint32_t>(__cvta_generic_to_shared(sq)), qb, q0, BQ);
    qc.rest();
  }
  TileCopy<VEC> cp(S, hd, pitch, kvstride);
  cp.start(s_k, kb, t_lo * BK, BK);
  cp.rest();
  cp_commit();

  const float4* q4 = reinterpret_cast<const float4*>(sq) + lr0 * pitch4;
  const float4* k4 = reinterpret_cast<const float4*>(sk) + tx * pitch4;
  const float4* v4 = reinterpret_cast<const float4*>(sv) + tx;
  const float4* p4 = reinterpret_cast<const float4*>(sp) + lr0 * (PP / 4);
  float* pw = sp + lr0 * PP + tx;

  float4 acc[R][C4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (tx == 0)
      *reinterpret_cast<float2*>(sml + 2 * (lr0 + G * i)) = make_float2(-CUDART_INF_F, 0.f);
#pragma unroll
    for (int c = 0; c < C4; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // [split] start
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    cp_wait_all();
    __syncthreads();  // K (and Q) landed; every warp is done with V
    // [split] K wait
    cp.start(s_v, vb, k0, BK);  // V, a unit a step of the scores
    // a warp none of whose rows has a live key in the tile skips it (the
    // result is the same: such keys add exp2(-inf) = 0), as does a warp
    // whose rows all lie at or past S
    const bool idle = w_lo >= S || (causal && k0 > w_hi) ||
                      (window > 0 && k0 + BK - 1 <= w_lo - window);
    float s[R][KT];
    if (!idle) {
      // S = Q K^T over hd in float4 steps
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < KT; ++j) s[i][j] = 0.f;
#pragma unroll 1
      for (int d = 0; d < nd4; ++d) {
        cp.step();
        float4 kf[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) kf[j] = k4[L * j * pitch4 + d];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qv = q4[G * i * pitch4 + d];
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            s[i][j] = fmaf(qv.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kf[j].w, s[i][j]);
          }
        }
      }
      // [split] scores
      // mask (only where the warp's rows meet the diagonal, the window's
      // edge or S), then the online softmax in base 2; s becomes P
      const bool masked = (causal && k0 + BK - 1 > w_lo) || k0 + BK > S ||
                          (window > 0 && k0 <= w_hi - window);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + lr0 + G * i;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          float x = s[i][j] * scale_log2;
          if (masked) {
            const int col = k0 + tx + L * j;
            const bool live = col < S && (!causal || col <= row) &&
                              (window <= 0 || col > row - window);
            x = live ? x : -CUDART_INF_F;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        float2* ml = reinterpret_cast<float2*>(sml + 2 * (lr0 + G * i));
        const float2 old = *ml;
        const float mn = fmaxf(old.x, group_max<L>(mx));
        const float base = mn == -CUDART_INF_F ? 0.f : mn;
        const float corr = exp2f(old.x - base);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          s[i][j] = exp2f(s[i][j] - base);
          rs += s[i][j];
        }
        rs = group_sum<L>(rs);
        __syncwarp();  // every lane has read the row's old (m, l)
        if (tx == 0) *ml = make_float2(mn, old.y * corr + rs);
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          acc[i][c].x *= corr;
          acc[i][c].y *= corr;
          acc[i][c].z *= corr;
          acc[i][c].w *= corr;
        }
      }
      // [split] softmax
    }
    cp.rest();
    cp_commit();
    cp_wait_all();
    __syncthreads();  // V landed; every warp is done with K
    // [split] V wait
    cp.start(s_k, kb, k0 + BK, t + 1 < t_hi ? BK : 0);  // the next K, a unit a step of P V
    if (!idle) {
      // O += P V, kPChunk keys at a time: the row group writes its P to
      // shared memory and reads it back as float4s of 4 keys
#pragma unroll
      for (int ch = 0; ch < BK / kPChunk; ++ch) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int jj = 0; jj < kPChunk / L; ++jj)
            pw[G * i * PP + L * jj] = s[i][ch * (kPChunk / L) + jj];
        __syncwarp();
#pragma unroll 1
        for (int kq = 0; kq < kPChunk / 4; ++kq) {
          cp.step();
          float4 pv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) pv[i] = p4[G * i * (PP / 4) + kq];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4* vrow = v4 + (ch * kPChunk + 4 * kq + e) * pitch4;
#pragma unroll
            for (int c = 0; c < C4; ++c) {
              const float4 vv = vrow[L * c];
#pragma unroll
              for (int i = 0; i < R; ++i) {
                const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
                acc[i][c].x = fmaf(pe, vv.x, acc[i][c].x);
                acc[i][c].y = fmaf(pe, vv.y, acc[i][c].y);
                acc[i][c].z = fmaf(pe, vv.z, acc[i][c].z);
                acc[i][c].w = fmaf(pe, vv.w, acc[i][c].w);
              }
            }
          }
        }
        __syncwarp();  // the chunk of P is read before the next overwrites it
      }
    }
    cp.rest();
    cp_commit();
    // [split] P V
  }
  // [split] end

  __syncwarp();  // the rows' (m, l) are written
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int lr = lr0 + G * i;
    const float2 ml = *reinterpret_cast<const float2*>(sml + 2 * lr);
    const float lt = ml.y;
    const int row = q0 + lr;
    float* dst;
    float inv = 1.f;
    if (parts == 1) {
      if (row >= S) continue;
      dst = o + ((long long)b * S + row) * qstride + (long long)h * hd;
      inv = 1.f / fmaxf(lt, 1e-30f);
    } else {
      dst = part_o + (id * BQ + lr) * hd;
      if (tx == 0) part_ml[id * BQ + lr] = ml;
    }
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int c4 = tx + L * c;
      if (c4 >= nd4) continue;
      const float4 r4 = make_float4(acc[i][c].x * inv, acc[i][c].y * inv, acc[i][c].z * inv,
                                    acc[i][c].w * inv);
      if (VEC) {
        *reinterpret_cast<float4*>(dst + 4 * c4) = r4;
      } else {
        const float e4[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * c4 + e < hd) dst[4 * c4 + e] = e4[e];
      }
    }
  }
}

// Merges the parts of each (b, s, h) row in part order, one warp a row: a
// part with m = -inf (no live key of the row in it) weighs 0 and its
// output is not read, so the sums never meet exp2(-inf - -inf).  No
// atomics: the same partials give the same bits.
__global__ void __launch_bounds__(kThreads32)
flash_attention_fp32_merge_kernel(const float* __restrict__ part_o,
                                  const float2* __restrict__ part_ml, float* __restrict__ o,
                                  int S, int H, int hd, int bq, int parts, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads32 / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bs = row / H;  // row = (b S + s) H + h
  const int h = (int)(row - bs * H);
  const int b = (int)(bs / S);
  const int s = (int)(bs - (long long)b * S);
  const int qt = s / bq;
  const int r = s - qt * bq;
  const int nq = (S + bq - 1) / bq;
  const long long id0 = (((long long)b * H + h) * nq + qt) * parts;
  float mx = -CUDART_INF_F;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, part_ml[(id0 + p) * bq + r].x);
  float sum = 0.f;
  float acc[kMaxHd / 32];
#pragma unroll
  for (int c = 0; c < kMaxHd / 32; ++c) acc[c] = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float2 ml = part_ml[(id0 + p) * bq + r];
    if (ml.x == -CUDART_INF_F) continue;
    const float w = exp2f(ml.x - mx);
    sum += w * ml.y;
    const float* src = part_o + ((id0 + p) * bq + r) * hd;
#pragma unroll
    for (int c = 0; c < kMaxHd / 32; ++c)
      if (lane + 32 * c < hd) acc[c] = fmaf(w, src[lane + 32 * c], acc[c]);
  }
  const float inv = 1.f / fmaxf(sum, 1e-30f);
  float* dst = o + row * hd;
#pragma unroll
  for (int c = 0; c < kMaxHd / 32; ++c)
    if (lane + 32 * c < hd) dst[lane + 32 * c] = acc[c] * inv;
}

// ----------------------------------------------------------------- host

// cuTensorMapEncodeTiled lives in libcuda, not cudart; its address is
// fetched through the runtime, so the library links nothing beyond cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads, hd) bf16 as a 4-D map (hd, heads, S, B), box 64 x 1 x rows
// x 1, 128-byte swizzle, out-of-bounds elements read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t row = 2ull * hd;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int KH, int hd, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, H, hd, kBQ);
  if (!err) err = make_map(&tk, k, B, S, KH, hd, TcSmem<HDP>::kBKey);
  if (!err) err = make_map(&tv, v, B, S, KH, hd, TcSmem<HDP>::kBKey);
  if (err) return err;
  const int smem = TcSmem<HDP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HDP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  flash_attention_kernel<HDP><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, S, H, KH, hd, causal, window,
      (float)(kLog2e / sqrt((double)hd)));
  return (int)cudaGetLastError();
}

template <int HDP, bool VEC>
int launch_fp32(const float* q, const float* k, const float* v, float* o, float* part_o,
                float2* part_ml, int B, int S, int H, int KH, int hd, int causal, int window,
                int parts, cudaStream_t stream) {
  constexpr int BQ = Fp32Tile<HDP>::kBQ;
  const int smem = fp32_smem_bytes<HDP>(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fp32_kernel<HDP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  const dim3 grid((unsigned)(B * H), (unsigned)(nq * parts));
  flash_attention_fp32_kernel<HDP, VEC><<<grid, kThreads32, smem, stream>>>(
      q, k, v, o, part_o, part_ml, S, H, KH, hd, causal, window, parts,
      (float)(kLog2e / sqrt((double)hd)));
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const long long rows = (long long)B * S * H;
  const int per_block = kThreads32 / 32;
  flash_attention_fp32_merge_kernel<<<(unsigned)((rows + per_block - 1) / per_block),
                                      kThreads32, 0, stream>>>(part_o, part_ml, o, S, H, hd,
                                                                BQ, parts, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KH, hd), contiguous __nv_bfloat16, H %
// KH == 0, hd % 8 == 0, hd <= 256, 16-byte aligned pointers (the tensor
// cores' instance).
extern "C" int fedar_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* o, int B, int S, int H, int KH, int hd,
                                          int causal, int window, void* stream) {
  if (hd < 1 || hd > kMaxHd || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (hd % 8) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return launch_tc<64>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
  if (hd <= 128) return launch_tc<128>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
  return launch_tc<256>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
}

// The same in float on the CUDA cores, with the plan of
// kernels/flash_attention.py::fp32_plan: block_q must be the instance's
// (256 at hd <= 64, 128 at hd <= 128, 64 above), and parts > 1 needs the
// workspace (part_o: B H nq parts block_q hd floats, part_ml: as many
// float2s, 8-byte aligned).  vec != 0 takes the 16-byte copies: hd % 4 ==
// 0 and every pointer 16-byte aligned.
extern "C" int fedar_flash_attention_fp32(const void* q, const void* k, const void* v,
                                          void* o, void* part_o, void* part_ml, int B, int S,
                                          int H, int KH, int hd, int causal, int window,
                                          int block_q, int parts, int vec, void* stream) {
  if (hd < 1 || hd > kMaxHd || KH < 1 || H % KH != 0 || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int hdp = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  const int bq = hdp == 64    ? Fp32Tile<64>::kBQ
                 : hdp == 128 ? Fp32Tile<128>::kBQ
                              : Fp32Tile<256>::kBQ;
  if (block_q != bq) return (int)cudaErrorInvalidValue;
  const long long nq = (S + block_q - 1) / block_q;
  if (parts < 1 || parts > kMaxParts || nq * parts > kMaxGridY) return (int)cudaErrorInvalidValue;
  if (parts > 1 && (part_o == nullptr || part_ml == nullptr)) return (int)cudaErrorInvalidValue;
  if (parts > 1 && reinterpret_cast<uintptr_t>(part_ml) % 8) return (int)cudaErrorMisalignedAddress;
  if (vec && (hd % 4 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                         reinterpret_cast<uintptr_t>(part_o)) % 16))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  float *fo = (float*)o, *po = (float*)part_o;
  float2* pml = (float2*)part_ml;
#define FEDAR_FA32(HDP, VEC) \
  launch_fp32<HDP, VEC>(fq, fk, fv, fo, po, pml, B, S, H, KH, hd, causal, window, parts, s)
  if (hdp == 64) return vec ? FEDAR_FA32(64, true) : FEDAR_FA32(64, false);
  if (hdp == 128) return vec ? FEDAR_FA32(128, true) : FEDAR_FA32(128, false);
  return vec ? FEDAR_FA32(256, true) : FEDAR_FA32(256, false);
#undef FEDAR_FA32
}

// The bf16 instance's resources at head-dim padding hdp (64, 128 or 256):
// registers a thread, local (spilled) bytes a thread, static and dynamic
// shared bytes a block.
extern "C" int fedar_flash_attention_attrs(int hdp, int* regs, int* local_bytes,
                                           int* static_smem, int* dynamic_smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  int dyn;
  if (hdp == 64) {
    err = cudaFuncGetAttributes(&a, flash_attention_kernel<64>);
    dyn = TcSmem<64>::kBytes;
  } else if (hdp == 128) {
    err = cudaFuncGetAttributes(&a, flash_attention_kernel<128>);
    dyn = TcSmem<128>::kBytes;
  } else if (hdp == 256) {
    err = cudaFuncGetAttributes(&a, flash_attention_kernel<256>);
    dyn = TcSmem<256>::kBytes;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = dyn;
  return 0;
}

// The fp32 kernels' resources: which = 2 i / 2 i + 1 the instance i (hd
// <= 64, 128, 256) with 16- / 4-byte copies, 6 the merge kernel.
// Registers and local (spilled) bytes a thread, static shared bytes a
// block, and the dynamic shared bytes a block of the instance takes at
// head dim hd (0 for the merge, or an hd past the instance).
extern "C" int fedar_flash_attention_fp32_attrs(int which, int hd, int* regs, int* local_bytes,
                                                int* static_smem, int* dynamic_smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (which) {
    case 0: err = cudaFuncGetAttributes(&a, flash_attention_fp32_kernel<64, true>); break;
    case 1: err = cudaFuncGetAttributes(&a, flash_attention_fp32_kernel<64, false>); break;
    case 2: err = cudaFuncGetAttributes(&a, flash_attention_fp32_kernel<128, true>); break;
    case 3: err = cudaFuncGetAttributes(&a, flash_attention_fp32_kernel<128, false>); break;
    case 4: err = cudaFuncGetAttributes(&a, flash_attention_fp32_kernel<256, true>); break;
    case 5: err = cudaFuncGetAttributes(&a, flash_attention_fp32_kernel<256, false>); break;
    case 6: err = cudaFuncGetAttributes(&a, flash_attention_fp32_merge_kernel); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int dyn = 0;
  if (which < 2 && hd >= 1 && hd <= 64) dyn = fp32_smem_bytes<64>(hd);
  if ((which == 2 || which == 3) && hd >= 1 && hd <= 128) dyn = fp32_smem_bytes<128>(hd);
  if ((which == 4 || which == 5) && hd >= 1 && hd <= kMaxHd) dyn = fp32_smem_bytes<256>(hd);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *static_smem = (int)a.sharedSizeBytes;
  *dynamic_smem = dyn;
  return 0;
}
