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
// fp32 (the route check's dtype): the earlier design, not redesigned.  TF32
// tensor cores would not hold the route check's 1e-4, so fp32 keeps plain
// FMAs from shared memory: 64-row query tiles, 256 threads as a 16 x 16
// grid, tiles widened in padded shared rows, two __syncthreads per key tile;
// one instance for hd <= 128 and one for hd <= 256 (16 output columns a
// thread, 148 KB of shared memory).
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

constexpr int kBQ32 = 64;       // query rows per block
constexpr int kBK32 = 64;       // keys per tile
constexpr int kThreads32 = 256;
constexpr int kMaxHd = 256;

// Loads rows [r0, r0 + 64) of one head (row stride `stride` elements) into
// a 64 x hd tile with row pitch `pitch`; rows at or past S are zeros.
__device__ __forceinline__ void load_tile32(float* dst, const float* src, int r0, int S,
                                            long long stride, int hd, int pitch) {
  for (int e = threadIdx.x; e < 64 * hd; e += kThreads32) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int s = r0 + r;
    dst[r * pitch + c] = s < S ? src[(long long)s * stride + c] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

// 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows 4 ty ..
// 4 ty + 3, score columns tx + 16 j (j < 4) and output columns tx + 16 c
// (c < HDP / 16, so hd <= HDP).  The 16 threads of a row are one half warp,
// so the row max and row sum are four shuffles.  Shared rows are padded to
// hd + 1 words; K and V share one buffer (K for the scores, then V for P V).
template <int HDP>
__global__ void __launch_bounds__(kThreads32)
flash_attention_fp32_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o, int S,
                                int H, int KH, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int pitch = hd + 1;
  float* sq = smem;                 // kBQ32 x pitch
  float* skv = sq + kBQ32 * pitch;  // kBK32 x pitch: K, then V
  float* sp = skv + kBK32 * pitch;  // kBQ32 x (kBK32 + 1): probabilities
  const int pp = kBK32 + 1;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / KH);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ32;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  constexpr int kOutCols = HDP / 16;  // output columns per thread

  const long long qstride = (long long)H * hd;
  const long long kvstride = (long long)KH * hd;
  const float* qb = q + (long long)b * S * qstride + (long long)h * hd;
  const float* kb = k + (long long)b * S * kvstride + (long long)g * hd;
  const float* vb = v + (long long)b * S * kvstride + (long long)g * hd;

  load_tile32(sq, qb, q0, S, qstride, hd, pitch);

  // live key range of this query tile
  const int k_end = causal ? min(S, q0 + kBQ32) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][kOutCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = k_begin / kBK32 * kBK32; k0 < k_end; k0 += kBK32) {
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile32(skv, kb, k0, S, kvstride, hd, pitch);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qa[4], kj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = sq[(ty * 4 + a) * pitch + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kj[j] = skv[(tx + 16 * j) * pitch + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qa[a], kj[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty * 4 + a;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < S && (!causal || col <= row) &&
                          (window <= 0 || col > row - window);
        s[a][j] = live ? s[a][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[a][j]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      const float off = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr = expf(m[a] - off);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - off);
        sp[(ty * 4 + a) * pp + tx + 16 * j] = p;
        rs += p;
      }
      l[a] = l[a] * corr + half_warp_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[a][c] *= corr;
    }
    __syncthreads();  // every thread is done with K; P is complete
    load_tile32(skv, vb, k0, S, kvstride, hd, pitch);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK32; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sp[(ty * 4 + a) * pp + j];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const int col = tx + 16 * c;
        if (col < hd) {
          const float vv = skv[j * pitch + col];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
        }
      }
    }
  }

  float* ob = o + (long long)b * S * qstride + (long long)h * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) ob[(long long)row * qstride + col] = acc[a][c] / denom;
    }
  }
}

int smem_bytes32(int hd) { return ((kBQ32 + kBK32) * (hd + 1) + kBQ32 * (kBK32 + 1)) * 4; }

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

template <int HDP>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KH, int hd, int causal, int window, cudaStream_t stream) {
  const int smem = smem_bytes32(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fp32_fma_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ32 - 1) / kBQ32));
  flash_attention_fp32_fma_kernel<HDP><<<grid, kThreads32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, KH, hd, causal,
      window, (float)(1.0 / sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KH, hd), contiguous, H % KH == 0,
// hd <= 256.  bf16 != 0: __nv_bfloat16 tensors, hd % 8 == 0 and 16-byte
// aligned pointers (the tensor cores' instance); else float (FMA instance).
extern "C" int fedar_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int S, int H, int KH, int hd,
                                     int causal, int window, int bf16, void* stream) {
  if (hd < 1 || hd > kMaxHd || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) {
    if (hd <= 128) return launch_fp32<128>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
    return launch_fp32<256>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (hd % 8) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return launch_tc<64>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
  if (hd <= 128) return launch_tc<128>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
  return launch_tc<256>(q, k, v, o, B, S, H, KH, hd, causal, window, s);
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
