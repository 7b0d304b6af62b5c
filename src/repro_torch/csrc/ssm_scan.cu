// Mamba2's state-space dual (SSD) scan, chunked, for the LM trunk's prefill.
// Per (batch, SSM head), with the (st, hd) state carried in fp32 and, in a
// chunk of L positions with lc the inclusive cumsum of the log-decays:
//   y_i   = exp(lc_i) C_i . state + sum_{j <= i} (C_i . B_j) exp(lc_i - lc_j) x_j
//   state = exp(lc_L) state + sum_j exp(lc_L - lc_j) B_j (x) x_j
// which is the sequential recurrence state_t = exp(l_t) state_{t-1} +
// B_t (x) x_t, y_t = C_t . state_t, summed in another order.
//
// Replaces: src/repro/kernels/ssm_scan.py::ssm_scan (Pallas TPU; body
// _ssd_kernel).
//
// Two instances:
//
// ssm_scan_kernel (bf16 x, B, C and y; the prefill's path).  What bounds it
// on an H100: bytes.  At zamba2-7b's prefill shape (B, S, nh, hd, st) =
// (4, 2048, 112, 64, 64) it must read x, B, C and the fp32 log-decays and
// write y, 240.6 MB: 0.0718 ms at 3.35 TB/s, against ~0.023 ms for its
// FLOPs on the bf16 tensor cores.  What the design does about it:
// - The chunk's three products run on the tensor cores (mma.sync m16n8k16,
//   bf16 in, fp32 accumulators): G = C B^T, y = G x + exp(lc) (C . state)
//   and the state update (B w)^T x.  Four warps; warp w owns chunk rows
//   16 w .. 16 w + 15 for G and y, and state rows 16 w .. 16 w + 15 (its
//   16 x 32 piece, fp32, in registers for the whole sequence).
// - Rounding: G (decayed) is rounded to bf16 as an operand.  What the
//   carried state is made of stays near fp32: B_j exp(lc_L - lc_j) enters
//   the state update, and the state enters C . state, each as a hi + lo
//   pair of bf16 operands (two products, ~16 bits of mantissa); exp(lc_i)
//   multiplies C . state's fp32 result, never a bf16 operand.  Rounding
//   any of the three to one bf16 misses an output ulp on some rows
//   (tests/test_torch_ssm_scan.py emulates the plan and the variants).
// - G's accumulators become the A operand of G x in registers (the m16n8
//   accumulator layout is the m16n8k16 A layout), after the decay is
//   applied on the lower triangle only: above the diagonal the gap
//   lc_i - lc_j is positive and could overflow, so it is never
//   exponentiated (2^-inf = 0 takes its place); tiles wholly above it are
//   skipped.  Exponentials run on the SFU in log2 units (ex2.approx).
// - A ring of two chunk stages: the next chunk's x slice, B, C and
//   log-decays are issued by cp.async (16 bytes a copy; the log-decays,
//   one fp32 every nh * 4 bytes, by 4-byte copies) before this chunk's
//   products start, each stage completed on an mbarrier that every thread
//   arrives on when its copies land.  A wait that outlasts ~10 s traps.
// - More blocks than (batch, head): the state's columns are independent,
//   so a block owns a slice of 32 columns of hd and recomputes its
//   chunk's G (the FLOPs are a third of the bytes' time).  896 blocks at
//   the shape above, 4 an SM; one head a block (448 blocks, 3 an SM) was
//   slower at B = 4 and level at B = 1 x 8,192, 16 columns slower at both.
// - x rows padded to 32 * 2 + 16 bytes, B and C rows of 128 bytes with
//   their 16-byte pieces swizzled by row: ldmatrix reads hit distinct
//   banks.  y is staged in the warp's own rows of C (read into registers
//   by then) and stored 16 bytes a lane.
// - Takes hd, st multiples of 8 up to 64 (16-byte rows), 16-byte aligned
//   storage; positions past S, columns past hd and state past st are
//   zero-filled by the copies, so any S works.
//
// ssm_scan_fp32_fma_kernel (fp32; the route check and the card tests):
// the earlier FMA design, kept as it was.  What bounds it: operations,
// about 2.3e10 FLOPs of the chunked form at the shape above as fp32 FMAs
// (67 TFLOP/s).  One block per (batch, head), 256 threads as a 16 x 16
// grid of 4 x 4 register tiles over five 64 x 64 fp32 tiles in shared
// memory (rows padded to 65 words, 83 KB), chunk 64, any hd, st <= 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// the fp32 FMA instance
// ---------------------------------------------------------------------------

constexpr int kL = 64;         // positions per chunk (both instances)
constexpr int kMax = 64;       // largest st and hd
constexpr int kThreads = 256;
constexpr int kP = kMax + 1;   // padded row pitch, in words

__global__ void __launch_bounds__(kThreads)
ssm_scan_fp32_fma_kernel(const float* __restrict__ x, const float* __restrict__ logdecay,
                         const float* __restrict__ Bm, const float* __restrict__ Cm,
                         float* __restrict__ y, int S, int nh, int hd, int st) {
  extern __shared__ float smem[];
  float* sx = smem;             // kL x kP: x_j[c]
  float* sb = sx + kL * kP;     // kL x kP: B_j[s]
  float* sc = sb + kL * kP;     // kL x kP: C_i[s]
  float* sg = sc + kL * kP;     // kL x kP: (C_i . B_j) exp(lc_i - lc_j), j <= i
  float* sst = sg + kL * kP;    // kMax x kP: state[s][c]
  float* slc = sst + kMax * kP; // kL: inclusive cumsum of the log-decays
  float* sw = slc + kL;         // kL: exp(lc_L - lc_j)

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x - b * nh;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long xrow = (long long)nh * hd;  // elements between positions of x and y
  const float* xb = x + (long long)b * S * xrow + (long long)h * hd;
  const float* lb = logdecay + (long long)b * S * nh + h;
  const float* bb = Bm + (long long)b * S * st;
  const float* cb = Cm + (long long)b * S * st;
  float* yb = y + (long long)b * S * xrow + (long long)h * hd;

  for (int e = tid; e < kMax * kP; e += kThreads) sst[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    // whole 64 x 64 tiles, zeros past S, hd and st: every word a product
    // reads is defined
    for (int e = tid; e < kL * kMax; e += kThreads) {
      const int r = e / kMax, c = e - r * kMax, t = t0 + r;
      sx[r * kP + c] = t < S && c < hd ? xb[(long long)t * xrow + c] : 0.f;
      const bool in = t < S && c < st;
      sb[r * kP + c] = in ? bb[(long long)t * st + c] : 0.f;
      sc[r * kP + c] = in ? cb[(long long)t * st + c] : 0.f;
    }
    if (tid < 32) {  // one warp: inclusive cumsum, two positions a lane
      const int t = t0 + 2 * tid;
      const float l0 = t < S ? lb[(long long)t * nh] : 0.f;
      const float l1 = t + 1 < S ? lb[(long long)(t + 1) * nh] : 0.f;
      float inc = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += n;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (tid == 0) excl = 0.f;
      slc[2 * tid] = excl + l0;
      slc[2 * tid + 1] = inc;
    }
    __syncthreads();
    const float lc_end = slc[kL - 1];
    if (tid < kL) sw[tid] = expf(lc_end - slc[tid]);

    // G = C B^T, decayed, lower triangle
    {
      float g[4][4] = {};
      for (int s = 0; s < st; ++s) {
        float ca[4], bj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ca[a] = sc[(ty * 4 + a) * kP + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) bj[j] = sb[(tx + 16 * j) * kP + s];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[a][j] = fmaf(ca[a], bj[j], g[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty * 4 + a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = tx + 16 * j;
          sg[i * kP + jj] = jj <= i ? g[a][j] * expf(slc[i] - slc[jj]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(lc_i) C_i . state + sum_{j <= i} G_ij x_j
    {
      float acc[4][4] = {};
      for (int s = 0; s < st; ++s) {
        float ca[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ca[a] = sc[(ty * 4 + a) * kP + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = sst[s * kP + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(ca[a], sv[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(slc[ty * 4 + a]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] *= e;
      }
      const int jmax = ty * 4 + 4;  // G is zero past the thread's last row
      for (int jj = 0; jj < jmax; ++jj) {
        float ga[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ga[a] = sg[(ty * 4 + a) * kP + jj];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sx[jj * kP + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(ga[a], xv[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = t0 + ty * 4 + a;
        if (t >= S) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < hd) yb[(long long)t * xrow + c] = acc[a][j];
        }
      }
    }
    __syncthreads();  // every thread is done reading the state

    // state = exp(lc_L) state + sum_j exp(lc_L - lc_j) B_j (x) x_j
    {
      float upd[4][4] = {};
      for (int jj = 0; jj < kL; ++jj) {
        const float w = sw[jj];
        float ba[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ba[a] = sb[jj * kP + ty * 4 + a] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sx[jj * kP + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) upd[a][j] = fmaf(ba[a], xv[j], upd[a][j]);
      }
      const float dec = expf(lc_end);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int s = ty * 4 + a;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          sst[s * kP + c] = sst[s * kP + c] * dec + upd[a][j];
        }
      }
    }
  }
}

int fma_smem_bytes() { return (4 * kL * kP + kMax * kP + 2 * kL) * 4; }

int launch_fp32(const void* x, const float* logdecay, const void* Bm, const void* Cm,
                void* y, int B, int S, int nh, int hd, int st, cudaStream_t stream) {
  const int smem = fma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_fp32_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_fp32_fma_kernel<<<(unsigned)(B * nh), kThreads, smem, stream>>>(
      (const float*)x, logdecay, (const float*)Bm, (const float*)Cm, (float*)y, S, nh, hd,
      st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the bf16 tensor-core instance
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps
constexpr int kStages = 2;
constexpr int kRow = 128;         // bytes of a B or C row in shared memory (64 bf16)
constexpr int kCols = 32;         // columns of hd a block owns
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block, in bytes:
// kStages x (x slice, B, C, raw log-decays), the state's hi and lo halves,
// the chunk's cumsum (log2 units) and exp2(lc_L - lc_j) by chunk parity,
// one mbarrier per stage.  kernels/ssm_scan.py::smem_bytes mirrors it.
struct TcSmem {
  static constexpr int kXPitch = kCols * 2 + 16;
  static constexpr int kX = kL * kXPitch;
  static constexpr int kBC = kL * kRow;
  static constexpr int kStage = kX + 2 * kBC + kL * 4;
  static constexpr int kState = kMax * kXPitch;
  static constexpr int kHi = kStages * kStage;
  static constexpr int kLo = kHi + kState;
  static constexpr int kLc = kLo + kState;
  static constexpr int kW = kLc + 2 * kL * 4;
  static constexpr int kBar = kW + 2 * kL * 4;
  static constexpr int kBytes = kBar + kStages * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// The barrier's pending count drops by one when every cp.async this thread
// issued before has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// 2^x on the SFU, results under 2^-126 flushed to 0 (beside an fp32 state
// and outputs of order one they weigh nothing); 2^-inf is 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as a pair of bf16 values hi and the pair of what they miss, lo:
// hi + lo holds ~16 bits of each value's mantissa
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = pack_bf16(a, b);
  const float2 hf = unpack_bf16(h);
  hi = h;
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// byte offset of 16-byte piece `piece` of row `row` in a 128-byte-row tile
__device__ __forceinline__ uint32_t swz(int row, int piece) {
  return (uint32_t)(row * kRow + ((piece ^ (row & 7)) << 4));
}

// grid: one block per (batch, head, slice of kCols columns of hd), slices of
// a head adjacent; 128 threads.
__global__ void __launch_bounds__(kTcThreads, 4)
ssm_scan_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ logdecay,
                const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                __nv_bfloat16* __restrict__ y, int S, int nh, int hd, int st) {
  using Sm = TcSmem;
  constexpr int NT = kCols / 8;      // n-tiles of columns
  constexpr int XP = Sm::kXPitch;
  constexpr int XPIECES = kCols / 8; // 16-byte pieces of a row of the x slice
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const uint32_t base = smem_addr(smem);
  const uint32_t s_hi = base + Sm::kHi, s_lo = base + Sm::kLo;
  float* s_lc = reinterpret_cast<float*>(smem + Sm::kLc);  // [2][kL]
  float* s_w = reinterpret_cast<float*>(smem + Sm::kW);    // [2][kL]

  const int nsl = (hd + kCols - 1) / kCols;
  const int slice = blockIdx.x % nsl;
  const int bh = blockIdx.x / nsl;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const int c0 = slice * kCols;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int i0 = 16 * warp;
  const long long xrow = (long long)nh * hd;
  const __nv_bfloat16* xb = x + (long long)b * S * xrow + (long long)h * hd + c0;
  __nv_bfloat16* yb = y + (long long)b * S * xrow + (long long)h * hd + c0;
  const float* lb = logdecay + (long long)b * S * nh + h;
  const __nv_bfloat16* bb = Bm + (long long)b * S * st;
  const __nv_bfloat16* cb = Cm + (long long)b * S * st;
  const int nchunks = (S + kL - 1) / kL;

  auto stage_x = [&](int s) { return base + s * Sm::kStage; };
  auto stage_b = [&](int s) { return base + s * Sm::kStage + Sm::kX; };
  auto stage_c = [&](int s) { return base + s * Sm::kStage + Sm::kX + Sm::kBC; };
  auto stage_l = [&](int s) { return s * Sm::kStage + Sm::kX + 2 * Sm::kBC; };
  auto bar = [&](int s) { return base + Sm::kBar + 8 * s; };

  // every thread issues its share of chunk k's copies, then arrives: rows
  // xr + 32 i of the x slice at piece xp, rows br + 16 i of B and C at
  // piece bp (the same swizzle for every i), and the log-decay of position
  // tid for tid < kL
  static_assert(XPIECES == 4 && kL * XPIECES == 2 * kTcThreads, "x: 2 copies a thread");
  static_assert(kL * 8 == 4 * kTcThreads, "B, C: 4 copies a thread each");
  auto load_chunk = [&](int k) {
    const int s = k & 1, t0 = k * kL;
    const int xr = tid >> 2, xp = tid & 3, br = tid >> 3, bp = tid & 7;
    const __nv_bfloat16* xsrc = xb + (long long)(t0 + xr) * xrow + 8 * xp;
    const uint32_t xdst = stage_x(s) + xr * XP + 16 * xp;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = c0 + 8 * xp < hd && t0 + xr + 32 * i < S;
      cp16(xdst + 32 * i * XP, ok ? xsrc + 32 * i * xrow : xb, ok);
    }
    const long long boff = (long long)(t0 + br) * st + 8 * bp;
    const uint32_t bdst = swz(br, bp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = 8 * bp < st && t0 + br + 16 * i < S;
      const long long off = boff + 16 * i * st;
      cp16(stage_b(s) + bdst + 16 * i * kRow, ok ? bb + off : bb, ok);
      cp16(stage_c(s) + bdst + 16 * i * kRow, ok ? cb + off : cb, ok);
    }
    if (tid < kL) {
      const int t = t0 + tid;
      cp4(base + stage_l(s) + 4 * tid, t < S ? lb + (long long)t * nh : lb, t < S);
    }
    mbar_arrive_cp_async(bar(s));
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar(s), kTcThreads);
  }
  // the state's halves start at zero (read from the second chunk on)
  for (int e = tid; e < 2 * Sm::kState / 16; e += kTcThreads)
    reinterpret_cast<uint4*>(smem + Sm::kHi)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  load_chunk(0);

  float sacc[NT][4];  // state rows 16 warp + {g, g + 8}, columns 8 nt + 2 q + {0, 1}
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;

  for (int k = 0; k < nchunks; ++k) {
    const int s = k & 1;
    const int t0 = k * kL;
    float* lc = s_lc + s * kL;
    float* wv = s_w + s * kL;
    mbar_wait(bar(s), (k >> 1) & 1);
    if (warp == 0) {  // inclusive cumsum in log2 units, two positions a lane
      const float* raw = reinterpret_cast<const float*>(smem + stage_l(s));
      const float l0 = raw[2 * lane] * kLog2e, l1 = raw[2 * lane + 1] * kLog2e;
      float inc = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += n;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.f;
      const float end = __shfl_sync(0xffffffffu, inc, 31);
      lc[2 * lane] = excl + l0;
      lc[2 * lane + 1] = inc;
      wv[2 * lane] = exp2_ftz(end - (excl + l0));
      wv[2 * lane + 1] = exp2_ftz(end - inc);
    }
    __syncthreads();  // lc and w are in place; every warp is done with chunk k - 1
    if (k + 1 < nchunks) load_chunk(k + 1);  // into the stage chunk k - 1 used

    const uint32_t sx = stage_x(s), sb = stage_b(s), sc = stage_c(s);
    const float lci0 = lc[i0 + g], lci1 = lc[i0 + g + 8];

    // this warp's 16 rows of C, as A fragments over the 4 k-tiles of st
    uint32_t ca[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      ldsm_x4(ca[kt], sc + swz(i0 + (lane & 15), 2 * kt + (lane >> 4)));

    // y = exp(lc_i) (C . (state_hi + state_lo)), first
    float yacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
    if (k > 0) {
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const int row = 16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const uint32_t off = row * XP + (16 * p + (lane >> 4) * 8) * 2;
          uint32_t hb[4], lb4[4];
          ldsm_x4_t(hb, s_hi + off);
          ldsm_x4_t(lb4, s_lo + off);
          mma(yacc[2 * p], ca[kt], hb[0], hb[1]);
          mma(yacc[2 * p + 1], ca[kt], hb[2], hb[3]);
          mma(yacc[2 * p], ca[kt], lb4[0], lb4[1]);
          mma(yacc[2 * p + 1], ca[kt], lb4[2], lb4[3]);
        }
      }
      const float e0 = exp2_ftz(lci0), e1 = exp2_ftz(lci1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        yacc[nt][0] *= e0;
        yacc[nt][1] *= e0;
        yacc[nt][2] *= e1;
        yacc[nt][3] *= e1;
      }
    }

    // G = C B^T over the key tiles that reach this warp's rows
    float gacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[nt][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p > warp) continue;
      const int row = 16 * p + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t bf[4];
        ldsm_x4(bf, sb + swz(row, 2 * kt + ((lane >> 3) & 1)));
        mma(gacc[2 * p], ca[kt], bf[0], bf[1]);
        mma(gacc[2 * p + 1], ca[kt], bf[2], bf[3]);
      }
    }
    // decay on the lower triangle, then bf16 A fragments of G: registers
    // (rows g, k 0-7), (g + 8, k 0-7), (g, k 8-15), (g + 8, k 8-15) of key
    // tile p, which are n-tiles 2 p and 2 p + 1 of G's accumulators
    uint32_t ga[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p > warp) continue;
      // only the diagonal tile reaches above the diagonal: there the gap
      // becomes -inf, whose exp2 is 0
      const bool diag = p == warp;
      const float ninf = -CUDART_INF_F;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * p + half;
        const int j = 8 * nt + 2 * q;
        const float lj0 = lc[j], lj1 = lc[j + 1];
        const int r0 = i0 + g, r1 = r0 + 8;
        const float v0 = gacc[nt][0] * exp2_ftz(diag && j > r0 ? ninf : lci0 - lj0);
        const float v1 = gacc[nt][1] * exp2_ftz(diag && j + 1 > r0 ? ninf : lci0 - lj1);
        const float v2 = gacc[nt][2] * exp2_ftz(diag && j > r1 ? ninf : lci1 - lj0);
        const float v3 = gacc[nt][3] * exp2_ftz(diag && j + 1 > r1 ? ninf : lci1 - lj1);
        ga[p][2 * half] = pack_bf16(v0, v1);
        ga[p][2 * half + 1] = pack_bf16(v2, v3);
      }
    }
    // y += G x over the key tiles at or below this warp's rows
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      if (kt > warp) continue;
      const int row = 16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t xf[4];
        ldsm_x4_t(xf, sx + row * XP + (16 * p + (lane >> 4) * 8) * 2);
        mma(yacc[2 * p], ga[kt], xf[0], xf[1]);
        mma(yacc[2 * p + 1], ga[kt], xf[2], xf[3]);
      }
    }

    // y out: staged in this warp's own rows of C, 16 bytes a lane
    __syncwarp();
    unsigned char* cbytes = smem + s * Sm::kStage + Sm::kX + Sm::kBC;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(cbytes + swz(i0 + g, nt) + 4 * q) =
          pack_bf16(yacc[nt][0], yacc[nt][1]);
      *reinterpret_cast<uint32_t*>(cbytes + swz(i0 + g + 8, nt) + 4 * q) =
          pack_bf16(yacc[nt][2], yacc[nt][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 16 rows of 4 pieces
      const int r = (lane >> 2) + 8 * i, p = lane & 3, t = t0 + i0 + r;
      if (t < S && c0 + 8 * p < hd)
        *reinterpret_cast<uint4*>(yb + (long long)t * xrow + 8 * p) =
            *reinterpret_cast<const uint4*>(cbytes + swz(i0 + r, p));
    }
    if (k + 1 == nchunks) break;
    __syncthreads();  // every warp is done reading the state's halves

    // state = exp(lc_L) state + (B w)^T x; this warp's state rows 16 warp ..
    const float dec = exp2_ftz(lc[kL - 1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] *= dec;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int mi = lane >> 3;
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4_t(a, sb + swz(16 * kt + (lane & 7) + (mi >> 1) * 8, 2 * warp + (mi & 1)));
      const float w0 = wv[16 * kt + 2 * q], w1 = wv[16 * kt + 2 * q + 1];
      const float w2 = wv[16 * kt + 8 + 2 * q], w3 = wv[16 * kt + 9 + 2 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack_bf16(a[r]);
        if (r < 2) split_bf16(v.x * w0, v.y * w1, ahi[r], alo[r]);
        else split_bf16(v.x * w2, v.y * w3, ahi[r], alo[r]);
      }
      const int row = 16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t xf[4];
        ldsm_x4_t(xf, sx + row * XP + (16 * p + (lane >> 4) * 8) * 2);
        mma(sacc[2 * p], ahi, xf[0], xf[1]);
        mma(sacc[2 * p + 1], ahi, xf[2], xf[3]);
        mma(sacc[2 * p], alo, xf[0], xf[1]);
        mma(sacc[2 * p + 1], alo, xf[2], xf[3]);
      }
    }
    // the state's bf16 halves for the next chunk's C . state
    unsigned char* hi = smem + Sm::kHi;
    unsigned char* lo = smem + Sm::kLo;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (i0 + g + 8 * half) * XP + (8 * nt + 2 * q) * 2;
        split_bf16(sacc[nt][2 * half], sacc[nt][2 * half + 1],
                   *reinterpret_cast<uint32_t*>(hi + off),
                   *reinterpret_cast<uint32_t*>(lo + off));
      }
    }
  }
}

int launch_tc(const void* x, const float* logdecay, const void* Bm, const void* Cm,
              void* y, int B, int S, int nh, int hd, int st, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem::kBytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * nh * ((hd + kCols - 1) / kCols);
  ssm_scan_kernel<<<(unsigned)blocks, kTcThreads, TcSmem::kBytes, stream>>>(
      (const __nv_bfloat16*)x, logdecay, (const __nv_bfloat16*)Bm,
      (const __nv_bfloat16*)Cm, (__nv_bfloat16*)y, S, nh, hd, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, S, nh, hd); logdecay: (B, S, nh) float; Bm, Cm: (B, S, st);
// contiguous, hd <= 64, st <= 64.  bf16 != 0: __nv_bfloat16 x, B, C and y,
// hd and st multiples of 8, 16-byte aligned pointers (the tensor-core
// instance); else float (the FMA instance).
extern "C" int fedar_ssm_scan(const void* x, const float* logdecay, const void* Bm,
                              const void* Cm, void* y, int B, int S, int nh, int hd,
                              int st, int bf16, void* stream) {
  if (hd < 1 || hd > kMax || st < 1 || st > kMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) return launch_fp32(x, logdecay, Bm, Cm, y, B, S, nh, hd, st, s);
  if (hd % 8 || st % 8) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
       reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(y)) % 16 ||
      reinterpret_cast<uintptr_t>(logdecay) % 4)
    return (int)cudaErrorMisalignedAddress;
  return launch_tc(x, logdecay, Bm, Cm, y, B, S, nh, hd, st, s);
}

// The bf16 instance's resources: registers and local (spilled) bytes a
// thread, shared bytes a block, blocks an SM can hold.
extern "C" int fedar_ssm_scan_attrs(int* regs, int* local_bytes, int* smem,
                                    int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem::kBytes);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, ssm_scan_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ssm_scan_kernel,
                                                        kTcThreads, TcSmem::kBytes);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem = TcSmem::kBytes + (int)a.sharedSizeBytes;
  return 0;
}
