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
// What bounds it on an H100: operations.  At zamba2-7b's prefill shape
// (B, S, nh, hd, st) = (4, 2048, 112, 64, 64) it moves about 235 MB (x in,
// y out, bf16) for about 2.3e10 FLOPs of the chunked form, run here as fp32
// FMAs (67 TFLOP/s peak), not on the tensor cores.
//
// What the design does about it:
// - One block per (batch, head): 448 blocks at the shape above.  The TPU
//   grid's sequential chunk axis becomes a loop inside the block, and the
//   state stays in shared memory (16 KB at st = hd = 64) for the whole
//   sequence; it never goes to device memory.
// - The kernel's chunk is 64 positions, not the reference's 128: the
//   intra-chunk work is quadratic in the chunk, and the five 64 x 64 fp32
//   tiles (x, B, C, the decayed C B^T and the state, rows padded to 65
//   words) take 83 KB, so two blocks share an SM.  The result differs from
//   a 128-position chunk only by rounding order.
// - 256 threads as a 16 x 16 grid, each owning a 4 x 4 piece (rows 4 ty +
//   a, columns tx + 16 j) of each 64 x 64 product: C B^T, then y, then the
//   state update, with a barrier between them.
// - exp(lc_i - lc_j) is computed only for j <= i: above the diagonal the
//   gap is positive and could overflow; those entries are set to 0.
// - Positions past S (a ragged last chunk) load x = B = C = 0 and a
//   log-decay of 0, so they add nothing and leave the state's decay as it
//   was; their y is not stored.  Any S works.
// - x, B, C and y are bf16 or fp32 (one type); the log-decays are fp32.
// Plain fp32 FMAs from shared memory: tensor cores (the chunk's three
// products are matrix products) are for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 64;         // positions per chunk
constexpr int kMax = 64;       // largest st and hd
constexpr int kThreads = 256;
constexpr int kP = kMax + 1;   // padded row pitch, in words

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ logdecay,
                const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
                int S, int nh, int hd, int st) {
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
  const T* xb = x + (long long)b * S * xrow + (long long)h * hd;
  const float* lb = logdecay + (long long)b * S * nh + h;
  const T* bb = Bm + (long long)b * S * st;
  const T* cb = Cm + (long long)b * S * st;
  T* yb = y + (long long)b * S * xrow + (long long)h * hd;

  for (int e = tid; e < kMax * kP; e += kThreads) sst[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    // whole 64 x 64 tiles, zeros past S, hd and st: every word a product
    // reads is defined
    for (int e = tid; e < kL * kMax; e += kThreads) {
      const int r = e / kMax, c = e - r * kMax, t = t0 + r;
      sx[r * kP + c] = t < S && c < hd ? widen(xb[(long long)t * xrow + c]) : 0.f;
      const bool in = t < S && c < st;
      sb[r * kP + c] = in ? widen(bb[(long long)t * st + c]) : 0.f;
      sc[r * kP + c] = in ? widen(cb[(long long)t * st + c]) : 0.f;
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
          if (c < hd) narrow(acc[a][j], yb + (long long)t * xrow + c);
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

int smem_bytes() { return (4 * kL * kP + kMax * kP + 2 * kL) * 4; }

template <typename T>
int launch(const void* x, const float* logdecay, const void* Bm, const void* Cm,
           void* y, int B, int S, int nh, int hd, int st, cudaStream_t stream) {
  const int smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssm_scan_kernel<T><<<(unsigned)(B * nh), kThreads, smem, stream>>>(
      (const T*)x, logdecay, (const T*)Bm, (const T*)Cm, (T*)y, S, nh, hd, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, S, nh, hd); logdecay: (B, S, nh) float; Bm, Cm: (B, S, st);
// contiguous, hd <= 64, st <= 64; bf16 != 0 means __nv_bfloat16 x, B, C
// and y, else float.
extern "C" int fedar_ssm_scan(const void* x, const float* logdecay, const void* Bm,
                              const void* Cm, void* y, int B, int S, int nh, int hd,
                              int st, int bf16, void* stream) {
  if (hd < 1 || hd > kMax || st < 1 || st > kMax) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, logdecay, Bm, Cm, y, B, S, nh, hd, st,
                                 (cudaStream_t)stream);
  return launch<float>(x, logdecay, Bm, Cm, y, B, S, nh, hd, st, (cudaStream_t)stream);
}
