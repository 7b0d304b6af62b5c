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
// 1.2e11 FLOPs: about 300 FLOPs per byte, above the bf16 ridge.  This first
// version runs them as fp32 FMAs (67 TFLOP/s peak), not on the tensor cores.
//
// What the design does about it:
// - One block per (query tile of 64 rows, batch x head).  The TPU grid's
//   sequential k axis becomes a loop inside the block over the 64-key tiles
//   that the causal mask and the window leave live: tiles wholly above the
//   diagonal or wholly left of the window are never loaded.  The grid's y
//   axis walks the query tiles last to first, so the blocks with the most
//   key tiles start first.
// - q, k and v are read in the (B, S, H, hd) layout the projections write,
//   k and v at kv head h / (H / KH), so nothing is transposed or repeated.
//   bf16 or fp32 in; every tile is widened to fp32 in shared memory; the
//   running max, normalizer and accumulator are fp32; the output is q's
//   dtype.
// - 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//   4 ty .. 4 ty + 3, score columns tx + 16 j (j < 4) and output columns
//   tx + 16 c (c < 8, so hd <= 128).  The 16 threads of a row are one half
//   warp, so the row max and row sum are four shuffles.  Shared rows are
//   padded to hd + 1 words, so the 16 key rows a half warp reads sit in 16
//   banks.  K and V share one buffer (K for the scores, then V for P V), so
//   a block holds about 75 KB at hd = 112 and two blocks fit on an SM.
// - Masked scores are -inf.  A row whose keys are all masked so far keeps
//   m = -inf, and the exponent's offset is then 0, not m: the kernel never
//   computes exp(-inf - (-inf)), and its first live key rescales the empty
//   accumulator by exp(-inf) = 0.  The reference masks with -1e30 instead;
//   both give exactly zero weight to every masked key of a row that has a
//   live key, and the diagonal key is always live.
// - The ragged edge (S not a multiple of 64) loads zeros past S, masks
//   those keys and stores no row past S.
// Plain fp32 FMAs from shared memory: wgmma, TMA and warp specialisation
// are for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kOutCols = kMaxHd / 16;  // output columns per thread

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// Loads rows [r0, r0 + 64) of one head (row stride `stride` elements) into
// a 64 x hd fp32 tile with row pitch `pitch`; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int S,
                                          long long stride, int hd, int pitch) {
  for (int e = threadIdx.x; e < 64 * hd; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int s = r0 + r;
    dst[r * pitch + c] = s < S ? widen(src[(long long)s * stride + c]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H,
                       int KH, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int pitch = hd + 1;
  float* sq = smem;                 // kBQ x pitch
  float* skv = sq + kBQ * pitch;    // kBK x pitch: K, then V
  float* sp = skv + kBK * pitch;    // kBQ x (kBK + 1): probabilities
  const int pp = kBK + 1;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / KH);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const long long qstride = (long long)H * hd;
  const long long kvstride = (long long)KH * hd;
  const T* qb = q + (long long)b * S * qstride + (long long)h * hd;
  const T* kb = k + (long long)b * S * kvstride + (long long)g * hd;
  const T* vb = v + (long long)b * S * kvstride + (long long)g * hd;

  load_tile(sq, qb, q0, S, qstride, hd, pitch);

  // live key range of this query tile
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][kOutCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile(skv, kb, k0, S, kvstride, hd, pitch);
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
    load_tile(skv, vb, k0, S, kvstride, hd, pitch);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
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

  T* ob = o + (long long)b * S * qstride + (long long)h * hd;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= S) continue;
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) narrow(acc[a][c] / denom, ob + (long long)row * qstride + col);
    }
  }
}

int smem_bytes(int hd) { return ((kBQ + kBK) * (hd + 1) + kBQ * (kBK + 1)) * 4; }

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int hd, int causal, int window, cudaStream_t stream) {
  const int smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KH, hd, causal, window,
      (float)(1.0 / sqrt((double)hd)));
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KH, hd), contiguous, H % KH == 0,
// hd <= 128; bf16 != 0 means __nv_bfloat16 tensors, else float.
extern "C" int fedar_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int S, int H, int KH, int hd,
                                     int causal, int window, int bf16, void* stream) {
  if (hd < 1 || hd > kMaxHd || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KH, hd, causal, window,
                                 (cudaStream_t)stream);
  return launch<float>(q, k, v, o, B, S, H, KH, hd, causal, window, (cudaStream_t)stream);
}
