// Uplink-compression codecs: 4-bit code packing, its inverse, and the
// top-k sparse -> dense decode.
//
// Replaces (Pallas TPU kernels in src/repro/kernels/compress.py):
//   pack_codes   (body _pack4_kernel)   -> pack4_kernel
//   unpack_codes (body _unpack4_kernel) -> unpack4_kernel
//   topk_decode  (body _topk_kernel)    -> zero_kernel + topk_scatter_kernel
// At 8 bits packing is a cast on both sides and runs no kernel.
//
// What bounds them on an H100: bytes, all three.  Pack reads 4 bytes of
// int32 code per 4 bits it writes; unpack reads half a byte per int32 code
// it writes; top-k decode writes the dense (N, D) fp32 rows and reads 8
// bytes per kept pair.  None does more than a few integer operations per
// byte, and none uses tensor cores.
//
// What the design does about it:
// - The 4-bit layout is half-split, as in the reference: byte j of a row
//   holds code j in its low nibble and code P + j in its high nibble,
//   P = ceil(D / 2), and the row is zero-padded to 2P.  One thread per
//   packed byte reads code j and code P + j (the second is 0 past D when D
//   is odd): neighbouring threads read neighbouring int32 words in both
//   halves, so each warp's loads are two coalesced 128-byte lines.
// - Unpack is one thread per packed byte, writing its two codes straight
//   to columns j and P + j of the (N, D) int32 output: no nibble planes,
//   no concatenate, no slice.
// - Top-k decode zeroes the output in one pass, then adds each (row, t)
//   pair into its index with one thread per pair and atomicAdd.  The TPU
//   kernel instead folds over k per column window (compare-and-accumulate);
//   on Hopper a scatter of k pairs touches k of D columns instead of
//   comparing all k against all D.  On the engine's path the indices of a
//   row are distinct (they come from top-k), so every element receives at
//   most one add to 0 and the result is exact.  Duplicate indices add: two
//   are still exact (0 + a + b == 0 + b + a); three or more may sum in
//   another order than the reference's left-to-right fold (a few ulp of
//   the sum).  Indices outside [0, D) are dropped, as the TPU kernel's
//   compare never matches them.
// - Every kernel walks its flat index space with a grid-stride loop in
//   64-bit indices, so N * D beyond 2^31 is fine.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

unsigned blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
pack4_kernel(const int32_t* __restrict__ codes, uint8_t* __restrict__ out,
             long long n_rows, long long dim, long long half) {
  const long long total = n_rows * half;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / half;
    const long long j = i - row * half;
    const int32_t* c = codes + row * dim;
    const int32_t lo = c[j];
    const int32_t hi = half + j < dim ? c[half + j] : 0;
    out[i] = (uint8_t)(lo | (hi << 4));
  }
}

__global__ void __launch_bounds__(kThreads)
unpack4_kernel(const uint8_t* __restrict__ packed, int32_t* __restrict__ out,
               long long n_rows, long long half, long long dim) {
  const long long total = n_rows * half;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / half;
    const long long j = i - row * half;
    const int32_t p = packed[i];
    int32_t* o = out + row * dim;
    if (j < dim) o[j] = p & 0xF;
    if (half + j < dim) o[half + j] = p >> 4;
  }
}

__global__ void __launch_bounds__(kThreads)
zero_kernel(float* __restrict__ out, long long total) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads)
    out[i] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
topk_scatter_kernel(const float* __restrict__ vals,
                    const int32_t* __restrict__ idx, float* __restrict__ out,
                    long long n_rows, long long k, long long dim) {
  const long long total = n_rows * k;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / k;
    const int32_t d = idx[i];
    if (d >= 0 && d < dim) atomicAdd(out + row * dim + d, vals[i]);
  }
}

}  // namespace

// codes (n_rows, dim) int32 -> out (n_rows, ceil(dim / 2)) uint8.
extern "C" int fedar_pack_codes4(const int32_t* codes, uint8_t* out,
                                 long long n_rows, long long dim,
                                 void* stream) {
  const long long half = (dim + 1) / 2;
  pack4_kernel<<<blocks_for(n_rows * half), kThreads, 0,
                 (cudaStream_t)stream>>>(codes, out, n_rows, dim, half);
  return (int)cudaGetLastError();
}

// packed (n_rows, half) uint8 -> out (n_rows, dim) int32, dim <= 2 * half.
extern "C" int fedar_unpack_codes4(const uint8_t* packed, int32_t* out,
                                   long long n_rows, long long half,
                                   long long dim, void* stream) {
  unpack4_kernel<<<blocks_for(n_rows * half), kThreads, 0,
                   (cudaStream_t)stream>>>(packed, out, n_rows, half, dim);
  return (int)cudaGetLastError();
}

// vals, idx (n_rows, k) -> out (n_rows, dim) float32, k >= 1.
extern "C" int fedar_topk_decode(const float* vals, const int32_t* idx,
                                 float* out, long long n_rows, long long k,
                                 long long dim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  zero_kernel<<<blocks_for(n_rows * dim), kThreads, 0, s>>>(out, n_rows * dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_scatter_kernel<<<blocks_for(n_rows * k), kThreads, 0, s>>>(
      vals, idx, out, n_rows, k, dim);
  return (int)cudaGetLastError();
}
