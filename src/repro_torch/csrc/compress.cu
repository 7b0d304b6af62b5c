// Uplink-compression codecs: 4-bit code packing, its inverse, and the
// top-k sparse -> dense decode.
//
// Replaces (Pallas TPU kernels in src/repro/kernels/compress.py):
//   pack_codes   (body _pack4_kernel)   -> pack4_kernel
//   unpack_codes (body _unpack4_kernel) -> unpack4_kernel
//   topk_decode  (body _topk_kernel, :118; pallas_call :150)
//                                        -> topk_decode_kernel
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
// - Top-k decode is one launch that writes every output byte once, from
//   shared memory, with no global atomic and no separate zero pass.  The
//   flat N * D output is cut into windows of W floats (W a multiple of 4,
//   so every window starts 16-byte aligned even where D * 4 is not, as at
//   D = 101,770).  A persistent grid walks the windows, each block
//   windows b, b + G, ...: it zeroes the window in shared memory, reads
//   the (value, index) pairs of every row the window spans (pairs of
//   neighbouring windows share rows, so these reads hit L2), adds each
//   pair that lands inside the window into shared memory (atomicAdd, which
//   sm_90a builds as a shared compare-and-swap loop, ATOMS.CAST.SPIN), and
//   writes the window out with one bulk copy (cp.async.bulk, shared ->
//   global) plus plain stores for the last window's remainder of up to 3
//   floats.  Two window buffers a block: the next window is zeroed and
//   scattered while the last one's copy drains.
//   Before a copy reads a buffer, every thread fences its shared writes
//   against the async proxy (fence.proxy.async.shared::cta) and the block
//   meets at a barrier; before a buffer is zeroed again, the thread that
//   issued its copy waits for that copy to have read it.  The TPU kernel
//   instead folds over k per column window (compare-and-accumulate); here
//   a window compares each pair once.  On the engine's path the indices of
//   a row are distinct (they come from top-k), so every element receives
//   at most one add to 0 and the result is exact.  Duplicate indices add:
//   two are still exact (0 + a + b == 0 + b + a); three or more may sum in
//   another order than the reference's left-to-right fold (a few ulp of
//   the sum).  Indices outside [0, D) are dropped, as the TPU kernel's
//   compare never matches them.  A non-finite value stays on its own
//   element, as in the reference's plain scatter-add (the TPU body's
//   acc + v * (i == col), as its arithmetic reads, spreads a NaN or an
//   inf over the row: NaN * 0 = inf * 0 = NaN).
// - Pack and unpack walk their flat index space with a grid-stride loop
//   in 64-bit indices, and the decode's window offsets are 64-bit, so
//   N * D beyond 2^31 is fine.
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

// top-k decode: a block's threads and window buffers, and the most
// dynamic shared memory the kernel may use (set once, below)
constexpr int kTopkThreads = 256;
constexpr int kTopkBuffers = 2;
constexpr int kTopkMaxSmem = 232448;
// groups of 4 pairs a thread loads before it adds any, so that several L2
// reads are in flight at once
constexpr int kTopkUnroll = 4;

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// add one pair into the window: column c of a row whose columns
// [lo, lo + span) fall in the window, at shared index shift + c
__device__ __forceinline__ void put(float* buf, int c, float v, int lo,
                                    unsigned span, int shift) {
  if ((unsigned)c - (unsigned)lo < span) atomicAdd(buf + (shift + c), v);
}

// every pair of one row: a scalar head up to the first 16-byte boundary, a
// body of float4 / int4 groups, a scalar tail (all scalar when vals and idx
// are not equally aligned)
__device__ __forceinline__ void scatter_row(float* buf,
                                            const float* __restrict__ v,
                                            const int32_t* __restrict__ ix,
                                            int k, int lo, unsigned span,
                                            int shift, bool vec) {
  const int tid = threadIdx.x;
  const int lead = (int)((reinterpret_cast<uintptr_t>(v) >> 2) & 3);
  const int head = vec ? min((4 - lead) & 3, k) : k;
  const int groups = (k - head) >> 2;
  for (int t = tid; t < head; t += kTopkThreads)
    put(buf, __ldg(ix + t), __ldg(v + t), lo, span, shift);
  for (int t = head + 4 * groups + tid; t < k; t += kTopkThreads)
    put(buf, __ldg(ix + t), __ldg(v + t), lo, span, shift);
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  const int4* i4 = reinterpret_cast<const int4*>(ix + head);
  for (int g0 = tid; g0 < groups; g0 += kTopkUnroll * kTopkThreads) {
    float4 vv[kTopkUnroll];
    int4 ii[kTopkUnroll];
#pragma unroll
    for (int u = 0; u < kTopkUnroll; ++u) {
      const int g = g0 + u * kTopkThreads;
      if (g < groups) {
        vv[u] = __ldg(v4 + g);
        ii[u] = __ldg(i4 + g);
      } else {
        ii[u] = make_int4(-1, -1, -1, -1);  // dropped: -1 is below any lo
        vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kTopkUnroll; ++u) {
      put(buf, ii[u].x, vv[u].x, lo, span, shift);
      put(buf, ii[u].y, vv[u].y, lo, span, shift);
      put(buf, ii[u].z, vv[u].z, lo, span, shift);
      put(buf, ii[u].w, vv[u].w, lo, span, shift);
    }
  }
}

__global__ void __launch_bounds__(kTopkThreads)
topk_decode_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   long long n_rows, int k, long long dim, int window,
                   long long windows) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const long long total = n_rows * dim;
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) ^
                     reinterpret_cast<uintptr_t>(idx)) & 15) == 0;
  int i = 0;
  for (long long w = blockIdx.x; w < windows; w += gridDim.x, ++i) {
    float* buf = smem + (i % kTopkBuffers) * window;
    // the copy issued two windows ago read this buffer: wait for it
    if (tid == 0 && i >= kTopkBuffers)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
    const long long w0 = w * window;
    const int len = (int)min((long long)window, total - w0);
    float4* b4 = reinterpret_cast<float4*>(buf);
    for (int j = tid; j < (len + 3) >> 2; j += kTopkThreads)
      b4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    const long long r0 = w0 / dim;
    const long long r1 = (w0 + len - 1) / dim;
    for (long long r = r0; r <= r1; ++r) {
      const long long rs = r * dim;  // the row's first flat index
      const int lo = (int)max(0LL, w0 - rs);
      const int hi = (int)min(dim, w0 + len - rs);
      scatter_row(buf, vals + r * k, idx + r * k, k, lo, (unsigned)(hi - lo),
                  (int)(rs - w0), vec);
    }
    // this thread's shared writes, ordered before the async proxy's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int body = len & ~3;
    if (tid == 0 && body > 0) bulk_store(out + w0, buf, body * 4);
    if (tid < len - body) out[w0 + body + tid] = buf[body + tid];
  }
  // shared memory must outlive the copies still reading it
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// vals, idx (n_rows, k) -> out (n_rows, dim) float32, k >= 1, out 16-byte
// aligned; window, blocks and smem_bytes from kernels/compress.py::topk_plan
// (smem_bytes holds the block's kTopkBuffers windows).
extern "C" int fedar_topk_decode(const float* vals, const int32_t* idx,
                                 float* out, long long n_rows, long long k,
                                 long long dim, int window, int blocks,
                                 int smem_bytes, void* stream) {
  if (window <= 0 || window % 4 || blocks <= 0 ||
      (long long)smem_bytes < (long long)kTopkBuffers * window * sizeof(float) ||
      smem_bytes > kTopkMaxSmem || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in, once for the process (one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      topk_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTopkMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long windows = (n_rows * dim + window - 1) / window;
  topk_decode_kernel<<<blocks, kTopkThreads, smem_bytes,
                       (cudaStream_t)stream>>>(vals, idx, out, n_rows, (int)k,
                                               dim, window, windows);
  return (int)cudaGetLastError();
}

// blocks of topk_decode_kernel an SM holds at smem_bytes, and its registers
extern "C" int fedar_topk_decode_attrs(int smem_bytes, int* blocks_per_sm,
                                       int* registers) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTopkMaxSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, topk_decode_kernel, kTopkThreads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, topk_decode_kernel);
  *registers = fa.numRegs;
  return (int)err;
}
