// The defense's count sketch in a fixed summation order:
//   out[n, b] = sum over d with bucket[d] == b of sign[d] * rows[n, d]
//
// Replaces no TPU kernel: the reference sketches with an XLA scatter
// (src/repro/core/defense.py, ``.at[:, bucket].add``).  A scatter-add on
// the card (``index_add_``) adds in an order that varies from run to run,
// and the port's resumed cohort runs must be bit-equal to uninterrupted
// ones, so every output here sums in an order fixed by the tables alone.
//
// What bounds it on an H100: bytes.  It reads the (N, D) fp32 rows once,
// 2.25 table bytes a coordinate, and writes (N, r).
//
// Tables (built once per model by ``kernels/count_sketch.py``): D is cut
// into chunks of kChunk coordinates.  ``ent`` lists each chunk's
// coordinates sorted by bucket (ascending coordinate within a bucket) as
// the offset within the chunk, bit 15 set where the sign is -1; ``start``
// (chunks, r + 1) holds where each bucket's run begins in its chunk.
//
// Design: pass 1 gives each block a fixed segment of consecutive chunks
// and a tile of kRows rows.  Per chunk it loads the rows' chunk, the
// entries and the run starts into shared memory (coalesced), then thread b
// walks bucket b's run in table order, summing the signed values of all
// kRows rows, and adds the chunk's sum to its own accumulator.  Each
// accumulator has one owner, so its order is the table's.  Pass 2 sums the
// segments' partials of each output in segment order: 8 lanes a column
// stride over the segments, then lane 0 adds the 8 lane sums in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;  // kernels/count_sketch.py SKETCH_CHUNK
constexpr int kRows = 4;      // rows a block (SKETCH_ROWS)
constexpr int kThreads = 256;
constexpr int kLanes = 8;     // pass 2: lanes a column

size_t smem_bytes(int r) {
  return sizeof(float) * (size_t)(kRows * kChunk + kRows * r) +
         sizeof(uint16_t) * kChunk + sizeof(int16_t) * (size_t)(r + 1);
}

__global__ void __launch_bounds__(kThreads)
count_sketch_partial_kernel(const float* __restrict__ rows, int n_rows,
                            long long dim, const uint16_t* __restrict__ ent,
                            const int16_t* __restrict__ start, int r,
                            long long n_chunks, int per_seg,
                            float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kRows][kChunk]
  float* acc = xs + kRows * kChunk;            // [kRows][r]
  uint16_t* es = reinterpret_cast<uint16_t*>(acc + kRows * r);
  int16_t* ss = reinterpret_cast<int16_t*>(es + kChunk);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nr = min(kRows, n_rows - row0);
  for (int i = tid; i < kRows * r; i += kThreads) acc[i] = 0.f;
  // a tile's missing rows read zeros; their sums are never stored
  for (int i = nr * kChunk + tid; i < kRows * kChunk; i += kThreads) xs[i] = 0.f;
  const long long c0 = (long long)blockIdx.x * per_seg;
  const long long c1 = min(n_chunks, c0 + per_seg);
  for (long long c = c0; c < c1; ++c) {
    const long long base = c * kChunk;
    const int len = (int)min((long long)kChunk, dim - base);
    __syncthreads();  // the previous chunk's readers are done
    for (int t = 0; t < nr; ++t) {
      const float* src = rows + (long long)(row0 + t) * dim + base;
      for (int i = tid; i < len; i += kThreads) xs[t * kChunk + i] = __ldcs(src + i);
    }
    for (int i = tid; i < len; i += kThreads) es[i] = ent[base + i];
    for (int i = tid; i <= r; i += kThreads) ss[i] = start[c * (r + 1) + i];
    __syncthreads();
    for (int b = tid; b < r; b += kThreads) {
      const int lo = ss[b], hi = ss[b + 1];
      float s[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t) s[t] = 0.f;
      for (int j = lo; j < hi; ++j) {
        const uint32_t e = es[j];
        const int off = (int)(e & 0x7FFFu);
        const uint32_t neg = (e & 0x8000u) << 16;  // the sign bit of a float
#pragma unroll
        for (int t = 0; t < kRows; ++t)
          s[t] += __uint_as_float(__float_as_uint(xs[t * kChunk + off]) ^ neg);
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) acc[t * r + b] += s[t];
    }
  }
  // each accumulator is read back by the thread that wrote it
  for (int t = 0; t < nr; ++t)
    for (int b = tid; b < r; b += kThreads)
      partial[((long long)blockIdx.x * n_rows + row0 + t) * r + b] = acc[t * r + b];
}

__global__ void __launch_bounds__(32 * kLanes)
count_sketch_reduce_kernel(const float* __restrict__ partial, int segs, int outs,
                           float* __restrict__ out) {
  __shared__ float red[kLanes][33];
  const int x = threadIdx.x & 31, lane = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + x;
  float s = 0.f;
  if (o < outs)
    for (int g = lane; g < segs; g += kLanes) s += partial[(long long)g * outs + o];
  red[lane][x] = s;
  __syncthreads();
  if (lane == 0 && o < outs) {
    float t = red[0][x];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) t += red[l][x];
    out[o] = t;
  }
}

}  // namespace

// rows (n_rows, dim) fp32 row-major; out (n_rows, r); partial (segs,
// n_rows, r) scratch, unused when segs == 1.  Chunk c belongs to segment
// c / per_seg.
extern "C" int fedar_count_sketch(const float* rows, const uint16_t* ent,
                                  const int16_t* start, float* out, float* partial,
                                  int n_rows, long long dim, int r, int segs,
                                  int per_seg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long n_chunks = (dim + kChunk - 1) / kChunk;
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(
      count_sketch_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)segs, (unsigned)((n_rows + kRows - 1) / kRows));
  count_sketch_partial_kernel<<<grid, kThreads, smem, s>>>(
      rows, n_rows, dim, ent, start, r, n_chunks, per_seg, segs == 1 ? out : partial);
  if (segs > 1) {
    const int outs = n_rows * r;
    count_sketch_reduce_kernel<<<(outs + 31) / 32, 32 * kLanes, 0, s>>>(
        partial, segs, outs, out);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared bytes a block of pass 1 takes at r buckets.
extern "C" long long fedar_count_sketch_smem(int r) { return (long long)smem_bytes(r); }
