// Fused masked local SGD for the FedAR client MLP (784 -> H -> 10), one
// thread block per client, in two forms built from one template:
//
//   local_sgd_kernel<false>  the dense (R, npad) sample rectangle
//   local_sgd_kernel<true>   the ragged batch-tile buffer of the packed
//                            layout: client r walks its own nb[r] tiles
//                            from tile off[r]
//
// Replaces: src/repro/kernels/local_sgd.py::local_sgd_fused (Pallas TPU;
// body _sgd_kernel and _batch_body) and ::local_sgd_fused_ragged (body
// _ragged_kernel).  Each client runs E epochs x its batches of forward,
// hand-written backward and SGD update; the hidden activation is ReLU or
// softmax per client (Table II); the loss gradient is
// (softmax - onehot) * m / max(sum m, 1); a batch whose mask count is zero
// is skipped, like pl.when(cnt > 0).
//
// The ragged TPU kernel walks a (client, epoch, batch) grid up to the
// widest client's batch count and skips the steps past nb[i], a TPU idiom
// for keeping params resident in VMEM over a sequential grid.  Here the
// ragged form is the dense block-per-client walk with a per-client tile
// source: block r loops t < epochs * nb[r] over tile off[r] + t % nb[r].
// The batch step is the same code in both forms, so a client's rows come
// out bit-equal whether its tiles are read from the ragged buffer or from
// the rectangle (all-masked batches are skipped in both, and masked
// samples add exact zeros).
//
// What bounds it on an H100: the steps of one client are sequential, so the
// TPU's sequential grid becomes a loop inside one block and only R blocks
// (R clients) ever run; the slowest block, the client with the most
// batches, sets the kernel's time.  Each step does ~4*B*I*H FLOPs of fp32
// CUDA-core work, but it is latency-bound on the w1 traffic: at H = 128,
// fp32 w1 is 784*128*4 = 401 KB, more than the 227 KB of shared memory a
// block can hold, so every step streams w1 from L2 several times (at B = 20
// three forward reads, one per 8-row tile, and the update's
// read-modify-write).
//
// What the design does about it: the working w1 lives in the client's own
// output row in global memory, where it stays L2-resident (12 clients x
// 401 KB = 4.8 MB of the 50 MB L2); everything else of the step lives in
// shared memory: the batch slab x (B x I, 63 KB at B = 20), the activations
// hpre / h / dh, the logits, and the small leaves w2, b1, b2 (copied in
// once, written out once).  The forward product reads each w1 column once
// per group of kRows batch rows (register tile), the update touches each
// w1 element once.  __syncthreads() separates the phases of a step, so
// every step sees the previous step's update.  Known limits: R = 12 clients
// fill 12 of 132 SMs; a long client is one block's sequential chain; the x
// tile of an all-masked batch is loaded before its count is known.  Later
// designs split a client over a thread-block cluster with an H-slice of w1
// in each block's shared memory.
//
// Layouts (all fp32 unless noted, row-major, contiguous):
//   g      (D,)          global params, flat order b1 | b2 | w1 | w2
//   dense:  x (R, npad, I) samples, npad = nb * B (zero-padded tail);
//           y (R, npad) int32 labels; mask (R, npad) validity
//   ragged: x (T, B, I) batch tiles; y (T, B) int32; mask (T, B);
//           nb, off (R,) int32 batch count and first tile of each client
//   act    (R,)          int32, 1 = softmax hidden, else ReLU
//   out    (R, D)        post-SGD params, same flat order as g
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 8;  // batch rows per thread in the hidden-layer product
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kRagged>
__global__ void __launch_bounds__(kThreads)
local_sgd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 const int* __restrict__ y, const int* __restrict__ act,
                 const float* __restrict__ mask, const int* __restrict__ nbs,
                 const int* __restrict__ offs, float* __restrict__ out,
                 int npad, int I, int H, int C, int B, int epochs, float lr) {
  extern __shared__ float smem[];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = (B + kRows - 1) / kRows;
  const int Bp = groups * kRows;  // x slab rows, zero-padded to the tile
  const long long D = (long long)H + C + (long long)I * H + (long long)H * C;

  float* xs = smem;              // Bp * I
  float* hpre = xs + Bp * I;     // B * H
  float* hact = hpre + B * H;    // B * H
  float* dh = hact + B * H;      // B * H (dh, then d hpre)
  float* lg = dh + B * H;        // B * C (logits, then d logits)
  float* w2s = lg + B * C;       // H * C
  float* b1s = w2s + H * C;      // H
  float* b2s = b1s + H;          // C
  float* ms = b2s + C;           // B
  int* ys = reinterpret_cast<int*>(ms + B);  // B

  const float* gb1 = g;
  const float* gb2 = g + H;
  const float* gw1 = g + H + C;
  const float* gw2 = gw1 + (long long)I * H;
  float* orow = out + (long long)r * D;
  float* w1 = orow + H + C;  // this client's working w1, updated in place

  for (long long k = tid; k < (long long)I * H; k += kThreads) w1[k] = gw1[k];
  for (int k = tid; k < H * C; k += kThreads) w2s[k] = gw2[k];
  for (int k = tid; k < H; k += kThreads) b1s[k] = gb1[k];
  for (int k = tid; k < C; k += kThreads) b2s[k] = gb2[k];
  for (int k = B * I + tid; k < Bp * I; k += kThreads) xs[k] = 0.f;
  const bool soft = act[r] == 1;
  // the client's batch count and the sample row its batch 0 starts at
  const int nb = kRagged ? nbs[r] : npad / B;
  const long long first = kRagged ? (long long)offs[r] * B : (long long)r * npad;
  __syncthreads();

  for (int t = 0; t < epochs * nb; ++t) {
    const long long row0 = first + (long long)(t % nb) * B;
    const float* xsrc = x + row0 * I;
    for (int k = tid; k < B * I; k += kThreads) xs[k] = xsrc[k];
    for (int k = tid; k < B; k += kThreads) {
      ms[k] = mask[row0 + k];
      ys[k] = y[row0 + k];
    }
    __syncthreads();
    float cnt = 0.f;
    for (int b = 0; b < B; ++b) cnt += ms[b];
    if (cnt > 0.f) {  // uniform over the block: every thread summed ms
      // hpre = x @ w1 + b1: one w1 column read per kRows batch rows
      for (int item = tid; item < H * groups; item += kThreads) {
        const int h = item % H;
        const int b0 = (item / H) * kRows;
        float acc[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
        const float* xr = xs + b0 * I;
#pragma unroll 4
        for (int i = 0; i < I; ++i) {
          const float w = w1[(long long)i * H + h];
#pragma unroll
          for (int q = 0; q < kRows; ++q) acc[q] += xr[q * I + i] * w;
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (b0 + q < B) hpre[(b0 + q) * H + h] = acc[q] + b1s[h];
      }
      __syncthreads();
      // Table II hidden activation, one warp per batch row
      for (int b = warp; b < B; b += kWarps) {
        const float* hp = hpre + b * H;
        float* ha = hact + b * H;
        if (soft) {
          float mx = -INFINITY;
          for (int h = lane; h < H; h += 32) mx = fmaxf(mx, hp[h]);
          mx = warp_max(mx);
          float s = 0.f;
          for (int h = lane; h < H; h += 32) s += expf(hp[h] - mx);
          s = warp_sum(s);
          for (int h = lane; h < H; h += 32) ha[h] = expf(hp[h] - mx) / s;
        } else {
          for (int h = lane; h < H; h += 32) ha[h] = fmaxf(hp[h], 0.f);
        }
      }
      __syncthreads();
      // logits = h @ w2 + b2
      for (int item = tid; item < B * C; item += kThreads) {
        const int b = item / C, c = item % C;
        float acc = 0.f;
        for (int h = 0; h < H; ++h) acc += hact[b * H + h] * w2s[h * C + c];
        lg[item] = acc + b2s[c];
      }
      __syncthreads();
      // d logits = (softmax - onehot) * m / max(cnt, 1), one thread per row
      for (int b = tid; b < B; b += kThreads) {
        float* l = lg + b * C;
        float mx = -INFINITY;
        for (int c = 0; c < C; ++c) mx = fmaxf(mx, l[c]);
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += expf(l[c] - mx);
        const float scale = ms[b] / fmaxf(cnt, 1.f);
        for (int c = 0; c < C; ++c) {
          const float p = expf(l[c] - mx) / s;
          l[c] = (p - (c == ys[b] ? 1.f : 0.f)) * scale;
        }
      }
      __syncthreads();
      // dh = d logits @ w2^T (reads the pre-update w2)
      for (int item = tid; item < B * H; item += kThreads) {
        const int b = item / H, h = item % H;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc += lg[b * C + c] * w2s[h * C + c];
        dh[item] = acc;
      }
      __syncthreads();
      // w2 -= lr * h^T @ d logits ; b2 -= lr * sum_b d logits
      for (int item = tid; item < H * C + C; item += kThreads) {
        if (item < H * C) {
          const int h = item / C, c = item % C;
          float acc = 0.f;
          for (int b = 0; b < B; ++b) acc += hact[b * H + h] * lg[b * C + c];
          w2s[item] -= lr * acc;
        } else {
          const int c = item - H * C;
          float acc = 0.f;
          for (int b = 0; b < B; ++b) acc += lg[b * C + c];
          b2s[c] -= lr * acc;
        }
      }
      // back through the hidden activation, in place, one warp per row
      for (int b = warp; b < B; b += kWarps) {
        float* d = dh + b * H;
        const float* ha = hact + b * H;
        const float* hp = hpre + b * H;
        if (soft) {
          float dot = 0.f;
          for (int h = lane; h < H; h += 32) dot += d[h] * ha[h];
          dot = warp_sum(dot);
          for (int h = lane; h < H; h += 32) d[h] = ha[h] * (d[h] - dot);
        } else {
          for (int h = lane; h < H; h += 32) d[h] = hp[h] > 0.f ? d[h] : 0.f;
        }
      }
      __syncthreads();
      // w1 -= lr * x^T @ d hpre (each element once) ; b1 -= lr * sum_b
      for (long long item = tid; item < (long long)I * H; item += kThreads) {
        const int i = (int)(item / H), h = (int)(item % H);
        float acc = 0.f;
        for (int b = 0; b < B; ++b) acc += xs[b * I + i] * dh[b * H + h];
        w1[item] -= lr * acc;
      }
      for (int h = tid; h < H; h += kThreads) {
        float acc = 0.f;
        for (int b = 0; b < B; ++b) acc += dh[b * H + h];
        b1s[h] -= lr * acc;
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < H; k += kThreads) orow[k] = b1s[k];
  for (int k = tid; k < C; k += kThreads) orow[H + k] = b2s[k];
  float* ow2 = w1 + (long long)I * H;
  for (int k = tid; k < H * C; k += kThreads) ow2[k] = w2s[k];
}

}  // namespace

extern "C" int fedar_local_sgd_smem_bytes(int I, int H, int C, int B) {
  const int Bp = (B + kRows - 1) / kRows * kRows;
  return (Bp * I + 3 * B * H + B * C + H * C + H + C + 2 * B) * 4;
}

extern "C" int fedar_local_sgd(const float* g, const float* x, const int* y,
                               const int* act, const float* mask, float* out,
                               int R, int npad, int I, int H, int C, int B,
                               int epochs, float lr, int smem_bytes,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      local_sgd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  local_sgd_kernel<false><<<R, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      g, x, y, act, mask, nullptr, nullptr, out, npad, I, H, C, B, epochs, lr);
  return (int)cudaGetLastError();
}

extern "C" int fedar_local_sgd_ragged(const float* g, const float* xt,
                                      const int* yt, const int* act,
                                      const float* mt, const int* nb,
                                      const int* off, float* out, int R, int I,
                                      int H, int C, int B, int epochs, float lr,
                                      int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      local_sgd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  local_sgd_kernel<true><<<R, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      g, xt, yt, act, mt, nb, off, out, 0, I, H, C, B, epochs, lr);
  return (int)cudaGetLastError();
}
