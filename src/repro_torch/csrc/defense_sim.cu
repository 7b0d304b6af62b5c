// The defense's similarity block product: out = A @ B^T, A (M, K), B (N, K),
// out (M, N), fp32 in and out, fp32 accumulation.
//
// Replaces: src/repro/kernels/defense_sim.py::sketch_similarity (Pallas
// TPU; body _sim_kernel).
//
// What bounds it on an H100: K = r = 256 (foolsgold_sketch) at M = N = 12
// moves 25 KB and is launch-bound; at N = 512 it is 2*512*512*256 = 134
// MFLOP of fp32 on the CUDA cores (no tensor cores: the goldens are fp32).
// Dense FoolsGold has K = D = 101,770 at M = N = 12: 9.8 MB read for only
// 29 MFLOP, so it is bound by bytes, and a single output tile would walk
// all of K on one SM.
//
// What the design does about it: 16 x 16 output tiles, each thread one
// output, the K loop staged through padded shared-memory tiles (no bank
// conflicts on the transposed read).  K is split across the grid's z axis
// into `chunk`-wide slices (chosen by the caller so that the grid has about
// two blocks per SM); each slice writes its partial (M, N) block and a
// second kernel sums the slices in a fixed order, so the result is
// deterministic.  With one slice the first kernel writes the output
// directly.  Ragged M, N and K edges load zeros, so padded rows and columns
// never leak into the product.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
sim_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ part, int M, int N, int K, int chunk) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float bs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.y * kTile + ty;
  const int n = blockIdx.x * kTile + tx;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int am = blockIdx.y * kTile + ty;  // A row this thread loads
  const int bn = blockIdx.x * kTile + ty;  // B row this thread loads
  float acc = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    const int k = k0 + tx;
    as[ty][tx] = (am < M && k < k_end) ? A[(long long)am * K + k] : 0.f;
    bs[ty][tx] = (bn < N && k < k_end) ? B[(long long)bn * K + k] : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc += as[ty][kk] * bs[tx][kk];
    __syncthreads();
  }
  if (m < M && n < N) part[((long long)blockIdx.z * M + m) * N + n] = acc;
}

__global__ void sim_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int mn, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(long long)s * mn + i];
  out[i] = acc;
}

}  // namespace

// part: (splits, M, N) scratch, unused (may be null) when splits == 1.
extern "C" int fedar_sketch_similarity(const float* A, const float* B,
                                       float* out, float* part, int M, int N,
                                       int K, int chunk, void* stream) {
  const int splits = (K + chunk - 1) / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 block(kTile, kTile);
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  sim_partial_kernel<<<grid, block, 0, s>>>(A, B, splits == 1 ? out : part,
                                            M, N, K, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int mn = M * N;
  sim_reduce_kernel<<<(mn + 255) / 256, 256, 0, s>>>(part, out, mn, splits);
  return (int)cudaGetLastError();
}
