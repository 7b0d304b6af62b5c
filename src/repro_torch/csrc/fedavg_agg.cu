// Trust-weighted, staleness-decayed federated aggregation:
//   out[d] = sum_n w[n] * (1 + tau[n])^-1/2 * delta[n, d]
//
// Replaces: src/repro/kernels/fedavg_agg.py::fedavg_agg (Pallas TPU;
// body _agg_kernel).
//
// What bounds it on an H100: bytes.  It reads the (N, D) fp32 delta slab
// once (4*N*D bytes) and does 2 FLOPs per 4 bytes read.
//
// What the design does about it: a streaming column reduction.  Each thread
// owns one column d, neighbouring threads on neighbouring addresses, so
// every load of a warp is one coalesced 128-byte line; it walks the client
// axis in order and accumulates in fp32 in a register.  The per-client
// factor w[n] * (1 + tau[n])^-1/2 is computed once per block into shared
// memory, 256 clients at a time (tau = 0 when no staleness is given).  The
// ragged tail of D is masked, so D needs no padding.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedavg_agg_kernel(const float* __restrict__ deltas,
                  const float* __restrict__ weights,
                  const float* __restrict__ staleness, float* __restrict__ out,
                  int n_clients, long long dim) {
  __shared__ float wf[kThreads];
  const long long d = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  for (int n0 = 0; n0 < n_clients; n0 += kThreads) {
    const int n = n0 + threadIdx.x;
    __syncthreads();
    if (n < n_clients) {
      const float tau = staleness ? staleness[n] : 0.f;
      wf[threadIdx.x] = weights[n] / sqrtf(1.f + tau);
    }
    __syncthreads();
    const int cnt = min(kThreads, n_clients - n0);
    if (d < dim) {
      const float* col = deltas + (long long)n0 * dim + d;
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) acc += wf[j] * col[(long long)j * dim];
    }
  }
  if (d < dim) out[d] = acc;
}

}  // namespace

extern "C" int fedar_fedavg_agg(const float* deltas, const float* weights,
                                const float* staleness, float* out,
                                int n_clients, long long dim, void* stream) {
  const long long blocks = (dim + kThreads - 1) / kThreads;
  fedavg_agg_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      deltas, weights, staleness, out, n_clients, dim);
  return (int)cudaGetLastError();
}

// Message for an error code returned by any of the library's entry points.
extern "C" const char* fedar_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
