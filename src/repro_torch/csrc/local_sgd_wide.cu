// Kernels 1 and 4's wide instance (257 <= H <= 1,024, B <= 20: w1 through a
// shared-memory ring, register tiles; local_sgd.cuh holds the design), in
// its own translation unit so that nvcc builds it beside the narrow plan's.
#include "local_sgd.cuh"

namespace {

template <bool kRagged>
int launch_wide(const WPlan& p, const float* g, const float* x, const int* y, const int* act,
                const float* mask, const int* nb, const int* off, const int* order, float* out,
                int R, int npad, int I, int H, int C, int B, int epochs, float lr,
                void* stream) {
  auto kernel = p.HS == 64 ? local_sgd_wide_kernel<kRagged, 64>
                           : local_sgd_wide_kernel<kRagged, 128>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * p.K));
  cfg.blockDim = dim3((unsigned)kWideThreads);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g, x, y, act, mask, nb, off, order, out, npad, I, H, C,
                           B, epochs, lr, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dense wide kernel's registers and spilled bytes a thread, and how
// many clusters of its K CTAs fit on the card at once.
int attrs_wide(const WPlan& p, int* regs, int* local_bytes, int* max_clusters) {
  auto kernel = p.HS == 64 ? local_sgd_wide_kernel<false, 64> : local_sgd_wide_kernel<false, 128>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.K);
  cfg.blockDim = dim3((unsigned)kWideThreads);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
}

}  // namespace

int local_sgd_wide_launch(bool ragged, const float* g, const float* x, const int* y,
                          const int* act, const float* mask, const int* nb, const int* off,
                          const int* order, float* out, int R, int npad, int I, int H, int C,
                          int B, int epochs, float lr, void* stream) {
  const WPlan p = wide_plan(I, H, C, B);
  if (!p.K) return (int)cudaErrorInvalidValue;
  return ragged ? launch_wide<true>(p, g, x, y, act, mask, nb, off, order, out, R, npad, I, H,
                                    C, B, epochs, lr, stream)
                : launch_wide<false>(p, g, x, y, act, mask, nb, off, order, out, R, npad, I, H,
                                     C, B, epochs, lr, stream);
}

int local_sgd_wide_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                         int* max_clusters) {
  const WPlan p = wide_plan(I, H, C, B);
  if (!p.K) return (int)cudaErrorInvalidValue;
  return attrs_wide(p, regs, local_bytes, max_clusters);
}
