// Kernels 1 and 4's general instance (every shape the narrow plan and the
// wide instance refuse; local_sgd.cuh holds the design), in its own
// translation unit so that nvcc builds it beside the other two.
#include "local_sgd.cuh"

int local_sgd_general_launch(bool ragged, const float* g, const float* x, const int* y,
                             const int* act, const float* mask, const int* nb, const int* off,
                             const int* order, float* out, float* ws, int nclusters, int R,
                             int npad, int I, int H, int C, int B, int epochs, float lr,
                             void* stream) {
  const GPlan p = make_general_plan(I, H, C, B);
  if (p.K == 0 || nclusters < 1) return (int)cudaErrorInvalidValue;
  return ragged ? launch_general<true>(p, g, x, y, act, mask, nb, off, order, out, ws,
                                       nclusters, R, npad, I, H, C, B, epochs, lr, stream)
                : launch_general<false>(p, g, x, y, act, mask, nb, off, order, out, ws,
                                        nclusters, R, npad, I, H, C, B, epochs, lr, stream);
}

int local_sgd_general_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                            int* max_clusters) {
  const GPlan p = make_general_plan(I, H, C, B);
  if (p.K == 0) return (int)cudaErrorInvalidValue;
  auto kernel = local_sgd_general_kernel<false>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.K);
  cfg.blockDim = dim3((unsigned)kThreads);
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
