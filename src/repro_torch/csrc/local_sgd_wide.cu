// Kernels 1 and 4's wide instance (256 < H <= 1,024, w1 streamed from L2;
// local_sgd.cuh holds the design), in its own translation unit so that nvcc
// builds it beside the narrow plan's.
#include "local_sgd.cuh"

int local_sgd_wide_launch(bool ragged, const float* g, const float* x, const int* y,
                          const int* act, const float* mask, const int* nb, const int* off,
                          const int* order, float* out, int R, int npad, int I, int H, int C,
                          int B, int epochs, float lr, void* stream) {
  const Plan p = make_plan(I, H, C, B);
  if (!p.wide) return (int)cudaErrorInvalidValue;
  return ragged ? launch<true, 0>(p, g, x, y, act, mask, nb, off, order, out, R, npad, I, H,
                                  C, B, epochs, lr, stream)
                : launch<false, 0>(p, g, x, y, act, mask, nb, off, order, out, R, npad, I, H,
                                   C, B, epochs, lr, stream);
}

int local_sgd_wide_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                         int* max_clusters) {
  const Plan p = make_plan(I, H, C, B);
  if (!p.wide) return (int)cudaErrorInvalidValue;
  return attrs<0>(p, regs, local_bytes, max_clusters);
}
