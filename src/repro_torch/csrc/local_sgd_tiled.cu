// Kernels 1 and 4's tiled plan (H <= 256, a step's batch in sub-tiles of
// x; local_sgd.cuh holds the design), in its own translation unit so that
// nvcc builds it beside the other three.
#include "local_sgd.cuh"

int local_sgd_tiled_launch(bool ragged, const float* g, const float* x, const int* y,
                           const int* act, const float* mask, const int* nb, const int* off,
                           const int* order, float* out, int R, int npad, int I, int H, int C,
                           int B, int epochs, float lr, void* stream) {
  const Plan p = tiled_plan(I, H, C, B);
  switch (p.HS) {
    case 8:
      return ragged ? launch<true, 8, true>(p, g, x, y, act, mask, nb, off, order, out, R,
                                            npad, I, H, C, B, epochs, lr, stream)
                    : launch<false, 8, true>(p, g, x, y, act, mask, nb, off, order, out, R,
                                             npad, I, H, C, B, epochs, lr, stream);
    case 16:
      return ragged ? launch<true, 16, true>(p, g, x, y, act, mask, nb, off, order, out, R,
                                             npad, I, H, C, B, epochs, lr, stream)
                    : launch<false, 16, true>(p, g, x, y, act, mask, nb, off, order, out, R,
                                              npad, I, H, C, B, epochs, lr, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int local_sgd_tiled_attrs(int I, int H, int C, int B, int* regs, int* local_bytes,
                          int* max_clusters) {
  const Plan p = tiled_plan(I, H, C, B);
  switch (p.HS) {
    case 8:
      return attrs<8, true>(p, regs, local_bytes, max_clusters);
    case 16:
      return attrs<16, true>(p, regs, local_bytes, max_clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
