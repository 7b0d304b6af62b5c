// Kernels 1 and 4 (local_sgd.cuh holds the design): the narrow plan's
// instances (H <= 256) and the C interface the wrapper loads.
#include "local_sgd.cuh"

namespace {

template <bool kRagged>
int dispatch(const float* g, const float* x, const int* y, const int* act, const float* mask,
             const int* nb, const int* off, const int* order, float* out, int R, int npad,
             int I, int H, int C, int B, int epochs, float lr, void* stream) {
  const Plan p = make_plan(I, H, C, B);
  if (p.wide)
    return local_sgd_wide_launch(kRagged, g, x, y, act, mask, nb, off, order, out, R, npad, I,
                                 H, C, B, epochs, lr, stream);
  switch (p.HS) {
    case 8:
      return launch<kRagged, 8>(p, g, x, y, act, mask, nb, off, order, out, R, npad, I, H, C,
                                B, epochs, lr, stream);
    case 16:
      return launch<kRagged, 16>(p, g, x, y, act, mask, nb, off, order, out, R, npad, I, H,
                                 C, B, epochs, lr, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The cluster size K, the slice width HS, one CTA's threads, its dynamic
// shared bytes and whether w1 streams from L2 (the wide instance) for (I,
// H, C, B); -1 for a shape the kernel cannot take (I not a multiple of 4, H
// over 1,024, B over 20 past H = 256, C over 16).
extern "C" int fedar_local_sgd_plan(int I, int H, int C, int B, int* K, int* HS,
                                    int* threads, int* smem_bytes, int* streamed) {
  if (I < 4 || I % 4 != 0 || H < 1 || C < 1 || C > 16 || B < 1) return -1;
  const Plan p = make_plan(I, H, C, B);
  if (p.K == 0) return -1;
  *K = p.K;
  *HS = p.HS;
  *threads = kThreads;
  *smem_bytes = p.bytes;
  *streamed = p.wide;
  return 0;
}

extern "C" int fedar_local_sgd_attrs(int I, int H, int C, int B, int* regs,
                                     int* local_bytes, int* max_clusters) {
  const Plan p = make_plan(I, H, C, B);
  if (p.wide) return local_sgd_wide_attrs(I, H, C, B, regs, local_bytes, max_clusters);
  switch (p.HS) {
    case 8:
      return attrs<8>(p, regs, local_bytes, max_clusters);
    case 16:
      return attrs<16>(p, regs, local_bytes, max_clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fedar_local_sgd(const float* g, const float* x, const int* y,
                               const int* act, const float* mask, const int* order,
                               float* out, int R, int npad, int I, int H, int C, int B,
                               int epochs, float lr, void* stream) {
  return dispatch<false>(g, x, y, act, mask, nullptr, nullptr, order, out, R, npad, I, H, C,
                         B, epochs, lr, stream);
}

extern "C" int fedar_local_sgd_ragged(const float* g, const float* xt, const int* yt,
                                      const int* act, const float* mt, const int* nb,
                                      const int* off, const int* order, float* out, int R,
                                      int I, int H, int C, int B, int epochs, float lr,
                                      void* stream) {
  return dispatch<true>(g, xt, yt, act, mt, nb, off, order, out, R, 0, I, H, C, B, epochs,
                        lr, stream);
}
