// Kernels 1 and 4 (local_sgd.cuh holds the design): the narrow plan's
// instances (H <= 256) and the C interface the wrapper loads, which routes
// a shape to the narrow plan, the wide instance, the tiled plan or the
// general instance, in that order.
#include "local_sgd.cuh"

namespace {

// Whether the narrow plan takes (I, H, C, B): rows of whole 16-byte units,
// C at most 16, a plan with a cluster, and its shared bytes within a
// block's.
bool fixed_plan(int I, int H, int C, int B, Plan* p) {
  if (!bulk_shapes(I, H, C, B)) return false;
  *p = make_plan(I, H, C, B);
  return p->K != 0 && p->bytes <= kMaxSmemBytes;
}

template <bool kRagged>
int dispatch(const float* g, const float* x, const int* y, const int* act, const float* mask,
             const int* nb, const int* off, const int* order, float* out, float* ws,
             int nclusters, int R, int npad, int I, int H, int C, int B, int epochs, float lr,
             void* stream) {
  Plan p;
  if (!fixed_plan(I, H, C, B, &p)) {
    if (wide_plan(I, H, C, B).K)
      return local_sgd_wide_launch(kRagged, g, x, y, act, mask, nb, off, order, out, R, npad,
                                   I, H, C, B, epochs, lr, stream);
    if (tiled_plan(I, H, C, B).K)
      return local_sgd_tiled_launch(kRagged, g, x, y, act, mask, nb, off, order, out, R, npad,
                                    I, H, C, B, epochs, lr, stream);
    return local_sgd_general_launch(kRagged, g, x, y, act, mask, nb, off, order, out, ws,
                                    nclusters, R, npad, I, H, C, B, epochs, lr, stream);
  }
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

// The plan of (I, H, C, B): its instance (0 the narrow plan, 1 the wide
// instance, 2 the general instance, 3 the tiled plan), cluster size K,
// slice width HS, one CTA's threads and dynamic shared bytes, whether w1
// streams from L2, the batch rows a sub-tile (B for the narrow plan and the
// wide instance), the wide instance's ring slots (0 for the others) and the
// floats of one cluster's workspace slot (the general instance; 0 for the
// others); -1 for a shape no instance takes (a dimension under 1, or a slot
// or an output row past 2^31 floats).
extern "C" int fedar_local_sgd_plan(int I, int H, int C, int B, int* instance, int* K,
                                    int* HS, int* threads, int* smem_bytes, int* streamed,
                                    int* rows, int* ring, long long* ws_floats) {
  Plan p;
  const bool fixed = fixed_plan(I, H, C, B, &p);
  const WPlan w = fixed ? WPlan{} : wide_plan(I, H, C, B);
  if (!fixed && !w.K) p = tiled_plan(I, H, C, B);
  *threads = kThreads;
  *ring = 0;
  *ws_floats = 0;
  if (w.K) {
    *instance = 1;
    *K = w.K;
    *HS = w.HS;
    *smem_bytes = w.bytes;
    *streamed = 1;
    *rows = B;
    *ring = w.NS;
    *threads = kWideThreads;
  } else if (p.K) {
    *instance = fixed ? 0 : 3;
    *K = p.K;
    *HS = p.HS;
    *smem_bytes = p.bytes;
    *streamed = 0;
    *rows = fixed ? B : p.Bp;
  } else {
    const GPlan q = make_general_plan(I, H, C, B);
    if (q.K == 0) return -1;
    *instance = 2;
    *K = q.K;
    *HS = q.HS;
    *smem_bytes = q.bytes;
    *streamed = 1;
    *rows = q.BT;
    *ws_floats = q.slot;
  }
  return 0;
}

extern "C" int fedar_local_sgd_attrs(int I, int H, int C, int B, int* regs,
                                     int* local_bytes, int* max_clusters) {
  Plan p;
  if (!fixed_plan(I, H, C, B, &p)) {
    if (wide_plan(I, H, C, B).K)
      return local_sgd_wide_attrs(I, H, C, B, regs, local_bytes, max_clusters);
    if (tiled_plan(I, H, C, B).K)
      return local_sgd_tiled_attrs(I, H, C, B, regs, local_bytes, max_clusters);
    return local_sgd_general_attrs(I, H, C, B, regs, local_bytes, max_clusters);
  }
  switch (p.HS) {
    case 8:
      return attrs<8>(p, regs, local_bytes, max_clusters);
    case 16:
      return attrs<16>(p, regs, local_bytes, max_clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ws / nclusters: the general instance's workspace (nclusters slots of the
// plan's ws_floats) and its grid in clusters; unused by the other three.
extern "C" int fedar_local_sgd(const float* g, const float* x, const int* y,
                               const int* act, const float* mask, const int* order,
                               float* out, float* ws, int nclusters, int R, int npad, int I,
                               int H, int C, int B, int epochs, float lr, void* stream) {
  return dispatch<false>(g, x, y, act, mask, nullptr, nullptr, order, out, ws, nclusters, R,
                         npad, I, H, C, B, epochs, lr, stream);
}

extern "C" int fedar_local_sgd_ragged(const float* g, const float* xt, const int* yt,
                                      const int* act, const float* mt, const int* nb,
                                      const int* off, const int* order, float* out,
                                      float* ws, int nclusters, int R, int I, int H, int C,
                                      int B, int epochs, float lr, void* stream) {
  return dispatch<true>(g, xt, yt, act, mt, nb, off, order, out, ws, nclusters, R, 0, I, H, C,
                        B, epochs, lr, stream);
}
