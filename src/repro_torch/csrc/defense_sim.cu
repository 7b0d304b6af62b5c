// The defense's similarity block product: out = A @ B^T, A (M, K), B (N, K),
// out (M, N), fp32 in and out, fp32 accumulation.
//
// Replaces: src/repro/kernels/defense_sim.py::sketch_similarity (Pallas
// TPU; body _sim_kernel).
//
// What bounds it on an H100: K = r = 256 (foolsgold_sketch) at M = N = 12
// moves 25 KB and is launch-bound; at N = 512 it is 2*512*512*256 = 134
// MFLOP of fp32 on the CUDA cores (no tensor cores: the goldens' band is
// 2e-4 and TF32 would not hold it), 2 us at the 67 TFLOP/s peak.  Dense
// FoolsGold has K = D = 101,770 at M = N = 12: 9.8 MB read for only 29
// MFLOP, so it is bound by bytes, and a single output tile would walk all
// of K on one SM.
//
// What the design does about it:
// - Register tiles: each thread computes a register tile of outputs from
//   float4s of 4 k read from shared rows.  For a large output a block
//   computes a 32 x 64 tile, 4 x 4 a thread: 8 shared loads feed 64 FMAs,
//   against two loads a FMA with one output a thread, and 512 x 512 is 128
//   blocks, one wave over the 132 SMs.  An output too small to fill the
//   card with those (the caller's `small`, e.g. 12 x 12) takes 16 x 16
//   tiles, 2 x 1 a thread, so no thread multiplies rows that do not exist
//   (at 12 x 256 the large tile alone is slower than cuBLAS, the small one
//   faster: PERF.md).  Each block is two groups of 128 threads that split
//   every K slice between them (8 warps an SM to hide latency) and add
//   their register tiles in group order at the end (one group alone only
//   ties cuBLAS at 512 x 256: PERF.md).
// - Loads in flight: K is staged in 32-wide slices through a ring of
//   shared buffers filled by cp.async (3 stages for the large tile, 8 for
//   the small one: at 12 x 256 the whole operand is in flight at once), so
//   later slices load while this one is multiplied; one __syncthreads a
//   slice.  Rows are padded to 36 words, so the 8 rows a quarter warp reads
//   as float4s sit in distinct banks.  cp.async copies 16, 8 or 4 bytes at
//   once, the widest that K's row pitch keeps aligned (K = 101,770 takes
//   8); its zero fill pads the ragged M, N and K edges.
// - Split-K: K is split across the grid's z axis into `chunk`-wide slices
//   (a multiple of 32, chosen by the caller so that the grid has about two
//   blocks per SM); each slice writes its partial (M, N) block and a second
//   kernel sums the slices, one warp an output, in an order fixed by the
//   number of slices alone, so the result is deterministic.  With one slice
//   the first kernel writes the output directly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 32;          // K slice per pipeline stage
constexpr int kPitch = kTK + 4;  // padded shared row, in floats
constexpr int kGroupThreads = 128;

// Copies `BYTES` (16, 8 or 4) from global to shared, or zeros when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// One block: a (8 RI) x (16 RJ) output tile, G groups of 128 threads.
// Thread t of a group owns rows ty + 8 i (i < RI) and columns tx + 16 j
// (j < RJ), ty = t / 16, tx = t % 16; group g multiplies columns
// [g kTK / G, (g + 1) kTK / G) of every K slice, and the groups' register
// tiles are summed in group order at the end.
template <int RI, int RJ, int G, int STAGES>
struct Tile {
  static constexpr int kM = 8 * RI;
  static constexpr int kN = 16 * RJ;
  static constexpr int kRows = kM + kN;  // A rows, then B rows, per stage
  static constexpr int kThreads = G * kGroupThreads;
  static constexpr int kStageFloats = kRows * kPitch;
  static constexpr int kKW = kTK / G;  // slice columns of one group
  static_assert(kKW % 4 == 0, "a group takes whole float4s");
  static_assert((G - 1) * RI * RJ * kGroupThreads <= STAGES * kStageFloats,
                "the groups' partial tiles fit in the ring");
};

// Stages K slice [k0, k0 + kTK) of the tile's A rows and B rows into one
// ring buffer; elements at or past k_end, or rows past M or N, are 0.
template <class T, int VEC>
__device__ __forceinline__ void load_slice(float* buf, const float* A, const float* B,
                                           int m0, int n0, int M, int N, int K, int k0,
                                           int k_end) {
  constexpr int kPerRow = kTK / VEC;
  for (int e = threadIdx.x; e < T::kRows * kPerRow; e += T::kThreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * VEC;
    const int k = k0 + c;
    const bool is_a = r < T::kM;
    const int row = is_a ? m0 + r : n0 + r - T::kM;
    const float* src = is_a ? A : B;
    const bool ok = row < (is_a ? M : N) && k < k_end;
    cp_async<VEC * 4>(buf + r * kPitch + c, ok ? src + (long long)row * K + k : src, ok);
  }
}

template <int RI, int RJ, int G, int STAGES, int VEC>
__global__ void __launch_bounds__(G * kGroupThreads)
sim_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ part, int M, int N, int K, int chunk) {
  using T = Tile<RI, RJ, G, STAGES>;
  __shared__ __align__(16) float ring[STAGES * T::kStageFloats];
  const int group = threadIdx.x / kGroupThreads;
  const int t = threadIdx.x % kGroupThreads;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * T::kM, n0 = blockIdx.x * T::kN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int n_slices = (k_end - k_begin + kTK - 1) / kTK;

  float acc[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices)
      load_slice<T, VEC>(ring + s * T::kStageFloats, A, B, m0, n0, M, N, K,
                         k_begin + s * kTK, k_end);
    cp_async_commit();  // an empty group keeps the count when n_slices is small
  }
  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait<STAGES - 2>();  // slice sl has landed
    __syncthreads();              // ... for every thread; slice sl - 1 is consumed
    const int nxt = sl + STAGES - 1;
    if (nxt < n_slices)
      load_slice<T, VEC>(ring + (nxt % STAGES) * T::kStageFloats, A, B, m0, n0, M, N, K,
                         k_begin + nxt * kTK, k_end);
    cp_async_commit();
    const float* a = ring + (sl % STAGES) * T::kStageFloats + group * T::kKW;
    const float* b = a + T::kM * kPitch;
#pragma unroll
    for (int kq = 0; kq < T::kKW; kq += 4) {
      float4 av[RI], bv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (ty + 8 * i) * kPitch + kq);
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kPitch + kq);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();

  if constexpr (G > 1) {
    // groups 1.. leave their tiles in the ring; group 0 adds them in order
    __syncthreads();
    float* red = ring;
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j)
          red[(((group - 1) * RI + i) * RJ + j) * kGroupThreads + t] = acc[i][j];
    }
    __syncthreads();
    if (group > 0) return;
#pragma unroll
    for (int g = 1; g < G; ++g)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j)
          acc[i][j] += red[(((g - 1) * RI + i) * RJ + j) * kGroupThreads + t];
  }

  float* dst = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) dst[(long long)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over the splits of part[s, i], one warp an output: lane l
// adds splits l, l + 32, ... in order, then a fixed shuffle tree.  The
// order depends on nothing but `splits`, so the result is deterministic.
__global__ void __launch_bounds__(256)
sim_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int mn,
                  int splits) {
  const int i = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = lane; s < splits; s += 32) acc += part[(long long)s * mn + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = acc;
}

template <int RI, int RJ, int G, int STAGES>
cudaError_t launch_partial(const float* A, const float* B, float* dst, int M, int N, int K,
                           int chunk, int splits, cudaStream_t s) {
  using T = Tile<RI, RJ, G, STAGES>;
  const dim3 grid((N + T::kN - 1) / T::kN, (M + T::kM - 1) / T::kM, splits);
  // the widest copy that every row start keeps aligned
  const uintptr_t addr = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B);
  if (K % 4 == 0 && addr % 16 == 0)
    sim_partial_kernel<RI, RJ, G, STAGES, 4><<<grid, T::kThreads, 0, s>>>(A, B, dst, M, N,
                                                                           K, chunk);
  else if (K % 2 == 0 && addr % 8 == 0)
    sim_partial_kernel<RI, RJ, G, STAGES, 2><<<grid, T::kThreads, 0, s>>>(A, B, dst, M, N,
                                                                           K, chunk);
  else
    sim_partial_kernel<RI, RJ, G, STAGES, 1><<<grid, T::kThreads, 0, s>>>(A, B, dst, M, N,
                                                                           K, chunk);
  return cudaGetLastError();
}

}  // namespace

// part: (splits, M, N) scratch, unused (may be null) when splits == 1;
// chunk a multiple of 32.  small != 0 picks the 16 x 16 tile (2 x 1 a
// thread, 8 stages in flight) for outputs too small to fill the card with
// 32 x 64 tiles (4 x 4 a thread, 3 stages).
extern "C" int fedar_sketch_similarity(const float* A, const float* B,
                                       float* out, float* part, int M, int N,
                                       int K, int chunk, int small, void* stream) {
  if (chunk <= 0 || chunk % kTK) return (int)cudaErrorInvalidValue;
  const int splits = (K + chunk - 1) / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = splits == 1 ? out : part;
  const cudaError_t err =
      small ? launch_partial<2, 1, 2, 8>(A, B, dst, M, N, K, chunk, splits, s)
            : launch_partial<4, 4, 2, 3>(A, B, dst, M, N, K, chunk, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int mn = M * N;
  sim_reduce_kernel<<<(mn + 7) / 8, 256, 0, s>>>(part, out, mn, splits);
  return (int)cudaGetLastError();
}
