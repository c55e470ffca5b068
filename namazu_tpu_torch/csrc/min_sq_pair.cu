// min_sq_pair.cu: the min-squared-distance kernels of the scorer.
//
// Replaces namazu_tpu/ops/pallas_score.py::min_sq_distance_pair_pallas
// (kernel body _pair_kernel; entry nmz_min_sq_pair_f32) and
// namazu_tpu/ops/pallas_score.py::min_sq_distance_pallas (kernel body
// _kernel; entry nmz_min_sq_f32). For each feature row f the pair kernel
// computes, in one pass over f,
//   nov[f] = min over archive rows a  of |f|^2 + |a|^2 - 2 f.a
//   bug[f] = min over failure rows g  of |f|^2 + |g|^2 - 2 f.g
// and the single kernel the first segment alone. Rows at or past a
// segment's occupancy get the norm 3.4e38 (they never win a min), and the
// results are clamped at >= 0. Both are one template, instantiated for
// one segment and for two.
//
// Bound on an H100 SXM at the pair kernel's main-path shape (N=16384,
// A=512, F=64, K=256): 2*N*(A+F)*K = 4.8 GFLOP of f32 multiply-add against
// ~17.4 MB of traffic (feats, both row sets and both outputs once), i.e.
// ~72 us at 67 TFLOP/s of non-tensor f32 against ~5 us at 3.35 TB/s; the
// single kernel at [16384, 512, 256] does 4.29 GFLOP, ~64 us. Both are
// bounded by arithmetic.
//
// Design. The TPU kernels walk a sequential grid and carry their running
// minima from one grid step to the next in the output block. Hopper blocks
// run in parallel and carry nothing, so here each block owns TN=64 feature
// rows and loops INSIDE the block over every column tile of its segments,
// keeping the running minima in registers. One pass over feats serves
// every minimum and no [N, A] matrix reaches device memory: the traffic is
// feats once, the segment rows once per block (they stay in L2), and the
// [N] outputs. Each of the 256 threads computes a 4x4 micro-tile of dot
// products by f32 FMA out of shared memory, so the arithmetic runs on the
// CUDA cores at full f32 precision, as the reference's CPU path does.
// Moving it to the tensor cores (bf16 or TF32 wgmma, TMA loads) is the
// kernels' redesign.
//
// The occupancies are read from device memory (int32[SEGMENTS]), so a
// later capture into a CUDA graph never bakes them in.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TN = 64;        // feature rows per block
constexpr int TC = 64;        // archive/failure rows per column tile
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // row padding that keeps float4 reads aligned
constexpr float MASK_BIG = 3.4e38f;

// One stage: rows [r0, r0 + 64) x depth [k0, k0 + BK) of a row-major
// [nrows, K] matrix into a k-major shared tile, zero past either edge.
__device__ __forceinline__ void stage_tile(float (*dst)[TN + PAD],
                                           const float* __restrict__ src,
                                           int r0, int nrows, int k0, int K,
                                           int tid) {
  constexpr int V = BK / 4;  // float4 loads per row of the stage
  for (int e = tid; e < TN * V; e += THREADS) {
    const int r = e / V;
    const int k = k0 + 4 * (e % V);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nrows && k < K)
      v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * K + k);
    const int kk = k - k0;
    dst[kk][r] = v.x;
    dst[kk + 1][r] = v.y;
    dst[kk + 2][r] = v.z;
    dst[kk + 3][r] = v.w;
  }
}

// SEGMENTS = 2: archive then failures, minima into nov and bug.
// SEGMENTS = 1: archive only, minimum into nov (failures, F and bug unused).
template <int SEGMENTS>
__global__ void __launch_bounds__(THREADS)
min_sq_kernel(const float* __restrict__ feats,
              const float* __restrict__ archive,
              const float* __restrict__ failures,
              const int* __restrict__ occ,
              float* __restrict__ nov, float* __restrict__ bug,
              int N, int A, int F, int K) {
  static_assert(SEGMENTS == 1 || SEGMENTS == 2, "one or two segments");
  static_assert(TN == TC, "stage_tile serves both tiles");
  __shared__ __align__(16) float fs[BK][TN + PAD];  // feats tile, k-major
  __shared__ __align__(16) float cs[BK][TC + PAD];  // column tile, k-major
  __shared__ float f2s[TN];
  __shared__ float c2s[TC];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns 4*tx .. 4*tx+3 of a column tile
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3 of the block's rows
  const int row0 = blockIdx.x * TN;
  const int live_a = min(max(occ[0], 0), A);
  const int live_f = SEGMENTS == 2 ? min(max(occ[1], 0), F) : 0;
  const int tiles_a = (A + TC - 1) / TC;
  const int tiles = tiles_a + (SEGMENTS == 2 ? (F + TC - 1) / TC : 0);

  float best_nov[4], best_bug[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_nov[i] = INFINITY;
    best_bug[i] = INFINITY;
  }

  for (int t = 0; t < tiles; ++t) {
    const bool is_arch = t < tiles_a;
    const float* rows = is_arch ? archive : failures;
    const int nrows = is_arch ? A : F;
    const int live = is_arch ? live_a : live_f;
    const int col0 = (is_arch ? t : t - tiles_a) * TC;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // threads [0, TC) sum a column row's norm; threads [TC, TC + TN) sum
    // a feature row's norm, on the first tile only
    float norm = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      stage_tile(fs, feats, row0, N, k0, K, tid);
      stage_tile(cs, rows, col0, nrows, k0, K, tid);
      __syncthreads();
      if (tid < TC) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          norm = fmaf(cs[kk][tid], cs[kk][tid], norm);
      } else if (tid < TC + TN && t == 0) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          norm = fmaf(fs[kk][tid - TC], fs[kk][tid - TC], norm);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&fs[kk][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    if (tid < TC)
      c2s[tid] = (col0 + tid < live) ? norm : MASK_BIG;
    else if (tid < TC + TN && t == 0)
      f2s[tid - TC] = norm;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f2 = f2s[4 * ty + i];
      float m = INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m = fminf(m, f2 + c2s[4 * tx + j] - 2.f * acc[i][j]);
      if (is_arch)
        best_nov[i] = fminf(best_nov[i], m);
      else
        best_bug[i] = fminf(best_bug[i], m);
    }
    __syncthreads();  // c2s is rewritten by the next tile
  }

  // the 16 threads of a row group (one half-warp) each hold a partial min
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      best_nov[i] = fminf(best_nov[i],
                          __shfl_xor_sync(0xffffffffu, best_nov[i], off));
      if (SEGMENTS == 2)
        best_bug[i] = fminf(best_bug[i],
                            __shfl_xor_sync(0xffffffffu, best_bug[i], off));
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * ty + i;
      if (r < N) {
        nov[r] = fmaxf(best_nov[i], 0.f);
        if (SEGMENTS == 2) bug[r] = fmaxf(best_bug[i], 0.f);
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 =
// launched). Takes f32 row-major contiguous feats [N, K], archive [A, K],
// failures [F, K] with K % 4 == 0 and 16-byte aligned rows, occ int32[2],
// and writes nov [N], bug [N]. Allocates nothing and does not synchronise.
extern "C" int nmz_min_sq_pair_f32(const float* feats, const float* archive,
                                   const float* failures, const int* occ,
                                   float* nov, float* bug, int N, int A,
                                   int F, int K, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + TN - 1) / TN;
  min_sq_kernel<2><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, archive, failures, occ, nov, bug, N, A, F, K);
  return static_cast<int>(cudaGetLastError());
}

// The single-segment kernel: min over archive rows only. Takes f32
// row-major contiguous feats [N, K], archive [A, K] (K % 4 == 0, 16-byte
// aligned rows) and occ int32[1] (valid_n), writes out [N]. Same launch
// contract as nmz_min_sq_pair_f32.
extern "C" int nmz_min_sq_f32(const float* feats, const float* archive,
                              const int* occ, float* out, int N, int A,
                              int K, void* stream) {
  if (N <= 0) return 0;
  const int blocks = (N + TN - 1) / TN;
  min_sq_kernel<1><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, archive, nullptr, occ, out, nullptr, N, A, 0, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nmz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
