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
// Precision. The cross term f.a runs on the tensor cores in split TF32
// ("3xTF32"): x = hi + lo with hi = tf32_rna(x), lo = tf32_rna(x - hi), and
// f.a ~ hi.hi' + hi.lo' + lo.hi' accumulated in f32, one 32-deep box at a
// time on the tensor cores, those partials summed on the CUDA cores (the
// tensor cores' own accumulation truncates). Every coordinate is shifted
// by -1/2 first: d2 is translation invariant, and for features in (0, 1)
// the sums the f32 arithmetic carries shrink 2-4x, their rounding errors
// with them. That keeps the result within a few 1e-5 of exact arithmetic
// even where d2 cancels to 0; one TF32 pass would be off by ~1e-2. Row
// norms are f32 FMA on the CUDA cores, summed per box, then across boxes.
//
// Bound on an H100 SXM at the pair kernel's main-path shape (N=16384,
// A=512, F=64, K=256): 3 * 2*N*(A+F)*K = 14.5 GFLOP of TF32 tensor work,
// 29.3 us at 495 TFLOP/s, against ~17.4 MB of traffic (feats, both row
// sets and both outputs once), 5.2 us at 3.35 TB/s: bounded by the tensor
// cores. The single kernel at [16384, 512, 256]: 12.9 GFLOP, 26.0 us.
//
// Design. The TPU kernels walk a sequential grid and carry their running
// minima in the output block. Hopper blocks run in parallel, so each block
// owns 64 * C feature rows (C = 1 or 2 consumer warpgroups, as the host
// plan says: 2 where the row tiles fill the card and the tile fits) and
// loops inside the block over column tiles of its segments, the running
// minima in registers. Warp specialisation:
//  - the feature tile [64C, K] arrives once by TMA (128-byte swizzle) and
//    stays resident in shared memory for every column tile;
//  - producer warp 0 streams 64-row x 32-deep column boxes by TMA into a
//    4-stage ring, each stage with a full and an empty mbarrier;
//  - producer warps 1-2 split each landed box in place into TF32 hi and a
//    second lo buffer (same swizzled layout: the split is elementwise),
//    sum the column rows' norms, and release the stage on a ready mbarrier;
//  - each consumer warpgroup loads its 64 rows' A fragments from the
//    resident tile, splits them in registers and issues
//    wgmma.m64n64k8.tf32 three times per k-step (A from registers, B hi
//    and lo from shared memory) into a partial per box that it adds to
//    the tile's f32 sums, then folds the 64 x 64 tile into its minima:
//    f2 + c2 - 2 cross, min over its columns, later across the four
//    lanes of a quad. Warpgroup 1 issues each box after warpgroup 0, so
//    the tensor cores run their wgmmas back to back.
// No [N, A] matrix reaches device memory: the traffic is feats once, the
// column rows once per block (they stay in L2), and the [N] outputs.
//
// The split. A block's time follows the (column tile, k box) steps it
// walks, ~1.15 us each with two consumer warpgroups, and one block runs
// on an SM (~199 KB of shared memory at K = 256). Where the feature tiles
// alone leave SMs idle (the MCTS rollouts' N = 64-256, the bench's N =
// 8192 at A = 1024), the host plan (ops/pair_distance.py::grid_plan)
// splits the column walk: a
// thread-block cluster of S blocks shares one feature tile, and rank r
// walks the column tiles [r * T / S, (r + 1) * T / S) of the T tiles
// (archive tiles, then failure tiles). Each rank folds its own minima, a
// segment none of its tiles belongs to staying at +inf; after a cluster
// barrier rank 0 reads the other ranks' per-row minima from their shared
// memory (distributed shared memory), takes the min, clamps it and writes
// nov and bug. One launch, no workspace, no atomics, and the result is the
// unsplit kernel's bit for bit: each tile's minima are computed alike and
// min is exact. S = 1 launches without a cluster, as before the split.
//
// Zero-filled padding (ragged K, rows past A or F) becomes -1/2 on both
// sides and still adds nothing to d2. Each occupancy is either read from
// device memory (an int32 the caller holds there, so a later capture into a
// CUDA graph never bakes it in) or passed by value (the caller's int, or
// the segment's row count where it has none): the wrapper launches
// nothing but the kernel. Tensor maps are encoded at every call (feats is
// a fresh tensor each generation).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper_ptx.cuh"

namespace {

using namespace nmz;

constexpr int BK = 32;       // k per TMA box: 128 bytes, one swizzle row
constexpr int BN = 64;       // column rows per tile (wgmma N)
constexpr int WG_ROWS = 64;  // feature rows per consumer warpgroup
constexpr int STAGES = 4;    // ring depth
constexpr int BOX_BYTES = BN * BK * 4;  // one landed column box, 8 KB
constexpr int SPLITTERS = 64;           // producer threads that split
constexpr int SMEM_LIMIT = 232448;      // per block on an H100
constexpr float MASK_BIG = 3.4e38f;
constexpr float CENTER = 0.5f;          // subtracted from every coordinate
constexpr int ORDER_BAR = 1;            // named barrier ordering the consumers
constexpr int MAX_SPLIT = 8;            // ranks of a split: the portable cluster

// error codes of the C entries besides cudaError_t values (all negative)
constexpr int ERR_WIDTH = -1;      // K does not fit the resident tile
constexpr int ERR_NO_ENCODE = -2;  // cuTensorMapEncodeTiled unavailable
constexpr int ERR_ENCODE = -3;     // cuTensorMapEncodeTiled refused a map
constexpr int ERR_PLAN = -4;       // a grid plan the kernel does not take

// an occupancy: read from device memory where `ptr` is set, else `value`
struct Occ {
  const int* ptr;
  int value;
  __device__ int get() const { return ptr != nullptr ? *ptr : value; }
};

__host__ __device__ constexpr int feats_bytes(int kb, int consumers) {
  return kb * consumers * WG_ROWS * BK * 4;
}

// dynamic shared memory: 1024 bytes of alignment slack, the resident
// feature tile, the ring (hi and lo per stage), the ring's column norms,
// the barriers (feats, then full/ready/empty per stage), a split rank's
// per-row minima (nov, then bug)
__host__ __device__ constexpr int smem_bytes(int kb, int consumers) {
  return 1024 + feats_bytes(kb, consumers) + STAGES * 2 * BOX_BYTES +
         STAGES * BN * 4 + (1 + 3 * STAGES) * 8 +
         2 * consumers * WG_ROWS * 4;
}

// SEGMENTS = 2: archive then failures, minima into nov and bug.
// SEGMENTS = 1: archive only, minimum into nov (fail_map, F, bug unused).
template <int SEGMENTS>
__global__ void __launch_bounds__(384, 1)
min_sq_kernel(const __grid_constant__ CUtensorMap feats_map,
              const __grid_constant__ CUtensorMap arch_map,
              const __grid_constant__ CUtensorMap fail_map,
              const Occ occ_a, const Occ occ_f, float* __restrict__ nov,
              float* __restrict__ bug, int N, int A, int F, int K,
              int consumers, int split) {
  static_assert(SEGMENTS == 1 || SEGMENTS == 2, "one or two segments");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // swizzled TMA boxes need 1024-byte aligned destinations
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int KB = (K + BK - 1) / BK;
  const int BM = consumers * WG_ROWS;
  uint8_t* fsm = smem;  // KB boxes of [BM rows][32], 128-byte swizzled
  uint8_t* ring = fsm + feats_bytes(KB, consumers);
  float* c2buf = reinterpret_cast<float*>(ring + STAGES * 2 * BOX_BYTES);
  uint64_t* feats_full = reinterpret_cast<uint64_t*>(c2buf + STAGES * BN);
  uint64_t* full = feats_full + 1;
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  float* pmin = reinterpret_cast<float*>(empty + STAGES);  // [2][BM]

  const int tiles_a = (A + BN - 1) / BN;
  const int tiles = tiles_a + (SEGMENTS == 2 ? (F + BN - 1) / BN : 0);
  // blocks blockIdx.x / split share a feature tile (a cluster when split
  // > 1); rank blockIdx.x % split walks the column tiles [t_lo, t_hi)
  const int rank = blockIdx.x % split;
  const int row0 = (blockIdx.x / split) * BM;
  const int t_lo = rank * tiles / split;
  const int t_hi = (rank + 1) * tiles / split;
  const int iters = (t_hi - t_lo) * KB;  // (column tile, k box) in order

  if (threadIdx.x == 0) {
    mbar_init(feats_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SPLITTERS);
      mbar_init(&empty[s], consumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (wg == consumers) {
    // ---- producer warpgroup -------------------------------------------
    // (with a split every thread stays for the cluster barriers below)
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(feats_full, feats_bytes(KB, consumers));
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(fsm + kb * BM * BK * 4, &feats_map, feats_full, kb * BK,
                    row0);
      int slot = 0;
      uint32_t phase = 0;
      for (int it = 0; it < iters; ++it) {
        const int t = t_lo + it / KB;
        const int kb = it % KB;
        const bool is_arch = t < tiles_a;
        mbar_wait(&empty[slot], phase ^ 1);
        mbar_expect_tx(&full[slot], BOX_BYTES);
        tma_load_2d(ring + slot * 2 * BOX_BYTES,
                    is_arch ? &arch_map : &fail_map, &full[slot], kb * BK,
                    (is_arch ? t : t - tiles_a) * BN);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    } else if (warp == 1 || warp == 2) {
      // splitter p owns row p of every landed box: its 8 16-byte chunks,
      // visited in a rotated order so the 8 lanes of a quarter-warp hit
      // 8 distinct bank groups
      const int p = threadIdx.x - consumers * 128 - 32;
      const int live_a = min(max(occ_a.get(), 0), A);
      const int live_f = SEGMENTS == 2 ? min(max(occ_f.get(), 0), F) : 0;
      float norm = 0.f;
      int slot = 0;
      uint32_t phase = 0;
      for (int it = 0; it < iters; ++it) {
        const int t = t_lo + it / KB;
        const int kb = it % KB;
        mbar_wait(&full[slot], phase);
        float4* hi = reinterpret_cast<float4*>(ring + slot * 2 * BOX_BYTES) +
                     p * 8;
        float4* lo = hi + BOX_BYTES / 16;
        float box_norm = 0.f;  // summed per box, then across boxes
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int pc = (c + p) & 7;
          const float4 v = hi[pc];
          const float x[4] = {v.x - CENTER, v.y - CENTER, v.z - CENTER,
                              v.w - CENTER};
          float h[4], l[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            box_norm = fmaf(x[q], x[q], box_norm);
            h[q] = __uint_as_float(tf32_rna(x[q]));
            l[q] = __uint_as_float(tf32_rna(x[q] - h[q]));
          }
          hi[pc] = make_float4(h[0], h[1], h[2], h[3]);
          lo[pc] = make_float4(l[0], l[1], l[2], l[3]);
        }
        norm += box_norm;
        if (kb == KB - 1) {
          const bool is_arch = t < tiles_a;
          const int col = (is_arch ? t : t - tiles_a) * BN + p;
          c2buf[slot * BN + p] =
              col < (is_arch ? live_a : live_f) ? norm : MASK_BIG;
          norm = 0.f;
        }
        fence_proxy_async();
        mbar_arrive(&ready[slot]);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    if (split == 1) return;
    cluster_sync();  // the ranks' minima are in place
    cluster_sync();  // rank 0 has read them
    return;
  }

  // ---- consumer warpgroup wg: feature rows [64 wg, 64 wg + 64) ----------
  // wgmma fragment coordinates: this thread holds rows r and r + 8 of the
  // tile, A columns t4 and t4 + 4 of each k-step, and D columns
  // 8j + 2 t4 and 8j + 2 t4 + 1 of each 8-column group j
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = wg * WG_ROWS + warp * 16 + g;
  // byte offsets into one swizzled box: row r at r * 128, 16-byte chunk c
  // of that row at chunk c ^ (r % 8) (r % 8 == g for both rows)
  const int off0 = r * 128 + t4 * 4;
  const int off1 = (r + 8) * 128 + t4 * 4;

  mbar_wait(feats_full, 0);
  float f2a = 0.f, f2b = 0.f;
  for (int kb = 0; kb < KB; ++kb) {
    const uint8_t* box = fsm + kb * BM * BK * 4;
    float pa = 0.f, pb = 0.f;  // summed per box, then across boxes
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float x0 = *reinterpret_cast<const float*>(
                           box + off0 + ((c ^ g) << 4)) - CENTER;
      const float x1 = *reinterpret_cast<const float*>(
                           box + off1 + ((c ^ g) << 4)) - CENTER;
      pa = fmaf(x0, x0, pa);
      pb = fmaf(x1, x1, pb);
    }
    f2a += pa;
    f2b += pb;
  }
  f2a += __shfl_xor_sync(0xffffffffu, f2a, 1);
  f2a += __shfl_xor_sync(0xffffffffu, f2a, 2);
  f2b += __shfl_xor_sync(0xffffffffu, f2b, 1);
  f2b += __shfl_xor_sync(0xffffffffu, f2b, 2);

  float nov0 = INFINITY, nov1 = INFINITY, bug0 = INFINITY, bug1 = INFINITY;
  // The tensor cores add into their f32 accumulator with truncation, a
  // bias of a fraction of an ulp of the running sum per wgmma: with all 96
  // wgmmas of a K = 256 tile in one accumulator, d2 drifts several times
  // past atol 1e-4 where it cancels to 0. So each box's twelve wgmmas go
  // into a fresh partial
  // `part`, which is added to the tile's sums `acc` on the CUDA cores,
  // rounded to nearest. Nothing reads `part` while a wgmma is in flight
  // (ptxas would serialise every wgmma otherwise); the other consumer
  // warpgroup's wgmmas fill the tensor cores meanwhile.
  float acc[32];
  float part[32];
  uint32_t ah[4][4], al[4][4];  // [k-step][fragment]
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int slot = 0;
  uint32_t phase = 0;
  for (int it = 0; it < iters; ++it) {
    const int t = t_lo + it / KB;
    const int kb = it % KB;
    const uint8_t* box = fsm + kb * BM * BK * 4;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float x[4] = {
          *reinterpret_cast<const float*>(box + off0 + (((2 * s) ^ g) << 4)),
          *reinterpret_cast<const float*>(box + off1 + (((2 * s) ^ g) << 4)),
          *reinterpret_cast<const float*>(box + off0 +
                                          (((2 * s + 1) ^ g) << 4)),
          *reinterpret_cast<const float*>(box + off1 +
                                          (((2 * s + 1) ^ g) << 4))};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xc = x[q] - CENTER;
        ah[s][q] = tf32_rna(xc);
        al[s][q] = tf32_rna(xc - __uint_as_float(ah[s][q]));
      }
    }
    mbar_wait(&ready[slot], phase);
    __syncwarp();  // wgmma is .aligned: the warp leaves the spin together
    const uint32_t bhi = smem_addr(ring + slot * 2 * BOX_BYTES);
    const uint32_t blo = bhi + BOX_BYTES;
    // with two consumer warpgroups, warpgroup 1 issues each box's wgmmas
    // after warpgroup 0: the tensor cores run them back to back, and each
    // warpgroup adds up its partial while the other's wgmmas run
    if (consumers == 2 && wg == 1) named_bar_sync(ORDER_BAR, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(part[i]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // the small products first, then hi.hi'
      wgmma_m64n64k8_tf32(part, ah[s], desc_k_sw128(blo + 32 * s), s > 0);
      wgmma_m64n64k8_tf32(part, al[s], desc_k_sw128(bhi + 32 * s), 1);
      wgmma_m64n64k8_tf32(part, ah[s], desc_k_sw128(bhi + 32 * s), 1);
    }
    wgmma_commit();
    if (consumers == 2 && wg == 0) named_bar_arrive(ORDER_BAR, 256);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_operand(part[i]);
      acc[i] += part[i];
    }
    if (kb == KB - 1) {
      // fold the finished tile into the minima, restart the sums
      const float* c2 = c2buf + slot * BN;
      float m0 = INFINITY, m1 = INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 cc =
            *reinterpret_cast<const float2*>(c2 + 8 * j + 2 * t4);
        m0 = fminf(m0, fminf(f2a + cc.x - 2.f * acc[4 * j],
                             f2a + cc.y - 2.f * acc[4 * j + 1]));
        m1 = fminf(m1, fminf(f2b + cc.x - 2.f * acc[4 * j + 2],
                             f2b + cc.y - 2.f * acc[4 * j + 3]));
      }
      if (SEGMENTS == 1 || t < tiles_a) {
        nov0 = fminf(nov0, m0);
        nov1 = fminf(nov1, m1);
      } else {
        bug0 = fminf(bug0, m0);
        bug1 = fminf(bug1, m1);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    mbar_arrive(&empty[slot]);
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }

  // the four lanes of a quad share rows r and r + 8
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    nov0 = fminf(nov0, __shfl_xor_sync(0xffffffffu, nov0, off));
    nov1 = fminf(nov1, __shfl_xor_sync(0xffffffffu, nov1, off));
    if (SEGMENTS == 2) {
      bug0 = fminf(bug0, __shfl_xor_sync(0xffffffffu, bug0, off));
      bug1 = fminf(bug1, __shfl_xor_sync(0xffffffffu, bug1, off));
    }
  }
  if (split == 1) {
    if (t4 == 0) {
      const int gr = row0 + r;
      if (gr < N) {
        nov[gr] = fmaxf(nov0, 0.f);
        if (SEGMENTS == 2) bug[gr] = fmaxf(bug0, 0.f);
      }
      if (gr + 8 < N) {
        nov[gr + 8] = fmaxf(nov1, 0.f);
        if (SEGMENTS == 2) bug[gr + 8] = fmaxf(bug1, 0.f);
      }
    }
    return;
  }

  // ---- the split: rank 0 takes the min over the cluster's ranks ----------
  if (t4 == 0) {
    pmin[r] = nov0;
    pmin[r + 8] = nov1;
    if (SEGMENTS == 2) {
      pmin[BM + r] = bug0;
      pmin[BM + r + 8] = bug1;
    }
  }
  cluster_sync();
  if (rank == 0) {
    const int n = SEGMENTS * BM;
    for (int i = threadIdx.x; i < n; i += consumers * 128) {
      const uint32_t at = smem_addr(pmin + i);
      float v = pmin[i];
      for (int q = 1; q < split; ++q)
        v = fminf(v, ld_cluster_f32(map_rank(at, q)));
      const int gr = row0 + i % BM;
      if (gr < N) (i < BM ? nov : bug)[gr] = fmaxf(v, 0.f);
    }
  }
  cluster_sync();  // no rank leaves before rank 0 has read its minima
}

// -- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

CUresult last_encode_error = CUDA_SUCCESS;

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so the
// library needs no -lcuda
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a map of a row-major f32 [rows, K] matrix in boxes of box_rows x 32,
// 128-byte swizzle, zeros past either edge
int encode_rows(EncodeTiledFn fn, CUtensorMap* map, const float* ptr,
                int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    last_encode_error = r;
    return ERR_ENCODE;
  }
  return 0;
}

// two consumer warpgroups (128 feature rows a block) where their resident
// tile fits, else one; 0 if not even one fits
int consumers_for(int K) {
  const int kb = (K + BK - 1) / BK;
  for (int c = 2; c >= 1; --c)
    if (smem_bytes(kb, c) <= SMEM_LIMIT) return c;
  return 0;
}

template <int SEGMENTS>
int launch(const float* feats, const float* archive, const float* failures,
           Occ occ_a, Occ occ_f, float* nov, float* bug, int N, int A, int F,
           int K, int consumers, int split, void* stream) {
  if (N <= 0) return 0;
  if (K <= 0 || K % 4 || consumers < 1 || consumers > 2 ||
      smem_bytes((K + BK - 1) / BK, consumers) > SMEM_LIMIT)
    return ERR_WIDTH;
  const int tiles = (A + BN - 1) / BN + (SEGMENTS == 2 ? (F + BN - 1) / BN : 0);
  if (split < 1 || split > MAX_SPLIT || split > tiles) return ERR_PLAN;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  CUtensorMap fmap, amap, gmap;
  int rc = encode_rows(fn, &fmap, feats, N, K, consumers * WG_ROWS);
  if (rc == 0) rc = encode_rows(fn, &amap, archive, A, K, BN);
  if (rc == 0)
    rc = SEGMENTS == 2 ? encode_rows(fn, &gmap, failures, F, K, BN)
                       : encode_rows(fn, &gmap, archive, A, K, BN);
  if (rc != 0) return rc;
  const int smem = smem_bytes((K + BK - 1) / BK, consumers);
  cudaError_t e = cudaFuncSetAttribute(
      min_sq_kernel<SEGMENTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bm = consumers * WG_ROWS;
  const int row_tiles = (N + bm - 1) / bm;
  if (split == 1) {
    min_sq_kernel<SEGMENTS>
        <<<row_tiles, 128 * (consumers + 1), smem,
           static_cast<cudaStream_t>(stream)>>>(fmap, amap, gmap, occ_a,
                                                occ_f, nov, bug, N, A, F, K,
                                                consumers, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(row_tiles * split);
  config.blockDim = dim3(128 * (consumers + 1));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, min_sq_kernel<SEGMENTS>, fmap, amap, gmap,
                         occ_a, occ_f, nov, bug, N, A, F, K, consumers,
                         split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns 0, a cudaError_t of the launch, or a
// negative code (see nmz_cuda_error_string). Takes f32 row-major
// contiguous feats [N, K], archive [A, K], failures [F, K] with 16-byte
// aligned bases, K % 4 == 0 and K <= nmz_min_sq_max_k(), and writes
// nov [N], bug [N]. Each occupancy is a pointer to one device int32 (read
// by the kernel) or, where that pointer is null, the value after it (the
// wrapper passes A or F for "every row live"). `consumers` (1 or 2: 64 or
// 128 feature rows a block) and `split` (1, or the ranks of a cluster, at
// most 8 and at most the column tiles) are the host plan's. Allocates
// nothing and does not synchronise.
extern "C" int nmz_min_sq_pair_f32(const float* feats, const float* archive,
                                   const float* failures,
                                   const int* archive_n, int archive_n_value,
                                   const int* failure_n, int failure_n_value,
                                   float* nov, float* bug, int N, int A,
                                   int F, int K, int consumers, int split,
                                   void* stream) {
  return launch<2>(feats, archive, failures, Occ{archive_n, archive_n_value},
                   Occ{failure_n, failure_n_value}, nov, bug, N, A, F, K,
                   consumers, split, stream);
}

// The single-segment kernel: min over archive rows only. Takes feats
// [N, K], archive [A, K] and the occupancy valid_n (pointer or value, as
// above), writes out [N]. Same launch contract as nmz_min_sq_pair_f32.
extern "C" int nmz_min_sq_f32(const float* feats, const float* archive,
                              const int* valid_n, int valid_n_value,
                              float* out, int N, int A, int K, int consumers,
                              int split, void* stream) {
  return launch<1>(feats, archive, nullptr, Occ{valid_n, valid_n_value},
                   Occ{nullptr, 0}, out, nullptr, N, A, 0, K, consumers,
                   split, stream);
}

// How many clusters of `split` pair-kernel blocks of `consumers` consumer
// warpgroups at width K the device can hold at once (the occupancy
// calculator's answer), or a negative code / cudaError_t.
extern "C" int nmz_min_sq_max_active_clusters(int K, int consumers,
                                              int split) {
  if (K <= 0 || consumers < 1 || consumers > 2) return ERR_WIDTH;
  const int smem = smem_bytes((K + BK - 1) / BK, consumers);
  if (smem > SMEM_LIMIT) return ERR_WIDTH;
  cudaError_t e = cudaFuncSetAttribute(
      min_sq_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(split);
  config.blockDim = dim3(128 * (consumers + 1));
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, min_sq_kernel<2>, &config);
  if (e != cudaSuccess) return static_cast<int>(e);
  return clusters;
}

// The widest K whose feature tile stays resident (one consumer warpgroup).
extern "C" int nmz_min_sq_max_k() {
  int k = 4;
  while (consumers_for(k + 4) > 0) k += 4;
  return k;
}

extern "C" const char* nmz_cuda_error_string(int code) {
  static char buf[96];
  switch (code) {
    case ERR_WIDTH:
      return "feature width K does not fit the kernel's resident tile";
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled could not be looked up";
    case ERR_PLAN:
      return "grid plan (consumers, split) the kernel does not take";
    case ERR_ENCODE:
      snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
               static_cast<int>(last_encode_error));
      return buf;
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
