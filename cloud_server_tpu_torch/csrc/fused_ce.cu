// Fused unembed + cross-entropy statistics for Hopper (sm_90a): the
// training loss's logits never reach device memory in float32.
//
// Replaces the two Pallas TPU kernels of cloud_server_tpu/ops/fused_ce.py:
//   _fwd_kernel (B7) -> ce_gemm_kernel<kStats>, then ce_fwd_combine_kernel
//                                              (entry ce_fwd_bf16)
//   _dx_kernel  (B8) -> ce_gemm_kernel<kDlogits>, then ce_gemm_kernel<kDx>
//                                              (entries ce_dlogits_bf16,
//                                               ce_dx_bf16)
// The Python wrapper (ops/fused_ce.py) counts one B7 per ce_fwd_bf16 call
// and one B8 per pair of B8 entries, and mirrors the work schedule below
// (ce_schedule) for its tests; the host entry ce_units lists the
// schedule as this source computes it, so the card tests hold the two
// against each other.
//
// What is computed, for x (N, D), head (D, V), targets t (N,):
//   logits[i][c] = x[i] . head[:, c]                    (f32 accumulate)
//   logz[i]      = log sum_c exp(logits[i][c])          (f32)
//   tl[i]        = logits[i][t[i]]                      (f32)
//   am[i]        = the first c with the largest logit   (int32)
// and for the backward, from the saved logz and the cotangents g (of
// logz) and h (of tl), both f32 (N,):
//   d[i][c] = bf16(g[i] exp(logits[i][c] - logz[i]) + (c == t[i] ? h[i] : 0))
//   dx      = bf16(d @ head^T)                          (f32 accumulate)
// d is written once, (N, V) bf16: the reference emits the same buffer for
// its dW product, which stays a library matmul outside the kernels. x, head
// and d are bf16, row-major and contiguous; N, V and D are multiples of
// 128.
//
// What bounds it on an H100: 2 N D V operations for B7 and 4 N D V for
// B8 (the logits' recompute and dx) at the bf16 tensor-core rate; the
// bytes of x, head and d are three orders of magnitude fewer. Only wgmma
// reaches that rate, and only with the next tiles in flight while the
// tensor cores run.
//
// One GEMM mainloop, three epilogues. A block is three warpgroups: two
// consumers of 64 output rows each and a producer whose one thread issues
// every copy; setmaxnreg hands the producer's registers to the consumers
// (24 and 240 a thread). The output tile is 128 rows x 256 columns; K
// runs in steps of 64 through a ring of stages (A 128 x 64, B 64 x 256,
// 48 KB a stage; 4 stages for B7, 3 beside a 64 KB output tile for B8)
// with full and empty mbarriers. Tiles arrive by TMA from 2-D maps in
// 128B-swizzled boxes of 64 x 64, so a tile past V or D reads zeros and a
// store past them is dropped. Each consumer accumulates its 64 x 256 f32
// tile (128 registers a thread) with wgmma m64n256k16 straight from shared
// memory, one group of four in flight while the previous stage is freed.
//   A  x (N, D) for B7 and d (ce_dlogits), K-major; d (N, V) for dx.
//   B  head (D, V): for B7 and d the tile is 64 k rows x 256 vocabulary
//      columns, V contiguous, read MN-major (the transpose bit); for dx it
//      is 256 head rows x 64 vocabulary columns, K-major.
// Pairs: where the row tiles pair up, blocks run in clusters of two on
// neighbouring row tiles, which need the same B tiles. Each block loads
// its own A and two of B's four boxes, multicast into both blocks, so the
// L2 serves 32 KB a stage a block where it served 48; a stage is free
// once the consumers of both blocks have released it (each block's empty
// barrier counts 16 warps, 8 of them arriving from the other block), and
// a producer stays until both have released its last stages. An odd
// number of row tiles runs the same kernel one block at a time.
// A block owns one work unit: a row tile and a range of column tiles,
// which it walks in increasing order; its producer streams straight from
// one tile's last K step into the next tile's first, so loads run on
// under each epilogue.
//   B7  units (row tile, vocabulary range): after each tile every thread
//       folds its logits into a running (max, sum of exp, target logit,
//       first argmax) for each of its 2 rows (exp2 of (logit - max) log2
//       e); at the end the 4 lanes of a quad combine theirs (ties to the
//       smaller column) and write one partial per row and range. A second
//       launch combines the ranges of each row in order: a later range
//       wins the argmax only on a strictly greater max, the reference's
//       rule. No atomics, so the result is the same on every run.
//   d   the same units; the epilogue forms d in f32 with the plain
//       version's arithmetic (expf, the product rounded before h is added:
//       an exp2 form with log2 e folded into logz shifted whole rows and
//       took dW's largest error past its limit), rounds it to bf16 into a
//       swizzled output tile in shared memory, and one thread of the
//       consumer stores its 64 rows by TMA (waiting, before the next tile,
//       only until the store has read shared memory).
//   dx  units (row tile, 256 columns of D), K = V (2004 steps at V
//       128256); the epilogue stores bf16 through the same output tile.
// Tails: V % 256 == 128 leaves the last vocabulary tile half past V; its
// columns >= V are masked out of the statistics (they read zeros), and
// their d is computed but not stored. D % 256 == 128 does the same to
// dx's last column tile; the zero K-tail of neither adds anything.
// Offsets above 2^31 elements (N V reaches 2.1e9 at N 16384) exist only
// in the TMA maps, whose coordinates stay small.
//
// Raster (the order of the units, unit_of): blocks with neighbouring
// indices start together and stay in step, so they should share operands
// in the 50 MB L2, which holds neither x (64 MB at N 8192, D 4096), head
// (1.05 GB) nor d (2.1 GB). Units come in groups of kRowGroup<E> row
// tiles, the row tile fastest within a group:
//   B7, d  group 16: the 132 resident blocks cover 16 row tiles (16 MB of
//          x, re-read from L2 for every vocabulary tile) and about 8
//          ranges (2 MB of head each per tile, shared by 16 blocks), so
//          head is read from memory N / (128 x 16) = 4 times. With all 64
//          row tiles in one group, x itself would stream from memory once
//          per vocabulary tile.
//   dx     group 8: the 8 blocks launched together share one D tile of
//          head (its 256 rows, K slice by K slice) and a wave covers 8 row
//          panels of d, shared by the 16 D tiles. With the D tile fastest
//          the blocks that share head start at different times, drift
//          apart over the 2004 K steps and read head again each.
// Both group sizes were chosen by timing the alternatives on the card
// (PERF.md). The wrapper picks the number of ranges so that the units fill whole waves of the
// card's SMs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWgThreads = 128;       // one warpgroup
constexpr int kThreads = 3 * 128;     // two consumer warpgroups + producer
constexpr int kProducerRegs = 24;     // setmaxnreg: 24 x 128 + 240 x 256
constexpr int kConsumerRegs = 240;    //   = 168 x 384, the launch's share
constexpr int kConsumerWarps = 8;     // arrivals that free a stage
constexpr int kBM = 128;              // rows of an output tile
constexpr int kBN = 256;              // columns of an output tile
constexpr int kBK = 64;               // K per stage: one 128-byte row
constexpr int kBox = 64 * 64 * 2;     // one 64 x 64 bf16 box, 8 KB
constexpr int kATile = 2 * kBox;      // 128 rows x 64 K
constexpr int kBTile = 4 * kBox;      // 64 K x 256 columns (or 256 x 64)
constexpr int kStageBytes = kATile + kBTile;
constexpr int kOutTile = 4 * 2 * kBox;  // 128 x 256 bf16 output staging
constexpr float kNegInf = -1e30f;     // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

enum Epilogue { kStats = 0, kDlogits = 1, kDx = 2 };

template <int E>
struct Smem {
  static constexpr int kStages = E == kStats ? 4 : 3;
  static constexpr int kOut = kStages * kStageBytes;  // d and dx staging
  static constexpr int kBars = kOut + (E == kStats ? 0 : kOutTile);
  // full[stages], empty[stages]
  static constexpr int kBytes = kBars + 16 * kStages;
};

struct Args {
  const int* targets;  // (N,) int32: B7, d
  const float* logz;   // (N,): d
  const float* gz;     // (N,): d
  const float* gt;     // (N,): d
  float* part_m;       // (splits, N): B7
  float* part_l;
  float* part_tl;
  int* part_am;
  int n;               // rows
  int cols;            // output columns: V's valid columns (B7, d) or D (dx)
  int store_cols;      // d: columns of the d buffer (V, >= cols; the
                       // columns from cols on are written as 0)
  int k_steps;         // K / 64
  int row_tiles;       // N / 128
  int col_tiles;       // ceil(cols / 256)
  int splits;          // column ranges per row tile
};

// Row tiles per raster group (see the raster note above). Both are even,
// so where the row tiles pair up every group holds whole pairs.
template <int E>
constexpr int kRowGroup = E == kDx ? 8 : 16;
static_assert(kRowGroup<kStats> % 2 == 0 && kRowGroup<kDx> % 2 == 0,
              "raster groups hold whole pairs");

struct Unit {
  int row_tile;
  int split;
  int t0;  // column tiles [t0, t1)
  int t1;
};

// Block b's work unit: groups of kRowGroup<E> row tiles (fewer in the
// last), the row tile fastest within a group, then the range. Range s
// holds the column tiles [s T / S, (s + 1) T / S).
// ops/fused_ce.py::ce_schedule mirrors this; ce_units runs it on the host.
template <int E>
__host__ __device__ __forceinline__ Unit unit_of(int b, const Args& a) {
  constexpr int kGroup = kRowGroup<E>;
  const int per_group = kGroup * a.splits;
  const int grp = b / per_group;
  const int rem = b - grp * per_group;
  const int left = a.row_tiles - grp * kGroup;
  const int rows = left < kGroup ? left : kGroup;
  Unit u;
  u.split = rem / rows;
  u.row_tile = grp * kGroup + (rem - u.split * rows);
  u.t0 = static_cast<int>(static_cast<long long>(u.split) * a.col_tiles /
                          a.splits);
  u.t1 = static_cast<int>(static_cast<long long>(u.split + 1) *
                          a.col_tiles / a.splits);
  return u;
}

// Fold the statistics (m2, l2, tl2, am2) of other columns of a row into
// (m, l, tl, am): the argmax ties go to the smaller column.
__device__ __forceinline__ void merge_stats(float& m, float& l, float& tl,
                                            int& am, float m2, float l2,
                                            float tl2, int am2) {
  const float mn = fmaxf(m, m2);
  l = l * exp2f((m - mn) * kLog2e) + l2 * exp2f((m2 - mn) * kLog2e);
  tl += tl2;
  if (m2 > m || (m2 == m && am2 < am)) am = am2;
  m = mn;
}

// Running statistics of one row over the columns this thread holds.
struct RowStats {
  float m = kNegInf;
  float l = 0.f;
  float tl = 0.f;
  int am = 0;
};

// Fold one tile's 64 logits of a row (accumulator entries 4c + 2 kHi +
// {0, 1}: row g, or g + 8 with kHi; column c0 + 8c + e) into s. Columns >=
// cols are masked to NEG_INF in place (the next tile overwrites the
// accumulator). The tile's argmax is searched only when its max beats the
// running one (an earlier tile keeps a tie), the target only in the tile
// that holds it.
template <int kHi>
__device__ __forceinline__ void fold_tile(RowStats& s, float (&acc)[128],
                                          int cbase, int target, int cols,
                                          bool tail) {
  float tmax = kNegInf;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& val = acc[4 * c + 2 * kHi + e];
      if (tail && cbase + 8 * c + e >= cols) val = kNegInf;
      tmax = fmaxf(tmax, val);
    }
  }
  if (tmax > s.m) {
    // columns descend: the last match is the first of equal maxima
#pragma unroll
    for (int c = 31; c >= 0; --c) {
#pragma unroll
      for (int e = 1; e >= 0; --e) {
        if (acc[4 * c + 2 * kHi + e] == tmax) s.am = cbase + 8 * c + e;
      }
    }
  }
  if (static_cast<unsigned>(target - cbase) < 256u) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (cbase + 8 * c + e == target) s.tl += acc[4 * c + 2 * kHi + e];
      }
    }
  }
  const float mn = fmaxf(s.m, tmax);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum += exp2f((acc[4 * c + 2 * kHi + e] - mn) * kLog2e);
    }
  }
  s.l = s.l * exp2f((s.m - mn) * kLog2e) + sum;
  s.m = mn;
}

__device__ __forceinline__ void quad_merge(RowStats& s) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, s.m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, s.l, off);
    const float t2 = __shfl_xor_sync(0xffffffffu, s.tl, off);
    const int a2 = __shfl_xor_sync(0xffffffffu, s.am, off);
    merge_stats(s.m, s.l, s.tl, s.am, m2, l2, t2, a2);
  }
}

// Byte offset of element (r, c) of a consumer's 64-row output staging:
// four 64-column boxes one after the other, 128B-swizzled as TMA reads
// them.
__device__ __forceinline__ uint32_t out_offset(int r, int c) {
  return (c >> 6) * kBox + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// ---------------------------------------------------------------------------
// The mainloop and its three epilogues
// ---------------------------------------------------------------------------

template <int E, bool kPair>
__global__ void __launch_bounds__(kThreads, 1) ce_gemm_kernel(
    const __grid_constant__ CUtensorMap ta,    // A (N, K) bf16
    const __grid_constant__ CUtensorMap tb,    // head (D, V) bf16
    const __grid_constant__ CUtensorMap tout,  // d (N, V) or dx (N, D)
    const Args args) {
  using L = Smem<E>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles: 1 KB
  const uint32_t bar_full = base + L::kBars;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const Unit u = unit_of<E>(blockIdx.x, args);
  const int m0 = u.row_tile * kBM;
  const int wg = threadIdx.x / kWgThreads;
  // a pair: this block's rank in its cluster of two, which share B
  const uint32_t rank = kPair ? cluster_ctarank() : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      // a pair's stage is free once both blocks' consumers are done
      mbar_init(bar_empty + 8 * st, (kPair ? 2 : 1) * kConsumerWarps);
    }
    mbar_init_fence();
  }
  if constexpr (kPair) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      int it = 0;
      for (int j = u.t0; j < u.t1; ++j) {
        const int c0 = j * kBN;
        for (int k = 0; k < args.k_steps; ++k, ++it) {
          const int st = it % kStages;
          mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
          const uint32_t full = bar_full + 8 * st;
          const uint32_t sa = base + st * kStageBytes;
          const uint32_t sb = sa + kATile;
          const int k0 = k * kBK;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(sa, &ta, full, k0, m0);
          tma_load_2d(sa + kBox, &ta, full, k0, m0 + 64);
          // B: a pair's blocks each load two of the four boxes into both
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (kPair && i / 2 != static_cast<int>(rank)) continue;
            // dx: 64 head rows (dx columns) x 64 vocabulary entries,
            // K-major; else 64 D rows x 64 vocabulary columns, MN-major
            const int x0 = E == kDx ? k0 : c0 + 64 * i;
            const int x1 = E == kDx ? c0 + 64 * i : k0;
            if constexpr (kPair) {
              tma_load_2d_multicast(sb + i * kBox, &tb, full, x0, x1, 3);
            } else {
              tma_load_2d(sb + i * kBox, &tb, full, x0, x1);
            }
          }
        }
      }
      if constexpr (kPair) {
        // stay until both blocks have released every stage: the other
        // block's consumers arrive on this block's barriers, and its
        // copies land in this block's shared memory
        for (int i = 0; i < kStages; ++i, ++it) {
          mbar_wait(bar_empty + 8 * (it % kStages),
                    ((it / kStages) & 1) ^ 1);
        }
      }
    }
  } else {
    // ---- consumers: 64 output rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int rl = warp * 16 + g;           // row in this consumer's 64
    const int r_lo = m0 + wg * 64 + rl;
    const int r_hi = r_lo + 8;

    int t_lo = 0, t_hi = 0;
    float lz_lo = 0.f, lz_hi = 0.f, g_lo = 0.f, g_hi = 0.f, h_lo = 0.f,
          h_hi = 0.f;
    if constexpr (E != kDx) {
      t_lo = args.targets[r_lo];
      t_hi = args.targets[r_hi];
    }
    if constexpr (E == kDlogits) {
      lz_lo = args.logz[r_lo];
      lz_hi = args.logz[r_hi];
      g_lo = args.gz[r_lo];
      g_hi = args.gz[r_hi];
      h_lo = args.gt[r_lo];
      h_hi = args.gt[r_hi];
    }
    RowStats s_lo, s_hi;

    // free a stage: lane 0 of each warp arrives here, lane 1 at the other
    // block of a pair
    const auto release = [&](int step) {
      const uint32_t bar = bar_empty + 8 * (step % kStages);
      if (lane == 0) mbar_arrive(bar);
      if (kPair && lane == 1) {
        mbar_arrive_cluster(mapa_shared(bar, rank ^ 1));
      }
    };

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int it = 0;
    for (int j = u.t0; j < u.t1; ++j) {
      for (int k = 0; k < args.k_steps; ++k, ++it) {
        const int st = it % kStages;
        mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        const uint32_t sa = base + st * kStageBytes + wg * kBox;
        const uint32_t sb = base + st * kStageBytes + kATile;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = sw128_desc(sa + kk * 32, 16);
          if constexpr (E == kDx) {
            wgmma_ss_n256<0>(acc, da, sw128_desc(sb + kk * 32, 16),
                             (k | kk) != 0);
          } else {
            // 16 k rows a step; LBO: the next 64 columns
            wgmma_ss_n256<1>(acc, da, sw128_desc(sb + kk * 16 * 128, kBox),
                             (k | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (k > 0) release(it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1);

      const int c0 = j * kBN;
      if constexpr (E == kStats) {
        const bool tail = c0 + kBN > args.cols;
        fold_tile<0>(s_lo, acc, c0 + 2 * tig, t_lo, args.cols, tail);
        fold_tile<1>(s_hi, acc, c0 + 2 * tig, t_hi, args.cols, tail);
      } else {
        // this consumer's 64 rows of the output tile
        const uint32_t out_s = base + L::kOut + wg * (kOutTile / 2);
        unsigned char* out = smem_raw + (out_s - raw);
        // the previous tile's store has read the staging buffer
        if (tid == 0) tma_store_wait_read();
        named_barrier(1 + wg, kWgThreads);
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int cl = 8 * c + 2 * tig;
          float v0 = acc[4 * c], v1 = acc[4 * c + 1];
          float v2 = acc[4 * c + 2], v3 = acc[4 * c + 3];
          if constexpr (E == kDlogits) {
            // the plain version's arithmetic: expf, the product rounded
            // before the target's h is added; a padded column (>= cols)
            // gets 0
            const int col = c0 + cl;
            v0 = __fadd_rn(__fmul_rn(g_lo, expf(v0 - lz_lo)),
                           col == t_lo ? h_lo : 0.f);
            v1 = __fadd_rn(__fmul_rn(g_lo, expf(v1 - lz_lo)),
                           col + 1 == t_lo ? h_lo : 0.f);
            v2 = __fadd_rn(__fmul_rn(g_hi, expf(v2 - lz_hi)),
                           col == t_hi ? h_hi : 0.f);
            v3 = __fadd_rn(__fmul_rn(g_hi, expf(v3 - lz_hi)),
                           col + 1 == t_hi ? h_hi : 0.f);
            if (col >= args.cols) v0 = v2 = 0.f;
            if (col + 1 >= args.cols) v1 = v3 = 0.f;
          }
          *reinterpret_cast<uint32_t*>(out + out_offset(rl, cl)) =
              pack_floats(v0, v1);
          *reinterpret_cast<uint32_t*>(out + out_offset(rl + 8, cl)) =
              pack_floats(v2, v3);
        }
        fence_proxy_async();
        named_barrier(1 + wg, kWgThreads);
        if (tid == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (c0 + 64 * i < args.store_cols) {
              tma_store_2d(&tout, out_s + i * kBox, c0 + 64 * i,
                           m0 + wg * 64);
            }
          }
          tma_store_commit();
        }
      }
    }

    if constexpr (E == kStats) {
      quad_merge(s_lo);
      quad_merge(s_hi);
      if (tig == 0) {
        const long long o = static_cast<long long>(u.split) * args.n;
        args.part_m[o + r_lo] = s_lo.m;
        args.part_l[o + r_lo] = s_lo.l;
        args.part_tl[o + r_lo] = s_lo.tl;
        args.part_am[o + r_lo] = s_lo.am;
        args.part_m[o + r_hi] = s_hi.m;
        args.part_l[o + r_hi] = s_hi.l;
        args.part_tl[o + r_hi] = s_hi.tl;
        args.part_am[o + r_hi] = s_hi.am;
      }
    } else {
      if (tid == 0) tma_store_wait_all();
    }
  }
}

// One thread per row: the ranges in order, as the reference's sequential
// vocabulary walk folds its tiles.
__global__ void ce_fwd_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_tl, const int* __restrict__ part_am,
    float* __restrict__ logz, float* __restrict__ tl, int* __restrict__ am,
    float* __restrict__ mx, int n, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float m = part_m[r], l = part_l[r], t = part_tl[r];
  int a = part_am[r];
  for (int s = 1; s < splits; ++s) {
    const long long i = static_cast<long long>(s) * n + r;
    const float m2 = part_m[i];
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + part_l[i] * expf(m2 - mn);
    t += part_tl[i];
    if (m2 > m) a = part_am[i];  // a later range wins only if strictly larger
    m = mn;
  }
  logz[r] = m + logf(l);
  tl[r] = t;
  am[r] = a;
  if (mx != nullptr) mx[r] = m;
}

// Blocks in clusters of two on neighbouring row tiles, which share every
// B tile, where the row tiles pair up (an even count: each raster group
// then has an even number of them); else one block alone per unit.
template <int E>
cudaError_t launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                        const CUtensorMap& tout, const Args& a,
                        cudaStream_t s) {
  constexpr int smem = Smem<E>::kBytes + 1024;  // + 1 KB alignment slack
  const bool pair = a.row_tiles % 2 == 0;
  const auto kernel =
      pair ? ce_gemm_kernel<E, true> : ce_gemm_kernel<E, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.row_tiles * a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pair ? 2 : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ta, tb, tout, a);
}

bool shape_ok(int n, int d, int v) {
  return n > 0 && d > 0 && v > 0 && n % 128 == 0 && v % 128 == 0 &&
         d % 128 == 0;
}

// The valid columns of a V-column head: its first `valid`, all but a
// tail of fewer than 128 (a padded vocab shard).
bool valid_ok(int v, int valid) { return valid > v - 128 && valid <= v; }

int col_tiles(int cols) { return (cols + kBN - 1) / kBN; }

Args make_args(int n, int cols, int k, int splits) {
  Args a = {};
  a.n = n;
  a.cols = cols;
  a.store_cols = cols;
  a.k_steps = k / kBK;
  a.row_tiles = n / kBM;
  a.col_tiles = col_tiles(cols);
  a.splits = splits;
  return a;
}

}  // namespace

// C entries, bound with ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is the caller's cudaStream_t. They allocate
// nothing, do not synchronise, and return cudaGetLastError() after the
// last launch (cudaErrorInvalidValue for a shape they do not take).

// B7: (logz, tl, am) per row, and the row max into `mx` unless it is
// null, over the first `valid` columns of the V-column head (the rest a
// zero pad). part_* are (splits, N) scratch buffers;
// 1 <= splits <= ceil(valid / 256).
extern "C" int ce_fwd_bf16(const void* x, const void* head,
                           const void* targets, void* part_m, void* part_l,
                           void* part_tl, void* part_am, void* logz, void* tl,
                           void* am, void* mx_out, int n, int d, int v,
                           int valid, int splits, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(n, d, v) || !valid_ok(v, valid) || splits < 1 ||
      splits > col_tiles(valid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mx, mh;
  if (!map_2d(&mx, x, d, n, 64) || !map_2d(&mh, head, v, d, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(n, valid, d, splits);
  a.targets = static_cast<const int*>(targets);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_tl = static_cast<float*>(part_tl);
  a.part_am = static_cast<int*>(part_am);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_gemm<kStats>(mx, mh, mx, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_tl), static_cast<const int*>(part_am),
      static_cast<float*>(logz), static_cast<float*>(tl),
      static_cast<int*>(am), static_cast<float*>(mx_out), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// B8, first launch: d (N, V) bf16 from the recomputed logits, over the
// same units as B7; the columns from `valid` on are written as 0.
extern "C" int ce_dlogits_bf16(const void* x, const void* head,
                               const void* targets, const void* logz,
                               const void* gz, const void* gt, void* dbuf,
                               int n, int d, int v, int valid, int splits,
                               void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(n, d, v) || !valid_ok(v, valid) || splits < 1 ||
      splits > col_tiles(valid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mx, mh, md;
  if (!map_2d(&mx, x, d, n, 64) || !map_2d(&mh, head, v, d, 64) ||
      !map_2d(&md, dbuf, v, n, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = make_args(n, valid, d, splits);
  a.store_cols = v;
  a.targets = static_cast<const int*>(targets);
  a.logz = static_cast<const float*>(logz);
  a.gz = static_cast<const float*>(gz);
  a.gt = static_cast<const float*>(gt);
  return static_cast<int>(
      launch_gemm<kDlogits>(mx, mh, md, a, static_cast<cudaStream_t>(stream)));
}

// B8, second launch: dx (N, D) bf16 = d @ head^T, f32 accumulate; one unit
// per 128 x 256 tile of dx.
extern "C" int ce_dx_bf16(const void* dbuf, const void* head, void* dx,
                          int n, int d, int v, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(n, d, v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap md, mh, mdx;
  if (!map_2d(&md, dbuf, v, n, 64) || !map_2d(&mh, head, v, d, 64) ||
      !map_2d(&mdx, dx, d, n, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(n, d, v, col_tiles(d));
  return static_cast<int>(
      launch_gemm<kDx>(md, mh, mdx, a, static_cast<cudaStream_t>(stream)));
}

// The work units in block order, as the kernels compute them, for N rows
// and `cols` output columns in `splits` ranges: those of B7 and d (dx 0;
// cols V) or of dx (dx 1; cols D, splits ceil(D / 256)). out holds
// (N / 128) * splits rows of (row tile, range, first tile, end tile),
// int32, in host memory. Runs on the host and launches nothing.
extern "C" int ce_units(int n, int cols, int splits, int dx, int* out) {
  if (!shape_ok(n, 128, cols) || splits < 1 || splits > col_tiles(cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(n, cols, 128, splits);
  for (int b = 0; b < a.row_tiles * splits; ++b) {
    const Unit u = dx ? unit_of<kDx>(b, a) : unit_of<kStats>(b, a);
    out[4 * b] = u.row_tile;
    out[4 * b + 1] = u.split;
    out[4 * b + 2] = u.t0;
    out[4 * b + 3] = u.t1;
  }
  return 0;
}
