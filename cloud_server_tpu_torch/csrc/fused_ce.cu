// Fused unembed + cross-entropy statistics for Hopper (sm_90a): the
// training loss's logits never reach device memory in float32.
//
// Replaces the two Pallas TPU kernels of cloud_server_tpu/ops/fused_ce.py:
//   _fwd_kernel (B7) -> ce_fwd_kernel, then ce_fwd_combine_kernel
//                                              (entry ce_fwd_bf16)
//   _dx_kernel  (B8) -> ce_dlogits_kernel, then ce_dx_kernel
//                                              (entries ce_dlogits_bf16,
//                                               ce_dx_bf16)
// The Python wrapper (ops/fused_ce.py) counts one B7 per ce_fwd_bf16 call
// and one B8 per pair of B8 launches.
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
// and d are bf16, row-major and contiguous; N and V are multiples of 128,
// D a multiple of 128.
//
// Layout of the work. Every kernel is one GEMM mainloop: a 128 x 128
// output tile per block of 8 warps (4 along M x 2 along N, 32 x 64 each),
// K in steps of 32 through a 3-stage cp.async ring in shared memory,
// fragments by ldmatrix, mma.sync m16n8k16 (mma_bf16.cuh). What differs
// is the operands and the epilogue:
//   B7  grid (N/128, splits). The vocabulary is cut into `splits` ranges
//       of whole 128-column tiles, one block each, so N/128 row tiles
//       fill the card's SMs (the reference's grid walks the vocabulary in
//       order on one core). The mainloop runs flat over (vocab tile, K
//       step), so loads of the next tile overlap the last products of the
//       current one. After each tile every thread folds its logits into a
//       running (max, sum of exp, target logit, first argmax) for each of
//       its 4 rows; at the end the 4 lanes of a quad and the 2 warps of a
//       row combine theirs (ties to the smaller index), and the block
//       writes one partial per row. A second launch combines the splits
//       of each row in order: a later range wins the argmax only on a
//       strictly greater max, the reference's rule. No atomics, so the
//       result is the same on every run.
//   B8  ce_dlogits, grid (N/128, V/128): K = D; the epilogue forms d and
//       writes it. ce_dx, grid (D/128, N/128): K = V over d and head^T
//       (head's rows are K-contiguous, loaded by plain ldmatrix); the
//       epilogue writes dx. The reference keeps a (256, D) f32 dx block
//       resident across all vocabulary tiles, 4 MB at D 4096, which no SM
//       can hold; two launches compute the same function (the reference
//       also multiplies the bf16-rounded d) for one extra read of d.
//
// What bounds it on an H100: 2 N D V operations for B7 and 4 N D V for
// B8 (the logits' recompute and dx), against bytes of head, x and d that
// are three orders of magnitude fewer: the bf16 tensor-core rate. This
// first version runs mma.sync, not wgmma, without TMA or warp
// specialisation, so it runs well below that rate; its times stand in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // eight warps
constexpr int kBM = 128;       // rows of the output tile
constexpr int kBN = 128;       // columns of the output tile
constexpr int kBK = 32;        // K per pipeline stage
constexpr int kStages = 3;
constexpr int kALd = kBK + 8;       // A tile (M, K) row stride, bf16
constexpr int kBknLd = kBN + 8;     // B tile stored (K, N)
constexpr int kBnkLd = kBK + 8;     // B tile stored (N, K)
constexpr int kATile = kBM * kALd;
constexpr int kBknTile = kBK * kBknLd;
constexpr int kBnkTile = kBN * kBnkLd;
constexpr float kNegInf = -1e30f;  // the reference's finite NEG_INF

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// A tile: rows [m0, m0 + 128), columns [k0, k0 + 32) of a row-major
// (., lda) array; 16 bytes per thread per copy.
__device__ __forceinline__ void load_a(bf16* s, const bf16* a, long long lda,
                                       int m0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 2;
    const int col = (c & 3) * 8;
    cp_async16(s + r * kALd + col,
               a + static_cast<long long>(m0 + r) * lda + k0 + col);
  }
}

// B tile from a (K, N) row-major array: rows [k0, k0 + 32), columns
// [n0, n0 + 128), stored (K, N).
__device__ __forceinline__ void load_b_kn(bf16* s, const bf16* b,
                                          long long ldb, int k0, int n0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < kBK * kBN / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 4;
    const int col = (c & 15) * 8;
    cp_async16(s + r * kBknLd + col,
               b + static_cast<long long>(k0 + r) * ldb + n0 + col);
  }
}

// B tile of B = src^T for an (N, K) row-major src: rows [n0, n0 + 128) of
// src, columns [k0, k0 + 32), stored (N, K).
__device__ __forceinline__ void load_b_nk(bf16* s, const bf16* src,
                                          long long ld, int n0, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < kBN * kBK / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 2;
    const int col = (c & 3) * 8;
    cp_async16(s + r * kBnkLd + col,
               src + static_cast<long long>(n0 + r) * ld + k0 + col);
  }
}

// acc (the warp's 32 x 64 tile) += A stage x B stage. A fragments by
// ldmatrix from the (M, K) tile; B fragments by ldmatrix.trans from a
// (K, N) tile (kNK false) or by ldmatrix from an (N, K) tile (kNK true).
template <bool kNK>
__device__ __forceinline__ void mma_stage(float acc[2][8][4], const bf16* sa,
                                          const bf16* sb, int warp_m,
                                          int warp_n, int lane) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4(a[mt], sa + (warp_m * 32 + mt * 16 + (lane & 15)) * kALd +
                             ks * 16 + (lane >> 4) * 8);
    }
    uint32_t b[8][2];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int nb = warp_n * 64 + np * 16;
      uint32_t r[4];
      if (kNK) {
        ldmatrix_x4(r, sb + (nb + (lane & 7) + ((lane >> 4) << 3)) * kBnkLd +
                           ks * 16 + ((lane >> 3) & 1) * 8);
      } else {
        ldmatrix_x4_trans(r, sb + (ks * 16 + (lane & 15)) * kBknLd + nb +
                                 (lane >> 4) * 8);
      }
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }
}

// Fold the statistics (m2, l2, tl2, am2) of other columns of a row into
// (m, l, tl, am): the argmax ties go to the smaller column.
__device__ __forceinline__ void merge_stats(float& m, float& l, float& tl,
                                            int& am, float m2, float l2,
                                            float tl2, int am2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  tl += tl2;
  if (m2 > m || (m2 == m && am2 < am)) am = am2;
  m = mn;
}

// ---------------------------------------------------------------------------
// B7: per-row statistics over one vocabulary range, then the combine
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ head,
    const int* __restrict__ targets, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_tl,
    int* __restrict__ part_am, int n, int d, int v, int splits) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* sa = smem;
  bf16* sb = smem + kStages * kATile;
  __shared__ float red_m[2][kBM], red_l[2][kBM], red_tl[2][kBM];
  __shared__ int red_am[2][kBM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int n_vt = v / kBN;
  const int vt0 = static_cast<int>(static_cast<long long>(split) * n_vt /
                                   splits);
  const int vt1 = static_cast<int>(static_cast<long long>(split + 1) * n_vt /
                                   splits);
  const int kt_n = d / kBK;
  const int total = (vt1 - vt0) * kt_n;

  // this thread's rows: local row warp_m*32 + mt*16 + g + 8*half
  int trow[2][2];
  float m_run[2][2], l_run[2][2], tl_run[2][2];
  int am_run[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      trow[mt][hf] = targets[m0 + warp_m * 32 + mt * 16 + g + 8 * hf];
      m_run[mt][hf] = kNegInf;
      l_run[mt][hf] = 0.f;
      tl_run[mt][hf] = 0.f;
      am_run[mt][hf] = 0;
    }
  }

  auto issue = [&](int it) {
    if (it < total) {
      const int st = it % kStages;
      const int vt = vt0 + it / kt_n;
      const int k0 = (it % kt_n) * kBK;
      load_a(sa + st * kATile, x, d, m0, k0, tid);
      load_b_kn(sb + st * kBknTile, head, v, k0, vt * kBN, tid);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    const int st = it % kStages;
    mma_stage<false>(acc, sa + st * kATile, sb + st * kBknTile, warp_m,
                     warp_n, lane);
    if (it % kt_n != kt_n - 1) continue;

    // the tile's logits are complete: fold them into the running stats
    const int cbase = (vt0 + it / kt_n) * kBN + warp_n * 64 + tig * 2;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float tmax = kNegInf;
        int tidx = 0;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float val = acc[mt][nt][2 * hf + j];
            const int col = cbase + nt * 8 + j;
            if (val > tmax) {
              tmax = val;
              tidx = col;
            }
            if (col == trow[mt][hf]) tl_run[mt][hf] += val;
          }
        }
        const float m_old = m_run[mt][hf];
        if (tmax > m_old) am_run[mt][hf] = tidx;
        const float m_new = fmaxf(m_old, tmax);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          sum += expf(acc[mt][nt][2 * hf] - m_new) +
                 expf(acc[mt][nt][2 * hf + 1] - m_new);
        }
        l_run[mt][hf] = l_run[mt][hf] * expf(m_old - m_new) + sum;
        m_run[mt][hf] = m_new;
      }
    }
    zero_acc(acc);
  }
  cp_async_wait<0>();

  // the four lanes of a quad hold interleaved columns of the same rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m_run[mt][hf], off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l_run[mt][hf], off);
        const float t2 = __shfl_xor_sync(0xffffffffu, tl_run[mt][hf], off);
        const int a2 = __shfl_xor_sync(0xffffffffu, am_run[mt][hf], off);
        merge_stats(m_run[mt][hf], l_run[mt][hf], tl_run[mt][hf],
                    am_run[mt][hf], m2, l2, t2, a2);
      }
      if (tig == 0) {
        const int r = warp_m * 32 + mt * 16 + g + 8 * hf;
        red_m[warp_n][r] = m_run[mt][hf];
        red_l[warp_n][r] = l_run[mt][hf];
        red_tl[warp_n][r] = tl_run[mt][hf];
        red_am[warp_n][r] = am_run[mt][hf];
      }
    }
  }
  __syncthreads();
  if (tid < kBM) {
    float m = red_m[0][tid], l = red_l[0][tid], tl = red_tl[0][tid];
    int am = red_am[0][tid];
    merge_stats(m, l, tl, am, red_m[1][tid], red_l[1][tid], red_tl[1][tid],
                red_am[1][tid]);
    const long long o = static_cast<long long>(split) * n + m0 + tid;
    part_m[o] = m;
    part_l[o] = l;
    part_tl[o] = tl;
    part_am[o] = am;
  }
}

// One thread per row: the splits in order, as the reference's sequential
// vocabulary walk folds its tiles.
__global__ void ce_fwd_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_tl, const int* __restrict__ part_am,
    float* __restrict__ logz, float* __restrict__ tl, int* __restrict__ am,
    int n, int splits) {
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
}

// ---------------------------------------------------------------------------
// B8: d from the recomputed logits, then dx = d @ head^T
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ce_dlogits_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ head,
    const int* __restrict__ targets, const float* __restrict__ logz,
    const float* __restrict__ gz, const float* __restrict__ gt,
    bf16* __restrict__ dbuf, int d, int v) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* sa = smem;
  bf16* sb = smem + kStages * kATile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kt_n = d / kBK;

  auto issue = [&](int it) {
    if (it < kt_n) {
      const int st = it % kStages;
      load_a(sa + st * kATile, x, d, m0, it * kBK, tid);
      load_b_kn(sb + st * kBknTile, head, v, it * kBK, n0, tid);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < kt_n; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    const int st = it % kStages;
    mma_stage<false>(acc, sa + st * kATile, sb + st * kBknTile, warp_m,
                     warp_n, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + warp_m * 32 + mt * 16 + g + 8 * hf;
      const float lz = logz[row];
      const float gg = gz[row];
      const float hh = gt[row];
      const int t = targets[row];
      bf16* out = dbuf + static_cast<long long>(row) * v;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + warp_n * 64 + nt * 8 + tig * 2;
        const float d0 = gg * expf(acc[mt][nt][2 * hf] - lz) +
                         (col == t ? hh : 0.f);
        const float d1 = gg * expf(acc[mt][nt][2 * hf + 1] - lz) +
                         (col + 1 == t ? hh : 0.f);
        *reinterpret_cast<uint32_t*>(out + col) = pack_floats(d0, d1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ce_dx_kernel(
    const bf16* __restrict__ dbuf, const bf16* __restrict__ head,
    bf16* __restrict__ dx, int d, int v) {
  extern __shared__ __align__(16) bf16 smem[];
  bf16* sa = smem;
  bf16* sb = smem + kStages * kATile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * kBN;  // columns of dx: rows of head
  const int m0 = blockIdx.y * kBM;
  const int kt_n = v / kBK;

  auto issue = [&](int it) {
    if (it < kt_n) {
      const int st = it % kStages;
      load_a(sa + st * kATile, dbuf, v, m0, it * kBK, tid);
      load_b_nk(sb + st * kBnkTile, head, v, n0, it * kBK, tid);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < kt_n; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    const int st = it % kStages;
    mma_stage<true>(acc, sa + st * kATile, sb + st * kBnkTile, warp_m,
                    warp_n, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + warp_m * 32 + mt * 16 + g + 8 * hf;
      bf16* out = dx + static_cast<long long>(row) * d;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + warp_n * 64 + nt * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_floats(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
    }
  }
}

constexpr size_t kSmemKN = kStages * (kATile + kBknTile) * sizeof(bf16);
constexpr size_t kSmemNK = kStages * (kATile + kBnkTile) * sizeof(bf16);

bool shape_ok(int n, int d, int v) {
  return n > 0 && d > 0 && v > 0 && n % kBM == 0 && v % kBN == 0 &&
         d % kBN == 0;
}

}  // namespace

// B7: (logz, tl, am) per row. part_* are (splits, N) scratch buffers;
// 1 <= splits <= V / 128.
extern "C" int ce_fwd_bf16(const void* x, const void* head,
                           const void* targets, void* part_m, void* part_l,
                           void* part_tl, void* part_am, void* logz, void* tl,
                           void* am, int n, int d, int v, int splits,
                           void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(n, d, v) || splits < 1 || splits > v / kBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemKN));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ce_fwd_kernel<<<dim3(n / kBM, splits), kThreads, kSmemKN, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(head),
      static_cast<const int*>(targets), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_tl),
      static_cast<int*>(part_am), n, d, v, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_tl), static_cast<const int*>(part_am),
      static_cast<float*>(logz), static_cast<float*>(tl),
      static_cast<int*>(am), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// B8, first launch: d (N, V) bf16 from the recomputed logits.
extern "C" int ce_dlogits_bf16(const void* x, const void* head,
                               const void* targets, const void* logz,
                               const void* gz, const void* gt, void* dbuf,
                               int n, int d, int v, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(n, d, v)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ce_dlogits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemKN));
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_dlogits_kernel<<<dim3(n / kBM, v / kBN), kThreads, kSmemKN,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(head),
      static_cast<const int*>(targets), static_cast<const float*>(logz),
      static_cast<const float*>(gz), static_cast<const float*>(gt),
      static_cast<bf16*>(dbuf), d, v);
  return static_cast<int>(cudaGetLastError());
}

// B8, second launch: dx (N, D) bf16 = d @ head^T, f32 accumulate.
extern "C" int ce_dx_bf16(const void* dbuf, const void* head, void* dx,
                          int n, int d, int v, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(n, d, v)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ce_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemNK));
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_dx_kernel<<<dim3(d / kBN, n / kBM), kThreads, kSmemNK,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dbuf), static_cast<const bf16*>(head),
      static_cast<bf16*>(dx), d, v);
  return static_cast<int>(cudaGetLastError());
}
