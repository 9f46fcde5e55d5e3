// Flash attention for Hopper (sm_90a): the training path's causal
// (optionally segment-masked) attention, forward and backward.
//
// Replaces the four Pallas TPU kernels of
// cloud_server_tpu/ops/flash_attention.py:
//   _fwd_kernel        -> flash_fwd_kernel        (entry flash_attention_fwd_bf16)
//   _bwd_dkdv_kernel   -> flash_bwd_kv_kernel<D, false>
//                                                 (entry flash_attention_bwd_dkdv_bf16)
//   _bwd_dq_kernel     -> flash_bwd_dq_kernel     (entry flash_attention_bwd_dq_bf16)
//   _bwd_fused_kernel  -> flash_bwd_kv_kernel<D, true>
//                                                 (entry flash_attention_bwd_fused_bf16)
// The Python wrapper (ops/flash_attention.py) picks the fused or the
// blocked backward by the reference's rule (S <= block), whatever tiles
// the kernels use inside, and counts each launch under its TPU kernel.
//
// What is computed, per batch b, q head h, kv head kh = h / G:
//   s[i][t]  = (q[i] . k[t]) * scale, masked to t <= i and, with segment
//              ids, seg[i] == seg[t] (masked scores are NEG_INF = -1e30,
//              as in the reference)
//   lse[i]   = log sum_t exp(s[i][t])                  (f32, (B, H, S))
//   out[i]   = sum_t softmax(s[i])[t] v[t]             (bf16)
//   delta[i] = sum_d dout[i][d] out[i][d]              (f32, pre-pass)
//   p[i][t]  = exp(s[i][t] - lse[i]) on the mask, else 0
//   ds[i][t] = p (dout[i] . v[t] - delta[i]) * scale   (rounded to bf16)
//   dv[t] = sum_{i,h in group} p[i][t] dout[i],  dk[t] = sum ds[i][t] q[i],
//   dq[i] = sum_t ds[i][t] k[t]
// Layouts: q, out, dout (B, H, S, Dh); k, v, dk, dv (B, KH, S, Dh); all
// bf16 and contiguous; seg (B, S) int32 or null. S is a multiple of 64.
// Products are bf16 x bf16 summed in f32 on the tensor cores (mma.sync
// m16n8k16, fragment helpers in mma_bf16.cuh); softmax math is f32, and
// probabilities are rounded to bf16 before each product, as the
// reference's kernels do.
//
// Layout of the work:
//   forward  grid (S/64, H, B), 4 warps x 16 q rows. The block walks kv
//            tiles of 64 only up to its last row (the tile-level causal
//            skip); online softmax in registers, GQA by index.
//   dK/dV    grid (S/64, KH, B), 4 warps x 16 kv rows, kv-stationary: the
//            block walks the q tiles of 32 at or after its first row, for
//            each of the G q heads of its kv head, recomputing P from the
//            saved LSE. dK and dV accumulate over the group in f32
//            registers and are written once per kv head in bf16 (the
//            reference writes f32 per q head and sums the group outside).
//   dQ       grid (S/64, H, B), 4 warps x 16 q rows, q-stationary over kv
//            tiles of 32 up to its last row.
//   fused    the dK/dV kernel, which also forms dQ: each (q tile, kv tile)
//            pair's dS is staged in shared memory and its dS.K partial is
//            added with atomicAdd into an f32 dQ the wrapper zeroed, so
//            one launch produces dQ, dK and dV. The atomics make dQ's
//            summation order vary from run to run.
//
// What bounds it on an H100: at S = 1024-2048 and Dh 128 the causal
// products (4 Dh operations per visible pair forward, 10 Dh backward) are
// well above the card's ridge point, so the tensor-core rate bounds every
// kernel. This first version feeds the tensor cores with mma.sync from
// shared memory filled by plain 16-byte loads: no wgmma, no TMA, no
// double buffering and no warp specialisation, so it runs far from that
// bound; its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;       // four warps
constexpr int kRows = 64;           // rows (q or kv) per block
constexpr int kPad = 8;             // shared row padding (bf16 elements)
constexpr int kFwdTile = 64;        // kv positions per forward tile
constexpr int kDqTile = 32;         // kv positions per dQ tile
constexpr int kKvTileQ = 32;        // q rows per dK/dV tile
constexpr float kNegInf = -1e30f;   // the reference's finite NEG_INF

// Copy `rows` rows of a (., D) bf16 array into shared rows of stride
// D + kPad, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows, int tid) {
  constexpr int kVec = D / 8;
  for (int item = tid; item < rows * kVec; item += kThreads) {
    const int r = item / kVec;
    const int c = (item % kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * D +
                                        c);
  }
}

// A fragments of the 16 rows [row0, row0 + 16) of a (., D) row-major
// bf16 array in device memory.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t frag[D / 16][4],
                                            const bf16* base, int row0,
                                            int g, int tig) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    frag[kk][0] = load_pair(base + (row0 + g) * D + c);
    frag[kk][1] = load_pair(base + (row0 + g + 8) * D + c);
    frag[kk][2] = load_pair(base + (row0 + g) * D + c + 8);
    frag[kk][3] = load_pair(base + (row0 + g + 8) * D + c + 8);
  }
}

// ---------------------------------------------------------------------------
// Forward (B3)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg,
    bf16* __restrict__ out, float* __restrict__ lse, int heads,
    int kv_heads, int seq, float scale) {
  constexpr int kS = D + kPad;
  __shared__ __align__(16) bf16 ks[kFwdTile * kS];
  __shared__ __align__(16) bf16 vs[kFwdTile * kS];
  __shared__ int segs[kFwdTile];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const bool has_seg = seg != nullptr;

  const long long qrow0 = (static_cast<long long>(b) * heads + h) * seq;
  const long long krow0 = (static_cast<long long>(b) * kv_heads + kh) * seq;
  const bf16* qb = q + qrow0 * D;
  const bf16* kb = k + krow0 * D;
  const bf16* vb = v + krow0 * D;
  const int seg_lo = has_seg ? seg[b * seq + r_lo] : 0;
  const int seg_hi = has_seg ? seg[b * seq + r_hi] : 0;

  uint32_t qf[D / 16][4];
  load_a_rows<D>(qf, qb, q0 + warp * 16, g, tig);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  float m_lo = kNegInf, m_hi = kNegInf;
  float l_lo = 0.f, l_hi = 0.f;  // per-thread partial sums

  // kv tiles up to the block's last row: the reference's block skip
  const int n_tiles = (q0 + kRows) / kFwdTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kFwdTile;
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(ks, kb + static_cast<long long>(t0) * D, kFwdTile, tid);
    load_tile<D>(vs, vb + static_cast<long long>(t0) * D, kFwdTile, tid);
    if (has_seg && tid < kFwdTile) segs[tid] = seg[b * seq + t0 + tid];
    __syncthreads();

    // S = Q K^T: 16 rows x 64 positions per warp
    float s[kFwdTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kFwdTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kFwdTile / 8; ++nt) {
        const bf16* kr = ks + (nt * 8 + g) * kS + kk * 16 + tig * 2;
        mma_bf16(s[nt], qf[kk], load_pair(kr), load_pair(kr + 8));
      }
    }

    // mask, online softmax (f32)
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kFwdTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = nt * 8 + tig * 2 + j;
        const int col = t0 + cl;
        const int sc = has_seg ? segs[cl] : 0;
        const bool ok_lo = col <= r_lo && sc == seg_lo;
        const bool ok_hi = col <= r_hi && sc == seg_hi;
        s[nt][j] = ok_lo ? s[nt][j] * scale : kNegInf;
        s[nt][2 + j] = ok_hi ? s[nt][2 + j] * scale : kNegInf;
        mx_lo = fmaxf(mx_lo, s[nt][j]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + j]);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float corr_lo = expf(m_lo - mn_lo);
    const float corr_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kFwdTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - mn_lo);
        s[nt][2 + j] = expf(s[nt][2 + j] - mn_hi);
        sum_lo += s[nt][j];
        sum_hi += s[nt][2 + j];
      }
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= corr_lo;
      acc[nt][1] *= corr_lo;
      acc[nt][2] *= corr_hi;
      acc[nt][3] *= corr_hi;
    }

    // O += P V; B operand (t, d) from the (t, d) tile: two 16-bit loads
#pragma unroll
    for (int kk = 0; kk < kFwdTile / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* v0 = vs + (kk * 16 + tig * 2) * kS + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const bf16* vr = v0 + nt * 8;
        mma_bf16(acc[nt], pa, pack_raw(vr[0], vr[kS]),
                 pack_raw(vr[8 * kS], vr[9 * kS]));
      }
    }
  }

  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* ob = out + qrow0 * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(ob + r_lo * D + c) =
        pack_floats(acc[nt][0] / den_lo, acc[nt][1] / den_lo);
    *reinterpret_cast<uint32_t*>(ob + r_hi * D + c) =
        pack_floats(acc[nt][2] / den_hi, acc[nt][3] / den_hi);
  }
  if (tig == 0) {
    lse[qrow0 + r_lo] = m_lo + logf(den_lo);
    lse[qrow0 + r_hi] = m_hi + logf(den_hi);
  }
}

// ---------------------------------------------------------------------------
// Backward pre-pass: delta = rowsum(dout * out), f32
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ delta, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane * 2; c < D; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + row * D + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + row * D + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// dQ (B5): q-stationary
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, bf16* __restrict__ dq, int heads,
    int kv_heads, int seq, float scale) {
  constexpr int kS = D + kPad;
  __shared__ __align__(16) bf16 ks[kDqTile * kS];
  __shared__ __align__(16) bf16 vs[kDqTile * kS];
  __shared__ int segs[kDqTile];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const bool has_seg = seg != nullptr;

  const long long qrow0 = (static_cast<long long>(b) * heads + h) * seq;
  const long long krow0 = (static_cast<long long>(b) * kv_heads + kh) * seq;
  const bf16* kb = k + krow0 * D;
  const bf16* vb = v + krow0 * D;
  const int seg_lo = has_seg ? seg[b * seq + r_lo] : 0;
  const int seg_hi = has_seg ? seg[b * seq + r_hi] : 0;
  const float lse_lo = lse[qrow0 + r_lo], lse_hi = lse[qrow0 + r_hi];
  const float dl_lo = delta[qrow0 + r_lo], dl_hi = delta[qrow0 + r_hi];

  uint32_t qf[D / 16][4];
  uint32_t df[D / 16][4];
  load_a_rows<D>(qf, q + qrow0 * D, q0 + warp * 16, g, tig);
  load_a_rows<D>(df, dout + qrow0 * D, q0 + warp * 16, g, tig);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  const int n_tiles = (q0 + kRows) / kDqTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kDqTile;
    __syncthreads();
    load_tile<D>(ks, kb + static_cast<long long>(t0) * D, kDqTile, tid);
    load_tile<D>(vs, vb + static_cast<long long>(t0) * D, kDqTile, tid);
    if (has_seg && tid < kDqTile) segs[tid] = seg[b * seq + t0 + tid];
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 rows x 32 positions per warp
    float s[kDqTile / 8][4];
    float dp[kDqTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDqTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kDqTile / 8; ++nt) {
        const int off = (nt * 8 + g) * kS + kk * 16 + tig * 2;
        mma_bf16(s[nt], qf[kk], load_pair(ks + off), load_pair(ks + off + 8));
        mma_bf16(dp[nt], df[kk], load_pair(vs + off),
                 load_pair(vs + off + 8));
      }
    }
    // dS = P (dP - delta) scale, P recomputed from the LSE
#pragma unroll
    for (int nt = 0; nt < kDqTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = nt * 8 + tig * 2 + j;
        const int col = t0 + cl;
        const int sc = has_seg ? segs[cl] : 0;
        const float p_lo = (col <= r_lo && sc == seg_lo)
                               ? expf(s[nt][j] * scale - lse_lo) : 0.f;
        const float p_hi = (col <= r_hi && sc == seg_hi)
                               ? expf(s[nt][2 + j] * scale - lse_hi) : 0.f;
        s[nt][j] = p_lo * (dp[nt][j] - dl_lo) * scale;
        s[nt][2 + j] = p_hi * (dp[nt][2 + j] - dl_hi) * scale;
      }
    }
    // dQ += dS K; B operand (t, d) from the (t, d) tile
#pragma unroll
    for (int kk = 0; kk < kDqTile / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* k0 = ks + (kk * 16 + tig * 2) * kS + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const bf16* kr = k0 + nt * 8;
        mma_bf16(acc[nt], pa, pack_raw(kr[0], kr[kS]),
                 pack_raw(kr[8 * kS], kr[9 * kS]));
      }
    }
  }

  bf16* dqb = dq + qrow0 * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(dqb + r_lo * D + c) =
        pack_floats(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(dqb + r_hi * D + c) =
        pack_floats(acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV (B4), and with WITH_DQ the fused whole-sequence backward (B6)
// ---------------------------------------------------------------------------

template <int D, bool WITH_DQ>
constexpr size_t kv_smem_bytes() {
  return static_cast<size_t>(2 * kRows + 2 * kKvTileQ) * (D + kPad) *
             sizeof(bf16) +
         3 * kKvTileQ * sizeof(float) +
         (WITH_DQ ? static_cast<size_t>(kRows) * (kKvTileQ + kPad) *
                        sizeof(bf16)
                  : 0);
}

template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dq32, int heads,
    int kv_heads, int seq, float scale) {
  constexpr int kS = D + kPad;
  constexpr int kDsS = kKvTileQ + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kRows * kS;
  bf16* qs = vs + kRows * kS;
  bf16* dos = qs + kKvTileQ * kS;
  float* lse_s = reinterpret_cast<float*>(dos + kKvTileQ * kS);
  float* dl_s = lse_s + kKvTileQ;
  int* segq = reinterpret_cast<int*>(dl_s + kKvTileQ);
  bf16* dst = reinterpret_cast<bf16*>(segq + kKvTileQ);  // (64, 32) dS^T

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int k0 = blockIdx.x * kRows;
  const int w0 = warp * 16;          // this warp's first kv row in the tile
  const int t_lo = k0 + w0 + g;      // absolute kv rows of its fragments
  const int t_hi = t_lo + 8;
  const bool has_seg = seg != nullptr;
  const int seg_lo = has_seg ? seg[b * seq + t_lo] : 0;
  const int seg_hi = has_seg ? seg[b * seq + t_hi] : 0;

  const long long krow0 = (static_cast<long long>(b) * kv_heads + kh) * seq;
  load_tile<D>(ks, k + (krow0 + k0) * D, kRows, tid);
  load_tile<D>(vs, v + (krow0 + k0) * D, kRows, tid);

  float dka[D / 8][4];
  float dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
  }

  for (int hg = 0; hg < group; ++hg) {
    const int h = kh * group + hg;
    const long long qrow0 = (static_cast<long long>(b) * heads + h) * seq;
    // q tiles whose rows reach this kv tile: the reference's block skip
    for (int i0 = k0; i0 < seq; i0 += kKvTileQ) {
      __syncthreads();  // the previous q tile (and dS^T) is no longer read
      load_tile<D>(qs, q + (qrow0 + i0) * D, kKvTileQ, tid);
      load_tile<D>(dos, dout + (qrow0 + i0) * D, kKvTileQ, tid);
      if (tid < kKvTileQ) {
        lse_s[tid] = lse[qrow0 + i0 + tid];
        dl_s[tid] = delta[qrow0 + i0 + tid];
        segq[tid] = has_seg ? seg[b * seq + i0 + tid] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns per warp
      float s[kKvTileQ / 8][4];
      float dp[kKvTileQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKvTileQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + tig * 2;
        uint32_t ka[4], va[4];
        ka[0] = load_pair(ks + (w0 + g) * kS + c);
        ka[1] = load_pair(ks + (w0 + g + 8) * kS + c);
        ka[2] = load_pair(ks + (w0 + g) * kS + c + 8);
        ka[3] = load_pair(ks + (w0 + g + 8) * kS + c + 8);
        va[0] = load_pair(vs + (w0 + g) * kS + c);
        va[1] = load_pair(vs + (w0 + g + 8) * kS + c);
        va[2] = load_pair(vs + (w0 + g) * kS + c + 8);
        va[3] = load_pair(vs + (w0 + g + 8) * kS + c + 8);
#pragma unroll
        for (int nt = 0; nt < kKvTileQ / 8; ++nt) {
          const int off = (nt * 8 + g) * kS + c;
          mma_bf16(s[nt], ka, load_pair(qs + off), load_pair(qs + off + 8));
          mma_bf16(dp[nt], va, load_pair(dos + off),
                   load_pair(dos + off + 8));
        }
      }
      // P^T (into s) and dS^T (into dp), f32
#pragma unroll
      for (int nt = 0; nt < kKvTileQ / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = nt * 8 + tig * 2 + j;
          const int i = i0 + ci;
          const float ls = lse_s[ci];
          const float dl = dl_s[ci];
          const int sq = segq[ci];
          const float p_lo =
              (i >= t_lo && sq == seg_lo) ? expf(s[nt][j] * scale - ls) : 0.f;
          const float p_hi = (i >= t_hi && sq == seg_hi)
                                 ? expf(s[nt][2 + j] * scale - ls) : 0.f;
          s[nt][j] = p_lo;
          s[nt][2 + j] = p_hi;
          dp[nt][j] = p_lo * (dp[nt][j] - dl) * scale;
          dp[nt][2 + j] = p_hi * (dp[nt][2 + j] - dl) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q; B operands (i, d) from (i, d) tiles
#pragma unroll
      for (int kk = 0; kk < kKvTileQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack_floats(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_floats(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_floats(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_floats(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int r = (kk * 16 + tig * 2) * kS + g;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const bf16* dr = dos + r + nt * 8;
          const bf16* qr = qs + r + nt * 8;
          mma_bf16(dva[nt], pa, pack_raw(dr[0], dr[kS]),
                   pack_raw(dr[8 * kS], dr[9 * kS]));
          mma_bf16(dka[nt], da, pack_raw(qr[0], qr[kS]),
                   pack_raw(qr[8 * kS], qr[9 * kS]));
        }
        if (WITH_DQ) {
          // stage dS^T (kv rows x q columns) for the dQ partial
          const int c0 = kk * 16 + tig * 2;
          *reinterpret_cast<uint32_t*>(dst + (w0 + g) * kDsS + c0) = da[0];
          *reinterpret_cast<uint32_t*>(dst + (w0 + g + 8) * kDsS + c0) =
              da[1];
          *reinterpret_cast<uint32_t*>(dst + (w0 + g) * kDsS + c0 + 8) =
              da[2];
          *reinterpret_cast<uint32_t*>(dst + (w0 + g + 8) * kDsS + c0 + 8) =
              da[3];
        }
      }
      if (WITH_DQ) {
        __syncthreads();
        // dQ[i0 .. i0+32) += dS (32 x 64) K (64 x D). Warp w takes the
        // 16 q rows (w & 1) and half of the D columns (w >> 1).
        const int mrow = (warp & 1) * 16;
        constexpr int kHalf = D / 16;  // n-tiles of 8 per warp
        const int nbase = (warp >> 1) * kHalf;
        float qa[kHalf][4];
#pragma unroll
        for (int nt = 0; nt < kHalf; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[nt][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          // A = dS[i][t] read from dS^T[t][i]: two 16-bit loads
          const bf16* a0 = dst + (kk * 16 + tig * 2) * kDsS + mrow + g;
          uint32_t a[4];
          a[0] = pack_raw(a0[0], a0[kDsS]);
          a[1] = pack_raw(a0[8], a0[kDsS + 8]);
          a[2] = pack_raw(a0[8 * kDsS], a0[9 * kDsS]);
          a[3] = pack_raw(a0[8 * kDsS + 8], a0[9 * kDsS + 8]);
          const bf16* k0p = ks + (kk * 16 + tig * 2) * kS + g;
#pragma unroll
          for (int nt = 0; nt < kHalf; ++nt) {
            const bf16* kr = k0p + (nbase + nt) * 8;
            mma_bf16(qa[nt], a, pack_raw(kr[0], kr[kS]),
                     pack_raw(kr[8 * kS], kr[9 * kS]));
          }
        }
        float* dqb = dq32 + (qrow0 + i0 + mrow) * D;
#pragma unroll
        for (int nt = 0; nt < kHalf; ++nt) {
          const int c = (nbase + nt) * 8 + tig * 2;
          atomicAdd(dqb + g * D + c, qa[nt][0]);
          atomicAdd(dqb + g * D + c + 1, qa[nt][1]);
          atomicAdd(dqb + (g + 8) * D + c, qa[nt][2]);
          atomicAdd(dqb + (g + 8) * D + c + 1, qa[nt][3]);
        }
      }
    }
  }

  bf16* dkb = dk + (krow0 + k0) * D;
  bf16* dvb = dv + (krow0 + k0) * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(dkb + (w0 + g) * D + c) =
        pack_floats(dka[nt][0], dka[nt][1]);
    *reinterpret_cast<uint32_t*>(dkb + (w0 + g + 8) * D + c) =
        pack_floats(dka[nt][2], dka[nt][3]);
    *reinterpret_cast<uint32_t*>(dvb + (w0 + g) * D + c) =
        pack_floats(dva[nt][0], dva[nt][1]);
    *reinterpret_cast<uint32_t*>(dvb + (w0 + g + 8) * D + c) =
        pack_floats(dva[nt][2], dva[nt][3]);
  }
}

template <int D>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         int batch, int heads, int seq, cudaStream_t s) {
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const int per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  flash_delta_kernel<D><<<blocks, kThreads, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <int D, bool WITH_DQ>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const void* lse,
                      const void* seg, void* delta, void* dk, void* dv,
                      void* dq32, int batch, int heads, int kv_heads,
                      int seq, float scale, cudaStream_t s) {
  cudaError_t e = launch_delta<D>(out, dout, delta, batch, heads, seq, s);
  if (e != cudaSuccess) return e;
  const size_t smem = kv_smem_bytes<D, WITH_DQ>();
  e = cudaFuncSetAttribute(flash_bwd_kv_kernel<D, WITH_DQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(seq / kRows, kv_heads, batch);
  flash_bwd_kv_kernel<D, WITH_DQ><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dq32), heads, kv_heads,
      seq, scale);
  return cudaGetLastError();
}

bool shape_ok(int batch, int heads, int kv_heads, int seq) {
  return batch > 0 && kv_heads > 0 && heads % kv_heads == 0 && seq > 0 &&
         seq % kRows == 0;
}

}  // namespace

// C entries, bound with ctypes. Pointers are device pointers of
// contiguous tensors (seg may be null); `stream` is the caller's
// cudaStream_t. They allocate nothing, do not synchronise, and return
// cudaGetLastError() after the last launch (cudaErrorInvalidValue for a
// shape or head dim they do not take).

extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    void* lse, int batch, int heads, int kv_heads, int seq, int head_dim,
    float scale, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(batch, heads, kv_heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(seq / kRows, heads, batch);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* sp = static_cast<const int*>(seg);
  auto* op = static_cast<bf16*>(out);
  auto* lp = static_cast<float*>(lse);
  switch (head_dim) {
    case 64:
      flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(
          qp, kp, vp, sp, op, lp, heads, kv_heads, seq, scale);
      break;
    case 128:
      flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(
          qp, kp, vp, sp, op, lp, heads, kv_heads, seq, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B4: delta pre-pass, then dK/dV (written per kv head, bf16).
extern "C" int flash_attention_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* seg, void* delta,
    void* dk, void* dv, int batch, int heads, int kv_heads, int seq,
    int head_dim, float scale, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(batch, heads, kv_heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_kv<64, false>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, nullptr, batch,
          heads, kv_heads, seq, scale, s));
    case 128:
      return static_cast<int>(launch_kv<128, false>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, nullptr, batch,
          heads, kv_heads, seq, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B5: dQ from the delta the dK/dV entry wrote.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dq,
    int batch, int heads, int kv_heads, int seq, int head_dim, float scale,
    void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(batch, heads, kv_heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(seq / kRows, heads, batch);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* sp = static_cast<const int*>(seg);
  auto* dqp = static_cast<bf16*>(dq);
  switch (head_dim) {
    case 64:
      flash_bwd_dq_kernel<64><<<grid, kThreads, 0, s>>>(
          qp, kp, vp, dp, lp, dl, sp, dqp, heads, kv_heads, seq, scale);
      break;
    case 128:
      flash_bwd_dq_kernel<128><<<grid, kThreads, 0, s>>>(
          qp, kp, vp, dp, lp, dl, sp, dqp, heads, kv_heads, seq, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B6: delta pre-pass, then dK/dV with dQ added into the zeroed f32 dq32.
extern "C" int flash_attention_bwd_fused_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* seg, void* delta,
    void* dq32, void* dk, void* dv, int batch, int heads, int kv_heads,
    int seq, int head_dim, float scale, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(batch, heads, kv_heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_kv<64, true>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, dq32, batch, heads,
          kv_heads, seq, scale, s));
    case 128:
      return static_cast<int>(launch_kv<128, true>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, dq32, batch, heads,
          kv_heads, seq, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
