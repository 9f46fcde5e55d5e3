// Paged attention for Hopper (sm_90a): one kernel for the serving path's
// cached attention at every window width.
//
// Replaces the two Pallas TPU kernels of the reference package,
// cloud_server_tpu/ops/paged_attention.py::_paged_attention_kernel (the
// batch-unrolled narrow kernel, W <= 32 and B <= 16: decode rounds) and
// ::_paged_attention_wide_kernel (grid over slot and kv head: prefill
// chunks and ragged mixed batches). Both compute one function, so one
// kernel serves both shape classes; the Python wrapper counts each launch
// under the TPU kernel whose class it serves.
//
// What it computes, for slot b, kv head h and folded query row r (row r of
// the (W*G, Dh) block is window position r / G, GQA group member r % G):
//   row_pos = lengths[b] - widths[b] + r / G
//   out[r]  = softmax_c(q[r] . k[c] * scale, over c <= row_pos and
//             c < lengths[b]) . v
// with k/v read from the pool (L, P, KH, Dh, ps) through the slot's int32
// page table. Page ids are clamped into [0, P-1] (those reads are masked
// anyway); the layer is selected by offset, so no pool slice is ever
// materialised. The online softmax runs in f32 with the finite
// NEG_INF = -0.7 * FLT_MAX, and the output is divided by max(l, 1e-30):
// length-0 slots and rows past their width give finite garbage, never NaN.
// Scores are bf16 x bf16 products summed in f32; the probabilities are
// rounded to bf16 before the P.V product, as in the reference.
//
// Layout of the work: the grid is (ceil(W*G / 64), KH, B). A block of four
// warps owns 64 folded query rows of one (slot, kv head); each warp owns 16
// rows and keeps its Q fragments, its running max/sum and its (16, Dh) f32
// accumulator in registers. The block walks the kv positions in tiles of 64,
// only up to min(lengths[b], last row position + 1): reads are bounded by
// length and by causality. All 128 threads copy each K and V tile into shared
// memory in the pool's own (Dh, positions) layout, 16 bytes per thread where
// the page size allows; the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) then compute S = Q K^T and O += P V. The transposed page layout
// puts positions on the minor axis: for S the B operand (d, t) needs two
// 16-bit shared loads per register, for P V the B operand (t, d) reads two
// neighbouring positions in one 32-bit load.
//
// What bounds it on an H100: at decode (W = 1, W*G = 4 rows per kv head)
// the K/V page bytes, so it is memory-bound; for wide prefill windows
// (W*G = 1024 rows) the tensor-core FLOPs. This first version does neither
// split-KV at decode (the grid is only B * KH blocks) nor wgmma/TMA nor
// double buffering of the tiles; its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;  // folded query rows per block
constexpr int kTile = 64;                     // kv positions per tile
constexpr int kPad = 8;                       // shared row padding (bf16)
constexpr float kNegInf = -0.7f * 3.402823466e38f;

template <int HEAD_DIM>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, KH, WG, Dh)
    const __nv_bfloat16* __restrict__ k_pool,  // (L, P, KH, Dh, ps)
    const __nv_bfloat16* __restrict__ v_pool,  // (L, P, KH, Dh, ps)
    const int* __restrict__ lengths,           // (B,)
    const int* __restrict__ tables,            // (B, max_pages)
    const int* __restrict__ widths,            // (B,)
    __nv_bfloat16* __restrict__ out,           // (B, KH, WG, Dh)
    int kv_heads, int wg, int group, int num_pages, int page_size,
    int max_pages, long long layer_offset, float scale, int vec_ok) {
  static_assert(HEAD_DIM % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 ks[HEAD_DIM][kTile + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[HEAD_DIM][kTile + kPad];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: fragment row
  const int tig = lane & 3;  // thread in group: fragment column pair

  const int kv_len = lengths[b];
  const int anchor = kv_len - widths[b];
  const int row0 = blockIdx.x * kRows;
  const int last_row = min(wg, row0 + kRows) - 1;
  // every key past the block's last query position is masked for all of
  // its rows, and every key past the length for all rows
  const int kv_end = max(0, min(kv_len, anchor + last_row / group + 1));
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  const long long head_stride = static_cast<long long>(HEAD_DIM) * page_size;
  const long long page_stride = head_stride * kv_heads;
  const __nv_bfloat16* kbase = k_pool + layer_offset + h * head_stride;
  const __nv_bfloat16* vbase = v_pool + layer_offset + h * head_stride;
  const int* table = tables + static_cast<long long>(b) * max_pages;

  const int wrow = row0 + warp * kRowsPerWarp;
  const bool warp_active = wrow < wg;
  const int r_lo = wrow + g;
  const int r_hi = wrow + g + 8;
  const int pos_lo = anchor + r_lo / group;
  const int pos_hi = anchor + r_hi / group;

  const __nv_bfloat16* qbase =
      q + (static_cast<long long>(b) * kv_heads + h) * wg * HEAD_DIM;
  uint32_t qf[HEAD_DIM / 16][4];
#pragma unroll
  for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    const bool lo_ok = warp_active && r_lo < wg;
    const bool hi_ok = warp_active && r_hi < wg;
    qf[kk][0] = lo_ok ? load_pair(qbase + r_lo * HEAD_DIM + c) : 0u;
    qf[kk][1] = hi_ok ? load_pair(qbase + r_hi * HEAD_DIM + c) : 0u;
    qf[kk][2] = lo_ok ? load_pair(qbase + r_lo * HEAD_DIM + c + 8) : 0u;
    qf[kk][3] = hi_ok ? load_pair(qbase + r_hi * HEAD_DIM + c + 8) : 0u;
  }

  float acc[HEAD_DIM / 8][4];
#pragma unroll
  for (int nt = 0; nt < HEAD_DIM / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  float m_lo = kNegInf, m_hi = kNegInf;
  float l_lo = 0.f, l_hi = 0.f;  // per-thread partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kTile;
    __syncthreads();  // the previous tile is no longer read
    for (int item = tid; item < HEAD_DIM * (kTile / 8); item += kThreads) {
      const int d = item / (kTile / 8);
      const int c8 = (item % (kTile / 8)) * 8;
      const int pos = t0 + c8;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u);
      uint4 vw = make_uint4(0u, 0u, 0u, 0u);
      if (vec_ok && pos + 8 <= kv_end) {
        // 8 positions inside one page: page_size % 8 == 0, pos % 8 == 0
        const int page = min(max(table[min(pos / page_size, max_pages - 1)],
                                 0), num_pages - 1);
        const long long off = page * page_stride +
                              static_cast<long long>(d) * page_size +
                              pos % page_size;
        kw = *reinterpret_cast<const uint4*>(kbase + off);
        vw = *reinterpret_cast<const uint4*>(vbase + off);
      } else {
        __nv_bfloat16* ke = reinterpret_cast<__nv_bfloat16*>(&kw);
        __nv_bfloat16* ve = reinterpret_cast<__nv_bfloat16*>(&vw);
        for (int i = 0; i < 8; ++i) {
          const int p = pos + i;
          if (p < kv_end) {
            const int page = min(
                max(table[min(p / page_size, max_pages - 1)], 0),
                num_pages - 1);
            const long long off = page * page_stride +
                                  static_cast<long long>(d) * page_size +
                                  p % page_size;
            ke[i] = kbase[off];
            ve[i] = vbase[off];
          }
        }
      }
      *reinterpret_cast<uint4*>(&ks[d][c8]) = kw;
      *reinterpret_cast<uint4*>(&vs[d][c8]) = vw;
    }
    __syncthreads();
    if (!warp_active) continue;

    // S = Q K^T for this warp's 16 rows x 64 positions
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk) {
      const int d0 = kk * 16 + tig * 2;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int tc = nt * 8 + g;
        const uint32_t b0 = pack_raw(ks[d0][tc], ks[d0 + 1][tc]);
        const uint32_t b1 = pack_raw(ks[d0 + 8][tc], ks[d0 + 9][tc]);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    // mask, online softmax (f32)
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = t0 + nt * 8 + tig * 2 + j;
        const bool in_len = col < kv_len;
        s[nt][j] = (in_len && col <= pos_lo) ? s[nt][j] * scale : kNegInf;
        s[nt][2 + j] =
            (in_len && col <= pos_hi) ? s[nt][2 + j] * scale : kNegInf;
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
    for (int nt = 0; nt < kTile / 8; ++nt) {
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
    for (int nt = 0; nt < HEAD_DIM / 8; ++nt) {
      acc[nt][0] *= corr_lo;
      acc[nt][1] *= corr_lo;
      acc[nt][2] *= corr_hi;
      acc[nt][3] *= corr_hi;
    }

    // O += P V: the S accumulators are already in the A-fragment layout
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < HEAD_DIM / 8; ++nt) {
        const __nv_bfloat16* vr = &vs[nt * 8 + g][kk * 16 + tig * 2];
        mma_bf16(acc[nt], pa, load_pair(vr), load_pair(vr + 8));
      }
    }
  }

  if (!warp_active) return;
  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  __nv_bfloat16* obase =
      out + (static_cast<long long>(b) * kv_heads + h) * wg * HEAD_DIM;
#pragma unroll
  for (int nt = 0; nt < HEAD_DIM / 8; ++nt) {
    const int c = nt * 8 + tig * 2;
    if (r_lo < wg) {
      *reinterpret_cast<uint32_t*>(obase + r_lo * HEAD_DIM + c) =
          pack_floats(acc[nt][0] / den_lo, acc[nt][1] / den_lo);
    }
    if (r_hi < wg) {
      *reinterpret_cast<uint32_t*>(obase + r_hi * HEAD_DIM + c) =
          pack_floats(acc[nt][2] / den_hi, acc[nt][3] / den_hi);
    }
  }
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers of contiguous
// tensors; `stream` is the caller's cudaStream_t. Allocates nothing and
// does not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* tables, const void* widths, void* out,
    int batch, int kv_heads, int wg, int group, int head_dim, int num_pages,
    int page_size, int max_pages, int layer, float scale, int vec_ok,
    void* stream) {
  (void)cudaGetLastError();
  if (batch <= 0 || wg <= 0) return 0;
  const dim3 grid((wg + kRows - 1) / kRows, kv_heads, batch);
  const long long layer_offset = static_cast<long long>(layer) * num_pages *
                                 kv_heads * head_dim * page_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* tp = static_cast<const int*>(tables);
  const auto* wp = static_cast<const int*>(widths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (head_dim) {
    case 64:
      paged_attention_kernel<64><<<grid, kThreads, 0, s>>>(
          qp, kp, vp, lp, tp, wp, op, kv_heads, wg, group, num_pages,
          page_size, max_pages, layer_offset, scale, vec_ok);
      break;
    case 128:
      paged_attention_kernel<128><<<grid, kThreads, 0, s>>>(
          qp, kp, vp, lp, tp, wp, op, kv_heads, wg, group, num_pages,
          page_size, max_pages, layer_offset, scale, vec_ok);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
