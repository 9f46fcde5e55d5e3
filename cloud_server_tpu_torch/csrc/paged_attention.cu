// Paged attention for Hopper (sm_90a): the serving path's cached attention,
// one kernel for each shape class of the reference.
//
// Replaces the two Pallas TPU kernels of the reference package,
// cloud_server_tpu/ops/paged_attention.py:
//   _paged_attention_kernel       (narrow: W <= 32 and B <= 16, decode and
//                                  speculative-verify windows)
//                                  -> paged_narrow_kernel
//   _paged_attention_wide_kernel  (wide: prefill chunks, ragged mixed
//                                  batches, any batch with B > 16)
//                                  -> paged_wide_kernel
// The Python wrapper (ops/paged_attention.py) picks the class by the
// reference's rule, the loader by the page size and the pools' alignment,
// and the narrow kernel's split count by the table's width, and counts each
// launch under the TPU kernel whose class it serves.
//
// What is computed, for slot b, kv head h and folded query row r (row r of
// the (W*G, Dh) block of a kv head is window position r / G, q head
// h * G + r % G):
//   row_pos = lengths[b] - widths[b] + r / G
//   out[r]  = softmax_c(q[r] . k[c] * scale, over c <= row_pos and
//             c < lengths[b]) . v
// with k/v read from the pools (L, P, KH, Dh, ps) through the slot's int32
// page table. Page ids are clamped into [0, P-1] (those reads are masked
// anyway); the layer is selected by offset, so no pool slice is ever
// materialised. q (B, W, H, Dh) is read and out (B, W, H, Dh) written
// through their strides, so the wrapper copies no layout; a null `widths`
// means every slot's width is W. The online softmax runs in f32 (in log2
// units, the scale folded into one multiply) with the finite NEG_INF =
// -0.7 * FLT_MAX: a row with no visible key yet subtracts its own max
// exactly, as the reference's does. Probabilities are rounded to bf16
// before P.V; the output is divided by max(l, 1e-30), so rows past their
// width and length-0 slots stay finite (a wide row block wholly past its
// slot's width writes zeros).
//
// The int8 KV cache (the reference's `int8_kv=True` branch): int8 pools
// with two (L, P, KH, ps) f32 scale pools, one absmax scale per position
// and kv head. Scales are per key column, constant along Dh, so they fold
// into the columns: s = (q . k_int8) * kscale[c] * scale before the mask,
// and the P.V operand is p * vscale[c], rounded to bf16; the running sum l
// adds the UNSCALED probabilities, as the reference's does.
//
// Tiles. Both kernels walk the kv positions in tiles of 64, which lie
// inside one page when ps % 64 == 0: the tile of one head is a box of 64
// positions x Dh rows of the pool seen as a 2-D tensor of L*P*KH*Dh rows by
// ps columns (row ((layer * P + page) * KH + h) * Dh), loaded by TMA from a
// tensor map that the host encodes once per pool and keeps (bf16: 128-byte
// rows, 128B swizzle; int8: 64-byte rows, no swizzle). An int8 tile's 64 k-
// and v-scales are contiguous in the scale pools and come with it by two
// bulk copies. The page table is read once per tile. Where the box cannot
// take the pool (ps % 64 != 0, or a pool not 16-byte aligned) the same
// stages are filled by a cp.async loader (8 positions, 16 bytes of bf16 or
// 8 of int8, per copy where ps % 8 == 0) or, for other page sizes, by
// element; positions past the block's last key are zero-filled there. The
// consumers are the same for every loader.
//
// paged_wide_kernel (B2), grid (ceil(W*G / 128), KH, B): three warpgroups,
// as the flash forward (B3): two consumers of 64 folded rows each and a
// producer. One producer thread issues the tile loads into a ring of four
// stages with full/empty mbarriers; setmaxnreg hands the producer's
// registers to the consumers. Each consumer copies its Q rows into shared
// memory once (the A operand) and per tile runs S = Q K^T as wgmma
// m64n64k16 with K read from its (Dh, positions) tile MN-major (the
// transpose bit), the online softmax on the accumulators, and O += P V as
// wgmma with P from registers and V read from its (Dh, positions) tile
// K-major. On int8 pools a fourth warpgroup joins the producer's warps 1-3
// (224 threads) to convert each int8 stage into a second ring of swizzled
// bf16 tiles (exact: |x| <= 127) with the scales beside them; the
// consumers are the bf16 ones plus the column scales. Work is bounded by
// the slot's own width: a row block wholly past widths[b] * G writes zeros
// and reads nothing, and the kv loop stops at the block's last live row's
// position; a consumer whose rows are all past it only keeps the ring
// turning.
//   What bounds it on an H100: at prefill (W*G = 1024 rows a kv head, 2048
//   keys) the tensor-core operations, 4 * Dh a visible query-key pair.
//
// paged_narrow_kernel (B1), grid (splits, KH, B) in clusters of `splits`
// (<= 8) blocks: split-KV inside one launch. The blocks of a cluster share
// one (slot, kv head); block c runs the online softmax over its share of
// the slot's tiles (the slot's tile count, read on the device, divided
// evenly), with 2-4 tiles in flight in an mbarrier ring that warp 0
// refills as soon as every warp is done with a stage. Each warp owns one
// 16-row fragment (mma.sync m16n8k16: the kernel is bound by bytes, not
// products); where the W*G rows fill fewer fragments than the block's
// four warps (decode: 4 rows), the warps take the same fragment over their
// own share of every tile's positions. K and V go from shared memory
// straight into B-operand registers, with the position axis permuted so
// that each thread reads runs of neighbouring positions (int8 values
// converted on the way, no second shared-memory pass). At the end the
// warps merge their partials (m, l, acc) in shared memory, and the
// cluster combines the blocks' partials through distributed shared
// memory, each block rescaling and summing its share of the output's rows
// and columns. One launch, nothing allocated, no host read of the
// lengths: the split count is as many blocks as fill one wave of the card
// at the instance's occupancy, from the shapes alone.
//   What bounds it on an H100: the K/V bytes (decode reads every visible
//   key of every slot once for 4 query rows a kv head).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <type_traits>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // kv positions per tile (one box)
constexpr int kMaxSplits = 8;  // blocks of a narrow cluster (portable)
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

// Loaders, chosen by the wrapper.
constexpr int kLoadTma = 0;     // TMA boxes (ps % 64 == 0, 16-byte aligned)
constexpr int kLoadVec = 1;     // cp.async, 8 positions a copy (ps % 8 == 0)
constexpr int kLoadScalar = 2;  // element by element

struct Args {
  const bf16* q;
  bf16* out;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;  // int8 only
  const float* v_scales;
  const int* lengths;
  const int* tables;
  const int* widths;  // null: every slot's width is w
  long long q_sb, q_sw, q_sh;  // q strides (elements): slot, window, head
  long long o_sb, o_sw, o_sh;  // out strides
  // num_pages: the pool's pages (the layer stride of pool_row);
  // last_page: the largest id a table entry reads (page_at clamps to it)
  int w, group, kv_heads, num_pages, last_page, page_size, max_pages, layer,
      loader;
  float scale_log2;
};

// A slot's geometry: its kv length, the position of its window's first
// row, and its folded rows that are inside its width.
struct Slot {
  int kv_len, anchor, live_rows;
};

__device__ __forceinline__ Slot slot_of(const Args& a, int b) {
  Slot s;
  s.kv_len = a.lengths[b];
  const int width = a.widths != nullptr ? a.widths[b] : a.w;
  s.anchor = s.kv_len - width;
  s.live_rows = max(0, min(width, a.w)) * a.group;
  return s;
}

__device__ __forceinline__ long long q_offset(const Args& a, int b, int h,
                                              int r) {
  return b * a.q_sb + (r / a.group) * a.q_sw +
         (h * a.group + r % a.group) * a.q_sh;
}

__device__ __forceinline__ long long o_offset(const Args& a, int b, int h,
                                              int r) {
  return b * a.o_sb + (r / a.group) * a.o_sw +
         (h * a.group + r % a.group) * a.o_sh;
}

__device__ __forceinline__ int page_at(const Args& a, const int* table,
                                       int pos) {
  return min(max(table[min(pos / a.page_size, a.max_pages - 1)], 0),
             a.last_page);
}

// The pool row of (layer, page, head), before the Dh axis: element
// (d, position p) of that page's tile is at (row * Dh + d) * ps + p.
__device__ __forceinline__ long long pool_row(const Args& a, int page,
                                              int h) {
  return (static_cast<long long>(a.layer) * a.num_pages + page) *
             a.kv_heads + h;
}

// This thread's Q fragments (rows r_lo, r_hi) in mma.sync's A layout, zero
// past the call's rows.
template <int D>
__device__ __forceinline__ void load_q(const Args& a, int b, int h, int r_lo,
                                       int r_hi, int rows, int tig,
                                       uint32_t (&qf)[D / 16][4]) {
  const bf16* qlo = a.q + q_offset(a, b, h, r_lo < rows ? r_lo : 0);
  const bf16* qhi = a.q + q_offset(a, b, h, r_hi < rows ? r_hi : 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = r_lo < rows ? load_pair(qlo + c) : 0u;
    qf[kk][1] = r_hi < rows ? load_pair(qhi + c) : 0u;
    qf[kk][2] = r_lo < rows ? load_pair(qlo + c + 8) : 0u;
    qf[kk][3] = r_hi < rows ? load_pair(qhi + c + 8) : 0u;
  }
}

// Four int8 values (one 32-bit word) as four bf16, packed in pairs: the
// byte goes into the mantissa of 2^23 + 128 + x, which is exact.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_uint2(pack_floats(f0 - kBias, f1 - kBias),
                    pack_floats(f2 - kBias, f3 - kBias));
}

// ---------------------------------------------------------------------------
// Stages: one K tile, one V tile (and on int8 pools their 64 + 64 scales)
// ---------------------------------------------------------------------------

template <int D, typename T>
struct Tiles {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  // one K or V tile as loaded: D rows of 64 positions
  static constexpr int kTileBytes = D * kTile * static_cast<int>(sizeof(T));
  static constexpr int kScales = 2 * kTileBytes;  // int8: 64 k-, 64 v-scales
  static constexpr int kStageBytes =
      (2 * kTileBytes + (kInt8 ? 512 : 0) + 1023) / 1024 * 1024;
  static constexpr int kTxBytes = 2 * kTileBytes + (kInt8 ? 512 : 0);
};

// Byte offset of (row d, position p) in a loaded tile: bf16 rows of 128
// bytes in the 128B swizzle, int8 rows of 64 bytes as they are.
template <typename T>
__device__ __forceinline__ int tile_offset(int d, int p) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return d * 64 + p;
  } else {
    return d * 128 + ((((p >> 3) ^ (d & 7))) << 4) + (p & 7) * 2;
  }
}

// TMA: one thread loads tile t0 of head h into a stage.
template <int D, typename T>
__device__ __forceinline__ void fill_tma(const Args& a, const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         uint32_t stage, uint32_t bar,
                                         const int* table, int h, int t0) {
  using TL = Tiles<D, T>;
  const int page = page_at(a, table, t0);
  const int col = t0 % a.page_size;
  const long long prow = pool_row(a, page, h);
  const int row = static_cast<int>(prow * D);
  mbar_expect_tx(bar, TL::kTxBytes);
  tma_load_2d(stage, tk, bar, col, row);
  tma_load_2d(stage + TL::kTileBytes, tv, bar, col, row);
  if constexpr (TL::kInt8) {
    const long long soff = prow * a.page_size + col;
    bulk_load(stage + TL::kScales, a.k_scales + soff, 256, bar);
    bulk_load(stage + TL::kScales + 256, a.v_scales + soff, 256, bar);
  }
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const uint32_t n = ok ? kBytes : 0;  // 0: zero-fill, nothing read
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}

// The barrier's arrival (one of its count) once this thread's earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// cp.async: the 32 lanes of one warp load tile t0 into a stage; lane l
// copies the 8 positions 8 (l % 8) .. of rows l / 8, l / 8 + 4, ...; past
// kv_end zero-filled. One arrival per lane.
template <int D, typename T>
__device__ __forceinline__ void fill_vec(const Args& a, uint32_t stage,
                                         uint32_t bar, const int* table,
                                         int h, int t0, int kv_end,
                                         int lane) {
  using TL = Tiles<D, T>;
  constexpr int kChunk = 8 * static_cast<int>(sizeof(T));
  const int c8 = (lane & 7) * 8;
  const int pos = t0 + c8;
  const bool ok = pos < kv_end;
  const long long prow = pool_row(a, page_at(a, table, ok ? pos : 0), h);
  const long long off = prow * D * a.page_size + pos % a.page_size;
  const T* kp = static_cast<const T*>(a.k_pool) + (ok ? off : 0);
  const T* vp = static_cast<const T*>(a.v_pool) + (ok ? off : 0);
  for (int d = lane >> 3; d < D; d += 4) {
    const long long step = ok ? static_cast<long long>(d) * a.page_size : 0;
    const int o = tile_offset<T>(d, c8);
    cp_async<kChunk>(stage + o, kp + step, ok);
    cp_async<kChunk>(stage + TL::kTileBytes + o, vp + step, ok);
  }
  if constexpr (TL::kInt8) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      const int p = t0 + i;
      const bool in = p < kv_end;
      const long long soff =
          in ? pool_row(a, page_at(a, table, p), h) * a.page_size +
                   p % a.page_size
             : 0;
      cp_async<4>(stage + TL::kScales + 4 * i, a.k_scales + soff, in);
      cp_async<4>(stage + TL::kScales + 256 + 4 * i, a.v_scales + soff, in);
    }
  }
  cp_async_arrive(bar);
}

// Element by element (page sizes that are not a multiple of 8): lane l
// writes positions l and l + 32 of every row. One arrival per lane.
template <int D, typename T>
__device__ __forceinline__ void fill_scalar(const Args& a,
                                            unsigned char* stage,
                                            uint32_t bar, const int* table,
                                            int h, int t0, int kv_end,
                                            int lane) {
  using TL = Tiles<D, T>;
  for (int i = lane; i < kTile; i += 32) {
    const int p = t0 + i;
    const bool in = p < kv_end;
    const long long prow = pool_row(a, page_at(a, table, in ? p : 0), h);
    const long long off = prow * D * a.page_size + p % a.page_size;
    const T* kp = static_cast<const T*>(a.k_pool) + off;
    const T* vp = static_cast<const T*>(a.v_pool) + off;
    for (int d = 0; d < D; ++d) {
      const long long step = static_cast<long long>(d) * a.page_size;
      const int o = tile_offset<T>(d, i);
      *reinterpret_cast<T*>(stage + o) = in ? kp[step] : T();
      *reinterpret_cast<T*>(stage + TL::kTileBytes + o) =
          in ? vp[step] : T();
    }
    if constexpr (TL::kInt8) {
      const long long soff = prow * a.page_size + p % a.page_size;
      float* sc = reinterpret_cast<float*>(stage + TL::kScales);
      sc[i] = in ? a.k_scales[soff] : 0.f;
      sc[kTile + i] = in ? a.v_scales[soff] : 0.f;
    }
  }
  fence_proxy_async();  // the wide kernel's wgmma reads these tiles
  mbar_arrive(bar);
}

// Tile t0 of head h into stage `st` of a ring: TMA from lane 0 alone, the
// other loaders from all 32 lanes of the calling warp.
template <int D, typename T>
__device__ __forceinline__ void fill_stage(const Args& a,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           unsigned char* sm, uint32_t base,
                                           int st, uint32_t full,
                                           const int* table, int h, int t0,
                                           int kv_end, int lane) {
  using TL = Tiles<D, T>;
  const uint32_t stage = base + st * TL::kStageBytes;
  if (a.loader == kLoadTma) {
    if (lane == 0) fill_tma<D, T>(a, tk, tv, stage, full, table, h, t0);
  } else if (a.loader == kLoadVec) {
    fill_vec<D, T>(a, stage, full, table, h, t0, kv_end, lane);
  } else {
    fill_scalar<D, T>(a, sm + st * TL::kStageBytes, full, table, h, t0,
                      kv_end, lane);
  }
}

// A producer warp's loop over tiles 0 .. n - 1 of a ring of S stages.
template <int D, typename T, int S>
__device__ __forceinline__ void produce(const Args& a, const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        unsigned char* sm, uint32_t base,
                                        uint32_t full0, uint32_t empty0,
                                        const int* table, int h, int n,
                                        int kv_end, int lane) {
  if (a.loader == kLoadTma && lane != 0) return;
  for (int i = 0; i < n; ++i) {
    const int st = i % S;
    mbar_wait(empty0 + 8 * st, ((i / S) & 1) ^ 1);
    fill_stage<D, T>(a, tk, tv, sm, base, st, full0 + 8 * st, table, h,
                     i * kTile, kv_end, lane);
  }
}

// ---------------------------------------------------------------------------
// B2: the wide kernel
// ---------------------------------------------------------------------------

constexpr int kWideRows = 128;     // folded rows a block (64 a consumer)
constexpr int kWideStages = 4;     // load ring
constexpr int kConvStages = 2;     // int8: ring of converted bf16 stages

template <int D, typename T>
struct WideSmem {
  using TL = Tiles<D, T>;
  static constexpr bool kInt8 = TL::kInt8;
  // two consumer warpgroups and a producer warpgroup; on int8 pools a
  // fourth warpgroup, whose warps convert with warps 1-3 of the producer's
  static constexpr int kThreads = kInt8 ? 512 : 384;
  static constexpr int kConverters = kInt8 ? 224 : 0;
  // setmaxnreg: bf16 40 x 128 + 232 x 256, int8 56 x 256 + 200 x 256
  static constexpr int kProducerRegs = kInt8 ? 56 : 40;
  static constexpr int kConsumerRegs = kInt8 ? 200 : 232;
  // each consumer's 64 Q rows (bf16, 128B swizzle, column halves of 64)
  static constexpr int kQBytes = 64 * D * 2;
  static constexpr int kRing = 2 * kQBytes;
  // a converted stage: K, V (bf16, swizzled) and the 128 scales
  static constexpr int kConvBytes = (2 * D * 128 + 512 + 1023) / 1024 * 1024;
  static constexpr int kConv = kRing + kWideStages * TL::kStageBytes;
  static constexpr int kBars = kConv + (kInt8 ? kConvStages * kConvBytes : 0);
  // full[S], empty[S] (bf16), cfull[CS], cempty[CS] (int8)
  static constexpr int kBytes = kBars + 8 * (2 * kWideStages + 2 * kConvStages);
};

// An int8 stage (K, V: D rows of 64 bytes; 128 scales) into a converted
// stage (K, V: D rows of 64 bf16, 128B swizzle; the scales), by
// kConverters threads, 16 positions (16 bytes in, 32 out) a step.
template <int D, int kConverters>
__device__ __forceinline__ void convert_stage(const unsigned char* src,
                                              unsigned char* dst, int ct) {
  constexpr int kUnits = 2 * D * 4;
#pragma unroll 2
  for (int u = ct; u < kUnits; u += kConverters) {
    const int tile = u / (D * 4);
    const int d = (u >> 2) % D;
    const int c16 = u & 3;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        src + tile * D * 64 + d * 64 + c16 * 16);
    const uint2 a0 = i8x4_to_bf16x4(raw.x);
    const uint2 a1 = i8x4_to_bf16x4(raw.y);
    const uint2 a2 = i8x4_to_bf16x4(raw.z);
    const uint2 a3 = i8x4_to_bf16x4(raw.w);
    unsigned char* row = dst + tile * D * 128 + d * 128;
    *reinterpret_cast<uint4*>(row + (((2 * c16) ^ (d & 7)) << 4)) =
        make_uint4(a0.x, a0.y, a1.x, a1.y);
    *reinterpret_cast<uint4*>(row + (((2 * c16 + 1) ^ (d & 7)) << 4)) =
        make_uint4(a2.x, a2.y, a3.x, a3.y);
  }
  for (int i = ct; i < 2 * kTile; i += kConverters) {
    reinterpret_cast<float*>(dst + 2 * D * 128)[i] =
        reinterpret_cast<const float*>(src + 2 * D * 64)[i];
  }
}

template <int D>
__device__ __forceinline__ void zero_rows(const Args& a, int b, int h,
                                          int r0, int r1, int t, int nt) {
  constexpr int kChunks = D / 8;  // 16 bytes each
  for (int i = t; i < (r1 - r0) * kChunks; i += nt) {
    const int r = r0 + i / kChunks;
    *reinterpret_cast<uint4*>(a.out + o_offset(a, b, h, r) +
                              (i % kChunks) * 8) = make_uint4(0, 0, 0, 0);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(WideSmem<D, T>::kThreads, 1)
    paged_wide_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = WideSmem<D, T>;
  using TL = Tiles<D, T>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int S = kWideStages;
  constexpr int CS = kConvStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles: 1 KB
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t ring = base + L::kRing;
  unsigned char* ring_ptr = sm + L::kRing;
  const uint32_t full0 = base + L::kBars;
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t cfull0 = empty0 + 8 * S;
  const uint32_t cempty0 = cfull0 + 8 * CS;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kWideRows;
  const int rows = a.w * a.group;
  const Slot sl = slot_of(a, b);
  if (row0 >= sl.live_rows) {
    // wholly past the slot's width: zeros, nothing read
    zero_rows<D>(a, b, h, row0, min(row0 + kWideRows, rows), threadIdx.x,
                 L::kThreads);
    return;
  }
  const int last_row = min(row0 + kWideRows, sl.live_rows) - 1;
  const int kv_end =
      max(0, min(sl.kv_len, sl.anchor + last_row / a.group + 1));
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int* table = a.tables + static_cast<long long>(b) * a.max_pages;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full0 + 8 * st, a.loader == kLoadTma ? 1 : 32);
      mbar_init(empty0 + 8 * st, kInt8 ? L::kConverters / 32 : 8);
    }
    for (int cs = 0; cs < CS; ++cs) {
      mbar_init(cfull0 + 8 * cs, kInt8 ? L::kConverters / 32 : 1);
      mbar_init(cempty0 + 8 * cs, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi >= 2) {
    // ---- producer side: warp 0 loads; on int8 pools the other warps
    // convert ----
    setmaxnreg_dec<L::kProducerRegs>();
    const int pt = threadIdx.x - 256;
    const int lane = pt & 31;
    if (pt < 32) {
      produce<D, T, S>(a, &tk, &tv, ring_ptr, ring, full0, empty0, table, h,
                       n_tiles, kv_end, lane);
    } else if constexpr (kInt8) {
      const int ct = pt - 32;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % S;
        const int cs = j % CS;
        mbar_wait(full0 + 8 * st, (j / S) & 1);
        mbar_wait(cempty0 + 8 * cs, ((j / CS) & 1) ^ 1);
        convert_stage<D, L::kConverters>(ring_ptr + st * TL::kStageBytes,
                                         sm + L::kConv + cs * L::kConvBytes,
                                         ct);
        fence_proxy_async();  // the consumers read it by wgmma
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty0 + 8 * st);
          mbar_arrive(cfull0 + 8 * cs);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 folded rows each ----
  setmaxnreg_inc<L::kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int rw0 = row0 + wgi * 64;
  const bool live = rw0 < sl.live_rows;
  const int r_lo = rw0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const int pos_lo = sl.anchor + r_lo / a.group;
  const int pos_hi = sl.anchor + r_hi / a.group;
  // this warpgroup's own tiles, and the first position any of its rows
  // cannot see: tiles before it need no mask
  int n_mine = 0;
  int mask_from = 0;
  if (live) {
    const int my_last = min(rw0 + 64, sl.live_rows) - 1;
    n_mine = (max(0, min(sl.kv_len, sl.anchor + my_last / a.group + 1)) +
              kTile - 1) / kTile;
    mask_from = sl.anchor + rw0 / a.group;
  }

  // this warpgroup's Q rows into shared memory (the A operand of S), 16
  // bytes a copy; zeros past the call's rows
  unsigned char* qs = sm + wgi * L::kQBytes;
  const uint32_t qa = base + wgi * L::kQBytes;
  if (live) {
    for (int i = tid; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (rw0 + r < rows) {
        v = *reinterpret_cast<const uint4*>(a.q + q_offset(a, b, h, rw0 + r) +
                                            c);
      }
      *reinterpret_cast<uint4*>(qs + swz_offset(r, c, 64)) = v;
    }
    fence_proxy_async();
  }
  named_barrier(1 + wgi, 128);

  float acc[D / 2];
  float s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // running max, log2 units
  float l_lo = 0.f, l_hi = 0.f;          // per-thread partial sums

  for (int j = 0; j < n_tiles; ++j) {
    const int st = kInt8 ? j % CS : j % S;
    const uint32_t ph = kInt8 ? (j / CS) & 1 : (j / S) & 1;
    const uint32_t tile = kInt8 ? base + L::kConv + st * L::kConvBytes
                                : ring + st * TL::kStageBytes;
    mbar_wait(kInt8 ? cfull0 + 8 * st : full0 + 8 * st, ph);
    if (j < n_mine) {
      if (!kInt8 && a.loader != kLoadTma) fence_proxy_async();
      const uint32_t kt = tile;
      const uint32_t vt = tile + D * 128;
      const float* scl =
          reinterpret_cast<const float*>(sm + (tile - base) + 2 * D * 128);

      // S = Q K^T (64 x 64): Q K-major, K's (Dh, positions) tile MN-major
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64<0, 1>(s,
                           sw128_desc(qa + (kk >> 2) * 64 * 128 +
                                          (kk & 3) * 32, 16),
                           sw128_desc(kt + kk * 16 * 128, D * 128), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scale (int8: and the key's scale) and mask; log2 units
      const int t0 = j * kTile;
      const bool masked = t0 + kTile - 1 > mask_from;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * 8 + tig * 2 + e;
          float cs = a.scale_log2;
          if constexpr (kInt8) cs *= scl[col];
          float lo = s[4 * c + e] * cs;
          float hi = s[4 * c + 2 + e] * cs;
          if (masked) {
            const int pos = t0 + col;
            const bool in_len = pos < sl.kv_len;
            lo = in_len && pos <= pos_lo ? lo : kNegInf;
            hi = in_len && pos <= pos_hi ? hi : kNegInf;
          }
          s[4 * c + e] = lo;
          s[4 * c + 2 + e] = hi;
        }
      }
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * c], s[4 * c + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * c + 2], s[4 * c + 3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float corr_lo = exp2f(m_lo - mn_lo);
      const float corr_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * c + e] = exp2f(s[4 * c + e] - mn_lo);
          s[4 * c + 2 + e] = exp2f(s[4 * c + 2 + e] - mn_hi);
          sum_lo += s[4 * c + e];
          sum_hi += s[4 * c + 2 + e];
        }
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
      if constexpr (kInt8) {
        // after the row sum: l holds unscaled probabilities, the P.V
        // operand carries the value's scale
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vsc = scl[kTile + c * 8 + tig * 2 + e];
            s[4 * c + e] *= vsc;
            s[4 * c + 2 + e] *= vsc;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= corr_lo;
        acc[4 * c + 1] *= corr_lo;
        acc[4 * c + 2] *= corr_hi;
        acc[4 * c + 3] *= corr_hi;
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_floats(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_floats(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_floats(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_floats(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V's (Dh, positions) tile read K-major, 16 positions a
      // step (32 bytes along its swizzled rows)
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<D, 0>(acc, pa[kk], sw128_desc(vt + kk * 32, 16));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kInt8 ? cempty0 + 8 * st : empty0 + 8 * st);
  }

  // out = acc / l (zeros from a warpgroup past the width: acc and l are 0)
  const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
  const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* olo = a.out + o_offset(a, b, h, r_lo < rows ? r_lo : 0);
  bf16* ohi = a.out + o_offset(a, b, h, r_hi < rows ? r_hi : 0);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + tig * 2;
    if (r_lo < rows) {
      *reinterpret_cast<uint32_t*>(olo + col) =
          pack_floats(acc[4 * c] / den_lo, acc[4 * c + 1] / den_lo);
    }
    if (r_hi < rows) {
      *reinterpret_cast<uint32_t*>(ohi + col) =
          pack_floats(acc[4 * c + 2] / den_hi, acc[4 * c + 3] / den_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// B1: the narrow kernel (split-KV in clusters)
// ---------------------------------------------------------------------------

// RF: 16-row fragments a block (W*G rows, rounded up to 1, 2, 4 or 8).
template <int D, typename T, int RF>
struct NarrowCfg {
  using TL = Tiles<D, T>;
  static constexpr int kWarps = RF > 4 ? RF : 4;
  // warps on one fragment, each over its own positions of every tile
  static constexpr int kParts = kWarps / RF;
  static constexpr int kNT = 8 / kParts;  // n-tiles of 8 positions a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * RF;
  // 2-4 stages in about 100 KB, or 200 KB where the registers of 8 warps
  // keep the block alone on its SM anyway
  static constexpr int kFit = (RF > 4 ? 204800 : 102400) / TL::kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kRing = kStages * TL::kStageBytes;
  // the partials, over the drained ring: acc [parts][rows][D], m and l
  // [parts][rows], then the block's m and l [rows]
  static constexpr int kM = kParts * kRows * D * 4;
  static constexpr int kL = kM + kParts * kRows * 4;
  static constexpr int kBlkM = kL + kParts * kRows * 4;
  static constexpr int kBlkL = kBlkM + kRows * 4;
  static constexpr int kPartial = kBlkL + kRows * 4;
  static constexpr int kBars =
      ((kRing > kPartial ? kRing : kPartial) + 15) / 16 * 16;
  static constexpr int kBytes = kBars + 16 * kStages;  // full, empty
};

// N neighbouring positions p .. p + N - 1 of row d of a loaded tile, as
// N / 2 bf16 pairs (int8 converted).
template <typename T, int N>
__device__ __forceinline__ void load_run(const unsigned char* tile, int d,
                                         int p, uint32_t (&o)[N / 2]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const unsigned char* src = tile + d * 64 + p;
    if constexpr (N == 2) {
      o[0] = i8x4_to_bf16x4(*reinterpret_cast<const uint16_t*>(src)).x;
    } else if constexpr (N == 4) {
      const uint2 v = i8x4_to_bf16x4(*reinterpret_cast<const uint32_t*>(src));
      o[0] = v.x;
      o[1] = v.y;
    } else {
      static_assert(N == 8 || N == 16, "load_run: N is 2, 4, 8 or 16");
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const uint2 w = *reinterpret_cast<const uint2*>(src + 8 * i);
        const uint2 lo = i8x4_to_bf16x4(w.x);
        const uint2 hi = i8x4_to_bf16x4(w.y);
        o[4 * i] = lo.x;
        o[4 * i + 1] = lo.y;
        o[4 * i + 2] = hi.x;
        o[4 * i + 3] = hi.y;
      }
    }
  } else {
    if constexpr (N == 2) {
      o[0] = *reinterpret_cast<const uint32_t*>(tile + tile_offset<T>(d, p));
    } else if constexpr (N == 4) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(tile + tile_offset<T>(d, p));
      o[0] = v.x;
      o[1] = v.y;
    } else {
      static_assert(N == 8 || N == 16, "load_run: N is 2, 4, 8 or 16");
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            tile + tile_offset<T>(d, p + 8 * i));
        o[4 * i] = v.x;
        o[4 * i + 1] = v.y;
        o[4 * i + 2] = v.z;
        o[4 * i + 3] = v.w;
      }
    }
  }
}

template <int D, typename T, int RF>
__global__ void __launch_bounds__(NarrowCfg<D, T, RF>::kThreads, 1)
    paged_narrow_kernel(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Args a) {
  using C = NarrowCfg<D, T, RF>;
  using TL = Tiles<D, T>;
  constexpr bool kInt8 = TL::kInt8;
  constexpr int S = C::kStages;
  constexpr int NT = C::kNT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full0 = base + C::kBars;
  const uint32_t empty0 = full0 + 8 * S;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = static_cast<int>(gridDim.x);  // the cluster's blocks
  const int rank = static_cast<int>(cluster_ctarank());
  const int rows = a.w * a.group;
  const Slot sl = slot_of(a, b);
  const int kv_end =
      sl.live_rows > 0
          ? max(0, min(sl.kv_len,
                       sl.anchor + (sl.live_rows - 1) / a.group + 1))
          : 0;
  // this block's share of the slot's tiles
  const int n_all = (kv_end + kTile - 1) / kTile;
  const int per = (n_all + splits - 1) / splits;
  const int j0 = min(n_all, rank * per);
  const int n = min(n_all, j0 + per) - j0;
  const int* table = a.tables + static_cast<long long>(b) * a.max_pages;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full0 + 8 * st, a.loader == kLoadTma ? 1 : 32);
      mbar_init(empty0 + 8 * st, C::kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc_buf = reinterpret_cast<float*>(sm);
  float* m_buf = reinterpret_cast<float*>(sm + C::kM);
  float* l_buf = reinterpret_cast<float*>(sm + C::kL);
  float* blk_m = reinterpret_cast<float*>(sm + C::kBlkM);
  float* blk_l = reinterpret_cast<float*>(sm + C::kBlkL);

  // warp 0 fills the ring's first stages, then refills each stage once
  // every warp is done with it
  if (warp == 0) {
    for (int i = 0; i < min(n, S); ++i) {
      fill_stage<D, T>(a, &tk, &tv, sm, base, i, full0 + 8 * i, table, h,
                       (j0 + i) * kTile, kv_end, lane);
    }
  }
  {
    // ---- warp = fragment rf, position part ----
    const int rf = warp % RF;
    const int part = warp / RF;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int r_lo = rf * 16 + g;
    const int r_hi = r_lo + 8;
    const int pos_lo = sl.anchor + r_lo / a.group;
    const int pos_hi = sl.anchor + r_hi / a.group;
    const int pb = part * 8 * NT;  // the warp's first position in a tile

    uint32_t qf[D / 16][4];
    load_q<D>(a, b, h, r_lo, r_hi, rows, tig, qf);
    float acc[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
    }
    float m_lo = kNegInf, m_hi = kNegInf;  // log2 units
    float l_lo = 0.f, l_hi = 0.f;

    for (int i = 0; i < n; ++i) {
      const int st = i % S;
      mbar_wait(full0 + 8 * st, (i / S) & 1);
      const unsigned char* kt = sm + st * TL::kStageBytes;
      const unsigned char* vt = kt + TL::kTileBytes;
      const float* scl = reinterpret_cast<const float*>(kt + TL::kScales);
      const int t0 = (j0 + i) * kTile;

      // S: n-tile nt, column c is position pb + NT * c + nt of the tile,
      // so each thread reads runs of NT neighbouring positions
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int d0 = kk * 16 + tig * 2;
        uint32_t k0[NT / 2], k1[NT / 2], k8[NT / 2], k9[NT / 2];
        load_run<T, NT>(kt, d0, pb + NT * g, k0);
        load_run<T, NT>(kt, d0 + 1, pb + NT * g, k1);
        load_run<T, NT>(kt, d0 + 8, pb + NT * g, k8);
        load_run<T, NT>(kt, d0 + 9, pb + NT * g, k9);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t sel = (nt & 1) ? 0x7632u : 0x5410u;
          const uint32_t b0 = __byte_perm(k0[nt / 2], k1[nt / 2], sel);
          const uint32_t b1 = __byte_perm(k8[nt / 2], k9[nt / 2], sel);
          mma_bf16(s[nt], qf[kk], b0, b1);
        }
      }

      // scale, mask, online softmax (log2 units); a thread's columns are
      // positions pb + 2 NT tig + NT e + nt (e = 0, 1)
      const int pr = pb + 2 * NT * tig;
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = t0 + pr + NT * e + nt;
          float cs = a.scale_log2;
          if constexpr (kInt8) cs *= scl[pr + NT * e + nt];
          const bool in_len = pos < sl.kv_len;
          s[nt][e] = in_len && pos <= pos_lo ? s[nt][e] * cs : kNegInf;
          s[nt][2 + e] =
              in_len && pos <= pos_hi ? s[nt][2 + e] * cs : kNegInf;
          mx_lo = fmaxf(mx_lo, s[nt][e]);
          mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
        }
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float corr_lo = exp2f(m_lo - mn_lo);
      const float corr_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2f(s[nt][e] - mn_lo);
          s[nt][2 + e] = exp2f(s[nt][2 + e] - mn_hi);
          sum_lo += s[nt][e];
          sum_hi += s[nt][2 + e];
        }
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
      if constexpr (kInt8) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float vsc = scl[kTile + pr + NT * e + nt];
            s[nt][e] *= vsc;
            s[nt][2 + e] *= vsc;
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[nd][0] *= corr_lo;
        acc[nd][1] *= corr_lo;
        acc[nd][2] *= corr_hi;
        acc[nd][3] *= corr_hi;
      }

      // O += P V: k-step kk pairs n-tiles 2kk and 2kk + 1; its B operand
      // comes from the run of 2 NT positions pr .. of each V row
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        pa[kk][0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        uint32_t x[NT];
        load_run<T, 2 * NT>(vt, nd * 8 + g, pr, x);
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const uint32_t b0 = __byte_perm(x[kk], x[NT / 2 + kk], 0x5410u);
          const uint32_t b1 = __byte_perm(x[kk], x[NT / 2 + kk], 0x7632u);
          mma_bf16(acc[nd], pa[kk], b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
      if (warp == 0 && i + S < n) {
        if (a.loader != kLoadTma || lane == 0) {
          mbar_wait(empty0 + 8 * st, (i / S) & 1);
        }
        fill_stage<D, T>(a, &tk, &tv, sm, base, st, full0 + 8 * st, table,
                         h, (j0 + i + S) * kTile, kv_end, lane);
        __syncwarp();
      }
    }

    // the warps' partials, over the drained ring
    __syncthreads();
    const float lsum_lo = quad_sum(l_lo);
    const float lsum_hi = quad_sum(l_hi);
    float* pacc = acc_buf + static_cast<long long>(part) * C::kRows * D;
    if (tig == 0) {
      m_buf[part * C::kRows + r_lo] = m_lo;
      m_buf[part * C::kRows + r_hi] = m_hi;
      l_buf[part * C::kRows + r_lo] = lsum_lo;
      l_buf[part * C::kRows + r_hi] = lsum_hi;
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + tig * 2;
      *reinterpret_cast<float2*>(pacc + r_lo * D + col) =
          make_float2(acc[nd][0], acc[nd][1]);
      *reinterpret_cast<float2*>(pacc + r_hi * D + col) =
          make_float2(acc[nd][2], acc[nd][3]);
    }
    __syncthreads();
    // the block's partial: parts merged into part 0's rows
    const int ct = threadIdx.x;
    for (int it = ct; it < rows * (D / 4); it += C::kWarps * 32) {
      const int r = it / (D / 4);
      const int c4 = (it % (D / 4)) * 4;
      float mm = kNegInf;
#pragma unroll
      for (int p = 0; p < C::kParts; ++p) {
        mm = fmaxf(mm, m_buf[p * C::kRows + r]);
      }
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      float ls = 0.f;
#pragma unroll
      for (int p = 0; p < C::kParts; ++p) {
        const float wgt = exp2f(m_buf[p * C::kRows + r] - mm);
        const float4 v = *reinterpret_cast<const float4*>(
            acc_buf + (static_cast<long long>(p) * C::kRows + r) * D + c4);
        sum.x += wgt * v.x;
        sum.y += wgt * v.y;
        sum.z += wgt * v.z;
        sum.w += wgt * v.w;
        ls += wgt * l_buf[p * C::kRows + r];
      }
      *reinterpret_cast<float4*>(acc_buf + r * D + c4) = sum;
      if (c4 == 0) {
        blk_m[r] = mm;
        blk_l[r] = ls;
      }
    }
  }

  // the cluster's blocks combine their partials through distributed
  // shared memory: block `rank` takes every splits-th item of the rows x
  // column quads
  __syncwarp();
  cluster_sync();
  const uint32_t acc_addr = smem_u32(acc_buf);
  const uint32_t m_addr = smem_u32(blk_m);
  const uint32_t l_addr = smem_u32(blk_l);
  for (int it = threadIdx.x * splits + rank; it < rows * (D / 4);
       it += C::kThreads * splits) {
    const int r = it / (D / 4);
    const int c4 = (it % (D / 4)) * 4;
    // every rank's loads issued before any is used
    float mv[kMaxSplits];
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      mv[c] = c < splits ? ld_cluster_f32(mapa_shared(m_addr + 4 * r, c))
                         : kNegInf;
    }
    float4 av[kMaxSplits];
    float lv[kMaxSplits];
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      if (c < splits) {
        av[c] = ld_cluster_f32x4(mapa_shared(acc_addr + 4 * (r * D + c4), c));
        lv[c] = ld_cluster_f32(mapa_shared(l_addr + 4 * r, c));
      } else {
        av[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        lv[c] = 0.f;
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) mm = fmaxf(mm, mv[c]);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      const float wgt = exp2f(mv[c] - mm);  // 0 past `splits` (l, acc 0)
      sum.x += wgt * av[c].x;
      sum.y += wgt * av[c].y;
      sum.z += wgt * av[c].z;
      sum.w += wgt * av[c].w;
      ls += wgt * lv[c];
    }
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    *reinterpret_cast<uint2*>(a.out + o_offset(a, b, h, r) + c4) =
        make_uint2(pack_floats(sum.x * inv, sum.y * inv),
                   pack_floats(sum.z * inv, sum.w * inv));
  }
  __syncwarp();
  cluster_sync();  // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Tensor maps of the pools, encoded once per (pointer, shape, type) and
// kept: encoding one costs host time on a path that is host-bound.
struct MapEntry {
  const void* ptr;
  long long rows;
  int cols;
  int box_rows;
  int int8;
  CUtensorMap map;
};

std::mutex g_map_mutex;
constexpr int kMapSlots = 16;
MapEntry g_maps[kMapSlots];
int g_map_count = 0;
int g_map_next = 0;

// The pool (rows = L*P*KH*Dh, cols = ps) in boxes of 64 positions x Dh
// rows: bf16 in the 128B swizzle, int8 as it is.
bool pool_map(CUtensorMap* out, const void* ptr, long long rows, int cols,
              int box_rows, bool int8) {
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == ptr && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows && e.int8 == static_cast<int>(int8)) {
      *out = e.map;
      return true;
    }
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int elem = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTile),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  MapEntry e;
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  e.int8 = static_cast<int>(int8);
  if (encode(&e.map,
             int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  g_maps[g_map_next] = e;
  g_map_next = (g_map_next + 1) % kMapSlots;
  if (g_map_count < kMapSlots) ++g_map_count;
  *out = e.map;
  return true;
}

template <int D, typename T>
cudaError_t launch_wide(const CUtensorMap& tk, const CUtensorMap& tv,
                        const Args& a, int batch, cudaStream_t s) {
  constexpr int smem = WideSmem<D, T>::kBytes + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      paged_wide_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.w * a.group + kWideRows - 1) / kWideRows, a.kv_heads,
                  batch);
  constexpr int threads = WideSmem<D, T>::kThreads;
  paged_wide_kernel<D, T><<<grid, threads, smem, s>>>(tk, tv, a);
  return cudaGetLastError();
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// The narrow kernel's split count: as many blocks for each (slot, kv head)
// as fill one wave of the card at the instance's occupancy, at most
// kMaxSplits and at most one for every two tiles of a full table. It
// depends on the shapes alone, never on the lengths.
template <int D, typename T, int RF>
int narrow_splits(int batch, int kv_heads, int max_pages, int page_size) {
  using C = NarrowCfg<D, T, RF>;
  constexpr int smem = C::kBytes + 1024;
  static const int per_sm = [] {
    int n = 0;
    cudaFuncSetAttribute(paged_narrow_kernel<D, T, RF>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, paged_narrow_kernel<D, T, RF>, C::kThreads, smem);
    return n > 0 ? n : 1;
  }();
  const long long tiles =
      (static_cast<long long>(max_pages) * page_size + kTile - 1) / kTile;
  const long long fill = static_cast<long long>(per_sm) * sm_count() /
                         (static_cast<long long>(batch) * kv_heads);
  long long n = fill < kMaxSplits ? fill : kMaxSplits;
  if (n > tiles / 2) n = tiles / 2;
  return n < 1 ? 1 : static_cast<int>(n);
}

template <int D, typename T, int RF>
cudaError_t launch_narrow(const CUtensorMap& tk, const CUtensorMap& tv,
                          const Args& a, int batch, cudaStream_t s) {
  using C = NarrowCfg<D, T, RF>;
  constexpr int smem = C::kBytes + 1024;
  const auto kernel = paged_narrow_kernel<D, T, RF>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int splits =
      narrow_splits<D, T, RF>(batch, a.kv_heads, a.max_pages, a.page_size);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.kv_heads, batch);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tk, tv, a);
}

// The narrow kernel's instance for W * G rows (<= 128): 16-row fragments
// rounded up to 1, 2, 4 or 8.
template <typename F>
auto by_fragments(int rows, F&& f) {
  if (rows <= 16) return f(std::integral_constant<int, 1>());
  if (rows <= 32) return f(std::integral_constant<int, 2>());
  if (rows <= 64) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
}

template <int D, typename T>
cudaError_t launch_class(const CUtensorMap& tk, const CUtensorMap& tv,
                         const Args& a, int batch, int narrow,
                         cudaStream_t s) {
  if (!narrow) return launch_wide<D, T>(tk, tv, a, batch, s);
  return by_fragments(a.w * a.group, [&](auto rf) {
    return launch_narrow<D, T, decltype(rf)::value>(tk, tv, a, batch, s);
  });
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scales, const void* v_scales, const void* lengths,
           const void* tables, const void* widths, void* out, long long q_sb,
           long long q_sw, long long q_sh, long long o_sb, long long o_sw,
           long long o_sh, int batch, int w, int kv_heads, int group,
           int head_dim, int num_pages, int last_page, int page_size,
           int max_pages, int layers, int layer, float scale, int loader,
           int narrow, void* stream) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  (void)cudaGetLastError();
  if (batch <= 0 || w <= 0) return 0;
  const long long rows = static_cast<long long>(layers) * num_pages *
                         kv_heads * head_dim;
  if ((head_dim != 64 && head_dim != 128) || group <= 0 || kv_heads <= 0 ||
      page_size <= 0 || max_pages <= 0 || layer < 0 || layer >= layers ||
      last_page < 0 || last_page >= num_pages ||
      loader < kLoadTma || loader > kLoadScalar ||
      (narrow && w * group > 128) ||
      (loader == kLoadTma && (page_size % kTile != 0 || rows >= (1ll << 31))) ||
      (loader == kLoadVec && page_size % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.widths = static_cast<const int*>(widths);
  a.q_sb = q_sb;
  a.q_sw = q_sw;
  a.q_sh = q_sh;
  a.o_sb = o_sb;
  a.o_sw = o_sw;
  a.o_sh = o_sh;
  a.w = w;
  a.group = group;
  a.kv_heads = kv_heads;
  a.num_pages = num_pages;
  a.last_page = last_page;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.layer = layer;
  a.loader = loader;
  a.scale_log2 = scale * kLog2e;
  CUtensorMap tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (loader == kLoadTma &&
      (!pool_map(&tk, k_pool, rows, page_size, head_dim, kInt8) ||
       !pool_map(&tv, v_pool, rows, page_size, head_dim, kInt8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      head_dim == 64 ? launch_class<64, T>(tk, tv, a, batch, narrow, s)
                     : launch_class<128, T>(tk, tv, a, batch, narrow, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. q, out: (B, W, H, Dh) bf16 with the given
// strides (elements; Dh contiguous); pools (L, P, KH, Dh, ps) and scale
// pools (L, P, KH, ps) contiguous; widths may be null (every slot's width
// is W). A table entry reads page min(max(entry, 0), last_page): a pool
// with a scratch page after its real pages passes its last real page, so
// a sentinel entry never reads the scratch page. `loader`: 0 TMA, 1 cp.async, 2 by element. `narrow`: 1 launches
// the narrow kernel (W * G <= 128), 0 the wide one. `stream` is the
// caller's cudaStream_t. They allocate nothing and do not synchronise, and
// return cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments they do not take).
extern "C" int paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* tables, const void* widths, void* out,
    long long q_sb, long long q_sw, long long q_sh, long long o_sb,
    long long o_sw, long long o_sh, int batch, int w, int kv_heads,
    int group, int head_dim, int num_pages, int last_page, int page_size,
    int max_pages, int layers, int layer, float scale, int loader,
    int narrow, void* stream) {
  return launch<bf16>(q, k_pool, v_pool, nullptr, nullptr, lengths, tables,
                      widths, out, q_sb, q_sw, q_sh, o_sb, o_sw, o_sh, batch,
                      w, kv_heads, group, head_dim, num_pages, last_page,
                      page_size, max_pages, layers, layer, scale, loader,
                      narrow, stream);
}

// The int8 KV cache: int8 pools with their (L, P, KH, ps) f32 scale pools.
extern "C" int paged_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* tables, const void* widths, void* out, long long q_sb,
    long long q_sw, long long q_sh, long long o_sb, long long o_sw,
    long long o_sh, int batch, int w, int kv_heads, int group, int head_dim,
    int num_pages, int last_page, int page_size, int max_pages, int layers,
    int layer, float scale, int loader, int narrow, void* stream) {
  return launch<int8_t>(q, k_pool, v_pool, k_scales, v_scales, lengths,
                        tables, widths, out, q_sb, q_sw, q_sh, o_sb, o_sw,
                        o_sh, batch, w, kv_heads, group, head_dim, num_pages,
                        last_page, page_size, max_pages, layers, layer, scale,
                        loader, narrow, stream);
}

// The narrow kernel's blocks for each (slot, kv head) at these shapes on
// the current device (0 for shapes it does not take).
extern "C" int paged_attention_narrow_splits(int batch, int w, int kv_heads,
                                             int group, int head_dim,
                                             int int8, int max_pages,
                                             int page_size) {
  const int rows = w * group;
  if (batch <= 0 || kv_heads <= 0 || rows <= 0 || rows > 128 ||
      max_pages <= 0 || page_size <= 0 ||
      (head_dim != 64 && head_dim != 128)) {
    return 0;
  }
  const auto count = [&](auto d, auto t) {
    using T = decltype(t);
    return by_fragments(rows, [&](auto rf) {
      return narrow_splits<decltype(d)::value, T, decltype(rf)::value>(
          batch, kv_heads, max_pages, page_size);
    });
  };
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (int8) {
    return head_dim == 64 ? count(D64(), int8_t()) : count(D128(), int8_t());
  }
  return head_dim == 64 ? count(D64(), bf16()) : count(D128(), bf16());
}
