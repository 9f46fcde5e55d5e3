// Flash attention for Hopper (sm_90a): the training path's causal
// (optionally segment-masked) attention, forward and backward.
//
// Replaces the four Pallas TPU kernels of
// cloud_server_tpu/ops/flash_attention.py:
//   _fwd_kernel        -> flash_fwd_wgmma_kernel
//                         (entry flash_attention_fwd_bf16)
//   _bwd_dkdv_kernel   -> flash_bwd_kv_wgmma_kernel<D, false>
//                         (entry flash_attention_bwd_dkdv_bf16)
//   _bwd_dq_kernel     -> flash_bwd_dq_wgmma_kernel
//                         (entry flash_attention_bwd_dq_bf16)
//   _bwd_fused_kernel  -> flash_bwd_kv_wgmma_kernel<D, true>
//                         (entry flash_attention_bwd_fused_bf16)
// The Python wrapper (ops/flash_attention.py) pads S to a multiple of 64,
// picks the fused or the blocked backward by the reference's rule
// (S <= block, on the unpadded S), whatever tiles the kernels use inside,
// and counts each launch under its TPU kernel.
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
// Layouts: q, out, dout, dq (B, H, S, Dh); k, v, dk, dv (B, KH, S, Dh); all
// bf16 and contiguous; seg (B, S) int32 or null. S is a multiple of 64,
// Dh 64 or 128. Products are bf16 x bf16 summed in f32 on the tensor
// cores; softmax math is f32, and probabilities (and dS) are rounded to
// bf16 before each product, as the reference's kernels do.
//
// What bounds them on an H100: at S = 1024-2048 the causal products (4 Dh
// operations per visible pair forward, 8 Dh for dK/dV, 6 Dh for dQ, 10 Dh
// fused) are far above the card's ridge point, so the tensor-core rate
// bounds every kernel: at B 4 x S 2048 x H 32, Dh 128, 0.139 ms forward,
// 0.278 ms dK/dV and 0.209 ms dQ at 989 TFLOP/s; the fused backward at
// B 4 x S 1024 0.087 ms. Only wgmma reaches that rate, and only if the
// tiles arrive while the tensor cores work on earlier ones.
//
// All four are built alike. A block is three warpgroups: two consumers of
// 64 rows each and a producer whose one thread issues every copy;
// setmaxnreg hands the producer's registers to the consumers (24 and 240
// a thread). Tiles arrive by TMA from 3-D maps (Dh, S, B x heads) in
// 128B-swizzled boxes of 64 columns x 64 rows, so a tile that runs past S
// reads zeros, not the next head's rows; rings of two stages with full
// and empty mbarriers keep loads in flight while the consumers run wgmma
// straight from shared memory. P is exp2(s * scale log2 e - lse log2 e)
// with the scale folded into one FMA; the causal mask applies on the
// diagonal tile only, the segment mask on every tile. In the backward
// kernels each consumer commits S (or S^T) and dP (dP^T) as two wgmma
// groups and forms P from the first while the second runs.
//   forward  grid (H, B, S/128) with the q tile slowest and reversed: the
//            heaviest causal tiles start first, and the G q heads of one
//            kv head run side by side and share K/V in L2. 128 q rows, Q
//            loaded once; kv tiles of 128 up to the diagonal. S = Q K^T by
//            wgmma m64n128k16 (both K-major in shared memory); online
//            softmax on the accumulators; O += P V with P packed from the
//            accumulators in registers and V read MN-major (the transpose
//            bit), so V needs no transposed copy. O goes through shared
//            memory (Q's own rows) and a TMA store; LSE per row.
//   dQ       the forward's mirror: the same grid and order, Q and dO (128
//            rows) loaded once with their LSE, delta and segment ids, K/V
//            tiles of 128 through the ring up to the diagonal. Per tile
//            S = Q K^T and dP = dO V^T (m64n128k16 from shared memory), dS
//            in registers, then dQ += dS K with dS packed to bf16 in
//            registers and K read MN-major from the tile S used. dQ (64
//            f32 a thread at Dh 128) stays in registers and is written
//            once through Q's rows and a TMA store.
//   dK/dV    grid (KH, B, S/128), the heaviest kv tiles first. K and V
//            (128 rows) stay in shared memory; the producer streams q
//            tiles of 64 rows (Q, dO, LSE, delta, segment ids) for each of
//            the G q heads of the kv head, from the block's first kv row
//            (the reference's block skip). Per tile each consumer forms
//            S^T = K Q^T and dP^T = V dO^T (m64n64k16 from shared memory);
//            dV += P^T dO is issued as soon as P^T is packed, then dK +=
//            dS^T Q, both with A from registers and dO, Q read MN-major
//            from the same tiles. dK and dV sum over the group in f32
//            registers and are written once per kv head in bf16 by TMA.
//            The delta pre-pass (flash_delta_kernel) runs first in the
//            same entry.
//   fused    the dK/dV kernel plus a dQ partial per q tile: each consumer
//            stages its dS^T (bf16) in shared memory (two buffers), and
//            after a named barrier of both consumers dQ_tile (64 q x Dh)
//            = dS K runs as SS wgmma with both operands MN-major (dS^T
//            read transposed through the descriptor, the resident K as the
//            dQ kernel reads it). At Dh 128 the two consumers split dQ's
//            columns (64 each, over all 128 kv rows); at Dh 64 each takes
//            its own 64 kv rows. The partial is added into an f32 dQ with
//            vector reductions (float4 atomicAdd after one shuffle); the
//            entry zeroes that f32 dQ in the delta pre-pass and converts
//            it to bf16 after (flash_f32_to_bf16_kernel), so one entry
//            yields dQ, dK and dV. The reductions make dQ's summation
//            order vary run to run. What bounds it beyond the tensor
//            cores: up to S/128 f32 partials reach each dQ element (302 MB
//            of reductions at B 4 x S 1024 x H 32, Dh 128, into a 67 MB f32
//            dQ that the 50 MB L2 cannot hold), the zeroing and conversion
//            passes, and the barrier that keeps the two consumers in step.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has each
// beside its bound, its range and SDPA's time in turns): forward 0.294
// ms, dK/dV 0.686 ms, dQ 0.476 ms at B 4 x S 2048 x H 32 / KH 8, Dh 128;
// fused 0.414 ms at S 1024, 1.24x SDPA's backward.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;       // delta pre-pass and conversion blocks
constexpr int kRows = 64;           // S % kRows == 0 (the wrapper pads)
constexpr float kNegInf = -1e30f;   // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The TMA kernels
constexpr int kWgThreads = 128;         // one warpgroup
constexpr int kTmaThreads = 3 * 128;    // two consumer warpgroups + producer
constexpr int kProducerRegs = 24;       // setmaxnreg: 24 x 128 + 240 x 256
constexpr int kConsumerRegs = 240;      //   = 168 x 384, the launch's share
constexpr int kBoxCols = 64;            // bf16 columns per box (128 bytes)
constexpr int kBoxRows = 64;            // rows per box
constexpr int kBoxBytes = kBoxCols * kBoxRows * 2;  // 8 KB
constexpr int kTileRows = 128;          // q rows (fwd, dQ) / kv rows (dK/dV)
constexpr int kFwdStages = 2;           // K/V ring depth (fwd, dQ)
constexpr int kBwdQ = 64;               // q rows per streamed dK/dV tile
constexpr int kBwdStages = 2;           // Q/dO ring depth
constexpr int kConsumerWarps = 8;       // arrivals that free a stage

// ---------------------------------------------------------------------------
// Hopper building blocks: TMA, mbarriers, setmaxnreg, wgmma
// ---------------------------------------------------------------------------

// Shared tiles are written by TMA with CU_TENSOR_MAP_SWIZZLE_128B in boxes
// of 64 bf16 columns (128 bytes) by 64 rows: row r of a box sits at r * 128
// bytes, its 16-byte chunk c at chunk c ^ (r % 8). A wider row (Dh 128) is
// two such column halves, one after the other. Every tile starts on a
// 1024-byte boundary, so the swizzle phase of a row is r % 8 and wgmma
// descriptors need no base offset.
//
// wgmma fragments (PTX ISA, m64nNk16, f32 accumulators): in a warpgroup,
// warp w owns rows 16w .. 16w + 15; lane l (g = l / 4, t = l % 4) holds,
// for each 8-column chunk j, d[4j + 0..1] = (row 16w + g, cols 8j + 2t ..
// 8j + 2t + 1) and d[4j + 2..3] = (row 16w + g + 8, the same cols). A bf16
// A operand from registers has mma.sync's m16n8k16 layout per warp, so two
// neighbouring accumulator chunks packed to bf16 are one 16-deep k-step of
// the next product's A.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`: the phase that
// `parity` names has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// One box of a 3-D tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A contiguous run of bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One box from shared memory to the tensor; rows past the tensor's end
// are not written.
__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic shared-memory writes before later reads
// by the async proxy (a TMA store, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- warpgroup register hand-over ------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled tile. K-major: SBO is
// the 1024 bytes between 8-row groups (LBO unused). MN-major: LBO is the
// distance between 64-element column halves, SBO again 1024 bytes between
// groups of 8 k rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous product (they are written or read until wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128); A and B in shared
// memory, both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64); A and B in shared memory,
// both K-major, or both MN-major with kMn (the transpose bits); scale_d 0
// overwrites D.
template <int kMn = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kMn));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128); B in
// shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64); B in shared
// memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The RS product at the output width N (64 or 128): accumulator N / 2
// floats a thread.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_n128_mn(d, a, db);
  } else {
    static_assert(N == 64, "wgmma_rs_mn: N is 64 or 128");
    wgmma_rs_n64_mn(d, a, db);
  }
}

// Byte offset of element (r, c) in a swizzled tile of `rows` rows whose
// column halves of 64 follow one another.
__device__ __forceinline__ uint32_t swz_offset(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Pack an accumulator of 64 rows x 16 k columns per step (chunks 2kk and
// 2kk + 1) into the bf16 A fragments of the next product.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&d)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_floats(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_floats(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_floats(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_floats(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Write a warpgroup's (64 x D) f32 accumulator as bf16 into its 64 rows
// of a swizzled tile of `rows` rows starting at row `row0`.
template <int D>
__device__ __forceinline__ void store_acc_swizzled(unsigned char* tile,
                                                   const float (&d)[D / 2],
                                                   float mul_lo, float mul_hi,
                                                   int row0, int rows,
                                                   int warp, int g, int tig) {
  const int rl = row0 + warp * 16 + g;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(tile + swz_offset(rl, col, rows)) =
        pack_floats(d[4 * c] * mul_lo, d[4 * c + 1] * mul_lo);
    *reinterpret_cast<uint32_t*>(tile + swz_offset(rl + 8, col, rows)) =
        pack_floats(d[4 * c + 2] * mul_hi, d[4 * c + 3] * mul_hi);
  }
}

// ---------------------------------------------------------------------------
// Forward (B3): TMA ring, two consumer warpgroups, wgmma
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kTile = D / kBoxCols * 2 * kBoxBytes;  // 128 x D
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                        // + stage * kTile
  static constexpr int kV = kK + kFwdStages * kTile;      // + stage * kTile
  static constexpr int kBars = kV + kFwdStages * kTile;
  // q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kFwdStages);
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, const int* __restrict__ seg,
    float* __restrict__ lse, int heads, int kv_heads, int seq,
    float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles: 1 KB
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  const auto bar_k = [&](int st) { return bar_q + 8 * (1 + st); };
  const auto bar_v = [&](int st) {
    return bar_q + 8 * (1 + kFwdStages + st);
  };
  const auto bar_e = [&](int st) {
    return bar_q + 8 * (1 + 2 * kFwdStages + st);
  };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = qt * kTileRows;
  const int n_tiles = qt + 1;                  // kv tiles up to the diagonal
  const int qplane = b * heads + h;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_e(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      const int kplane = b * kv_heads + h / (heads / kv_heads);
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tma_load_3d(base + L::kQ + (2 * hf + r) * kBoxBytes, &tq, bar_q,
                      hf * kBoxCols, q0 + r * kBoxRows, qplane);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kFwdStages;
        mbar_wait(bar_e(st), ((j / kFwdStages) & 1) ^ 1);
        const uint32_t ks = base + L::kK + st * L::kTile;
        const uint32_t vs = base + L::kV + st * L::kTile;
        mbar_expect_tx(bar_k(st), L::kTile);
#pragma unroll
        for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tma_load_3d(ks + (2 * hf + r) * kBoxBytes, &tk, bar_k(st),
                        hf * kBoxCols, j * kTileRows + r * kBoxRows, kplane);
          }
        }
        mbar_expect_tx(bar_v(st), L::kTile);
#pragma unroll
        for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tma_load_3d(vs + (2 * hf + r) * kBoxBytes, &tv, bar_v(st),
                        hf * kBoxCols, j * kTileRows + r * kBoxRows, kplane);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int r_lo = q0 + wg * 64 + warp * 16 + g;
    const int r_hi = r_lo + 8;
    const bool has_seg = seg != nullptr;
    const int* segb = has_seg ? seg + static_cast<long long>(b) * seq
                              : nullptr;
    const int seg_lo = has_seg && r_lo < seq ? segb[r_lo] : 0;
    const int seg_hi = has_seg && r_hi < seq ? segb[r_hi] : 0;

    float acc[D / 2];
    float s[64];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf;  // running max, log2 units
    float l_lo = 0.f, l_hi = 0.f;          // per-thread partial sums

    // this warpgroup's 64 rows of Q in each column half
    const uint32_t qa = base + L::kQ + wg * kBoxBytes;
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kFwdStages;
      const uint32_t ph = (j / kFwdStages) & 1;
      const uint32_t ks = base + L::kK + st * L::kTile;
      const uint32_t vs = base + L::kV + st * L::kTile;

      // S = Q K^T (64 x 128), both K-major
      mbar_wait(bar_k(st), ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n128(s, sw128_desc(qa + off, 16), sw128_desc(ks + off, 16),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // masks: causal on the diagonal tile, segments on every tile. A
      // masked tile is scaled here, its masked scores set to NEG_INF in
      // log2 units, so that a row with no visible key yet subtracts its
      // max exactly (exp2(0) = 1, wiped by the next visible tile's
      // correction, as in the reference's finite NEG_INF)
      const int t0 = j * kTileRows;
      const bool masked = j == n_tiles - 1 || has_seg;
      if (masked) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = t0 + c * 8 + tig * 2 + e;
            const int sc = has_seg ? (col < seq ? segb[col] : -1) : 0;
            float& lo = s[4 * c + e];
            float& hi = s[4 * c + 2 + e];
            lo = col > r_lo || sc != seg_lo ? kNegInf : lo * scale_log2;
            hi = col > r_hi || sc != seg_hi ? kNegInf : hi * scale_log2;
          }
        }
      }
      const float sl = masked ? 1.f : scale_log2;

      // online softmax in log2 units: p = exp2(s * scale log2 e - m)
      float mx_lo = s[0], mx_hi = s[2];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * c], s[4 * c + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * c + 2], s[4 * c + 3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * sl);
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * sl);
      const float corr_lo = exp2f(m_lo - mn_lo);
      const float corr_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * c + e] = exp2f(fmaf(s[4 * c + e], sl, -mn_lo));
          s[4 * c + 2 + e] = exp2f(fmaf(s[4 * c + 2 + e], sl, -mn_hi));
          sum_lo += s[4 * c + e];
          sum_hi += s[4 * c + 2 + e];
        }
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= corr_lo;
        acc[4 * c + 1] *= corr_lo;
        acc[4 * c + 2] *= corr_hi;
        acc[4 * c + 3] *= corr_hi;
      }
      uint32_t pa[8][4];
      pack_a<8>(pa, s);

      // O += P V: V (kv x Dh) read MN-major, 16 kv rows a step
      mbar_wait(bar_v(st), ph);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs_mn<D>(acc, pa[kk],
                       sw128_desc(vs + kk * 16 * 128, 2 * kBoxBytes));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_e(st));
    }

    // O = acc / l through this warpgroup's Q rows and a TMA store; LSE
    const float den_lo = fmaxf(quad_sum(l_lo), 1e-30f);
    const float den_hi = fmaxf(quad_sum(l_hi), 1e-30f);
    store_acc_swizzled<D>(sm + L::kQ, acc, 1.f / den_lo, 1.f / den_hi,
                          wg * 64, kTileRows, warp, g, tig);
    fence_proxy_async();
    named_barrier(1 + wg, kWgThreads);
    if (tid == 0 && q0 + wg * 64 < seq) {
#pragma unroll
      for (int hf = 0; hf < D / kBoxCols; ++hf) {
        tma_store_3d(&to, base + L::kQ + (2 * hf + wg) * kBoxBytes,
                     hf * kBoxCols, q0 + wg * 64, qplane);
      }
      tma_store_commit_and_wait();
    }
    if (tig == 0) {
      float* lp = lse + static_cast<long long>(qplane) * seq;
      if (r_lo < seq) lp[r_lo] = (m_lo + log2f(den_lo)) * kLn2;
      if (r_hi < seq) lp[r_hi] = (m_hi + log2f(den_hi)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward pre-pass: delta = rowsum(dout * out), f32; with a non-null
// dq32, also zeroes that row of the fused backward's f32 dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ delta, float* __restrict__ dq32, long long rows) {
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
  if (dq32 != nullptr) {
    float4* z = reinterpret_cast<float4*>(dq32 + row * D);
    for (int c = lane; c < D / 4; c += 32) {
      z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// dq = bf16(dq32), 8 values a thread per step.
__global__ void __launch_bounds__(kThreads) flash_f32_to_bf16_kernel(
    const float* __restrict__ src, bf16* __restrict__ dst, long long n8) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
    uint4 o;
    o.x = pack_floats(a.x, a.y);
    o.y = pack_floats(a.z, a.w);
    o.z = pack_floats(b.x, b.y);
    o.w = pack_floats(b.z, b.w);
    reinterpret_cast<uint4*>(dst)[i] = o;
  }
}

// ---------------------------------------------------------------------------
// dQ (B5): Q, dO resident; a TMA ring of K/V tiles; wgmma
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kTile = D / kBoxCols * 2 * kBoxBytes;  // 128 x D
  static constexpr int kVec = kTileRows * 4;                  // 128 floats
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  static constexpr int kK = 2 * kTile;                  // + stage * kTile
  static constexpr int kV = kK + kFwdStages * kTile;    // + stage * kTile
  static constexpr int kLse = kV + kFwdStages * kTile;
  static constexpr int kDelta = kLse + kVec;
  static constexpr int kSegQ = kDelta + kVec;
  static constexpr int kSegK = kSegQ + kVec;            // + stage * kVec
  static constexpr int kBars = kSegK + kFwdStages * kVec;
  // q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kFwdStages);
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg, int heads,
    int kv_heads, int seq, float scale, float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles: 1 KB
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBars;
  const auto bar_k = [&](int st) { return bar_q + 8 * (1 + st); };
  const auto bar_v = [&](int st) {
    return bar_q + 8 * (1 + kFwdStages + st);
  };
  const auto bar_e = [&](int st) {
    return bar_q + 8 * (1 + 2 * kFwdStages + st);
  };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int q0 = qt * kTileRows;
  const int n_tiles = qt + 1;                  // kv tiles up to the diagonal
  const int qplane = b * heads + h;
  const bool has_seg = seg != nullptr;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_e(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q, dO and their row vectors once, then K/V tiles ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      const int kplane = b * kv_heads + h / (heads / kv_heads);
      // row vectors of the rows inside S only (S % 64 == 0)
      const uint32_t q_bytes = 4 * min(kTileRows, seq - q0);
      mbar_expect_tx(bar_q, 2 * L::kTile + (has_seg ? 3 : 2) * q_bytes);
#pragma unroll
      for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int box = (2 * hf + r) * kBoxBytes;
          tma_load_3d(base + L::kQ + box, &tq, bar_q, hf * kBoxCols,
                      q0 + r * kBoxRows, qplane);
          tma_load_3d(base + L::kDo + box, &tdo, bar_q, hf * kBoxCols,
                      q0 + r * kBoxRows, qplane);
        }
      }
      const long long row0 = static_cast<long long>(qplane) * seq + q0;
      bulk_load(base + L::kLse, lse + row0, q_bytes, bar_q);
      bulk_load(base + L::kDelta, delta + row0, q_bytes, bar_q);
      if (has_seg) {
        bulk_load(base + L::kSegQ, seg + static_cast<long long>(b) * seq + q0,
                  q_bytes, bar_q);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kFwdStages;
        const int t0 = j * kTileRows;
        mbar_wait(bar_e(st), ((j / kFwdStages) & 1) ^ 1);
        const uint32_t ks = base + L::kK + st * L::kTile;
        const uint32_t vs = base + L::kV + st * L::kTile;
        const uint32_t kv_bytes = 4 * min(kTileRows, seq - t0);
        mbar_expect_tx(bar_k(st), L::kTile + (has_seg ? kv_bytes : 0));
#pragma unroll
        for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tma_load_3d(ks + (2 * hf + r) * kBoxBytes, &tk, bar_k(st),
                        hf * kBoxCols, t0 + r * kBoxRows, kplane);
          }
        }
        if (has_seg) {
          bulk_load(base + L::kSegK + st * L::kVec,
                    seg + static_cast<long long>(b) * seq + t0, kv_bytes,
                    bar_k(st));
        }
        mbar_expect_tx(bar_v(st), L::kTile);
#pragma unroll
        for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tma_load_3d(vs + (2 * hf + r) * kBoxBytes, &tv, bar_v(st),
                        hf * kBoxCols, t0 + r * kBoxRows, kplane);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int lr = wg * 64 + warp * 16 + g;  // fragment row in the tile
    const int r_lo = q0 + lr;
    const int r_hi = r_lo + 8;

    mbar_wait(bar_q, 0);
    // rows past S (the second half of a last tile of 64 rows) have no
    // row vectors loaded: give them finite ones; they are not stored
    const float* lse_s = reinterpret_cast<const float*>(sm + L::kLse);
    const float* dl_s = reinterpret_cast<const float*>(sm + L::kDelta);
    const int* segq_s = reinterpret_cast<const int*>(sm + L::kSegQ);
    const bool in_lo = r_lo < seq, in_hi = r_hi < seq;
    const float ls_lo = in_lo ? lse_s[lr] * kLog2e : 0.f;
    const float ls_hi = in_hi ? lse_s[lr + 8] * kLog2e : 0.f;
    const float dl_lo = in_lo ? dl_s[lr] : 0.f;
    const float dl_hi = in_hi ? dl_s[lr + 8] : 0.f;
    const int seg_lo = has_seg && in_lo ? segq_s[lr] : 0;
    const int seg_hi = has_seg && in_hi ? segq_s[lr + 8] : 0;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // this warpgroup's 64 rows of Q and dO in each column half
    const uint32_t qa = base + L::kQ + wg * kBoxBytes;
    const uint32_t doa = base + L::kDo + wg * kBoxBytes;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kFwdStages;
      const uint32_t ph = (j / kFwdStages) & 1;
      const uint32_t ks = base + L::kK + st * L::kTile;
      const uint32_t vs = base + L::kV + st * L::kTile;

      // S = Q K^T and dP = dO V^T (64 x 128 each), all K-major, in two
      // groups: P is formed while dP runs
      float s[64], dp[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.f;
      mbar_wait(bar_k(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n128(s, sw128_desc(qa + off, 16), sw128_desc(ks + off, 16),
                      kk > 0);
      }
      wgmma_commit();
      mbar_wait(bar_v(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n128(dp, sw128_desc(doa + off, 16), sw128_desc(vs + off, 16),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P = exp2(S scale log2 e - lse log2 e) on the mask, else 0, into s;
      // then dS = P (dP - delta) scale. The causal mask only on the
      // diagonal tile, the segment mask on every tile.
      const int t0 = j * kTileRows;
      const bool diag = j == n_tiles - 1;
      const int* segk_s =
          reinterpret_cast<const int*>(sm + L::kSegK + st * L::kVec);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = c * 8 + tig * 2 + e;
          const int col = t0 + cl;
          bool ok_lo = !diag || col <= r_lo;
          bool ok_hi = !diag || col <= r_hi;
          if (has_seg) {
            const int sk = segk_s[cl];
            ok_lo = ok_lo && sk == seg_lo;
            ok_hi = ok_hi && sk == seg_hi;
          }
          s[4 * c + e] =
              ok_lo ? exp2f(fmaf(s[4 * c + e], scale_log2, -ls_lo)) : 0.f;
          s[4 * c + 2 + e] =
              ok_hi ? exp2f(fmaf(s[4 * c + 2 + e], scale_log2, -ls_hi)) : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * c + e] *= (dp[4 * c + e] - dl_lo) * scale;
          s[4 * c + 2 + e] *= (dp[4 * c + 2 + e] - dl_hi) * scale;
        }
      }
      uint32_t da[8][4];
      pack_a<8>(da, s);

      // dQ += dS K: K (kv x Dh) read MN-major from the same tile, 16 kv
      // rows a step
      fence_regs(dq);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs_mn<D>(dq, da[kk],
                       sw128_desc(ks + kk * 16 * 128, 2 * kBoxBytes));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      if (lane == 0) mbar_arrive(bar_e(st));
    }

    // dQ (bf16) through this warpgroup's Q rows and a TMA store
    store_acc_swizzled<D>(sm + L::kQ, dq, 1.f, 1.f, wg * 64, kTileRows,
                          warp, g, tig);
    fence_proxy_async();
    named_barrier(1 + wg, kWgThreads);
    if (tid == 0 && q0 + wg * 64 < seq) {
#pragma unroll
      for (int hf = 0; hf < D / kBoxCols; ++hf) {
        tma_store_3d(&tdq, base + L::kQ + (2 * hf + wg) * kBoxBytes,
                     hf * kBoxCols, q0 + wg * 64, qplane);
      }
      tma_store_commit_and_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV (B4) and the fused backward (B6): K, V resident; a TMA ring of q
// tiles; wgmma. kDq adds the fused backward's dQ partial per q tile.
// ---------------------------------------------------------------------------

template <int D, bool kDq>
struct BwdSmem {
  static constexpr int kKv = D / kBoxCols * 2 * kBoxBytes;  // 128 x D
  static constexpr int kQt = D / kBoxCols * kBoxBytes;      // 64 x D
  static constexpr int kDsTile = kTileRows * 128;  // dS^T: 128 kv x 64 q
  static constexpr int kK = 0;
  static constexpr int kV = kKv;
  static constexpr int kQ = 2 * kKv;                   // + stage * kQt
  static constexpr int kDo = kQ + kBwdStages * kQt;    // + stage * kQt
  static constexpr int kDs = kDo + kBwdStages * kQt;   // + buffer * kDsTile
  static constexpr int kVec = kBwdQ * 4;               // 64 floats or ints
  static constexpr int kLse = kDs + (kDq ? 2 * kDsTile : 0);  // + stage * kVec
  static constexpr int kDelta = kLse + kBwdStages * kVec;
  static constexpr int kSeg = kDelta + kBwdStages * kVec;
  static constexpr int kBars = kSeg + kBwdStages * kVec;
  // kv_full, full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kBwdStages);
};

// The fused backward's dQ partial of one q tile: dQ_tile (64 q x 64
// columns, f32) = dS K, dS read through the descriptor from the staged
// dS^T (MN-major) and K resident (MN-major). Dh 128: this warpgroup's 64
// columns over all 128 kv rows, after both consumers staged their halves
// of dS^T; Dh 64: all columns over its own 64 kv rows. Issues and commits
// the product.
template <int D>
__device__ __forceinline__ void issue_dq_partial(float (&dqp)[32],
                                                 uint32_t ds_tile,
                                                 uint32_t k_tile, int wg) {
  fence_proxy_async();
  if (D == 128) {
    named_barrier(3, 2 * kWgThreads);
  } else {
    named_barrier(1 + wg, kWgThreads);
  }
  const uint32_t dsa = ds_tile + (D == 128 ? 0 : wg * kBoxBytes);
  const uint32_t kb = k_tile + wg * (D == 128 ? 2 : 1) * kBoxBytes;
#pragma unroll
  for (int i = 0; i < 32; ++i) dqp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < (D == 128 ? 8 : 4); ++kk) {
    wgmma_ss_n64<1>(dqp, sw128_desc(dsa + kk * 16 * 128, kBoxBytes),
                    sw128_desc(kb + kk * 16 * 128, kBoxBytes), kk > 0);
  }
  wgmma_commit();
}

// Adds a finished dQ partial into the f32 dQ rows from row0 (of the
// flattened (B x H x S) rows): the lanes of a quad pair up (tig ^ 1) so
// that each holds four consecutive columns of one row, then one vector
// reduction per 8-column chunk.
template <int D>
__device__ __forceinline__ void add_dq_partial(float* dq32, long long row0,
                                               int wg,
                                               const float (&dqp)[32]) {
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const bool odd = tig & 1;
  float* row = dq32 +
               (row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) +
                (tig & 1) * 8) * D +
               (D == 128 ? wg * 64 : 0) + (tig & 2) * 2;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float sx = odd ? dqp[4 * c] : dqp[4 * c + 2];
    const float sy = odd ? dqp[4 * c + 1] : dqp[4 * c + 3];
    const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
    const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
    const float4 v4 = odd
                          ? make_float4(rx, ry, dqp[4 * c + 2], dqp[4 * c + 3])
                          : make_float4(dqp[4 * c], dqp[4 * c + 1], rx, ry);
    atomicAdd(reinterpret_cast<float4*>(row + c * 8), v4);
  }
}

template <int D, bool kDq>
__global__ void __launch_bounds__(kTmaThreads, 1) flash_bwd_kv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk,
    const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    float* __restrict__ dq32, int heads, int kv_heads, int seq, float scale,
    float scale_log2) {
  using L = BwdSmem<D, kDq>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles: 1 KB
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::kBars;
  const auto bar_f = [&](int st) { return bar_kv + 8 * (1 + st); };
  const auto bar_e = [&](int st) {
    return bar_kv + 8 * (1 + kBwdStages + st);
  };

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kTileRows;  // the lowest (heaviest) first
  const int group = heads / kv_heads;
  const int kplane = b * kv_heads + kh;
  const int n_qt = (seq - k0) / kBwdQ;    // q tiles at or after row k0
  const int n_items = group * n_qt;
  const bool has_seg = seg != nullptr;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(bar_f(st), 1);
      mbar_init(bar_e(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: K, V once, then (Q, dO, LSE, delta, seg) per q tile
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(bar_kv, 2 * L::kKv);
#pragma unroll
      for (int hf = 0; hf < D / kBoxCols; ++hf) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int box = (2 * hf + r) * kBoxBytes;
          tma_load_3d(base + L::kK + box, &tk, bar_kv, hf * kBoxCols,
                      k0 + r * kBoxRows, kplane);
          tma_load_3d(base + L::kV + box, &tv, bar_kv, hf * kBoxCols,
                      k0 + r * kBoxRows, kplane);
        }
      }
      const uint32_t tile_bytes =
          2 * L::kQt + 2 * L::kVec + (has_seg ? L::kVec : 0);
      int n = 0;
      for (int hg = 0; hg < group; ++hg) {
        const int qplane = b * heads + kh * group + hg;
        const float* lse_h = lse + static_cast<long long>(qplane) * seq;
        const float* dl_h = delta + static_cast<long long>(qplane) * seq;
        for (int i0 = k0; i0 < seq; i0 += kBwdQ, ++n) {
          const int st = n % kBwdStages;
          mbar_wait(bar_e(st), ((n / kBwdStages) & 1) ^ 1);
          mbar_expect_tx(bar_f(st), tile_bytes);
#pragma unroll
          for (int hf = 0; hf < D / kBoxCols; ++hf) {
            const int box = st * L::kQt + hf * kBoxBytes;
            tma_load_3d(base + L::kQ + box, &tq, bar_f(st), hf * kBoxCols,
                        i0, qplane);
            tma_load_3d(base + L::kDo + box, &tdo, bar_f(st),
                        hf * kBoxCols, i0, qplane);
          }
          bulk_load(base + L::kLse + st * L::kVec, lse_h + i0, L::kVec,
                    bar_f(st));
          bulk_load(base + L::kDelta + st * L::kVec, dl_h + i0, L::kVec,
                    bar_f(st));
          if (has_seg) {
            bulk_load(base + L::kSeg + st * L::kVec,
                      seg + static_cast<long long>(b) * seq + i0, L::kVec,
                      bar_f(st));
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int t_wg = k0 + wg * 64;          // this warpgroup's first kv row
    const int t_lo = t_wg + warp * 16 + g;  // its fragment rows
    const int t_hi = t_lo + 8;
    const int* segb = has_seg ? seg + static_cast<long long>(b) * seq
                              : nullptr;
    const int seg_lo = has_seg && t_lo < seq ? segb[t_lo] : 0;
    const int seg_hi = has_seg && t_hi < seq ? segb[t_hi] : 0;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    // this warpgroup's 64 rows of K and V in each column half
    const uint32_t ka = base + L::kK + wg * kBoxBytes;
    const uint32_t va = base + L::kV + wg * kBoxBytes;
    // fused: item n's dS^T buffer (128 kv rows x 64 q, the rows of each
    // consumer) and the first f32 dQ row of its q tile
    const auto ds_tile = [&](int n) {
      return sm + L::kDs + (n & 1) * L::kDsTile;
    };
    const auto dq_row0 = [&](int n, int i0) {
      return static_cast<long long>(b * heads + kh * group + n / n_qt) * seq +
             i0;
    };
    mbar_wait(bar_kv, 0);
    for (int n = 0; n < n_items; ++n) {
      const int st = n % kBwdStages;
      const int i0 = k0 + (n % n_qt) * kBwdQ;
      mbar_wait(bar_f(st), (n / kBwdStages) & 1);
      // some row of this q tile reaches the warpgroup's kv rows
      const bool live = i0 + kBwdQ > t_wg;
      if (live) {
        const uint32_t qs = base + L::kQ + st * L::kQt;
        const uint32_t dos = base + L::kDo + st * L::kQt;

        // S^T = K Q^T and dP^T = V dO^T (64 kv x 64 q), all K-major
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t oa = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
          const uint32_t ob = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
          wgmma_ss_n64(s, sw128_desc(ka + oa, 16), sw128_desc(qs + ob, 16),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t oa = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
          const uint32_t ob = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
          wgmma_ss_n64(dp, sw128_desc(va + oa, 16), sw128_desc(dos + ob, 16),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        // P^T = exp2(S^T scale log2 e - lse log2 e) on the mask, else 0,
        // formed while dP^T runs, and dV += P^T dO issued; then dS^T =
        // P^T (dP^T - delta) scale and dK += dS^T Q. dO and Q (q x Dh)
        // are read MN-major, 16 q rows a step. The causal mask only on
        // the diagonal tile, the segment mask on every tile.
        const float* lse_s =
            reinterpret_cast<const float*>(sm + L::kLse + st * L::kVec);
        const float* dl_s =
            reinterpret_cast<const float*>(sm + L::kDelta + st * L::kVec);
        const int* seg_s =
            reinterpret_cast<const int*>(sm + L::kSeg + st * L::kVec);
        const bool diag = i0 == t_wg;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = c * 8 + tig * 2 + e;
            const int i = i0 + ci;
            const float ls = lse_s[ci] * kLog2e;
            bool ok_lo = !diag || i >= t_lo;
            bool ok_hi = !diag || i >= t_hi;
            if (has_seg) {
              const int sq = seg_s[ci];
              ok_lo = ok_lo && sq == seg_lo;
              ok_hi = ok_hi && sq == seg_hi;
            }
            s[4 * c + e] =
                ok_lo ? exp2f(fmaf(s[4 * c + e], scale_log2, -ls)) : 0.f;
            s[4 * c + 2 + e] =
                ok_hi ? exp2f(fmaf(s[4 * c + 2 + e], scale_log2, -ls)) : 0.f;
          }
        }
        uint32_t pa[4][4], da[4][4];
        pack_a<4>(pa, s);
        fence_regs(dv);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_mn<D>(dv, pa[kk],
                         sw128_desc(dos + kk * 16 * 128, kBoxBytes));
        }
        wgmma_commit();

        wgmma_wait<1>();  // dP^T (dV may still run)
        fence_regs(dp);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dl = dl_s[c * 8 + tig * 2 + e];
            dp[4 * c + e] = s[4 * c + e] * (dp[4 * c + e] - dl) * scale;
            dp[4 * c + 2 + e] =
                s[4 * c + 2 + e] * (dp[4 * c + 2 + e] - dl) * scale;
          }
        }
        pack_a<4>(da, dp);
        fence_regs(dk);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_mn<D>(dk, da[kk], sw128_desc(qs + kk * 16 * 128, kBoxBytes));
        }
        wgmma_commit();
        if constexpr (kDq) {
          // stage dS^T (bf16, this warpgroup's 64 kv rows) while the
          // products run; the A fragments are (kv row, q column pairs)
          unsigned char* dsb = ds_tile(n);
          const int rl = wg * 64 + warp * 16 + g;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int c = kk * 16 + tig * 2;
            *reinterpret_cast<uint32_t*>(dsb + swz_offset(rl, c, kTileRows)) =
                da[kk][0];
            *reinterpret_cast<uint32_t*>(
                dsb + swz_offset(rl + 8, c, kTileRows)) = da[kk][1];
            *reinterpret_cast<uint32_t*>(
                dsb + swz_offset(rl, c + 8, kTileRows)) = da[kk][2];
            *reinterpret_cast<uint32_t*>(
                dsb + swz_offset(rl + 8, c + 8, kTileRows)) = da[kk][3];
          }
        }
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        if (lane == 0) mbar_arrive(bar_e(st));
      } else {
        if (lane == 0) mbar_arrive(bar_e(st));
        if constexpr (kDq && D == 128) {
          // every pair is masked: this warpgroup's dS^T rows are zeros,
          // which the other consumer's half of the dQ product reads
          uint4* z = reinterpret_cast<uint4*>(ds_tile(n) + wg * kBoxBytes);
#pragma unroll
          for (int i = 0; i < kBoxBytes / 16 / kWgThreads; ++i) {
            z[i * kWgThreads + tid] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      if constexpr (kDq) {
        if (D == 128 || live) {
          float dqp[32];
          issue_dq_partial<D>(dqp, smem_u32(ds_tile(n)), base + L::kK, wg);
          wgmma_wait<0>();
          fence_regs(dqp);
          add_dq_partial<D>(dq32, dq_row0(n, i0), wg, dqp);
        }
      }
    }

    // dK, dV (bf16) through this warpgroup's K and V rows and TMA stores;
    // in the fused kernel the other consumer may still read K for its dQ
    // product, so both finish first
    if constexpr (kDq) named_barrier(3, 2 * kWgThreads);
    store_acc_swizzled<D>(sm + L::kK, dk, 1.f, 1.f, wg * 64, kTileRows,
                          warp, g, tig);
    store_acc_swizzled<D>(sm + L::kV, dv, 1.f, 1.f, wg * 64, kTileRows,
                          warp, g, tig);
    fence_proxy_async();
    named_barrier(1 + wg, kWgThreads);
    if (tid == 0 && t_wg < seq) {
#pragma unroll
      for (int hf = 0; hf < D / kBoxCols; ++hf) {
        const int box = (2 * hf + wg) * kBoxBytes;
        tma_store_3d(&tdk, base + L::kK + box, hf * kBoxCols, t_wg, kplane);
        tma_store_3d(&tdv, base + L::kV + box, hf * kBoxCols, t_wg, kplane);
      }
      tma_store_commit_and_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side of the TMA kernels
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime so that
// the library links no libcuda of its own.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The 3-D map (Dh, S, planes) of a contiguous (planes, S, Dh) bf16 array,
// in 128B-swizzled boxes of 64 columns x 64 rows; reads past S give
// zeros, writes past S are dropped.
bool bhsd_map(CUtensorMap* map, const void* ptr, int d, int seq,
              int planes) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(seq) * d * 2};
  const cuuint32_t box[3] = {kBoxCols, kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* seg, void* out, void* lse, int batch,
                       int heads, int kv_heads, int seq, float scale,
                       cudaStream_t s) {
  CUtensorMap mq, mk, mv, mo;
  if (!bhsd_map(&mq, q, D, seq, batch * heads) ||
      !bhsd_map(&mk, k, D, seq, batch * kv_heads) ||
      !bhsd_map(&mv, v, D, seq, batch * kv_heads) ||
      !bhsd_map(&mo, out, D, seq, batch * heads)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = FwdSmem<D>::kBytes + 1024;  // + 1 KB alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(heads, batch, (seq + kTileRows - 1) / kTileRows);
  flash_fwd_wgmma_kernel<D><<<grid, kTmaThreads, smem, s>>>(
      mq, mk, mv, mo, static_cast<const int*>(seg), static_cast<float*>(lse),
      heads, kv_heads, seq, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_delta(const void* out, const void* dout, void* delta,
                         void* dq32, int batch, int heads, int seq,
                         cudaStream_t s) {
  const long long rows = static_cast<long long>(batch) * heads * seq;
  const int per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  flash_delta_kernel<D><<<blocks, kThreads, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq32), rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* seg, void* dq, int batch, int heads,
                      int kv_heads, int seq, float scale, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!bhsd_map(&mq, q, D, seq, batch * heads) ||
      !bhsd_map(&mk, k, D, seq, batch * kv_heads) ||
      !bhsd_map(&mv, v, D, seq, batch * kv_heads) ||
      !bhsd_map(&mdo, dout, D, seq, batch * heads) ||
      !bhsd_map(&mdq, dq, D, seq, batch * heads)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = DqSmem<D>::kBytes + 1024;  // + 1 KB alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(heads, batch, (seq + kTileRows - 1) / kTileRows);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kTmaThreads, smem, s>>>(
      mq, mk, mv, mdo, mdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), heads,
      kv_heads, seq, scale, scale * kLog2e);
  return cudaGetLastError();
}

// The dK/dV kernel, and with kDq the fused backward's (dQ added into the
// zeroed f32 dq32).
template <int D, bool kDq>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* seg, void* dq32, void* dk, void* dv,
                      int batch, int heads, int kv_heads, int seq,
                      float scale, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!bhsd_map(&mq, q, D, seq, batch * heads) ||
      !bhsd_map(&mk, k, D, seq, batch * kv_heads) ||
      !bhsd_map(&mv, v, D, seq, batch * kv_heads) ||
      !bhsd_map(&mdo, dout, D, seq, batch * heads) ||
      !bhsd_map(&mdk, dk, D, seq, batch * kv_heads) ||
      !bhsd_map(&mdv, dv, D, seq, batch * kv_heads)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = BwdSmem<D, kDq>::kBytes + 1024;  // + alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kv_wgmma_kernel<D, kDq>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(kv_heads, batch, (seq + kTileRows - 1) / kTileRows);
  flash_bwd_kv_wgmma_kernel<D, kDq><<<grid, kTmaThreads, smem, s>>>(
      mq, mk, mv, mdo, mdk, mdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg),
      static_cast<float*>(dq32), heads, kv_heads, seq, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        const void* seg, void* delta, void* dk, void* dv,
                        int batch, int heads, int kv_heads, int seq,
                        float scale, cudaStream_t s) {
  const cudaError_t e =
      launch_delta<D>(out, dout, delta, nullptr, batch, heads, seq, s);
  if (e != cudaSuccess) return e;
  return launch_kv<D, false>(q, k, v, dout, lse, delta, seg, nullptr, dk, dv,
                             batch, heads, kv_heads, seq, scale, s);
}

template <int D>
cudaError_t launch_fused(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         const void* seg, void* delta, void* dq32, void* dq,
                         void* dk, void* dv, int batch, int heads,
                         int kv_heads, int seq, float scale, cudaStream_t s) {
  cudaError_t e = launch_delta<D>(out, dout, delta, dq32, batch, heads, seq,
                                  s);
  if (e != cudaSuccess) return e;
  e = launch_kv<D, true>(q, k, v, dout, lse, delta, seg, dq32, dk, dv, batch,
                         heads, kv_heads, seq, scale, s);
  if (e != cudaSuccess) return e;
  const long long n8 = static_cast<long long>(batch) * heads * seq * D / 8;
  const long long want = (n8 + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want
                                                                : 132 * 16);
  flash_f32_to_bf16_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(dq32), static_cast<bf16*>(dq), n8);
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

// B3: out (bf16) and the LSE (f32, (B, H, S)).
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    void* lse, int batch, int heads, int kv_heads, int seq, int head_dim,
    float scale, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(batch, heads, kv_heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_fwd<64>(q, k, v, seg, out, lse, batch,
                                             heads, kv_heads, seq, scale, s));
    case 128:
      return static_cast<int>(launch_fwd<128>(q, k, v, seg, out, lse, batch,
                                              heads, kv_heads, seq, scale,
                                              s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
      return static_cast<int>(launch_dkdv<64>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, batch, heads,
          kv_heads, seq, scale, s));
    case 128:
      return static_cast<int>(launch_dkdv<128>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, batch, heads,
          kv_heads, seq, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B5: dQ (bf16) from the delta the dK/dV entry wrote.
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
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_dq<64>(q, k, v, dout, lse, delta, seg,
                                            dq, batch, heads, kv_heads, seq,
                                            scale, s));
    case 128:
      return static_cast<int>(launch_dq<128>(q, k, v, dout, lse, delta, seg,
                                             dq, batch, heads, kv_heads, seq,
                                             scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B6: delta pre-pass (zeroing the f32 scratch dq32, (B, H, S, Dh)), then
// dK/dV with dQ added into dq32, then dq = bf16(dq32).
extern "C" int flash_attention_bwd_fused_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* seg, void* delta,
    void* dq32, void* dq, void* dk, void* dv, int batch, int heads,
    int kv_heads, int seq, int head_dim, float scale, void* stream) {
  (void)cudaGetLastError();
  if (!shape_ok(batch, heads, kv_heads, seq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch_fused<64>(
          q, k, v, out, dout, lse, seg, delta, dq32, dq, dk, dv, batch,
          heads, kv_heads, seq, scale, s));
    case 128:
      return static_cast<int>(launch_fused<128>(
          q, k, v, out, dout, lse, seg, delta, dq32, dq, dk, dv, batch,
          heads, kv_heads, seq, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
