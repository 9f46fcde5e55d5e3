// Flash attention for Hopper (sm_90a): the training path's causal
// (optionally segment-masked) attention, forward and backward.
//
// Replaces the four Pallas TPU kernels of
// cloud_server_tpu/ops/flash_attention.py:
//   _fwd_kernel        -> flash_fwd_wgmma_kernel
//                         (entry flash_attention_fwd_bf16)
//   _bwd_dkdv_kernel   -> flash_bwd_dkdv_wgmma_kernel
//                         (entry flash_attention_bwd_dkdv_bf16)
//   _bwd_dq_kernel     -> flash_bwd_dq_kernel
//                         (entry flash_attention_bwd_dq_bf16)
//   _bwd_fused_kernel  -> flash_bwd_fused_kernel
//                         (entry flash_attention_bwd_fused_bf16)
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
// bf16 and contiguous; seg (B, S) int32 or null. S is a multiple of 64,
// Dh 64 or 128. Products are bf16 x bf16 summed in f32 on the tensor
// cores; softmax math is f32, and probabilities (and dS) are rounded to
// bf16 before each product, as the reference's kernels do.
//
// What bounds them on an H100: at S = 1024-2048 the causal products (4 Dh
// operations per visible pair forward, 8 Dh for dK/dV, 6 Dh for dQ) are
// far above the card's ridge point, so the tensor-core rate bounds every
// kernel: at B 4 x S 2048 x H 32, Dh 128, 0.139 ms forward and 0.278 ms
// for dK/dV at 989 TFLOP/s. Only wgmma reaches that rate, and only if the
// tiles arrive while the tensor cores work on earlier ones.
//
// Forward and dK/dV (TMA, mbarrier rings, wgmma). A block is three
// warpgroups: two consumers of 64 rows each and a producer whose one
// thread issues every copy; setmaxnreg hands the producer's registers to
// the consumers (24 and 240 a thread). Tiles arrive by TMA from 3-D maps
// (Dh, S, B x heads) in 128B-swizzled boxes of 64 columns x 64 rows, so a
// tile that runs past S reads zeros, not the next head's rows; a ring of
// two stages with full and empty mbarriers keeps loads in flight while
// the consumers run wgmma straight from shared memory.
//   forward  grid (H, B, S/128) with the q tile slowest and reversed: the
//            heaviest causal tiles start first, and the G q heads of one
//            kv head run side by side and share K/V in L2. 128 q rows, Q
//            loaded once; kv tiles of 128 up to the diagonal. S = Q K^T by
//            wgmma m64n128k16 (both K-major in shared memory); online
//            softmax on the accumulators in exp2 with scale * log2(e)
//            folded into one FMA; the causal mask only on the diagonal
//            tile, the segment mask on every tile; O += P V with P packed
//            from the accumulators in registers and V read MN-major (the
//            transpose bit), so V needs no transposed copy. O goes through
//            shared memory (Q's own rows) and a TMA store; LSE per row.
//   dK/dV    grid (KH, B, S/128), the heaviest kv tiles first. K and V
//            (128 rows) stay in shared memory; the producer streams q
//            tiles of 64 rows (Q, dO, LSE, delta, segment ids) for each of
//            the G q heads of the kv head, from the block's first kv row
//            (the reference's block skip). Per tile each consumer forms
//            S^T = K Q^T and dP^T = V dO^T (m64n64k16 from shared memory),
//            P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
//            with A from registers and dO, Q read MN-major from the same
//            tiles. dK and dV sum over the group in f32 registers and are
//            written once per kv head in bf16 by TMA. The delta pre-pass
//            (flash_delta_kernel) runs first in the same entry.
//   dQ       grid (S/64, H, B), 4 warps x 16 q rows, q-stationary over kv
//            tiles of 32 up to its last row.
//   fused    kv-stationary like dK/dV, 4 warps x 16 kv rows over q tiles
//            of 32; each (q tile, kv tile) pair's dS is staged in shared
//            memory and its dS.K partial added with atomicAdd into an f32
//            dQ the wrapper zeroed, so one launch produces dQ, dK and dV
//            (the atomics make dQ's summation order vary from run to run).
// dQ and fused are still the first versions: mma.sync m16n8k16 (helpers
// in mma_bf16.cuh) on padded shared tiles filled by plain 16-byte loads
// between two __syncthreads, far from their bound; their times stand in
// PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;       // four warps (dQ, fused, delta)
constexpr int kRows = 64;           // rows (q or kv) per block; S % kRows == 0
constexpr int kPad = 8;             // shared row padding (bf16 elements)
constexpr int kDqTile = 32;         // kv positions per dQ tile
constexpr int kKvTileQ = 32;        // q rows per fused-backward tile
constexpr float kNegInf = -1e30f;   // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The TMA kernels (forward, dK/dV)
constexpr int kWgThreads = 128;         // one warpgroup
constexpr int kTmaThreads = 3 * 128;    // two consumer warpgroups + producer
constexpr int kProducerRegs = 24;       // setmaxnreg: 24 x 128 + 240 x 256
constexpr int kConsumerRegs = 240;      //   = 168 x 384, the launch's share
constexpr int kBoxCols = 64;            // bf16 columns per box (128 bytes)
constexpr int kBoxRows = 64;            // rows per box
constexpr int kBoxBytes = kBoxCols * kBoxRows * 2;  // 8 KB
constexpr int kTileRows = 128;          // q rows (fwd) / kv rows (dK/dV)
constexpr int kFwdStages = 2;           // K/V ring depth
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
// both K-major; scale_d 0 overwrites D.
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
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
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
// dK/dV (B4): K, V resident; a TMA ring of q tiles; wgmma
// ---------------------------------------------------------------------------

template <int D>
struct BwdSmem {
  static constexpr int kKv = D / kBoxCols * 2 * kBoxBytes;  // 128 x D
  static constexpr int kQt = D / kBoxCols * kBoxBytes;      // 64 x D
  static constexpr int kK = 0;
  static constexpr int kV = kKv;
  static constexpr int kQ = 2 * kKv;                   // + stage * kQt
  static constexpr int kDo = kQ + kBwdStages * kQt;    // + stage * kQt
  static constexpr int kVec = kBwdQ * 4;               // 64 floats or ints
  static constexpr int kLse = kDo + kBwdStages * kQt;  // + stage * kVec
  static constexpr int kDelta = kLse + kBwdStages * kVec;
  static constexpr int kSeg = kDelta + kBwdStages * kVec;
  static constexpr int kBars = kSeg + kBwdStages * kVec;
  // kv_full, full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kBwdStages);
};

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk,
    const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg, int heads,
    int kv_heads, int seq, float scale, float scale_log2) {
  using L = BwdSmem<D>;
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
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

    // this warpgroup's 64 rows of K and V in each column half
    const uint32_t ka = base + L::kK + wg * kBoxBytes;
    const uint32_t va = base + L::kV + wg * kBoxBytes;
    mbar_wait(bar_kv, 0);
    for (int n = 0; n < n_items; ++n) {
      const int st = n % kBwdStages;
      const int i0 = k0 + (n % n_qt) * kBwdQ;
      mbar_wait(bar_f(st), (n / kBwdStages) & 1);
      if (i0 + kBwdQ <= t_wg) {
        // every row of this q tile lies before the warpgroup's kv rows
        if (lane == 0) mbar_arrive(bar_e(st));
        continue;
      }
      const uint32_t qs = base + L::kQ + st * L::kQt;
      const uint32_t dos = base + L::kDo + st * L::kQt;

      // S^T = K Q^T and dP^T = V dO^T (64 kv x 64 q), all K-major
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
        const uint32_t ob = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n64(s, sw128_desc(ka + oa, 16), sw128_desc(qs + ob, 16),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk >> 2) * 2 * kBoxBytes + (kk & 3) * 32;
        const uint32_t ob = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
        wgmma_ss_n64(dp, sw128_desc(va + oa, 16), sw128_desc(dos + ob, 16),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp2(S^T scale log2 e - lse log2 e) on the mask, else 0;
      // dS^T = P^T (dP^T - delta) scale. The causal mask only on the
      // diagonal tile, the segment mask on every tile.
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
          const float dl = dl_s[ci];
          bool ok_lo = !diag || i >= t_lo;
          bool ok_hi = !diag || i >= t_hi;
          if (has_seg) {
            const int sq = seg_s[ci];
            ok_lo = ok_lo && sq == seg_lo;
            ok_hi = ok_hi && sq == seg_hi;
          }
          const float p_lo =
              ok_lo ? exp2f(fmaf(s[4 * c + e], scale_log2, -ls)) : 0.f;
          const float p_hi =
              ok_hi ? exp2f(fmaf(s[4 * c + 2 + e], scale_log2, -ls)) : 0.f;
          s[4 * c + e] = p_lo;
          s[4 * c + 2 + e] = p_hi;
          dp[4 * c + e] = p_lo * (dp[4 * c + e] - dl) * scale;
          dp[4 * c + 2 + e] = p_hi * (dp[4 * c + 2 + e] - dl) * scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_a<4>(pa, s);
      pack_a<4>(da, dp);

      // dV += P^T dO and dK += dS^T Q: dO and Q (q x Dh) read MN-major,
      // 16 q rows a step
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_mn<D>(dv, pa[kk], sw128_desc(dos + kk * 16 * 128, kBoxBytes));
        wgmma_rs_mn<D>(dk, da[kk], sw128_desc(qs + kk * 16 * 128, kBoxBytes));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(bar_e(st));
    }

    // dK, dV (bf16) through this warpgroup's K and V rows and TMA stores
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
// Fused whole-sequence backward (B6): dK/dV kv-stationary, dQ by atomics
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fused_smem_bytes() {
  return static_cast<size_t>(2 * kRows + 2 * kKvTileQ) * (D + kPad) *
             sizeof(bf16) +
         3 * kKvTileQ * sizeof(float) +
         static_cast<size_t>(kRows) * (kKvTileQ + kPad) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_fused_kernel(
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
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const void* lse,
                        const void* seg, void* delta, void* dk, void* dv,
                        int batch, int heads, int kv_heads, int seq,
                        float scale, cudaStream_t s) {
  cudaError_t e = launch_delta<D>(out, dout, delta, batch, heads, seq, s);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!bhsd_map(&mq, q, D, seq, batch * heads) ||
      !bhsd_map(&mk, k, D, seq, batch * kv_heads) ||
      !bhsd_map(&mv, v, D, seq, batch * kv_heads) ||
      !bhsd_map(&mdo, dout, D, seq, batch * heads) ||
      !bhsd_map(&mdk, dk, D, seq, batch * kv_heads) ||
      !bhsd_map(&mdv, dv, D, seq, batch * kv_heads)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = BwdSmem<D>::kBytes + 1024;  // + 1 KB alignment slack
  e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(kv_heads, batch, (seq + kTileRows - 1) / kTileRows);
  flash_bwd_dkdv_wgmma_kernel<D><<<grid, kTmaThreads, smem, s>>>(
      mq, mk, mv, mdo, mdk, mdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seg), heads,
      kv_heads, seq, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fused(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         const void* seg, void* delta, void* dk, void* dv,
                         void* dq32, int batch, int heads, int kv_heads,
                         int seq, float scale, cudaStream_t s) {
  cudaError_t e = launch_delta<D>(out, dout, delta, batch, heads, seq, s);
  if (e != cudaSuccess) return e;
  const size_t smem = fused_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_fused_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(seq / kRows, kv_heads, batch);
  flash_bwd_fused_kernel<D><<<grid, kThreads, smem, s>>>(
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
      return static_cast<int>(launch_fused<64>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, dq32, batch, heads,
          kv_heads, seq, scale, s));
    case 128:
      return static_cast<int>(launch_fused<128>(
          q, k, v, out, dout, lse, seg, delta, dk, dv, dq32, batch, heads,
          kv_heads, seq, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
