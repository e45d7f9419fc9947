// Flash attention for Hopper (sm_90a): online-softmax attention with causal and sliding-window
// masks, a static q_offset, and grouped-query heads.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas.
//
// What it computes: o[b, h, i] = softmax_j(q[b, h, i] . k[b, h // G, j] * scale) v[b, h // G, j]
// over the keys j that row i keeps: j <= q_offset + i when causal, j > q_offset + i - window
// with a window. A row that keeps no key returns 0 (the TPU kernel's zero-mass rule).
//
// Bound on the card: at prefill lengths the QK^T and PV products bound it by operations. Two
// kernels, picked by the dtype (kernels/flash_attention/ops.py):
//
// - mma (bf16), FlashAttention-3's forward shape on wgmma and TMA: one block per (q tile of BQ
//   rows, b * Hq + h), heaviest causal tiles first. A producer warpgroup's first thread loads the
//   block's Q once and keeps a ring of two (K, V) stages full by TMA (cp.async.bulk.tensor,
//   4-d maps over the (B, H, S, D) views' strides, 128-byte swizzle), each K and V tile with its
//   own full mbarrier and each stage an empty one; it walks only the kv tiles some row of the block
//   keeps. No consumer thread issues a copy. Each consumer warpgroup owns 64 query rows (wgmma's
//   M): S = Q K^T by wgmma m64nBKVk16 with both operands in shared memory (K's rows have D
//   contiguous: K-major, no transpose), the online softmax in fp32 registers on the accumulator
//   fragment (ex2.approx with scale * log2(e) folded into one FFMA a score, the -inf mask only on
//   edge tiles and without a branch an element, m = 0 for a row with no key yet), P rounded to
//   bf16 in registers (the one rounding step the fp32 reference does not take) and fed straight
//   back as wgmma's register A operand for O += P V, with V an MN-major B from shared memory (the descriptor's transpose, no copy). A
//   warpgroup whose 64 rows keep no key of a tile skips its products and still releases the stage.
//   With two consumer warpgroups (BQ = 128) they take turns to issue S (named barriers), so one's
//   softmax runs under the other's product, and setmaxnreg gives the producer's registers to the
//   consumers (40 / 232). The epilogue divides by the quad-summed row sum (0 where it is 0) and
//   stores bf16 pairs to the strided output. D = 80 and 96 fill one 128-byte box and part of a
//   second, which TMA fills with zeros past D: S takes the k steps up to D only, and O += P V runs
//   at N = D. q, k, v and their strides must be 16-byte aligned, with no zero stride along a dim of
//   more than one (the wrapper checks).
// - v1 (float32), FlashAttention-2's shape in FP32 SIMT (tensor cores would round fp32 to tf32,
//   which misses the float32 tolerances): one block of 256 threads per (64-row q tile, b * Hq +
//   h), the heaviest causal tiles launched first. Q stays in shared memory for the whole walk;
//   K and V tiles of 64 keys come through a two-stage cp.async ring (16-byte chunks, zero-filled
//   past Skv; plain loads inside the kernel where a tensor or its strides are not 16-byte
//   aligned), so the next tile loads while this one is multiplied. Rows are padded to D + 4
//   floats, so a half-warp's float4 reads of 8 K rows fall in 32 different banks. S = QK^T is a
//   register-tiled outer product: thread (tx, ty) = (tid % 16, tid / 16) owns rows ty * 4 + i and
//   keys tx + 16 j (i, j < 4) and reads its q and k fragments as float4s along D, 64 FMAs per 8
//   LDS.128. The online softmax runs once a tile: row max over the 16 threads of a row group by
//   shuffles, one expf per score (plus one rescale a row), the row sums kept per thread and
//   summed at the end. P goes through shared memory, and O += PV is register-tiled the same way:
//   the thread owns rows ty * 4 + i and the float4 chunks tx + 16 j of D (D / 64 of them, the
//   last partly idle at D = 80 and 96). Shared memory is Q, the K/V ring and P: 102 KiB at D = 64
//   (two blocks an SM) up to 182 KiB at D = 128. It also stays reachable for bf16 by an explicit
//   variant (plain loads, converted to fp32 in shared memory), to be timed beside the mma kernel.
//
// Both skip every kv tile that the causal and window masks exclude for all rows of the block,
// read the kv head h // (Hq / Hkv) without repeating K and V per query head, take q, k, v and o
// through their batch/head/sequence strides (the caller's (B, S, H, D) projections need no
// copy), and mask ragged Sq and Skv here. Both take the head dim D as a template parameter and are
// built for D = 64, 80, 96 and 128 (the reference's model zoo: SmolLM and hymba 64, hubert-xlarge
// 80, phi3-mini 96, qwen3, llama3, mixtral, llama4 and internvl2 128), with their tiles in dynamic
// shared memory, its limit raised at each launch that needs more than 48 KiB (per launch, not once
// per instance: the attribute belongs to the current device).
//
// Tiles. Both kernels take the q tile BQ and the kv tile BKV as template parameters, and each is
// built at four (BQ, BKV) instances of its own, chosen from the kernel's structure; the autotuner
// (repro_torch.tune, space "flash_attention") picks among a variant's per shape:
// - mma: BQ / 64 consumer warpgroups and one producer warpgroup, so 256 threads at BQ = 64 and
//   384 at 128 (which reuses each K/V tile for twice the rows at twice the causal tiles' diagonal
//   waste); BKV is wgmma's N for S and BKV / 16 k steps of O += P V. Shared memory is 1 KiB of
//   alignment, Q and the ring, ceil(D / 64) boxes of 128-byte rows each (FlashShape): (64, 64)
//   41 KiB at D = 64, (128, 128) 161 KiB at D = 80 to 128. Instances (128, 128), the heuristic,
//   (128, 64), (64, 128) and (64, 64), at every D.
// - v1: 256 threads as 16 x 16, thread (tx, ty) owning rows ty x BQ / 16 + i and keys tx + 16 j,
//   so BQ / 16 rows and BKV / 16 keys a thread: BQ = 128 gives each thread 8 rows (each K float4
//   read from shared memory feeds twice the FMAs), BKV = 32 or 128 gives it 2 or 8 keys. Shared
//   memory is 4 ((BQ + 4 BKV)(D + 4) + BQ (BKV + 4)) bytes, so (128, 64) fits only up to D = 96 and
//   (64, 128) up to D = 80: the over-limit instances are not built (the lint's KRN002 refuses
//   them first). In bf16, v1 is a timing variant only and is built at (64, 64) alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma fences, TMA maps

namespace {

struct Strides {
  long long b, h, s;  // the last (head-dim) stride is 1
};

// ---------------------------------------------------------------------------
// mma: bf16, wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

// A block: BQ / 64 consumer warpgroups (64 query rows each, wgmma's M) and one producer
// warpgroup. Shared memory holds Q and a ring of STAGES (K, V) tiles, each as 64-column boxes of
// 128-byte rows under TMA's 128-byte swizzle (box c holds columns 64c .. 64c + 63 of every row;
// past D, TMA writes zeros).
template <int D, int BQ, int BKV> struct FlashShape {
  static constexpr int CONSUMERS = BQ / 64;  // warpgroups
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int BOXES = (D + 63) / 64;          // 64-column boxes a row
  static constexpr int Q_BYTES = BQ * 128 * BOXES;
  static constexpr int KV_BYTES = BKV * 128 * BOXES;   // one K or V tile
  // two (K, V) stages: three or four timed no faster, and cost the 64-row instances their second
  // block an SM at D >= 80
  static constexpr int STAGES = 2;
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;  // + the slack that aligns it to 1 KB
  // Two consumer warpgroups: 168 registers a thread at launch (ptxas's cap for 384 threads), and
  // setmaxnreg hands the producer's to the consumers (384 x 168 = 128 x 40 + 256 x 232). One: 256
  // threads with up to 255 registers each, no rebalance.
  static constexpr bool REBALANCE = CONSUMERS > 1;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
};

struct FlashArgs {
  __nv_bfloat16* o;
  Strides os;
  int Hq, Hkv, Sq, Skv, causal, window, q_offset;
  float scale_log2;
};

// A K-major operand (Q as A, K as B: D contiguous): 128-byte rows under the 128-byte swizzle,
// 8-row groups 1024 bytes apart; `saddr` is the 1-KB aligned box plus 32 bytes a k step.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// V as an MN-major B (its D columns are wgmma's N, its keys the k): N runs along the 128-byte rows,
// the next 64 columns one box (`box` bytes) on (the leading byte offset), and 8-key groups are
// 1024 bytes apart (the stride byte offset); `saddr` is the tile plus 2048 bytes a k step of 16 keys.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t saddr, uint32_t box) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(box >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// S (64 x 64) = A B, A and B K-major from shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// S (64 x 128) = A B, A and B K-major from shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
// O (64 x 64) += A B, A (P) from registers, B (V) MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// O (64 x 80) += A B, A (P) from registers, B (V) MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_80(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// O (64 x 96) += A B, A (P) from registers, B (V) MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// O (64 x 128) += A B, A (P) from registers, B (V) MN-major from shared memory
__device__ __forceinline__ void wgmma_rs_128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N> __device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_64(d, da, db, scale_d);
  else wgmma_ss_128(d, da, db, scale_d);
}
template <int N> __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_80(d, a, db);
  else if constexpr (N == 96) wgmma_rs_96(d, a, db);
  else wgmma_rs_128(d, a, db);
}

// 2^x by the SFU (ex2.approx, flushing subnormal results to 0; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// named barriers 1 and 2 (0 is __syncthreads), between the two consumer warpgroups' 256 threads
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One block per (q tile, b * Hq + h), the heaviest causal tiles first. The producer warpgroup's
// first thread loads Q once and keeps the (K, V) ring full over the kv tiles any row of the block
// keeps; each consumer warpgroup computes its 64 rows: S = Q K^T (wgmma, both from shared memory),
// the online softmax in fp32 registers, P rounded to bf16 in registers and O += P V (wgmma, P from
// registers, V from shared memory).
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(FlashShape<D, BQ, BKV>::THREADS, 1)
flash_mma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const FlashArgs a) {
  using S = FlashShape<D, BQ, BKV>;
  constexpr int STAGES = S::STAGES;
  constexpr int NR = BKV / 2;  // a consumer thread's scores of a tile: BKV / 8 blocks of 8 keys, 4 each
  extern __shared__ unsigned char flash_raw[];
  unsigned char* const qs =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(flash_raw) + 1023) & ~uintptr_t(1023));
  auto ks = [&](int st) { return qs + S::Q_BYTES + st * 2 * S::KV_BYTES; };
  auto vs = [&](int st) { return qs + S::Q_BYTES + (st * 2 + 1) * S::KV_BYTES; };
  // the Q barrier, then each stage's K full, V full and empty barriers
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  uint64_t* const qbar = bars;
  auto kfull = [&](int st) { return bars + 1 + st; };
  auto vfull = [&](int st) { return bars + 1 + STAGES + st; };
  auto empty = [&](int st) { return bars + 1 + 2 * STAGES + st; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first

  // kv range any row of this block keeps, in whole tiles
  const int lo = a.q_offset + q0;
  const int hi = a.q_offset + min(q0 + BQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, hi + 1) : a.Skv;
  const int kv_begin = a.window > 0 ? max(0, lo - a.window + 1) : 0;
  const int t_first = kv_begin / BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - 1) / BKV - t_first + 1 : 0;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kfull(st), 1);  // the producer's expect_tx; the bytes complete it
      mbar_init(vfull(st), 1);
      mbar_init(empty(st), 4 * S::CONSUMERS);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * S::CONSUMERS) {  // the producer warpgroup
    if constexpr (S::REBALANCE) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::PRODUCER_REGS));
    if (warp == 4 * S::CONSUMERS && lane == 0 && n_tiles > 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      mbar_arrive_tx(qbar, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::BOXES; ++c) tma_load4(qs + c * BQ * 128, &qmap, qbar, 64 * c, q0, h, b);
      int st = 0;
      uint32_t ph = 0;  // the ring's stage and its phase, tile after tile
      for (int it = 0; it < n_tiles; ++it) {
        const int t0 = (t_first + it) * BKV;
        mbar_wait(empty(st), ph ^ 1);
        mbar_arrive_tx(kfull(st), S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::BOXES; ++c) tma_load4(ks(st) + c * BKV * 128, &kmap, kfull(st), 64 * c, t0, hk, b);
        mbar_arrive_tx(vfull(st), S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::BOXES; ++c) tma_load4(vs(st) + c * BKV * 128, &vmap, vfull(st), 64 * c, t0, hk, b);
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (S::REBALANCE) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));

  // the consumers: warpgroup wg owns rows row0 .. row0 + 63 of the block; its warp wq rows
  // 16 wq + g and 16 wq + g + 8 of those (g = lane / 4), keys 8i + 2 t4 and + 1 of each block i of 8
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 64 * wg;
  const bool live = row0 < a.Sq;
  const int w_lo = a.q_offset + row0, w_hi = a.q_offset + min(row0 + 64, a.Sq) - 1;  // absolute
  const int r0 = w_lo + 16 * wq + g, r1 = r0 + 8;
  const uint32_t qaddr = smem_u32(qs) + 64 * wg * 128;

  float o[D / 2];  // 64 x D output: D / 8 blocks of 8 head dims, 4 a thread each
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  acc_fence(o);
  // rows r0 and r1: the running max in log2 units (scores times scale_log2) and this thread's share
  // of the running sum (the quad is summed at the end)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // the columns each row keeps, [keep_lo, keep_hi], for the edge tiles' mask
  int keep_lo[2], keep_hi[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? r1 : r0;
    keep_lo[hf] = a.window > 0 ? row - a.window + 1 : 0;
    keep_hi[hf] = a.causal ? min(row, a.Skv - 1) : a.Skv - 1;
  }
  // Two consumer warpgroups take turns to issue S = Q K^T (named barriers 1 and 2), so one's
  // softmax runs while the other's product holds the tensor cores; warpgroup 0 goes first.
  constexpr bool PINGPONG = S::CONSUMERS == 2;
  if (n_tiles > 0) mbar_wait(qbar, 0);
  if (PINGPONG && wg == 1 && n_tiles > 0) named_arrive(1);

  int st = 0;
  uint32_t ph = 0;  // the ring's stage and its phase, tile after tile
  for (int it = 0; it < n_tiles; ++it, st = st + 1 == STAGES ? 0 : st + 1, ph ^= st == 0) {  // next stage
    const int t0 = (t_first + it) * BKV;
    mbar_wait(kfull(st), ph);
    if (PINGPONG) named_sync(1 + wg);
    // a tile that keeps no key of this warpgroup's rows adds nothing; its stage is still released
    // once its loads have landed
    if (!live || (a.causal && t0 > w_hi) || (a.window > 0 && t0 + BKV - 1 <= w_lo - a.window)) {
      if (PINGPONG) named_arrive(2 - wg);
      mbar_wait(vfull(st), ph);
      if (lane == 0) mbar_arrive(empty(st));
      continue;
    }

    // S = Q K^T: 64 rows x BKV keys, D / 16 k steps (up to D: the zero columns past it are not read)
    float s[NR];
    const uint32_t kaddr = smem_u32(ks(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV>(s, kmajor_desc(qaddr + (kk >> 2) * BQ * 128 + (kk & 3) * 32),
                    kmajor_desc(kaddr + (kk >> 2) * BKV * 128 + (kk & 3) * 32), kk > 0);
    wg_commit();
    if (PINGPONG) named_arrive(2 - wg);
    wg_wait<0>();
    acc_fence(s);

    // -inf where the tile crosses an edge of what these rows keep (the zero rows TMA writes past
    // Skv included), without a branch an element
    if (t0 + BKV > a.Skv || (a.causal && t0 + BKV - 1 > w_lo) || (a.window > 0 && t0 <= w_hi - a.window)) {
#pragma unroll
      for (int i = 0; i < NR / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + 8 * i + 2 * t4 + (e & 1);
          const bool keep = (col >= keep_lo[e >> 1]) & (col <= keep_hi[e >> 1]);
          s[4 * i + e] = keep ? s[4 * i + e] : -INFINITY;
        }
    }

    // online softmax in log2 units, one row per half of each block (e 0-1: row r0, e 2-3: row r1):
    // p = 2^(s * scale_log2 - m) by one FFMA and one ex2; the max and the sum as four partial
    // chains a row
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NR / 4; ++i)
        mx[i & 3] = fmaxf(mx[i & 3], fmaxf(s[4 * i + 2 * hf], s[4 * i + 2 * hf + 1]));
      float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(m_run[hf], m * a.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      const float alpha = fast_exp2(m_run[hf] - m_use);
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NR / 4; ++i) {
        float& x0 = s[4 * i + 2 * hf];
        float& x1 = s[4 * i + 2 * hf + 1];
        x0 = fast_exp2(fmaf(x0, a.scale_log2, -m_use));
        x1 = fast_exp2(fmaf(x1, a.scale_log2, -m_use));
        sum[i & 3] += x0 + x1;
      }
      l_run[hf] = l_run[hf] * alpha + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      m_run[hf] = m_new;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i + 2 * hf] *= alpha;
        o[4 * i + 2 * hf + 1] *= alpha;
      }
    }

    // P (64 x BKV, bf16) as BKV / 16 A fragments straight from the score registers: k step kk is
    // blocks 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3])
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V: BKV / 16 k steps of 16 keys, N = D
    mbar_wait(vfull(st), ph);
    const uint32_t vaddr = smem_u32(vs(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs<D>(o, p[kk], mnmajor_desc(vaddr + kk * 2048, BKV * 128));
    wg_commit();
    wg_wait<0>();
    acc_fence(o);
    if (lane == 0) mbar_arrive(empty(st));
  }
  if (PINGPONG && wg == 0 && n_tiles > 0) named_sync(1);  // the last turn warpgroup 1 handed over

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that kept no key returns 0
    const int qi = row0 + 16 * wq + g + 8 * hf;
    if (qi >= a.Sq) continue;
    __nv_bfloat16* op = a.o + b * a.os.b + h * a.os.h + (long long)qi * a.os.s + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * hf] * inv, o[4 * i + 2 * hf + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// v1: FP32 SIMT
// ---------------------------------------------------------------------------
namespace v1 {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// BQ query rows per block, BKV keys per kv tile (template parameters)
constexpr int NT = 256;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
template <int D> __host__ __device__ constexpr int ld() { return D + 4; }
// Q, the two-stage K and V rings, P: 104,448 bytes at D = 64, 186,368 at D = 128 for (64, 64)
template <int D, int BQ, int BKV> __host__ __device__ constexpr int smem_bytes() {
  return 4 * ((BQ + 4 * BKV) * ld<D>() + BQ * (BKV + 4));
}
// two blocks an SM at D = 64 where two fit (128 registers a thread), else one
template <int D, int BQ, int BKV> __host__ __device__ constexpr int min_blocks() {
  return D == 64 && 2 * smem_bytes<D, BQ, BKV>() <= SMEM_LIMIT ? 2 : 1;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// vec: q, k and v and their strides 16-byte aligned (fp32 only): cp.async; else plain loads.
// o_vec: the same for o, stored as float4s.
template <typename T, int D, int BQ, int BKV>
__global__ void __launch_bounds__(NT, (min_blocks<D, BQ, BKV>()))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
                       int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       int causal, int window, int q_offset, int vec, int o_vec) {
  constexpr int LD = ld<D>();
  constexpr int LP = BKV + 4;         // a row of P
  constexpr int CH = D / 4;          // float4 chunks a row
  constexpr int DJ = (CH + 15) / 16;  // chunks of O a thread: tx + 16 j
  constexpr int RI = BQ / 16;         // rows a thread: ty * RI + i
  constexpr int KJ = BKV / 16;        // keys a thread: tx + 16 j
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Qs = reinterpret_cast<float*>(smem);  // [BQ][LD]
  float* const Ks = Qs + BQ * LD;                      // [2][BKV][LD]
  float* const Vs = Ks + 2 * BKV * LD;                 // [2][BKV][LD]
  float* const Ps = Vs + 2 * BKV * LD;                 // [BQ][LP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows start first

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  // kv range any row of this block keeps, in whole tiles
  const int lo = q_offset + q0;
  const int hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, lo - window + 1) : 0;
  const int t_first = kv_begin / BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - 1) / BKV - t_first + 1 : 0;

  // ROWS rows from row0 of src (rows past `limit` zero) into dst: CH / 4 chunks a thread at 64 rows
  auto stage = [&](auto rows, float* dst, const T* src, long long sstride, int row0, int limit) {
    constexpr int CHUNKS = decltype(rows)::value * CH;
#pragma unroll
    for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if constexpr (CHUNKS % NT != 0) {
        if (c >= CHUNKS) break;
      }
      const int r = c / CH, ch = (c % CH) * 4;
      const bool in = row0 + r < limit;
      float* d = dst + r * LD + ch;
      const T* p = src + (long long)(row0 + r) * sstride + ch;
      if constexpr (std::is_same<T, float>::value) {
        if (vec) {
          cp_async16(d, in ? p : src, in ? 16 : 0);
          continue;
        }
      }
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) val = make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
      *reinterpret_cast<float4*>(d) = val;
    }
  };
  const std::integral_constant<int, BQ> q_rows{};
  const std::integral_constant<int, BKV> kv_rows{};
  stage(q_rows, Qs, qp, qs.s, q0, Sq);
  if (n_tiles > 0) {
    stage(kv_rows, Ks, kp, ks.s, t_first * BKV, Skv);
    stage(kv_rows, Vs, vp, vs.s, t_first * BKV, Skv);
  }
  cp_async_commit();

  float oacc[RI][DJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][jj][e] = 0.f;
  float m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const int row0 = q_offset + q0 + ty * RI;  // this thread's first row, absolute

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    cp_async_wait0();
    __syncthreads();  // tile it has landed; every thread is done with tile it - 1 and with P
    if (it + 1 < n_tiles) {
      const int t1 = (t_first + it + 1) * BKV;
      stage(kv_rows, Ks + (st ^ 1) * BKV * LD, kp, ks.s, t1, Skv);
      stage(kv_rows, Vs + (st ^ 1) * BKV * LD, vp, vs.s, t1, Skv);
    }
    cp_async_commit();
    const float* kt = Ks + st * BKV * LD;
    const float* vt = Vs + st * BKV * LD;
    const int t0 = (t_first + it) * BKV;

    // S = Q K^T: rows ty * RI + i, keys tx + 16 j
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qa[RI], kb[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * RI + i) * LD + d0);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kb[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * LD + d0);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          s[i][j] = fmaf(qa[i].w, kb[j].w, a);
        }
    }

    // scale; mask where the tile crosses an edge of what the block's rows keep
    const bool edge = t0 + BKV > Skv || (causal && t0 + BKV - 1 > lo) || (window > 0 && t0 <= hi - window);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = row0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float val = s[i][j] * scale;
        if (edge) {
          const int col = t0 + tx + 16 * j;
          const bool keep = col < Skv && (!causal || col <= row) && (window <= 0 || col > row - window);
          val = keep ? val : -INFINITY;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      const float alpha = expf(m_run[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = expf(s[i][j] - m_use);
        sum += p;
        Ps[(ty * RI + i) * LP + tx + 16 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + sum;  // this thread's share; the row group is summed at the end
      m_run[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[i][jj][e] *= alpha;
    }
    __syncthreads();  // P complete

    // O += P V: rows ty * RI + i, head dims 4 (tx + 16 jj) .. + 3
#pragma unroll 2
    for (int c0 = 0; c0 < BKV; c0 += 4) {
      float4 pa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pa[i] = *reinterpret_cast<const float4*>(Ps + (ty * RI + i) * LP + c0);
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        if (tx + 16 * jj >= CH) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 vb = *reinterpret_cast<const float4*>(vt + (c0 + cc) * LD + 4 * (tx + 16 * jj));
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
            oacc[i][jj][0] = fmaf(p, vb.x, oacc[i][jj][0]);
            oacc[i][jj][1] = fmaf(p, vb.y, oacc[i][jj][1]);
            oacc[i][jj][2] = fmaf(p, vb.z, oacc[i][jj][2]);
            oacc[i][jj][3] = fmaf(p, vb.w, oacc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 8);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that kept no key returns 0
    const int qi = q0 + ty * RI + i;
    if (qi >= Sq) continue;
    T* op = o + b * os.b + h * os.h + (long long)qi * os.s;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = 4 * (tx + 16 * jj);
      if (d >= D) continue;
      const float4 r = make_float4(oacc[i][jj][0] * inv, oacc[i][jj][1] * inv, oacc[i][jj][2] * inv,
                                   oacc[i][jj][3] * inv);
      if constexpr (std::is_same<T, float>::value) {
        if (o_vec) {
          *reinterpret_cast<float4*>(op + d) = r;
          continue;
        }
      }
      op[d] = from_f<T>(r.x);
      op[d + 1] = from_f<T>(r.y);
      op[d + 2] = from_f<T>(r.z);
      op[d + 3] = from_f<T>(r.w);
    }
  }
}

template <typename T, int D, int BQ, int BKV>
int launch_tile(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
                int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
                int window, int q_offset, int vec, int o_vec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, BQ, BKV>();
  if constexpr (smem > SMEM_LIMIT) {  // not built: over the card's shared memory
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kern = flash_attention_kernel<T, D, BQ, BKV>;
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window, q_offset, vec, o_vec);
    return static_cast<int>(cudaGetLastError());
  }
}

// the (BQ, BKV) instances; bf16 (a timing variant) at (64, 64) alone
template <typename T, int D>
int launch(int bq, int bkv, const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
           int window, int q_offset, int vec, int o_vec, cudaStream_t st) {
#define V1_TILE(BQ_, BKV_)                                                                            \
  if (bq == BQ_ && bkv == BKV_)                                                                      \
    return launch_tile<T, D, BQ_, BKV_>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, \
                                        window, q_offset, vec, o_vec, st);
  V1_TILE(64, 64)
  if constexpr (std::is_same<T, float>::value) {
    V1_TILE(128, 64)
    V1_TILE(64, 32)
    V1_TILE(64, 128)
  }
#undef V1_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace v1

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A (D, S, H, B) map of a (B, H, S, D) view, element strides st (0 along a dim of size 1, which
// is never stepped: any legal stride will do there), in boxes of 64 columns x `rows` rows under the
// 128-byte swizzle wgmma reads; zero past D and past S. TMA cannot step a broadcast dim (a zero
// stride along a dim of more than one): refused.
int flash_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, Strides st, int rows) {
  const long long steps[3][2] = {{st.s, S}, {st.h, H}, {st.b, B}};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    if (steps[i][0] == 0 && steps[i][1] > 1) return static_cast<int>(cudaErrorInvalidValue);
    strides[i] = steps[i][0] != 0 ? 2ULL * steps[i][0] : 2ULL * D;
    if (!tma_stride(static_cast<long long>(strides[i]))) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(S > 0 ? S : 1), (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return cached_map(map, map_spec(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B));
}

template <int D, int BQ, int BKV>
int launch_mma_tile(const void* q, const void* k, const void* v, int B, Strides qs, Strides ks, Strides vs,
                    const FlashArgs& a, cudaStream_t stream) {
  using S = FlashShape<D, BQ, BKV>;
  static_assert(S::SMEM <= v1::SMEM_LIMIT, "every mma instance fits the card's shared memory");
  CUtensorMap qm, km, vm;
  if (int e = flash_map(&qm, q, D, a.Sq, a.Hq, B, qs, BQ)) return e;
  if (int e = flash_map(&km, k, D, a.Skv, a.Hkv, B, ks, BKV)) return e;
  if (int e = flash_map(&vm, v, D, a.Skv, a.Hkv, B, vs, BKV)) return e;
  auto kern = flash_mma_kernel<D, BQ, BKV>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.Hq);
  kern<<<grid, S::THREADS, S::SMEM, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

// the (BQ, BKV) instances
template <int D>
int launch_mma(int bq, int bkv, const void* q, const void* k, const void* v, int B, Strides qs, Strides ks,
               Strides vs, const FlashArgs& a, cudaStream_t st) {
#define MMA_TILE(BQ_, BKV_) \
  if (bq == BQ_ && bkv == BKV_) return launch_mma_tile<D, BQ_, BKV_>(q, k, v, B, qs, ks, vs, a, st);
  MMA_TILE(128, 128)
  MMA_TILE(128, 64)
  MMA_TILE(64, 128)
  MMA_TILE(64, 64)
#undef MMA_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_v1(int D, int bq, int bkv, const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
              int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
              int window, int q_offset, cudaStream_t st) {
  // cp.async and float4 stores where every row a tensor steps to is 16-byte aligned (fp32 only)
  auto rows16 = [](const void* p, Strides t) {
    return aligned16(p) && t.b % 4 == 0 && t.h % 4 == 0 && t.s % 4 == 0;
  };
  constexpr bool f32 = std::is_same<T, float>::value;
  const int vec = f32 && rows16(q, qs) && rows16(k, ks) && rows16(v, vs);
  const int o_vec = f32 && rows16(o, os);
  switch (D) {
    case 64: return v1::launch<T, 64>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window, q_offset, vec, o_vec, st);
    case 80: return v1::launch<T, 80>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window, q_offset, vec, o_vec, st);
    case 96: return v1::launch<T, 96>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window, q_offset, vec, o_vec, st);
    case 128: return v1::launch<T, 128>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window, q_offset, vec, o_vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// variant: 1 = v1 (float32 or bfloat16), 2 = mma (bfloat16 only, q, k and v 16-byte aligned with
// strides that are multiples of 8 elements). dtype: 0 = float32, 1 = bfloat16 for q, k, v and o
// alike. Layouts (B, H, S, D) addressed by (batch, head, sequence) strides with a unit head-dim
// stride; D is 64, 80, 96 or 128 (the head dims built); (bq, bkv) is one of the tiles built for the
// variant, dtype and D. window <= 0 means no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(int variant, int dtype, const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq, int Skv, int D, int bq, int bkv,
                               long long qsb, long long qsh, long long qss,
                               long long ksb, long long ksh, long long kss,
                               long long vsb, long long vsh, long long vss,
                               long long osb, long long osh, long long oss,
                               float scale, int causal, int window, int q_offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  if (variant == 1) {
    if (dtype == 0)
      return launch_v1<float>(D, bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal,
                              window, q_offset, st);
    if (dtype == 1)
      return launch_v1<__nv_bfloat16>(D, bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale,
                                      causal, window, q_offset, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 2 || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  for (long long s : strides)
    if (s % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const FlashArgs a{static_cast<__nv_bfloat16*>(o), os, Hq, Hkv, Sq, Skv, causal, window, q_offset,
                    scale * 1.4426950408889634f};
  switch (D) {
    case 64: return launch_mma<64>(bq, bkv, q, k, v, B, qs, ks, vs, a, st);
    case 80: return launch_mma<80>(bq, bkv, q, k, v, B, qs, ks, vs, a, st);
    case 96: return launch_mma<96>(bq, bkv, q, k, v, B, qs, ks, vs, a, st);
    case 128: return launch_mma<128>(bq, bkv, q, k, v, B, qs, ks, vs, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
