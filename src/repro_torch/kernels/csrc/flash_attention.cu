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
// - mma (bf16), FlashAttention-2's shape within what mma.sync offers: one block of 4 warps per
//   (b * Hq + h, 64-row q tile), heaviest causal tiles first; each warp owns 16 query rows and
//   keeps their q fragments in registers for the whole walk. S = QK^T and O += PV run on the
//   tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators), K fragments by ldmatrix and V
//   fragments by ldmatrix.trans. The online softmax stays in fp32 registers: row max and row sum
//   over each quad by shuffles, exp2f with scale * log2(e) folded into the scores. P is rounded
//   to bf16 in registers and fed straight back as the A operand of PV (the one rounding step the
//   fp32 reference does not take, as in FlashAttention-2). K and V tiles of 64 keys go through a
//   two-stage shared-memory ring by cp.async (16-byte chunks, zero-filled past Skv), so the next
//   tile loads while this one is multiplied; rows are padded to D + 8 bf16 (an odd number of
//   16-byte units), so ldmatrix is free of bank conflicts. q, k, v and their strides must be
//   16-byte aligned (the wrapper checks).
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
// 80, phi3-mini 96, qwen3, llama3, mixtral, llama4 and internvl2 128); the fragments, chunk loops
// and padded rows follow D, and the tiles live in dynamic shared memory (mma 45 KiB at D = 64 and
// 85 KiB at 128, v1 102 and 182 KiB), its limit raised at each launch that needs more than 48 KiB
// (per launch, not once per instance: the attribute belongs to the current device). Left for
// later work: wgmma and TMA, with a producer warp keeping the ring full.
//
// Tiles. Both kernels take the q tile BQ and the kv tile BKV as template parameters, and each is
// built at four (BQ, BKV) instances, chosen from the kernel's structure; the autotuner
// (repro_torch.tune, space "flash_attention") picks among them per shape, and (64, 64), the
// heuristic, keeps the code the kernels had with fixed tiles:
// - mma: a warp owns 16 query rows, so BQ = 16 x warps: 64 is 4 warps (128 threads), 128 is 8
//   warps (256 threads), which reuses each K/V tile for twice the rows (half the K/V traffic
//   through shared memory a row) at twice the causal tiles' diagonal waste. BKV sets the n
//   fragments of S a warp holds, BKV / 8: 32 keys are 4 fragments (fewer registers, more
//   barriers a row), 64 are 8, 128 are 16 (half the barriers and ring refills, 32 more registers
//   a thread). Instances (64, 64), (128, 64), (64, 32), (64, 128): at most 153 KiB, (64, 128) at
//   D = 128.
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

namespace {

struct Strides {
  long long b, h, s;  // the last (head-dim) stride is 1
};

// ---------------------------------------------------------------------------
// mma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

// BQ query rows per block, 16 per warp; BKV keys per kv tile
template <int BQ> __host__ __device__ constexpr int f_threads() { return 2 * BQ; }
// A padded shared-memory row of head dim D: D + 8 bf16, an odd number of 16-byte units (144 bytes at
// D = 64, 272 at 128), so the eight rows an ldmatrix reads fall in eight different bank groups.
template <int D> __host__ __device__ constexpr int f_ld() { return D + 8; }
// Q, then the two-stage K and V rings: 46,080 bytes at D = 64, 87,040 at D = 128 for (64, 64)
template <int D, int BQ, int BKV> __host__ __device__ constexpr int f_smem() {
  return (BQ + 4 * BKV) * f_ld<D>() * 2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D, int F_BQ, int F_BKV>
__global__ void __launch_bounds__(f_threads<F_BQ>())
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                 int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
                 int causal, int window, int q_offset) {
  constexpr int F_LD = f_ld<D>();
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int F_THREADS = f_threads<F_BQ>();
  constexpr int KV_CHUNKS = F_BKV * CH;  // of a K (or V) tile
  constexpr int NB = F_BKV / 8;           // n fragments of S: blocks of 8 keys
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto Ks = [&](int stage) { return Qs + (F_BQ + stage * F_BKV) * F_LD; };
  auto Vs = [&](int stage) { return Qs + (F_BQ + (2 + stage) * F_BKV) * F_LD; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_BQ;  // the longest causal rows start first

  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;

  // kv range any row of this block keeps, in whole tiles
  const int lo = q_offset + q0;
  const int hi = q_offset + min(q0 + F_BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, lo - window + 1) : 0;
  const int t_first = kv_begin / F_BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - 1) / F_BKV - t_first + 1 : 0;

  // this warp's rows (absolute positions) and the range of keys any of them keeps
  const int w_lo = lo + warp * 16, w_hi = w_lo + 15;
  const int r0 = w_lo + g, r1 = r0 + 8;

  // F_BKV rows x D / 8 chunks of 16 bytes per tile: D / 16 chunks per thread at (64, 64)
  auto load_kv = [&](int tile, int stage) {
    const int t0 = tile * F_BKV;
#pragma unroll
    for (int i = 0; i < (KV_CHUNKS + F_THREADS - 1) / F_THREADS; ++i) {
      const int c = tid + i * F_THREADS;
      if constexpr (KV_CHUNKS % F_THREADS != 0) {
        if (c >= KV_CHUNKS) break;
      }
      const int r = c / CH, ch = (c % CH) * 8;
      const bool in = t0 + r < Skv;
      cp_async16(Ks(stage) + r * F_LD + ch, in ? kp + (long long)(t0 + r) * ks.s + ch : kp, in ? 16 : 0);
      cp_async16(Vs(stage) + r * F_LD + ch, in ? vp + (long long)(t0 + r) * vs.s + ch : vp, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const int c = tid + i * F_THREADS;
    const int r = c / CH, ch = (c % CH) * 8;
    const bool in = q0 + r < Sq;
    cp_async16(&Qs[r * F_LD + ch], in ? qp + (long long)(q0 + r) * qs.s + ch : qp, in ? 16 : 0);
  }
  if (n_tiles > 0) load_kv(t_first, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];  // this warp's 16 x D q tile as D / 16 A fragments
  float oacc[D / 8][4];    // 16 x D output: D / 8 blocks of 8 head dims
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows r0 and r1

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    cp_async_wait0();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ldsm_x4(qf[kc], &Qs[(warp * 16 + (lane & 15)) * F_LD + kc * 16 + (lane >> 4) * 8]);
    }
    if (it + 1 < n_tiles) {
      load_kv(t_first + it + 1, st ^ 1);
      cp_async_commit();
    }
    const int t0 = (t_first + it) * F_BKV;
    // a tile that keeps no key of this warp's rows adds nothing
    if ((causal && t0 > w_hi) || (window > 0 && t0 + F_BKV - 1 <= w_lo - window)) continue;

    // S = Q K^T for 16 rows x F_BKV keys: NB blocks of 8 keys
    float s[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    const __nv_bfloat16* kt = Ks(st);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * F_LD + kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kc], r[0], r[1]);
        mma16816(s[2 * np + 1], qf[kc], r[2], r[3]);
      }

    // scale into log2 units; mask where the tile crosses an edge of what these rows keep
    const bool edge = t0 + F_BKV > Skv || (causal && t0 + F_BKV - 1 > w_lo) ||
                      (window > 0 && t0 <= w_hi - window);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nb][e] * scale_log2;
        if (edge) {
          const int col = t0 + nb * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool keep = col < Skv && (!causal || col <= row) && (window <= 0 || col > row - window);
          val = keep ? val : -INFINITY;
        }
        s[nb][e] = val;
      }

    // online softmax, one row per half of the accumulator (e 0-1: row r0, e 2-3: row r1)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * hf], s[nb][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hf], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      const float alpha = exp2f(m_run[hf] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s[nb][2 * hf] = exp2f(s[nb][2 * hf] - m_use);
        s[nb][2 * hf + 1] = exp2f(s[nb][2 * hf + 1] - m_use);
        sum += s[nb][2 * hf] + s[nb][2 * hf + 1];
      }
      l_run[hf] = l_run[hf] * alpha + sum;  // this thread's share; the quad is summed at the end
      m_run[hf] = m_new;
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        oacc[db][2 * hf] *= alpha;
        oacc[db][2 * hf + 1] *= alpha;
      }
    }

    // O += P V: P (16 x F_BKV, bf16) as F_BKV / 16 A fragments straight from the S accumulators
    const __nv_bfloat16* vt = Vs(st);
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * F_LD + dp * 16 + (lane >> 4) * 8);
        mma16816(oacc[2 * dp], pa, r[0], r[1]);
        mma16816(oacc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that kept no key returns 0
    const int qi = q0 + warp * 16 + g + 8 * hf;
    if (qi >= Sq) continue;
    __nv_bfloat16* op = o + b * os.b + h * os.h + (long long)qi * os.s + 2 * t4;
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      *reinterpret_cast<__nv_bfloat162*>(op + db * 8) =
          __floats2bfloat162_rn(oacc[db][2 * hf] * inv, oacc[db][2 * hf + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// v1: FP32 SIMT
// ---------------------------------------------------------------------------
namespace v1 {

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

template <int D, int BQ, int BKV>
int launch_mma_tile(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
                    int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2, int causal,
                    int window, int q_offset, cudaStream_t stream) {
  constexpr int smem = f_smem<D, BQ, BKV>();
  static_assert(smem <= v1::SMEM_LIMIT, "every mma instance fits the card's shared memory");
  auto kern = flash_mma_kernel<D, BQ, BKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, f_threads<BQ>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, qs,
      ks, vs, os, scale_log2, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// the (BQ, BKV) instances
template <int D>
int launch_mma(int bq, int bkv, const void* q, const void* k, const void* v, void* o, int B, int Hq,
               int Hkv, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
               int causal, int window, int q_offset, cudaStream_t st) {
#define MMA_TILE(BQ_, BKV_)                                                                        \
  if (bq == BQ_ && bkv == BKV_)                                                                   \
    return launch_mma_tile<D, BQ_, BKV_>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale_log2, \
                                         causal, window, q_offset, st);
  MMA_TILE(64, 64)
  MMA_TILE(128, 64)
  MMA_TILE(64, 32)
  MMA_TILE(64, 128)
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
  const float sl = scale * 1.4426950408889634f;
  switch (D) {
    case 64: return launch_mma<64>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, sl, causal, window, q_offset, st);
    case 80: return launch_mma<80>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, sl, causal, window, q_offset, st);
    case 96: return launch_mma<96>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, sl, causal, window, q_offset, st);
    case 128: return launch_mma<128>(bq, bkv, q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, sl, causal, window, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
