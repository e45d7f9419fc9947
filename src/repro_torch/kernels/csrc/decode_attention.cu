// Decode attention over an int8 KV cache for Hopper (sm_90a): one query token per head, dense
// (a valid prefix shared by the batch) and paged (each sequence's page chain at its own length).
//
// Replaces the TPU kernels
//   src/repro/kernels/decode_attention/decode_attention.py::decode_attention_pallas (dense) and
//   src/repro/kernels/decode_attention/decode_attention.py::paged_decode_attention_pallas (paged).
//
// What they compute, for query head hq = h * G + g of sequence b (G query heads per KV head h):
//   s_j = (q . (k_i8[j] * k_scale[j])) * scale over the valid keys j < len,
//   o = sum_j softmax(s)_j * v_i8[j] * v_scale[j], with an online softmax in fp32 (running max,
//   running sum, accumulator), and o cast to q's dtype. A sequence of length 0 returns 0, as the
//   TPU kernels do.
//
// Bound on the card: bytes (the int8 cache and its scales, read once). At the serving shapes a
// call reads a few MB, so the time is the latency of getting every SM to read its share at once.
//
// Design: split-KV (flash-decoding). The grid is one block per (sequence, KV head, chunk of at most
// GMAX query heads) times `splits`, a launch parameter that the wrapper picks from host-known
// shapes alone (kernels/decode_attention/ops.py::split_plan) so that a small batch still puts
// blocks on every SM. A split covers whole tiles of bkv keys; a block whose range starts at or past
// the valid length does no reading and leaves an empty partial. Inside a block each of the NW
// warps owns its own KC-key chunks of the range (chunk c goes to warp c % NW) and streams them
// through its own ring of shared-memory slots by cp.async: 16-byte copies, D / 16 lanes per int8
// row, a 4-byte copy per scale. The ring holds `slots` chunks a warp (bkv / (NW * KC), at least
// 2), and a chunk's slot is refilled with the chunk `slots` ahead as soon as it is consumed, so the
// next chunks' loads are in flight during this chunk's arithmetic and nothing in the loop waits
// on another warp. Per chunk, lane j converts key j's int8 row once (a byte permute and one add,
// exact, not I2F, which Hopper runs at a quarter of the FMA rate) and computes its score for every
// query head of the chunk against q in shared memory (pre-scaled by scale * log2 e, read as a
// broadcast); the online softmax runs per warp in registers (a warp max by shuffles, exp2); then
// each key's V row is taken by the largest power-of-two number of lanes that divides its D / 4
// 32-bit words, so a warp takes whole keys, and each lane accumulates p * v_scale * v in registers
// for four head dims a word (D = 32, 64, 128: one word a lane, 4, 2, 1 keys a step; D = 96: 8
// lanes of three words each, 4 keys a step). The warps of a block combine once, at the end of
// their range, through shared memory. The group size (1-8) is a template parameter, so every head
// loop is straight-line code; one kernel per (D in {32, 64, 96, 128}, group size) serves the dense
// and the paged layout and both q dtypes (32 kernels). Nothing is dequantized to device memory,
// and the tensor cores are not used: with G <= 8 query rows per KV head a 16-row mma tile would be
// mostly padding.
//
// The merge. With one split a block writes the output itself. Otherwise each block writes its
// partial (running max m, running sum l, unnormalized accumulator, fp32) to a workspace of
// B * Hq * splits * (D + 2) floats, and the last block of its (sequence, KV head, head chunk) to
// arrive (an atomic counter per group, which that block resets to 0, so the caller zeroes the
// counters once and not per launch) stages every split's partial into shared memory in one wave
// and merges them in split order: each partial is rescaled by exp(m_i - M), an empty split
// (m_i = -inf, l_i = 0) is skipped without forming exp(-inf - (-inf)), and where every split is
// empty the output is 0. The result does not depend on which block finished last, so two
// launches give the same bits, and since the plan reads no device value, an int length and a
// device-resident one give the same bits too.
//
// Only the valid keys are read: the dense kernel stops at len, and the paged kernel dereferences
// only the table entries before ceil(len / page) (it asks L2 for its range's entries before the
// length arrives), so stale entries past a sequence's length are never followed into the pool.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads per block
constexpr int NW = NT / 32;
constexpr int KC = 32;    // keys per warp chunk: one key per lane in the score phase
constexpr int GMAX = 8;   // query heads per block; a larger group takes several head chunks
constexpr float LOG2E = 1.4426950408889634f;
constexpr long long SMEM_LIMIT = 232448;  // 227 KiB of dynamic shared memory per block

__host__ __device__ inline long long a16(long long n) { return (n + 15) / 16 * 16; }

// Four int8 (one little-endian 32-bit word) to fp32, exactly: each byte, made unsigned by
// flipping its top bit, becomes the low mantissa byte of 2^23, and one add takes 2^23 + 128 off.
__device__ __forceinline__ float4 i8x4_to_f32(int w) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  constexpr float off = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - off,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - off,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - off,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - off);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// At most n groups of this thread still pending. wait_group takes an immediate, so a deeper ring
// waits for all but 7 (it waits for more than it must, never for less).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Byte offsets of the shared-memory regions. The Python wrappers compute the same total
// (kernels/decode_attention/ops.py::smem_bytes) and pass it; a launch whose total disagrees is
// refused, so the lint that checks it against the 227 KiB limit and the launch cannot drift.
// One ring slot holds a chunk: KC int8 K rows padded to D + 16 bytes (lane j reads row j: the
// padding puts eight neighbouring rows on eight different 16-byte bank groups), KC int8 V rows of
// D bytes, and the chunk's KC K scales and KC V scales. After its last chunk a warp's ring holds
// its partial: GMAX running maxima, GMAX running sums, then the (heads, D) accumulator.
struct Layout {
  long long q, p, stats, ring, slot, total;
  int slots;
};

__host__ __device__ inline Layout layout(long long bkv, int d, int group) {
  Layout L;
  const int gc = group < GMAX ? group : GMAX;
  const long long per_warp = (bkv + NW * KC - 1) / (NW * KC);
  L.slots = per_warp < 2 ? 2 : static_cast<int>(per_warp > 1 << 20 ? 1 << 20 : per_warp);
  L.slot = (long long)KC * (2 * d + 24);
  long long o = 0;
  L.q = o;     o += a16(4LL * gc * d);            // q * scale * log2 e, fp32 (heads, D)
  L.p = o;     o += a16(4LL * NW * KC * GMAX);    // each warp's p * v_scale, fp32 (KC, GMAX)
  L.stats = o; o += a16(4);                         // the last-block flag
  L.ring = o;  o += (long long)NW * L.slots * L.slot;
  L.total = o;
  return L;
}

// Where the keys live. Dense: K/V (B, Hkv, S, D), scales (B, Hkv, S), one valid length for the
// batch (len_ptr[0] on the device, or len_value). Paged: pools (Hkv, P, page, D), scales
// (Hkv, P, page), block tables (B, maxp), lengths (B,). One kernel serves both (the choice is a
// uniform branch per key row), so the build compiles each (D, G) once.
struct Src {
  const int* len_ptr;  // dense
  int len_value, S;
  const int* tables;   // paged
  const int* lens;
  int maxp, page, P, paged;
  __device__ int length(int b) const {
    return paged ? min(max(lens[b], 0), maxp * page)
                 : min(max(len_ptr ? len_ptr[0] : len_value, 0), S);
  }
  // Ask L2 for the block's table entries (before the length is known; an entry is read, never
  // dereferenced, past the length) while lane 0 reads the length, so the table reads that follow
  // do not wait a second trip to memory.
  __device__ void prefetch(int b, int k0, int n, int lane) const {
    if (!paged) return;
    const int* first = tables + (long long)b * maxp + k0 / page;
    const int entries = min(maxp - k0 / page, (n + page - 1) / page);
    for (int e = 32 * lane; e < entries; e += 32 * 32) prefetch_l2(first + e);  // 128-byte lines
  }
  // row of token t of (b, h) in units of D-byte rows (and of scale entries)
  __device__ long long row(int b, int h, int Hkv, int t) const {
    if (!paged) return ((long long)b * Hkv + h) * S + t;
    const int pid = __ldg(tables + (long long)b * maxp + t / page);
    return ((long long)h * P + pid) * page + t % page;
  }
};

struct Args {
  const void* q;  // (B, Hq, D), float32 or bfloat16
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  void* o;        // like q
  float* ws_acc;  // (B * Hq, splits, D)
  float* ws_ml;   // (B * Hq, splits, 2): running max, running sum
  int* counters;  // one per (sequence, KV head, head chunk), left at 0
  int Hkv, G, HC, per_split, splits, bkv, bf16;
  float scale;  // softmax scale * log2 e
  Src src;
};

__device__ __forceinline__ void store_o(const Args& a, long long i, float x) {
  if (a.bf16)
    static_cast<__nv_bfloat16*>(a.o)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(a.o)[i] = x;
}

// The merge, run by the last block of a group. The partials of a batch of splits (all of them
// unless they outgrow the free rings) are staged into shared memory in one wave: the accumulators
// by 16-byte cp.async through L2 (.cg), the maxima and sums by loads through L2 (other blocks
// wrote them in this launch, and L1 is not coherent). A thread per (head, split) then forms the
// head's max M and the split's weight exp(m_i - M), 0 for an empty split (never
// exp(-inf - -inf)), and every output sums its weighted accumulators and the weighted running
// sums in split order. A later batch rescales the running sums to its larger max; where every
// split is empty the output is 0.
template <int D>
__device__ __forceinline__ void merge_splits(const Args& a, unsigned char* buf, long long buf_bytes,
                                             long long head0, int gc) {
  const int tid = threadIdx.x;
  const int sb = static_cast<int>(
      min((long long)a.splits, (buf_bytes / 4 - 3 * gc) / ((long long)gc * (D + 3))));
  float* xs_s = reinterpret_cast<float*>(buf);  // (heads, sb, D) accumulators
  float* ml_s = xs_s + (long long)gc * sb * D;   // (heads, sb, 2) maxima and sums
  float* w_s = ml_s + gc * sb * 2;               // (heads, sb) weights
  float* mr_s = w_s + gc * sb;                   // (heads) the max over the batches so far
  float* mb_s = mr_s + gc;                       // (heads) this batch's max
  float* mc_s = mb_s + gc;                       // (heads) the earlier batches' rescale
  for (int g = tid; g < gc; g += NT) mr_s[g] = -INFINITY;
  constexpr int RMAX = GMAX * D / NT;  // outputs per thread
  float x_run[RMAX], l_run[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) x_run[r] = l_run[r] = 0.f;
  for (int s0 = 0; s0 < a.splits; s0 += sb) {
    const int nb = min(sb, a.splits - s0);
    for (int g = 0; g < gc; ++g) {
      const float* src = a.ws_acc + ((head0 + g) * a.splits + s0) * D;
      for (int r = tid; r < nb * (D / 4); r += NT)
        cp_async16(xs_s + (long long)g * sb * D + 4 * r, src + 4 * r);
    }
    cp_async_commit();
    for (int e = tid; e < gc * 2 * nb; e += NT) {
      const int g = e / (2 * nb), r = e % (2 * nb);
      ml_s[g * sb * 2 + r] = __ldcg(a.ws_ml + ((head0 + g) * a.splits + s0) * 2 + r);
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < gc * nb; e += NT) {
      const int g = e / nb, j = e % nb;
      float mx = mr_s[g];
      for (int i = 0; i < nb; ++i) mx = fmaxf(mx, ml_s[(g * sb + i) * 2]);
      const float mj = ml_s[(g * sb + j) * 2];
      w_s[g * sb + j] = mj == -INFINITY ? 0.f : exp2f(mj - mx);
      if (j == 0) {
        mb_s[g] = mx;
        mc_s[g] = mr_s[g] == -INFINITY ? 0.f : exp2f(mr_s[g] - mx);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int i = tid + r * NT;
      if (i < gc * D) {
        const int g = i / D;
        const float* w = w_s + g * sb;
        const float* ml = ml_s + g * sb * 2;
        const float* xs = xs_s + (long long)g * sb * D + i % D;
        float x = x_run[r] * mc_s[g], sum = l_run[r] * mc_s[g];
#pragma unroll 4
        for (int j = 0; j < nb; ++j) {
          sum = fmaf(w[j], ml[2 * j + 1], sum);
          x = fmaf(w[j], xs[(long long)j * D], x);
        }
        x_run[r] = x;
        l_run[r] = sum;
      }
    }
    __syncthreads();  // the batch is read
    for (int g = tid; g < gc; g += NT) mr_s[g] = mb_s[g];
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int i = tid + r * NT;
    // every split empty: the sum is 0 and so is the output (the length-0 rule)
    if (i < gc * D) store_o(a, head0 * D + i, l_run[r] == 0.f ? 0.f : x_run[r] / l_run[r]);
  }
}

// GP: the query heads a block computes, a compile-time count so that every head loop unrolls into
// straight-line code (independent FMA chains, no branches). A head chunk with fewer heads than GP
// (the tail of a group larger than GMAX) computes zero queries for the rest and stores nothing
// for them.
template <int D, int GP>
__global__ void __launch_bounds__(NT, 3) decode_kernel(const Args a) {
  constexpr int LK = D / 16;    // 16-byte pieces per int8 row
  constexpr int KR = D + 16;    // K row stride in a slot
  constexpr int W4 = D / 4;     // 32-bit words (four head dims each) per V row
  // lanes of one key in the PV phase: the largest power of two dividing W4, at most a warp, so
  // that a warp takes whole keys (D = 96: 8 lanes of 3 words each, 4 keys a step)
  constexpr int LPK = (W4 & -W4) < 32 ? (W4 & -W4) : 32;
  constexpr int VW = W4 / LPK;   // words a lane takes per key: lane w4 takes w4, w4 + LPK, ...
  constexpr int KPS = 32 / LPK;  // keys per PV step
  constexpr int PS = GP <= 4 ? 4 : 8;  // floats of p per key
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.bkv, D, a.G);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = blockIdx.x, split = blockIdx.y;
  const int bh = grp / a.HC, g0 = grp % a.HC * GMAX;
  const int b = bh / a.Hkv, h = bh % a.Hkv;
  const int gc = min(GP, a.G - g0);  // heads stored: GP but for a tail chunk
  const long long head0 = (long long)b * a.Hkv * a.G + (long long)h * a.G + g0;  // row of (B * Hq)
  const int k0 = split * a.per_split;
  if (tid < 32) a.src.prefetch(b, k0, a.per_split, tid);  // the table rows, with the length
  const int len = a.src.length(b);
  const int k1 = min(k0 + a.per_split, len);
  const int nch = k1 > k0 ? (k1 - k0 + KC - 1) / KC : 0;
  const int mine = nch > warp ? (nch - warp + NW - 1) / NW : 0;  // this warp's chunks
  const int slots = L.slots;

  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_w = reinterpret_cast<float*>(smem + L.p) + warp * KC * PS;
  unsigned char* ring = smem + L.ring + (long long)warp * slots * L.slot;

  // this warp's i-th chunk into slot i % slots; one commit group per call, empty past the range
  auto load_chunk = [&](int i) {
    if (i < mine) {
      const int t0 = k0 + (warp + NW * i) * KC, nv = min(KC, k1 - t0);
      unsigned char* sl = ring + (long long)(i % slots) * L.slot;
      long long row = 0;
      if (lane < nv) {
        row = a.src.row(b, h, a.Hkv, t0 + lane);
        cp_async4(sl + KC * (KR + D) + 4 * lane, a.ks + row);
        cp_async4(sl + KC * (KR + D + 4) + 4 * lane, a.vs + row);
      }
#pragma unroll
      for (int e = 0; e < LK; ++e) {
        const int piece = lane + 32 * e, r = piece / LK, c = piece % LK;
        const long long rr = __shfl_sync(0xffffffffu, row, r);
        if (r < nv) {
          cp_async16(sl + r * KR + 16 * c, a.k + rr * D + 16 * c);
          cp_async16(sl + KC * KR + r * D + 16 * c, a.v + rr * D + 16 * c);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < slots; ++i) load_chunk(i);

  for (int i = tid; i < GP * D; i += NT) {
    const long long qi = head0 * D + i;
    float x = 0.f;
    if (i < gc * D)
      x = a.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qi])
                 : static_cast<const float*>(a.q)[qi];
    q_s[i] = x * a.scale;
  }
  __syncthreads();

  float m[GP], l[GP];
  float4 acc[GP][VW];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[g][v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int w4 = lane % LPK, kslot = lane / LPK;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait_upto(slots - 1);  // this lane's copies of chunk i have landed
    __syncwarp();                   // and so have the other lanes'
    const unsigned char* sl = ring + (long long)(i % slots) * L.slot;
    const int t0 = k0 + (warp + NW * i) * KC, nv = min(KC, k1 - t0);
    const bool valid = lane < nv;

    // scores: lane j converts key j once, for every query head of the chunk
    float s[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
    const int4* kr = reinterpret_cast<const int4*>(sl + lane * KR);
#pragma unroll
    for (int c = 0; c < LK; ++c) {
      const int4 t = kr[c];
      const float4 f0 = i8x4_to_f32(t.x), f1 = i8x4_to_f32(t.y), f2 = i8x4_to_f32(t.z),
                   f3 = i8x4_to_f32(t.w);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float4* qg = reinterpret_cast<const float4*>(q_s + g * D + 16 * c);
        s[g] = dot4(qg[3], f3, dot4(qg[2], f2, dot4(qg[1], f1, dot4(qg[0], f0, s[g]))));
      }
    }
    const float* sc = reinterpret_cast<const float*>(sl + KC * (KR + D));
    const float sk = valid ? sc[lane] : 0.f, sv = valid ? sc[KC + lane] : 0.f;

    // online softmax per query head, in registers; the chunk has at least one valid key
    float x[GP], mx[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) mx[g] = x[g] = valid ? s[g] * sk : -INFINITY;
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int g = 0; g < GP; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
    float p[PS];
#pragma unroll
    for (int g = 0; g < PS; ++g) p[g] = 0.f;
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float mn = fmaxf(m[g], mx[g]);
      const float alpha = exp2f(m[g] - mn);  // 0 on the warp's first chunk
      const float pg = valid ? exp2f(x[g] - mn) : 0.f;
      l[g] = fmaf(l[g], alpha, pg);  // this lane's share; summed over the warp at the end
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        acc[g][v].x *= alpha;
        acc[g][v].y *= alpha;
        acc[g][v].z *= alpha;
        acc[g][v].w *= alpha;
      }
      m[g] = mn;
      p[g] = pg * sv;  // v's scale folded into the weight
    }
#pragma unroll
    for (int g = 0; g < PS; g += 4)
      reinterpret_cast<float4*>(p_w + lane * PS + g)[0] = make_float4(p[g], p[g + 1], p[g + 2], p[g + 3]);
    __syncwarp();

    // accumulator: lane (kslot, w4) sums p * v over keys kslot, kslot + KPS, ... for the four dims
    // of each of its VW words; a key past the range has p = 0 (and its stale int8 row is finite),
    // so the loop runs whole
    const int* vw = reinterpret_cast<const int*>(sl + KC * KR) + w4;
#pragma unroll
    for (int jj = 0; jj < KC / KPS; ++jj) {
      const int j = kslot + jj * KPS;
      float4 vv[VW];
#pragma unroll
      for (int v = 0; v < VW; ++v) vv[v] = i8x4_to_f32(vw[j * W4 + v * LPK]);
      float pj[PS];
#pragma unroll
      for (int g = 0; g < PS; g += 4) {
        const float4 t = reinterpret_cast<const float4*>(p_w + j * PS + g)[0];
        pj[g] = t.x;
        pj[g + 1] = t.y;
        pj[g + 2] = t.z;
        pj[g + 3] = t.w;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          acc[g][v].x = fmaf(pj[g], vv[v].x, acc[g][v].x);
          acc[g][v].y = fmaf(pj[g], vv[v].y, acc[g][v].y);
          acc[g][v].z = fmaf(pj[g], vv[v].z, acc[g][v].z);
          acc[g][v].w = fmaf(pj[g], vv[v].w, acc[g][v].w);
        }
    }
    __syncwarp();  // the slot and p_w are read; refill the slot
    load_chunk(i + slots);
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's partial, into its own ring
#pragma unroll
  for (int off = 16; off; off >>= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g) l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        acc[g][v].x += __shfl_xor_sync(0xffffffffu, acc[g][v].x, off);
        acc[g][v].y += __shfl_xor_sync(0xffffffffu, acc[g][v].y, off);
        acc[g][v].z += __shfl_xor_sync(0xffffffffu, acc[g][v].z, off);
        acc[g][v].w += __shfl_xor_sync(0xffffffffu, acc[g][v].w, off);
      }
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (lane < LPK)
#pragma unroll
      for (int v = 0; v < VW; ++v) reinterpret_cast<float4*>(part + 2 * GMAX + g * D)[lane + v * LPK] = acc[g][v];
    if (lane == 0) {
      part[g] = m[g];
      part[GMAX + g] = l[g];
    }
  }
  __syncthreads();

  // the block's partial: the warps combined in order, each thread weighing them for its outputs
  auto warp_part = [&](int w) {
    return reinterpret_cast<const float*>(smem + L.ring + (long long)w * slots * L.slot);
  };
  for (int i = tid; i < gc * D; i += NT) {
    const int g = i / D;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, warp_part(w)[g]);
    float sum = 0.f, xb = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = warp_part(w)[g];
      const float e = mw == -INFINITY ? 0.f : exp2f(mw - mb);  // an empty warp weighs nothing
      sum = fmaf(e, warp_part(w)[GMAX + g], sum);
      xb = fmaf(e, warp_part(w)[2 * GMAX + i], xb);
    }
    if (a.splits == 1) {
      store_o(a, head0 * D + i, mb == -INFINITY ? 0.f : xb / sum);
    } else {
      a.ws_acc[((head0 + g) * a.splits + split) * D + i % D] = xb;
      if (i % D == 0) {
        a.ws_ml[((head0 + g) * a.splits + split) * 2] = mb;
        a.ws_ml[((head0 + g) * a.splits + split) * 2 + 1] = sum;
      }
    }
  }
  if (a.splits == 1) return;

  // the last block of the group to arrive merges every split's partial, in split order: every
  // thread's partial is visible device-wide before the block counts its arrival, and the last
  // block reads the partials through L2 (the CUDA programming guide's last-block pattern)
  int& is_last = *reinterpret_cast<int*>(smem + L.stats);
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&a.counters[grp], 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  merge_splits<D>(a, smem + L.ring, (long long)NW * slots * L.slot, head0, gc);
  if (tid == 0) a.counters[grp] = 0;
}

template <int D, int GP>
int launch_g(const Args& a, int groups, long long smem, cudaStream_t stream) {
  auto kern = decode_kernel<D, GP>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(groups, a.splits), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Args& a, int groups, long long smem, cudaStream_t st) {
  switch (a.G < GMAX ? a.G : GMAX) {
    case 1: return launch_g<D, 1>(a, groups, smem, st);
    case 2: return launch_g<D, 2>(a, groups, smem, st);
    case 3: return launch_g<D, 3>(a, groups, smem, st);
    case 4: return launch_g<D, 4>(a, groups, smem, st);
    case 5: return launch_g<D, 5>(a, groups, smem, st);
    case 6: return launch_g<D, 6>(a, groups, smem, st);
    case 7: return launch_g<D, 7>(a, groups, smem, st);
    default: return launch_g<D, 8>(a, groups, smem, st);
  }
}

// keys: the length the split plan covers (S, or maxp * page). The launch is refused unless the
// shared memory is the layout's, 1 <= splits <= the tiles, and the workspace is exactly
// B * Hq * splits * (D + 2) floats with a counter per (sequence, KV head, head chunk) when
// splits > 1 (no workspace and no counters with one split).
int launch(int dtype, int d, const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* o, int B, int Hkv, int G, int keys, int bkv, float scale,
           long long smem, int splits, void* ws, long long ws_bytes, void* counters,
           long long n_counters, const Src& src, cudaStream_t st) {
  if (Hkv <= 0 || G <= 0 || bkv <= 0 || B <= 0 || keys <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((long long)keys + bkv - 1) / bkv;
  const int HC = (G + GMAX - 1) / GMAX;
  const long long groups = (long long)B * Hkv * HC;
  const long long want_ws = splits > 1 ? 4LL * B * Hkv * G * splits * (d + 2) : 0;
  if (splits < 1 || splits > tiles || splits > 65535 || groups > 0x7fffffffLL ||
      smem != layout(bkv, d, G).total || smem > SMEM_LIMIT || ws_bytes != want_ws ||
      (splits > 1 && (!ws || !counters || n_counters < groups)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_split = (tiles + splits - 1) / splits * bkv;
  Args a;
  a.q = q;
  a.k = static_cast<const int8_t*>(k);
  a.ks = static_cast<const float*>(ks);
  a.v = static_cast<const int8_t*>(v);
  a.vs = static_cast<const float*>(vs);
  a.o = o;
  a.ws_acc = static_cast<float*>(ws);
  a.ws_ml = splits > 1 ? a.ws_acc + (long long)B * Hkv * G * splits * d : nullptr;
  a.counters = static_cast<int*>(counters);
  a.Hkv = Hkv;
  a.G = G;
  a.HC = HC;
  a.per_split = static_cast<int>(per_split < keys ? per_split : keys);
  a.splits = splits;
  a.bkv = bkv;
  a.bf16 = dtype;
  a.scale = scale * LOG2E;
  a.src = src;
  if (d == 32) return launch_d<32>(a, (int)groups, smem, st);
  if (d == 64) return launch_d<64>(a, (int)groups, smem, st);
  if (d == 96) return launch_d<96>(a, (int)groups, smem, st);
  if (d == 128) return launch_d<128>(a, (int)groups, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for q and o; d in {32, 64, 96, 128}. q and o (B, Hkv * G, 1, D),
// k and v int8 (B, Hkv, S, D), scales f32 (B, Hkv, S), all contiguous. The valid length is
// len_ptr[0] (an int32 on the device) when len_ptr is not null, else len_value; it is clamped to
// [0, S]. The keys are split into `splits` ranges of whole bkv tiles; ws and counters are the
// merge's workspace and zeroed counters (see launch). Returns cudaGetLastError() after the launch.
extern "C" int decode_attention(int dtype, int d, const void* q, const void* k, const void* ks,
                                const void* v, const void* vs, void* o, int B, int Hkv, int G,
                                int S, int bkv, const void* len_ptr, int len_value, float scale,
                                long long smem, int splits, void* ws, long long ws_bytes,
                                void* counters, long long n_counters, void* stream) {
  Src src{};
  src.len_ptr = static_cast<const int*>(len_ptr);
  src.len_value = len_value;
  src.S = S;
  return launch(dtype, d, q, k, ks, v, vs, o, B, Hkv, G, S, bkv, scale, smem, splits, ws, ws_bytes,
                counters, n_counters, src, static_cast<cudaStream_t>(stream));
}

// The paged form: pools int8 (Hkv, P, page, D), scales f32 (Hkv, P, page), block tables int32
// (B, maxp), lengths int32 (B,), all contiguous and on the device. A sequence's length is
// clamped to [0, maxp * page]; only its first ceil(len / page) table entries are dereferenced.
// The tile is bkv tokens (whole pages: ops.py::paged_tile), and the splits cover maxp * page.
extern "C" int paged_decode_attention(int dtype, int d, const void* q, const void* k,
                                      const void* ks, const void* v, const void* vs, void* o,
                                      int B, int Hkv, int G, int P, int page, const void* tables,
                                      int maxp, const void* lens, int bkv, float scale,
                                      long long smem, int splits, void* ws, long long ws_bytes,
                                      void* counters, long long n_counters, void* stream) {
  if (page <= 0 || maxp <= 0 || (long long)maxp * page > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Src src{};
  src.tables = static_cast<const int*>(tables);
  src.lens = static_cast<const int*>(lens);
  src.maxp = maxp;
  src.page = page;
  src.P = P;
  src.paged = 1;
  return launch(dtype, d, q, k, ks, v, vs, o, B, Hkv, G, maxp * page, bkv, scale, smem, splits, ws,
                ws_bytes, counters, n_counters, src, static_cast<cudaStream_t>(stream));
}
