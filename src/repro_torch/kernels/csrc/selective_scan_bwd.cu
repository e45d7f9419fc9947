// Mamba-1 selective scan's backward for Hopper (sm_90a): the gradient of selective_scan.cu's
// function, the autograd formula of the custom op repro_torch::selective_scan
// (kernels/mamba_scan/ops.py). The reference trains through a lax.scan that JAX differentiates
// (src/repro/kernels/mamba_scan/ops.py::selective_scan_ref); its TPU kernel
// (mamba_scan.py::selective_scan_pallas) has no backward.
//
// What it computes, per batch row b and channel d, given gy (B, L, D) and gh (B, D, N), the
// gradient of h_last (or none). With h_t the forward's states (h_{-1} = 0), g_t = exp(dt_t A) and
// dh_t the gradient of h_t:
//   dh_{L-1} = gh + gy_{L-1} C_{L-1},   dh_{t-1} = g_t dh_t + gy_{t-1} C_{t-1}
//   gC[b, t, n] = sum_d gy h_t[d, n]               gB[b, t, n] = sum_d dh_t[d, n] dt u
//   gu[b, t, d] = dt sum_n dh_t B_t + D gy          gdt[b, t, d] = u sum_n dh_t B_t + sum_n dh_t A g_t h_{t-1}
//   gA[d, n] = sum_{b, t} dh_t dt g_t h_{t-1}       gD[d] = sum_{b, t} gy u
// Everything runs in fp32; the five gradients are written in fp32 and cast by the wrapper.
//
// Bound on the card: the issue of its instructions, and the latency between them; not its bytes.
// Its bytes (each input read once, each output written once) take 0.053 ms at the population fit's
// 2 chips x 8 x 64 x 8192 x 16 (178 MB); its instructions, about 55 an element in the SASS (two
// precise expf of 9 each, the recurrence twice, the five gradients' terms, their sums over lanes
// and channels, the staging), take about 0.25 ms at 4 warp-instructions a clock on 132 SMs; the
// main kernel takes about twice that, and three blocks an SM in place of four take 13% longer.
// tools/selective_scan_bwd_probe.py times the launches apart, reads the loops' SASS, and times
// patched copies without the exponentials, the channel sums, the partials' stores or pass 1's
// steps, and alternatives (PERF.md §6).
//
// Design. Blocks run in no order, so each block walks its row's whole L, and sums across blocks
// take a second kernel. What the design does about the bound:
//
// - Layout: a channel's N states over P lanes of one warp, S states a lane in registers (S =
//   min(4, N) rounded up to a power of two; 8 above 128 states, which 32 lanes of 4 would not
//   hold), 128 / P channels a block of one row (ops.py::bwd_plan). Four states a lane, not the
//   forward's eight, keep a lane's chunk of recomputed states small enough for four blocks an SM.
// - Chunks of CT = 8 steps, their inputs staged: a two-stage ring in shared memory is filled by
//   cp.async one chunk ahead (u, dt and B in the forward pass, gy and C as well in the reverse;
//   zeros past D, L and N), and each landed chunk is converted once a block into (dt, dt u, gy, u)
//   per (step, channel) and (B, C) pairs per (step, state), so the inner steps read shared memory
//   alone and convert no bf16.
// - Two exponentials an element. Pass 1 runs the recurrence forward over every chunk but the last
//   and writes h before each chunk after the first to a checkpoint, each thread's states side by
//   side with its block's (coalesced); its state before the last chunk stays in registers. Pass 2
//   walks the chunks backward: it recomputes the chunk's h_t and g_t from the checkpoint into
//   shared memory (each thread's own slots, read back by the same thread: no barrier), then walks
//   them backward with no exponential. expf stays the precise one: ex2.approx missed the forward's
//   float32 gate.
// - gu and gdt: sums over a channel's P lanes by a shuffle tree.
// - gB and gC: each step's 2S terms of a lane are summed over the warp's 32 / P channels by a
//   reduce-scatter (each exchange halves what a lane keeps, so a step costs about 2S shuffles, not
//   2S log2(32 / P)); a lane holds its states in an order set by its lane bits (state_order), so
//   that the exchanges that split states need no select, and only the one that splits gB from gC
//   has one. At the end of a chunk the block adds its warps' sums in warp order, a warp a step,
//   and writes one partial a block a (row, step). A second kernel adds the blocks' partials in a
//   fixed order (up to eight warps a column group, each a fixed slice of the terms), as it adds
//   gA and gD over each chip's rows. No atomics: two launches give the same bits.
// - The staging's copy loops split rows into units by shifts (every row a power of two of bytes),
//   and are not unrolled: a thread copies a unit or two a region.
// - A chip axis as the forward's: row b reads chip b / rows's A and D (chip stride 0: one for
//   every chip), and gA and gD come out one a chip.
//
// The ring's copy helpers repeat selective_scan.cu's: each source is one translation unit, and
// its build is named by the hash of that file alone (kernels/common.py::_lib_path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int WARPS = NT / 32;
constexpr int CT = 8;    // steps a chunk: a ring stage, a recompute held in shared memory, a checkpoint's span
constexpr int MIN_BLOCKS = 4;  // __launch_bounds__' blocks per SM up to 4 states a lane: at most 128 registers
constexpr int NMAX = 256;
constexpr long long SMEM_LIMIT = 232448;  // 227 KiB of dynamic shared memory per block
constexpr int SUM_WARPS = 8;  // warps of a block of the cross-block sum

__host__ __device__ inline long long a16(long long n) { return (n + 15) / 16 * 16; }

// the least power of two that is at least n and 16
__host__ __device__ inline long long p16(long long n) {
  long long p = 16;
  while (p < n) p *= 2;
  return p;
}

struct Strides {
  long long b, t;  // in elements; the channel (or state) stride is 1
};

// Byte offsets of the shared-memory regions. A ring stage holds a chunk's u, dt and gy (CT, CPB)
// and B and C (CT, N) rows padded to a power of two of at least 16 bytes (rows of a power of two
// bytes split into copy units by shifts). After the stages: x (CT, CPB) float4 (dt, dt u,
// gy, u), bc (CT, NP) float2 (B, C), h (CT + 1, NT x S) (slot j: the state before the chunk's step
// j), g (CT, NT x S), and red (CT, WARPS, 2 NP), each warp's sums of gB and gC a step.
struct Layout {
  long long u, dt, gy, b, c, rb, stage, x, bc, h, g, red, total;
};

__host__ __device__ inline Layout layout(int es, int n, int p, int s) {
  const int cpb = NT / p, np = p * s;
  Layout y;
  long long o = 0;
  y.u = o;  o += a16((long long)CT * cpb * es);
  y.dt = o; o += a16((long long)CT * cpb * 4);
  y.gy = o; o += a16((long long)CT * cpb * es);
  y.rb = p16((long long)n * es);
  y.b = o;  o += CT * y.rb;
  y.c = o;  o += CT * y.rb;
  y.stage = o;
  o = 2 * y.stage;
  y.x = o;   o += (long long)CT * cpb * 16;
  y.bc = o;  o += (long long)CT * np * 8;
  y.h = o;   o += (long long)(CT + 1) * NT * s * 4;
  y.g = o;   o += (long long)CT * NT * s * 4;
  y.red = o; o += (long long)CT * WARPS * 2 * np * 4;
  y.total = o;
  return y;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// One vec-byte unit of a row into shared memory, nbytes (0..vec) of it from src and the rest
// zero. Units of 2 bytes (a bf16 slice at an odd element) are copied by the thread itself.
__device__ __forceinline__ void copy_unit(unsigned char* dst, const unsigned char* src, int vec, int nbytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (vec) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(nbytes) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(nbytes) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(nbytes) : "memory");
      break;
    default:
      *reinterpret_cast<unsigned short*>(dst) = nbytes ? *reinterpret_cast<const unsigned short*>(src) : 0;
  }
}

// rows x row_bytes (a power of two, at least vec) into shared memory rows dst_stride apart, in
// vec-byte units: valid bytes of each of the first rows_valid rows from src (rows src_stride bytes
// apart), zeros elsewhere. A thread copies a unit or two a call: the loop is not unrolled.
__device__ __forceinline__ void copy_rows(unsigned char* dst, long long dst_stride, const unsigned char* src,
                                          long long src_stride, int rows, int rows_valid, int row_bytes,
                                          int valid, int vec) {
  const int lg = __ffs(row_bytes / vec) - 1;  // units a row, as a shift
#pragma unroll 1
  for (int e = threadIdx.x; e < rows << lg; e += NT) {
    const int row = e >> lg, k = e & ((1 << lg) - 1);
    const int nb = row < rows_valid ? min(max(valid - k * vec, 0), vec) : 0;
    copy_unit(dst + row * dst_stride + k * vec, nb ? src + row * src_stride + k * vec : src, vec, nb);
  }
}

__device__ __forceinline__ float load_elem(const unsigned char* p, int i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// A thread's S states in an array of the block's NT x S: S / V vectors of V floats, the block's
// threads' vectors side by side, so a warp's accesses are contiguous (shared memory or device).
template <int S>
__device__ __forceinline__ void put(float* base, int tid, const float (&v)[S]) {
  constexpr int V = S < 4 ? S : 4;
#pragma unroll
  for (int q = 0; q < S / V; ++q) {
    float* p = base + (q * NT + tid) * V;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[2 * q], v[2 * q + 1]);
    } else {
      *p = v[q];
    }
  }
}

template <int S>
__device__ __forceinline__ void get(float (&v)[S], const float* base, int tid) {
  constexpr int V = S < 4 ? S : 4;
#pragma unroll
  for (int q = 0; q < S / V; ++q) {
    const float* p = base + (q * NT + tid) * V;
    if constexpr (V == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
    } else if constexpr (V == 2) {
      const float2 w = *reinterpret_cast<const float2*>(p);
      v[2 * q] = w.x, v[2 * q + 1] = w.y;
    } else {
      v[q] = *p;
    }
  }
}

// A step's (B, C) pairs of this lane's S state slots: slot p holds state p ^ ms of the lane's row
template <int S>
__device__ __forceinline__ void load_bc(const float2* row, int ms, float (&bv)[S], float (&cv)[S]) {
#pragma unroll
  for (int p = 0; p < S; ++p) {
    const float2 w = row[p ^ ms];
    bv[p] = w.x, cv[p] = w.y;
  }
}

// The order of a lane's state slots (slot p holds state p ^ ms) under which reduce_channels'
// exchanges that split states need no select: the exchange over lane bit 16 >> k splits state bit
// log2(S) - 1 - k, for each k < log2(S) whose lane bit is a channel's (at least P).
template <int P, int S>
__device__ __forceinline__ int state_order(int lane) {
  int ms = 0;
#pragma unroll
  for (int k = 0; (1 << k) < S && (16 >> k) >= P; ++k)
    if (lane & (16 >> k)) ms |= (S / 2) >> k;
  return ms;
}

// v (v[2p] gB's and v[2p + 1] gC's term of state slot p) summed over the warp's channels (lanes r,
// r + P, ... hold the same states), lane bit M first and down to P. While a lane keeps more than
// two values an exchange splits a state bit: the lane's slots are in state_order, so it keeps its
// lower half whatever its bit and adds its partner's upper half, which holds the same states. At
// two, the exchange splits gB from gC by a select (kind is set where the lane keeps gC); after that,
// plain exchanges, and of each pair of lanes that now hold the same sums only the one with the bit
// clear stays a writer.
template <int P, int M, int CNT, int NV>
__device__ __forceinline__ void reduce_stage(float (&v)[NV], int lane, int& kind, bool& writer) {
  if constexpr (M >= P) {
    if constexpr (CNT > 2) {
      constexpr int H = CNT / 2;
#pragma unroll
      for (int i = 0; i < H; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i + H], M);
      reduce_stage<P, M / 2, H>(v, lane, kind, writer);
    } else if constexpr (CNT == 2) {
      const bool up = lane & M;
      const float send = up ? v[0] : v[1];
      const float keep = up ? v[1] : v[0];
      v[0] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      kind = up;
      reduce_stage<P, M / 2, 1>(v, lane, kind, writer);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      if (lane & M) writer = false;
      reduce_stage<P, M / 2, 1>(v, lane, kind, writer);
    }
  }
}

// Returns the index (2 x state + kind) of this lane's first kept value: v[0 .. max(1, NV P / 32) -
// 1] then hold the sums over the warp's channels of values index, index + 1, ...
template <int P, int NV>
__device__ __forceinline__ int reduce_channels(float (&v)[NV], int lane, int ms, bool& writer) {
  int kind = 0;
  reduce_stage<P, 16, NV>(v, lane, kind, writer);
  return (ms << 1) | kind;
}

struct Args {
  const void* u;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dskip;
  const void* gy;   // (B, L, D) contiguous, in u's dtype
  const float* gh;  // (B, D, N) contiguous, or null
  float* gu;        // (B, L, D)
  float* gdt;       // (B, L, D)
  float* pbc;       // (B, L, nblk, 2, N): each block's sums of gB and gC over its channels
  float* pa;        // (B, D, N): each row's gA
  float* pd;        // (B, D): each row's gD
  float* ckpt;      // (B, nblk, nslots, NT x S): h before chunks 1 .. nch - 2, each thread's S side by side
  int L, D, N, nblk, nslots, bf16;
  int vu, vdt, vgy, vb, vc;  // copy widths in bytes
  Strides us, dts, bs, cs;
  int rows;          // batch rows a chip
  long long sa, sd;  // A's and D's chip strides in elements (0: one for every chip)
};

template <int P, int S>
__global__ void __launch_bounds__(NT, S > 4 ? 1 : MIN_BLOCKS) selective_scan_bwd_kernel(const Args a) {
  constexpr int CPB = NT / P;  // channels per block
  constexpr int NP = P * S;    // states a channel holds, N rounded up
  constexpr int W = 32 / P;    // channels a warp
  constexpr int KEEP = 2 * S >= W ? 2 * S / W : 1;  // gB and gC terms a lane keeps after the channel sum
  extern __shared__ __align__(16) unsigned char smem[];
  const int es = a.bf16 ? 2 : 4;
  const Layout ly = layout(es, a.N, P, S);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, r = tid % P, ch = tid / P;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const bool ok = d < a.D;
  const int dvalid = min(CPB, a.D - d0);
  const long long chip = bi / a.rows;
  const float* ap = a.a + chip * a.sa;

  const int ms = state_order<P, S>(lane);  // state slot s holds state r S + (s ^ ms)
  float a2[S], h[S], dh[S], ga[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = r * S + (s ^ ms);
    const bool on = ok && n < a.N;
    a2[s] = on ? ap[(long long)d * a.N + n] : 0.f;
    h[s] = 0.f;
    dh[s] = (a.gh && on) ? a.gh[((long long)bi * a.D + d) * a.N + n] : 0.f;
    ga[s] = 0.f;
  }
  const float dsk = ok ? a.dskip[chip * a.sd + d] : 0.f;
  const long long row0 = (long long)bi * a.L * a.D + d;  // gu and gdt of step t at row0 + t D
  float gd = 0.f;

  const unsigned char* ub = static_cast<const unsigned char*>(a.u) + (bi * a.us.b + d0) * es;
  const unsigned char* dtb = reinterpret_cast<const unsigned char*>(a.dt) + (bi * a.dts.b + d0) * 4;
  const unsigned char* gyb = static_cast<const unsigned char*>(a.gy) + ((long long)bi * a.L * a.D + d0) * es;
  const unsigned char* bb = static_cast<const unsigned char*>(a.b) + bi * a.bs.b * es;
  const unsigned char* cb = static_cast<const unsigned char*>(a.c) + bi * a.cs.b * es;

  // chunk k into ring stage st, one commit group: u, dt and B; gy and C too for the reverse pass
  auto load_chunk = [&](int k, int st, bool rev) {
    unsigned char* sg = smem + st * ly.stage;
    const int t0 = k * CT, rv = min(CT, a.L - t0);
    copy_rows(sg + ly.u, CPB * es, ub + t0 * a.us.t * es, a.us.t * es, CT, rv, CPB * es, dvalid * es, a.vu);
    copy_rows(sg + ly.dt, CPB * 4, dtb + t0 * a.dts.t * 4, a.dts.t * 4, CT, rv, CPB * 4, dvalid * 4, a.vdt);
    copy_rows(sg + ly.b, ly.rb, bb + t0 * a.bs.t * es, a.bs.t * es, CT, rv, ly.rb, a.N * es, a.vb);
    if (rev) {
      copy_rows(sg + ly.gy, CPB * es, gyb + (long long)t0 * a.D * es, (long long)a.D * es, CT, rv, CPB * es,
                dvalid * es, a.vgy);
      copy_rows(sg + ly.c, ly.rb, cb + t0 * a.cs.t * es, a.cs.t * es, CT, rv, ly.rb, a.N * es, a.vc);
    }
    cp_async_commit();
  };

  // the items the ring walks: pass 1 chunks 0 .. nch - 2 forward, pass 2 chunks nch - 1 .. 0
  const int nch = (a.L + CT - 1) / CT, n1 = nch - 1, items = n1 + nch;
  auto chunk_of = [&](int i) { return i < n1 ? i : items - 1 - i; };

  float4* x = reinterpret_cast<float4*>(smem + ly.x);
  float2* bc = reinterpret_cast<float2*>(smem + ly.bc);
  float* hs = reinterpret_cast<float*>(smem + ly.h);
  float* gs = reinterpret_cast<float*>(smem + ly.g);
  float* red = reinterpret_cast<float*>(smem + ly.red);
  float* ck = a.ckpt + ((long long)bi * a.nblk + blockIdx.x) * a.nslots * NT * S;  // slot k - 1: h before chunk k
  load_chunk(chunk_of(0), 0, n1 == 0);

  for (int i = 0; i < items; ++i) {
    const int st = i & 1, k = chunk_of(i), t0 = k * CT;
    const bool rev = i >= n1;
    const unsigned char* sg = smem + st * ly.stage;
    cp_async_wait0();
    __syncthreads();  // item i has landed; item i - 1 is done with its stage, x, bc and red
    if (i + 1 < items) load_chunk(chunk_of(i + 1), st ^ 1, i + 1 >= n1);

    // the landed chunk as the steps read it: (dt, dt u, gy, u) and (B, C) pairs in fp32
    for (int e = tid; e < CT * CPB; e += NT) {
      const float dtv = reinterpret_cast<const float*>(sg + ly.dt)[e];
      const float uv = load_elem(sg + ly.u, e, a.bf16);
      x[e] = make_float4(dtv, dtv * uv, rev ? load_elem(sg + ly.gy, e, a.bf16) : 0.f, uv);
    }
    for (int e = tid; e < CT * NP; e += NT) {
      const int t = e / NP, n = e - t * NP;
      float bv = 0.f, cv = 0.f;
      if (n < a.N) {
        bv = load_elem(sg + ly.b + t * ly.rb, n, a.bf16);
        if (rev) cv = load_elem(sg + ly.c + t * ly.rb, n, a.bf16);
      }
      bc[e] = make_float2(bv, cv);
    }
    __syncthreads();

    if (!rev) {  // pass 1: the recurrence forward, h before chunk k > 0 to its checkpoint
      if (k > 0) put<S>(ck + (long long)(k - 1) * NT * S, tid, h);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float4 xv = x[j * CPB + ch];
        float bv[S], cv[S];
        load_bc<S>(bc + j * NP + r * S, ms, bv, cv);
#pragma unroll
        for (int s = 0; s < S; ++s) h[s] = fmaf(expf(xv.x * a2[s]), h[s], xv.y * bv[s]);
      }
      continue;
    }

    // pass 2: chunk k's h_t and g_t recomputed from its checkpoint (the last chunk's state is pass
    // 1's, the first's zero) into shared memory; steps past L read zeros and leave h as it was
    if (k < n1) {
      if (k > 0) {
        get<S>(h, ck + (long long)(k - 1) * NT * S, tid);
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) h[s] = 0.f;
      }
    }
    put<S>(hs, tid, h);
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float4 xv = x[j * CPB + ch];
      float bv[S], cv[S], g[S];
      load_bc<S>(bc + j * NP + r * S, ms, bv, cv);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        g[s] = expf(xv.x * a2[s]);
        h[s] = fmaf(g[s], h[s], xv.y * bv[s]);
      }
      put<S>(gs + j * NT * S, tid, g);
      put<S>(hs + (j + 1) * NT * S, tid, h);
    }

    // the reverse walk: h_t carried back from the chunk's last step; past L gy, C and dt are zero,
    // so dh passes through unchanged and nothing of those steps is written
    float ht[S];
#pragma unroll
    for (int s = 0; s < S; ++s) ht[s] = h[s];
#pragma unroll 2  // the reverse walk's steps: unrolled 1, 2, 4 or 8 they take the same time
    for (int j = CT - 1; j >= 0; --j) {
      const int t = t0 + j;
      const float4 xv = x[j * CPB + ch];  // dt, dt u, gy, u
      float bv[S], cv[S], g[S], hp[S], v[2 * S];
      load_bc<S>(bc + j * NP + r * S, ms, bv, cv);
      get<S>(g, gs + j * NT * S, tid);
      get<S>(hp, hs + j * NT * S, tid);  // h_{t-1}: slot j holds the state before step j
      float gsum = 0.f, gdec = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        dh[s] = fmaf(xv.z, cv[s], dh[s]);
        v[2 * s] = dh[s] * xv.y;       // gB's term
        v[2 * s + 1] = xv.z * ht[s];   // gC's term
        gsum = fmaf(dh[s], bv[s], gsum);
        const float dgh = dh[s] * g[s] * hp[s];
        gdec = fmaf(dgh, a2[s], gdec);
        ga[s] = fmaf(dgh, xv.x, ga[s]);
        dh[s] *= g[s];
        ht[s] = hp[s];
      }
#pragma unroll
      for (int m = 1; m < P; m *= 2) {
        gsum += __shfl_xor_sync(0xffffffffu, gsum, m);
        gdec += __shfl_xor_sync(0xffffffffu, gdec, m);
      }
      if (ok && r == 0 && t < a.L) {
        const long long idx = row0 + (long long)t * a.D;
        a.gu[idx] = fmaf(xv.x, gsum, dsk * xv.z);
        a.gdt[idx] = fmaf(xv.w, gsum, gdec);
        gd = fmaf(xv.z, xv.w, gd);
      }
      bool writer = true;
      const int base = reduce_channels<P>(v, lane, ms, writer);
      if (writer) {
        float* out = red + (j * WARPS + warp) * 2 * NP + r * S;
#pragma unroll
        for (int q = 0; q < KEEP; ++q) out[((base | q) & 1) * NP + ((base | q) >> 1)] = v[q];
      }
    }
    __syncthreads();  // red holds every warp's sums of the chunk

    // the block's partial of gB and gC a (row, step), a warp a step: its warps' sums added in warp order
    const int rv = min(CT, a.L - t0);
    for (int j = warp; j < rv; j += WARPS) {
      float* out = a.pbc + (((long long)bi * a.L + t0 + j) * a.nblk + blockIdx.x) * 2 * a.N;
      for (int col = lane; col < 2 * a.N; col += 32) {
        const int kind = col >= a.N;
        const float* in = red + j * WARPS * 2 * NP + kind * NP + col - kind * a.N;
        float acc = in[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) acc += in[w * 2 * NP];
        out[col] = acc;
      }
    }
  }

  if (ok) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = r * S + (s ^ ms);
      if (n < a.N) a.pa[((long long)bi * a.D + d) * a.N + n] = ga[s];
    }
    if (r == 0) a.pd[(long long)bi * a.D + d] = gd;
  }
}

// out[o, i] = sum over k of in[o, k, i], in a fixed order: a block's warps take 32 columns i of
// one o each, `split` warps to a column group (the fewest powers of two, up to SUM_WARPS, that
// deal out at most 16 terms a warp), warp w of a group the terms k = w, w + split, ... in order,
// coalesced across its lanes; a group's warps' sums are then added in warp order.
__global__ void __launch_bounds__(SUM_WARPS * 32) sum_middle(const float* in, float* out, long long inner, int K,
                                                              int split) {
  __shared__ float part[SUM_WARPS][32];
  const long long cols = 32LL * (SUM_WARPS / split), groups = (inner + cols - 1) / cols;
  const long long o = blockIdx.x / groups;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, slice = w % split;
  const long long i = (blockIdx.x - o * groups) * cols + (w / split) * 32 + lane;
  float acc = 0.f;
  if (i < inner) {
    const float* p = in + o * K * inner + i;
    for (int k = slice; k < K; k += split) acc += p[k * inner];
  }
  part[w][lane] = acc;
  __syncthreads();
  if (slice == 0 && i < inner) {
    for (int v = 1; v < split; ++v) acc += part[w + v][lane];
    out[o * inner + i] = acc;
  }
}

int launch_sum(const float* in, float* out, long long outer, int K, long long inner, cudaStream_t st) {
  int split = 1;
  while (split < SUM_WARPS && split * 16 < K) split *= 2;
  const long long cols = 32LL * (SUM_WARPS / split), blocks = outer * ((inner + cols - 1) / cols);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  sum_middle<<<(unsigned)blocks, SUM_WARPS * 32, 0, st>>>(in, out, inner, K, split);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int S>
int launch_ps(const Args& a, int B, long long smem, cudaStream_t st) {
  auto kern = selective_scan_bwd_kernel<P, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(a.nblk, B), NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy (16, 8, 4 or 2 bytes, at least the element) that every row start of a tensor
// is aligned to: its base, its batch and time strides and the step between blocks, in bytes.
int width(const void* p, long long sb, long long st, long long step, int es) {
  int v = 16;
  while (v > es && ((reinterpret_cast<uintptr_t>(p) | sb | st | step) % v) != 0) v /= 2;
  return v;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for u, B, C and gy; dt, A, D and gh are float32. u, dt, B
// and C as selective_scan's (strides in elements, unit last stride), gy (B, L, D) contiguous, gh
// (B, D, N) contiguous or null. Writes gu and gdt (B, L, D), gbc (B, L, 2, N) (gB then gC), ga
// (chips, D, N) and gd (chips, D), all fp32 and contiguous, chips = B / rows. Scratch, fp32: pbc
// (B, L, nblk, 2, N), pa (B, D, N), pd (B, D), ckpt (B, nblk, nslots, 128 x states), where nblk =
// ceil(D / (128 / lanes)) and nslots = max(ceil(L / 8) - 2, 0); the call refuses other nblk and
// nslots. states = min(4, N rounded up to a power of two), 8 above 128 states, and lanes the
// fewest powers of two that hold N (ops.py::bwd_plan). Returns cudaGetLastError() after the last
// launch.
extern "C" int selective_scan_bwd(int dtype, const void* u, const void* dt, const void* a, const void* b,
                                  const void* c, const void* d, const void* gy, const void* gh, void* gu,
                                  void* gdt, void* gbc, void* ga, void* gd, void* pbc, void* pa, void* pd,
                                  void* ckpt, int B, int L, int D, int N, int lanes, int states, int nblk,
                                  int nslots, long long usb, long long ust, long long dtsb, long long dtst,
                                  long long bsb, long long bst, long long csb, long long cst, int rows,
                                  long long sa, long long sd, void* stream) {
  int want_states = 1;
  while (want_states < N && want_states < 4) want_states *= 2;
  if (N > 128) want_states = 8;
  int want_lanes = 1;
  while (want_lanes * want_states < N) want_lanes *= 2;
  const int nch = (L + CT - 1) / CT;
  if (N < 1 || N > NMAX || B < 1 || D < 1 || L < 1 || B > 65535 || (dtype != 0 && dtype != 1) ||
      lanes != want_lanes || states != want_states || rows < 1 || B % rows != 0 || sa < 0 || sd < 0 ||
      nblk != (D + NT / lanes - 1) / (NT / lanes) || nslots != (nch > 2 ? nch - 2 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 1 ? 2 : 4;
  const int cpb = NT / lanes;
  const long long smem = layout(es, N, lanes, states).total;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.u = u;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.dskip = static_cast<const float*>(d);
  args.gy = gy;
  args.gh = static_cast<const float*>(gh);
  args.gu = static_cast<float*>(gu);
  args.gdt = static_cast<float*>(gdt);
  args.pbc = static_cast<float*>(pbc);
  args.pa = static_cast<float*>(pa);
  args.pd = static_cast<float*>(pd);
  args.ckpt = static_cast<float*>(ckpt);
  args.L = L;
  args.D = D;
  args.N = N;
  args.nblk = nblk;
  args.nslots = nslots;
  args.bf16 = dtype;
  args.vu = width(u, usb * es, ust * es, (long long)cpb * es, es);
  args.vdt = width(dt, dtsb * 4, dtst * 4, (long long)cpb * 4, 4);
  args.vgy = width(gy, (long long)L * D * es, (long long)D * es, (long long)cpb * es, es);
  args.vb = width(b, bsb * es, bst * es, 16, es);
  args.vc = width(c, csb * es, cst * es, 16, es);
  args.us = Strides{usb, ust};
  args.dts = Strides{dtsb, dtst};
  args.bs = Strides{bsb, bst};
  args.cs = Strides{csb, cst};
  args.rows = rows;
  args.sa = sa;
  args.sd = sd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (lanes) {
    case 1:
      switch (states) {
        case 1: err = launch_ps<1, 1>(args, B, smem, st); break;
        case 2: err = launch_ps<1, 2>(args, B, smem, st); break;
        default: err = launch_ps<1, 4>(args, B, smem, st);
      }
      break;
    case 2: err = launch_ps<2, 4>(args, B, smem, st); break;
    case 4: err = launch_ps<4, 4>(args, B, smem, st); break;
    case 8: err = launch_ps<8, 4>(args, B, smem, st); break;
    case 16: err = launch_ps<16, 4>(args, B, smem, st); break;
    default: err = states == 8 ? launch_ps<32, 8>(args, B, smem, st) : launch_ps<32, 4>(args, B, smem, st);
  }
  if (err) return err;
  const int chips = B / rows;
  if ((err = launch_sum(args.pbc, static_cast<float*>(gbc), (long long)B * L, nblk, 2LL * N, st))) return err;
  if ((err = launch_sum(args.pa, static_cast<float*>(ga), chips, rows, (long long)D * N, st))) return err;
  return launch_sum(args.pd, static_cast<float*>(gd), chips, rows, D, st);
}
