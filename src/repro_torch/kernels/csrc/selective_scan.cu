// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py::selective_scan_pallas.
//
// What it computes, per batch row b and channel d, with h (N states) starting at zero:
//   h_t = exp(dt[b, t, d] * A[d, :]) * h_{t-1} + (dt[b, t, d] * u[b, t, d]) * B[b, t, :]
//   y[b, t, d] = <C[b, t, :], h_t> + D[d] * u[b, t, d]
// and h_last[b, d, :] = h_{L-1}. The recurrence runs in fp32; y is written in u's dtype, h_last
// in fp32. u, dt, B and C are read through their (batch, time) strides with a unit last stride,
// so the B and C slices of the x_proj output need no copy. Nothing is padded: the kernel masks
// its own ragged D, L and N. 1 <= N <= 256.
//
// Bound on the card: the exps. Each (b, t, d, n) costs one exponential on the special-function
// units (SFUs), which issue 16 results per clock per SM, against about 8 bytes of input per
// (b, t, d) shared by N states. At every shape the serving paths give it (N = 16) the exps take
// longer than the bytes: 4 x 128 x 8192 x 16 is 67 M exps, 16 us on 132 SMs at 1.98 GHz,
// against 10.8 us to move its 36 MB at 3.35 TB/s. What binds this kernel is the issue of its
// instructions, not the SFUs: the precise expf adds about 8 FP32 and integer instructions to its
// one SFU op, so the inner loop is about 13 instructions a (step, state), against the 8 a warp
// scheduler could issue in the SFU's time, and a build with no exponential at all still takes
// about two thirds of the time (tools/selective_scan_probe.py counts the SASS and times both).
//
// Design. The TPU kernel carries h in VMEM scratch from one L-chunk grid step to the next,
// relying on the grid running in order. Blocks on this card run in no order, so the whole L loop
// lives inside one block and nothing is carried or reduced across blocks. What the design does
// about the bound:
//
// - It fills the card. A channel's N states are split over P lanes of one warp, S = N / P (a
//   power of two, at most 8) states a lane in registers with that lane's row of A. A block of 128
//   threads covers 128 / P channels of one batch row. P comes from host-known shapes and the
//   card's SM count alone (kernels/mamba_scan/ops.py::scan_plan): the fewest lanes that put about 12 warps on each SM
//   while a lane keeps more than 4 states, and more below 4 warps an SM. So falcon-mamba's 4 x
//   8192 channels take P = 2 (S = 8, 16 warps an SM) and hymba's 4 x 3200 P = 4 (S = 4, 12): on
//   the H100 a lane's independent state chains hide latency better than more warps do, and each
//   doubling of P adds shuffles and loads per state. __launch_bounds__ asks for four blocks an SM,
//   which caps a thread at 128 registers: uncapped, the 8-step passes of 2 x 8 took more and ran
//   three blocks an SM, 25-30% slower.
// - y is reduced over a channel's P lanes by a fixed shuffle tree, a reduce-scatter over P time
//   steps at once: after log2(P) exchange stages (P - 1 shuffles a lane in all) lane r holds the
//   full sum of step r of the group. So the reduction costs about one shuffle per lane per step,
//   not log2(P), and two launches give the same bits.
// - Loads overlap the recurrence. u, dt, B and C of the next chunk of time steps (32, or 16
//   where four blocks of 32 would not fit an SM's shared memory; chosen here, from the layout)
//   are copied into a two-stage shared-memory ring by cp.async (16-byte copies where the addresses allow, else 8,
//   4 or, for a bf16 slice at an odd element, 2; zero-filled past D, L and N) while this chunk
//   runs. A pass then turns the landed chunk into (dt, dt * u) per (step, channel) and
//   interleaved fp32 (B, C) pairs per (step, state), so the inner loop reads one 8-byte word and
//   S / 2 16-byte words a step. y goes back through shared memory and leaves in 16-byte coalesced
//   stores where D allows.
// - The exps are off the critical path: exp(dt * A) does not depend on h, so each step's
//   exponentials issue ahead of its FMA chains (h, and y in two chains), with A in registers.
//   The exponential is the precise expf (one SFU op and its range reduction in FP32): a single
//   ex2.approx.ftz of dt * A * log2(e) (tools/selective_scan_probe.py builds it from a patched
//   copy of this source and times it beside this one) missed the float32 y gate (rtol 2e-5, atol
//   1e-4) at 4 x 2048 x 3200 on one seed, since its bias compounds over the long memory of a
//   state whose decay is near 1. Time steps past L read zeros: dt = 0 gives a factor of exactly 1
//   and h is unchanged.
// - A chip axis (the counterpart of the TPU kernel under jax.vmap): a fleet's B rows are chips x
//   rows, and a block reads its chip's A and D at chip * stride (0: one A and D for every chip),
//   so one launch scans every chip's prefill; nothing else in the kernel knows of chips.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads per block
constexpr int PASS = 8;     // time steps a pass of the recurrence unrolls, at least
constexpr int MIN_BLOCKS = 4;  // __launch_bounds__' blocks per SM: at most 128 registers a thread
constexpr int NMAX = 256;   // most states per channel: 32 lanes x 8
constexpr int CHUNK = 32;   // time steps a ring stage holds, unless MIN_BLOCKS blocks would not fit
constexpr long long SMEM_LIMIT = 232448;  // 227 KiB of dynamic shared memory per block
constexpr long long SMEM_PER_SM = 233472;  // 228 KiB, of which each resident block also takes 1 KiB

__host__ __device__ inline long long a16(long long n) { return (n + 15) / 16 * 16; }

struct Strides {
  long long b, t;  // in elements; the channel (or state) stride is 1
};

// Byte offsets of the shared-memory regions. A ring stage holds a chunk of CL steps: u (CL, CPB) in u's dtype, dt (CL, CPB) fp32, B and C (CL, N) in u's dtype
// with rows padded to 16 bytes. After the ring: (dt, dt * u) (CL, CPB) fp32 pairs, the (B, C)
// pairs (CL, NP) fp32 and the chunk's y sums (CL, CPB) fp32.
struct Layout {
  long long u, dt, b, c, rb, stage, dtdu, bc, ys, total;
};

__host__ __device__ inline Layout layout(int es, int cpb, int cl, int n, int np) {
  Layout s;
  long long o = 0;
  s.u = o;  o += a16((long long)cl * cpb * es);
  s.dt = o; o += a16((long long)cl * cpb * 4);
  s.rb = a16((long long)n * es);
  s.b = o;  o += cl * s.rb;
  s.c = o;  o += cl * s.rb;
  s.stage = o;
  o = 2 * s.stage;
  s.dtdu = o; o += (long long)cl * cpb * 8;
  s.bc = o;   o += (long long)cl * np * 8;
  s.ys = o;   o += (long long)cl * cpb * 4;
  s.total = o;
  return s;
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

// rows x row_bytes into shared memory rows dst_stride apart, in vec-byte units: valid bytes of
// each of the first rows_valid rows from src (rows src_stride bytes apart), zeros elsewhere.
__device__ __forceinline__ void copy_rows(unsigned char* dst, long long dst_stride, const unsigned char* src,
                                          long long src_stride, int rows, int rows_valid, int row_bytes,
                                          int valid, int vec) {
  const int units = (row_bytes + vec - 1) / vec;
  for (int e = threadIdx.x; e < rows * units; e += NT) {
    const int row = e / units, k = e - row * units;
    const int nb = row < rows_valid ? min(max(valid - k * vec, 0), vec) : 0;
    copy_unit(dst + row * dst_stride + k * vec, nb ? src + row * src_stride + k * vec : src, vec, nb);
  }
}

__device__ __forceinline__ float load_elem(const unsigned char* p, int i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// exp(dt * A): the precise expf
__device__ __forceinline__ float decay(float x) { return expf(x); }

// Reduce-scatter over the P lanes of a channel: v[j] is this lane's partial of step j of the
// group; after log2(P) stages lane r returns the sum over the P lanes of step r. At stage h a
// lane keeps the half of its values whose step has bit h equal to its own and adds its
// partner's (lane ^ h) partials of that half.
template <int P>
__device__ __forceinline__ float reduce_scatter(float (&v)[P], int r) {
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
    const bool up = r & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  return v[0];
}

struct Args {
  const void* u;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dskip;
  void* y;
  float* h_last;
  int L, D, N, CL, bf16;
  int vu, vdt, vb, vc, vy;  // copy and store widths in bytes
  Strides us, dts, bs, cs;
  int rows;       // batch rows a chip: row bi reads chip bi / rows's A and D
  long long sa, sd;  // A's and D's chip strides in elements (0: one for every chip)
};

template <int P, int S>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) selective_scan_kernel(const Args a) {
  constexpr int CPB = NT / P;  // channels per block
  constexpr int NP = P * S;    // states a channel holds, N rounded up
  extern __shared__ __align__(16) unsigned char smem[];
  const int es = a.bf16 ? 2 : 4;
  const Layout ly = layout(es, CPB, a.CL, a.N, NP);

  const int tid = threadIdx.x, r = tid % P, ch = tid / P;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const bool ok = d < a.D;
  const int dvalid = min(CPB, a.D - d0);
  const long long chip = bi / a.rows;
  const float* ap = a.a + chip * a.sa;
  const float* dskip = a.dskip + chip * a.sd;

  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = r * S + s;
    a2[s] = (ok && n < a.N) ? ap[(long long)d * a.N + n] : 0.f;
    h[s] = 0.f;
  }

  const unsigned char* ub = static_cast<const unsigned char*>(a.u) + (bi * a.us.b + d0) * es;
  const unsigned char* dtb = reinterpret_cast<const unsigned char*>(a.dt) + (bi * a.dts.b + d0) * 4;
  const unsigned char* bb = static_cast<const unsigned char*>(a.b) + bi * a.bs.b * es;
  const unsigned char* cb = static_cast<const unsigned char*>(a.c) + bi * a.cs.b * es;

  // chunk starting at step t0 into ring stage st: one commit group
  auto load_chunk = [&](int t0, int st) {
    unsigned char* sg = smem + st * ly.stage;
    const int rv = min(a.CL, a.L - t0);
    copy_rows(sg + ly.u, CPB * es, ub + t0 * a.us.t * es, a.us.t * es, a.CL, rv, CPB * es, dvalid * es, a.vu);
    copy_rows(sg + ly.dt, CPB * 4, dtb + t0 * a.dts.t * 4, a.dts.t * 4, a.CL, rv, CPB * 4, dvalid * 4, a.vdt);
    copy_rows(sg + ly.b, ly.rb, bb + t0 * a.bs.t * es, a.bs.t * es, a.CL, rv, a.N * es, a.N * es, a.vb);
    copy_rows(sg + ly.c, ly.rb, cb + t0 * a.cs.t * es, a.cs.t * es, a.CL, rv, a.N * es, a.N * es, a.vc);
    cp_async_commit();
  };

  float2* dtdu = reinterpret_cast<float2*>(smem + ly.dtdu);
  float2* bc = reinterpret_cast<float2*>(smem + ly.bc);
  float* ys = reinterpret_cast<float*>(smem + ly.ys);
  const int nchunks = (a.L + a.CL - 1) / a.CL;
  if (nchunks > 0) load_chunk(0, 0);

  for (int i = 0; i < nchunks; ++i) {
    const int st = i & 1, t0 = i * a.CL;
    const unsigned char* sg = smem + st * ly.stage;
    cp_async_wait0();
    __syncthreads();  // chunk i has landed; chunk i - 1 is computed and stored
    if (i + 1 < nchunks) load_chunk(t0 + a.CL, st ^ 1);

    // the landed chunk as the recurrence reads it: (dt, dt * u) and (B, C) pairs in fp32
    for (int e = tid; e < a.CL * CPB; e += NT) {
      const float dtv = reinterpret_cast<const float*>(sg + ly.dt)[e];
      dtdu[e] = make_float2(dtv, dtv * load_elem(sg + ly.u, e, a.bf16));
    }
    for (int e = tid; e < a.CL * NP; e += NT) {
      const int t = e / NP, n = e - t * NP;
      float bv = 0.f, cv = 0.f;
      if (n < a.N) {
        bv = load_elem(sg + ly.b + t * ly.rb, n, a.bf16);
        cv = load_elem(sg + ly.c + t * ly.rb, n, a.bf16);
      }
      bc[e] = make_float2(bv, cv);
    }
    __syncthreads();

    // the recurrence, P steps a group and GU groups (at least PASS steps) a pass, so that a
    // pass's loads and exps issue ahead of its FMA chains; y sums leave at the end of it
    constexpr int GU = P >= PASS ? 1 : PASS / P;
#pragma unroll 1
    for (int p0 = 0; p0 < a.CL; p0 += P * GU) {
      float yo[GU];
#pragma unroll
      for (int gu = 0; gu < GU; ++gu) {
        float yp[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int t = p0 + gu * P + j;
          const float2 x = dtdu[t * CPB + ch];
          if constexpr (S == 1) {
            const float2 v = bc[t * NP + r];
            h[0] = fmaf(decay(x.x * a2[0]), h[0], x.y * v.x);
            yp[j] = h[0] * v.y;
          } else {
            const float4* bcr = reinterpret_cast<const float4*>(bc + t * NP + r * S);
            float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
            for (int s2 = 0; s2 < S / 2; ++s2) {
              const float4 v = bcr[s2];
              h[2 * s2] = fmaf(decay(x.x * a2[2 * s2]), h[2 * s2], x.y * v.x);
              h[2 * s2 + 1] = fmaf(decay(x.x * a2[2 * s2 + 1]), h[2 * s2 + 1], x.y * v.z);
              acc0 = fmaf(h[2 * s2], v.y, acc0);
              acc1 = fmaf(h[2 * s2 + 1], v.w, acc1);
            }
            yp[j] = acc0 + acc1;
          }
        }
        yo[gu] = reduce_scatter<P>(yp, r);
      }
#pragma unroll
      for (int gu = 0; gu < GU; ++gu) ys[(p0 + gu * P + r) * CPB + ch] = yo[gu];
    }
    __syncthreads();

    // y = sum + D * u, VE channels of one step per store (16 bytes where D allows)
    const int rv = min(a.CL, a.L - t0);
    const int ve = a.vy / es, per_row = CPB / ve;
    for (int e = tid; e < rv * per_row; e += NT) {
      const int t = e / per_row, c0 = (e - t * per_row) * ve;
      if (c0 >= dvalid) continue;
      union {
        uint4 v;
        unsigned short hb[8];
        float f[4];
      } pk;
      pk.v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < ve) {
          const int c = c0 + k;
          const float yv = ys[t * CPB + c] + __ldg(dskip + d0 + c) * load_elem(sg + ly.u, t * CPB + c, a.bf16);
          if (a.bf16) {
            pk.hb[k] = __bfloat16_as_ushort(__float2bfloat16(yv));
          } else if (k < 4) {
            pk.f[k] = yv;
          }
        }
      }
      unsigned char* dst = static_cast<unsigned char*>(a.y) +
                           (((long long)bi * a.L + t0 + t) * a.D + d0 + c0) * es;
      switch (a.vy) {
        case 16: *reinterpret_cast<uint4*>(dst) = pk.v; break;
        case 8: *reinterpret_cast<uint2*>(dst) = make_uint2(pk.v.x, pk.v.y); break;
        case 4: *reinterpret_cast<unsigned*>(dst) = pk.v.x; break;
        default: *reinterpret_cast<unsigned short*>(dst) = pk.hb[0];
      }
    }
  }

  if (ok) {
    float* hp = a.h_last + ((long long)bi * a.D + d) * a.N;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (r * S + s < a.N) hp[r * S + s] = h[s];
  }
}

template <int P, int S>
int launch_ps(const Args& a, int B, long long smem, cudaStream_t stream) {
  auto kern = selective_scan_kernel<P, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int CPB = NT / P;
  kern<<<dim3((a.D + CPB - 1) / CPB, B), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const Args& a, int states, int B, long long smem, cudaStream_t st) {
  switch (states) {
    case 1: return launch_ps<P, 1>(a, B, smem, st);
    case 2: return launch_ps<P, 2>(a, B, smem, st);
    case 4: return launch_ps<P, 4>(a, B, smem, st);
    case 8: return launch_ps<P, 8>(a, B, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The widest copy (16, 8, 4 or 2 bytes, at least the element) that every row start of a tensor
// is aligned to: its base, its batch and time strides and the step between blocks, in bytes.
int width(const void* p, long long sb, long long st, long long step, int es) {
  int v = 16;
  while (v > es && ((reinterpret_cast<uintptr_t>(p) | sb | st | step) % v) != 0) v /= 2;
  return v;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for u, B, C and y alike; dt, A, D and h_last are float32.
// u and dt (B, L, D), B and C (B, L, N) are addressed by (batch, time) strides in elements with
// a unit last stride; y (B, L, D) and h_last (B, D, N) are contiguous. A chip axis: the B rows
// are chips x `rows`, and row b reads chip b / rows's A (D, N) and D (D,), each contiguous, chip
// c's starting sa (A) and sd (D) elements after chip c - 1's (0: one A or D for every chip).
// lanes (1-32, a power of two) x states (1, 2, 4 or 8) >= N, 1 <= N <= 256 (ops.py::scan_plan
// picks them). The chunk and the shared memory are this file's: CHUNK steps a ring stage, or
// max(16, lanes) where MIN_BLOCKS blocks of CHUNK would not fit an SM. Returns cudaGetLastError()
// after the launch.
extern "C" int selective_scan(int dtype, const void* u, const void* dt, const void* a,
                              const void* b, const void* c, const void* d, void* y,
                              void* h_last, int B, int L, int D, int N, int lanes, int states,
                              long long usb, long long ust, long long dtsb, long long dtst,
                              long long bsb, long long bst, long long csb, long long cst,
                              int rows, long long sa, long long sd, void* stream) {
  const bool pow2 = lanes > 0 && (lanes & (lanes - 1)) == 0;
  if (N < 1 || N > NMAX || B < 1 || D < 1 || L < 0 || B > 65535 || (dtype != 0 && dtype != 1) ||
      !pow2 || lanes > 32 || (long long)lanes * states < N || rows < 1 || B % rows != 0 || sa < 0 ||
      sd < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 1 ? 2 : 4;
  const int cpb = NT / lanes;
  int chunk = CHUNK;
  if (MIN_BLOCKS * (layout(es, cpb, chunk, N, lanes * states).total + 1024) > SMEM_PER_SM)
    chunk = lanes > 16 ? lanes : 16;
  const long long smem = layout(es, cpb, chunk, N, lanes * states).total;
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.u = u;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = b;
  args.c = c;
  args.dskip = static_cast<const float*>(d);
  args.y = y;
  args.h_last = static_cast<float*>(h_last);
  args.L = L;
  args.D = D;
  args.N = N;
  args.CL = chunk;
  args.bf16 = dtype;
  args.us = Strides{usb, ust};
  args.dts = Strides{dtsb, dtst};
  args.bs = Strides{bsb, bst};
  args.cs = Strides{csb, cst};
  args.rows = rows;
  args.sa = sa;
  args.sd = sd;
  args.vu = width(u, usb * es, ust * es, (long long)cpb * es, es);
  args.vdt = width(dt, dtsb * 4, dtst * 4, (long long)cpb * 4, 4);
  args.vb = width(b, bsb * es, bst * es, 16, es);
  args.vc = width(c, csb * es, cst * es, 16, es);
  args.vy = width(y, (long long)L * D * es, (long long)D * es, (long long)cpb * es, es);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_p<1>(args, states, B, smem, st);
    case 2: return launch_p<2>(args, states, B, smem, st);
    case 4: return launch_p<4>(args, states, B, smem, st);
    case 8: return launch_p<8>(args, states, B, smem, st);
    case 16: return launch_p<16>(args, states, B, smem, st);
    default: return launch_p<32>(args, states, B, smem, st);
  }
}
