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
// Design: a simple kernel, right first.
// - The layout is the forward's: a channel's N states over P lanes of one warp, S states a lane in
//   registers (S = min(8, N) rounded up to a power of two), 128 / P channels a block of one row.
// - The reverse recurrence needs h_{t-1} at every step. Nothing of the forward is saved: a first
//   pass runs the recurrence and writes h at the start of each chunk of CT steps (B x L / CT x D x N
//   floats, against the B x L x D x N the plain version keeps); the reverse pass then recomputes
//   each chunk's CT states from its checkpoint into registers and walks them backward.
// - Sums over a channel's P lanes (gu, gdt) are shuffle trees. gB and gC sum over channels: a
//   shuffle tree over the warp's 32 / P channels, then one partial a warp into a scratch buffer,
//   summed in a fixed order by a second kernel, as are gA and gD over each chip's rows. No
//   atomics, so two launches give the same bits.
// - A chip axis as the forward's: row b reads chip b / rows's A and D (chip stride 0: one for every
//   chip), and gA and gD come out one a chip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int WARPS = NT / 32;
constexpr int CT = 8;    // steps a recomputed chunk holds in registers
constexpr int NMAX = 256;

struct Strides {
  long long b, t;  // in elements; the channel (or state) stride is 1
};

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
  float* pbc;       // (B, L, nw, 2, N): each warp's sums of gB and gC over its channels
  float* pa;        // (B, D, N): each row's gA
  float* pd;        // (B, D): each row's gD
  float* ckpt;      // (B, nch, D, N): h before each chunk of CT steps
  int L, D, N, nw, nch, bf16;
  Strides us, dts, bs, cs;
  int rows;          // batch rows a chip
  long long sa, sd;  // A's and D's chip strides in elements (0: one for every chip)
};

__device__ __forceinline__ float load_elem(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

template <int P, int S>
__global__ void __launch_bounds__(NT) selective_scan_bwd_kernel(const Args a) {
  constexpr int CPB = NT / P;  // channels per block
  const int tid = threadIdx.x, lane = tid % 32, r = tid % P, ch = tid / P;
  const int bi = blockIdx.y, d = blockIdx.x * CPB + ch;
  const bool ok = d < a.D;
  const long long chip = bi / a.rows;
  const float* ap = a.a + chip * a.sa;

  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = r * S + s;
    a2[s] = (ok && n < a.N) ? ap[(long long)d * a.N + n] : 0.f;
    h[s] = 0.f;
  }
  const float dsk = ok ? a.dskip[chip * a.sd + d] : 0.f;

  // one step's inputs for this thread's channel and states; zeros past D
  auto step_in = [&](int t, float& dtv, float& uv, float (&bv)[S], float (&cv)[S]) {
    dtv = ok ? a.dt[bi * a.dts.b + t * a.dts.t + d] : 0.f;
    uv = ok ? load_elem(a.u, bi * a.us.b + t * a.us.t + d, a.bf16) : 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = r * S + s;
      bv[s] = n < a.N ? load_elem(a.b, bi * a.bs.b + t * a.bs.t + n, a.bf16) : 0.f;
      cv[s] = n < a.N ? load_elem(a.c, bi * a.cs.b + t * a.cs.t + n, a.bf16) : 0.f;
    }
  };
  auto ckpt_at = [&](int k, int s) -> float* {
    return a.ckpt + (((long long)bi * a.nch + k) * a.D + d) * a.N + r * S + s;
  };

  // pass 1: the forward recurrence, h written at the start of each chunk
  for (int t = 0; t < a.L; ++t) {
    if (t % CT == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (ok && r * S + s < a.N) *ckpt_at(t / CT, s) = h[s];
    }
    float dtv, uv, bv[S], cv[S];
    step_in(t, dtv, uv, bv, cv);
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = fmaf(expf(dtv * a2[s]), h[s], dtv * uv * bv[s]);
  }

  // pass 2: the reverse recurrence, a chunk at a time from its checkpoint
  float dh[S], ga[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = r * S + s;
    dh[s] = (a.gh && ok && n < a.N) ? a.gh[((long long)bi * a.D + d) * a.N + n] : 0.f;
    ga[s] = 0.f;
  }
  float gd = 0.f;
  const int wg = blockIdx.x * WARPS + tid / 32;  // this warp's slot among the row's nw
  for (int k = a.nch - 1; k >= 0; --k) {
    const int t0 = k * CT;
    float h0[S], hb[CT][S];
#pragma unroll
    for (int s = 0; s < S; ++s) h0[s] = h[s] = (ok && r * S + s < a.N) ? *ckpt_at(k, s) : 0.f;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (t0 + j < a.L) {
        float dtv, uv, bv[S], cv[S];
        step_in(t0 + j, dtv, uv, bv, cv);
#pragma unroll
        for (int s = 0; s < S; ++s) h[s] = fmaf(expf(dtv * a2[s]), h[s], dtv * uv * bv[s]);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) hb[j][s] = h[s];
    }
#pragma unroll
    for (int j = CT - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t >= a.L) continue;  // the same t for the whole block: no lane leaves a shuffle
      float dtv, uv, bv[S], cv[S];
      step_in(t, dtv, uv, bv, cv);
      const long long idx = ((long long)bi * a.L + t) * a.D + d;
      const float gyv = ok ? load_elem(a.gy, idx, a.bf16) : 0.f;
      const float dtu = dtv * uv;
      float gb[S], gc[S], gsum = 0.f, gdec = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float hp = j ? hb[j - 1][s] : h0[s];
        const float g = expf(dtv * a2[s]);
        dh[s] = fmaf(gyv, cv[s], dh[s]);
        gc[s] = gyv * hb[j][s];
        gb[s] = dh[s] * dtu;
        gsum = fmaf(dh[s], bv[s], gsum);
        const float dgh = dh[s] * g * hp;
        gdec = fmaf(dgh, a2[s], gdec);
        ga[s] = fmaf(dgh, dtv, ga[s]);
        dh[s] *= g;
      }
#pragma unroll
      for (int m = 1; m < P; m *= 2) {
        gsum += __shfl_xor_sync(0xffffffffu, gsum, m);
        gdec += __shfl_xor_sync(0xffffffffu, gdec, m);
      }
      if (ok && r == 0) {
        a.gu[idx] = fmaf(dtv, gsum, dsk * gyv);
        a.gdt[idx] = fmaf(uv, gsum, gdec);
        gd = fmaf(gyv, uv, gd);
      }
      // gB and gC over the warp's channels: lanes r, r + P, ... hold the same states
#pragma unroll
      for (int m = P; m < 32; m *= 2) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          gb[s] += __shfl_xor_sync(0xffffffffu, gb[s], m);
          gc[s] += __shfl_xor_sync(0xffffffffu, gc[s], m);
        }
      }
      if (lane < P) {
        float* out = a.pbc + (((long long)bi * a.L + t) * a.nw + wg) * 2 * a.N;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int n = r * S + s;
          if (n < a.N) {
            out[n] = gb[s];
            out[a.N + n] = gc[s];
          }
        }
      }
    }
  }

  if (ok) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = r * S + s;
      if (n < a.N) a.pa[((long long)bi * a.D + d) * a.N + n] = ga[s];
    }
    if (r == 0) a.pd[(long long)bi * a.D + d] = gd;
  }
}

// out[o, i] = sum over k of in[o, k, i], k in order
__global__ void sum_middle(const float* in, float* out, long long outer, int K, long long inner) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= outer * inner) return;
  const long long o = e / inner, i = e - o * inner;
  const float* p = in + o * K * inner + i;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc += p[k * inner];
  out[e] = acc;
}

int launch_sum(const float* in, float* out, long long outer, int K, long long inner, cudaStream_t st) {
  const long long n = outer * inner;
  if (n == 0) return 0;
  sum_middle<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(in, out, outer, K, inner);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int S>
int launch_ps(const Args& a, int B, cudaStream_t st) {
  constexpr int CPB = NT / P;
  selective_scan_bwd_kernel<P, S><<<dim3((a.D + CPB - 1) / CPB, B), NT, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for u, B, C and gy; dt, A, D and gh are float32. u, dt, B
// and C as selective_scan's (strides in elements, unit last stride), gy (B, L, D) contiguous, gh
// (B, D, N) contiguous or null. Writes gu and gdt (B, L, D), gbc (B, L, 2, N) (gB then gC), ga
// (chips, D, N) and gd (chips, D), all fp32 and contiguous, chips = B / rows. Scratch, fp32: pbc
// (B, L, nw, 2, N), pa (B, D, N), pd (B, D), ckpt (B, nch, D, N), where nw = ceil(D / (128 /
// lanes)) x 4 and nch = ceil(L / 8); the call refuses other nw and nch. lanes x states >= N with
// states = min(8, N rounded up to a power of two) and lanes the fewest powers of two that hold N
// (ops.py::bwd_plan). Returns cudaGetLastError() after the last launch.
extern "C" int selective_scan_bwd(int dtype, const void* u, const void* dt, const void* a, const void* b,
                                  const void* c, const void* d, const void* gy, const void* gh, void* gu,
                                  void* gdt, void* gbc, void* ga, void* gd, void* pbc, void* pa, void* pd,
                                  void* ckpt, int B, int L, int D, int N, int lanes, int states, int nw,
                                  int nch, long long usb, long long ust, long long dtsb, long long dtst,
                                  long long bsb, long long bst, long long csb, long long cst, int rows,
                                  long long sa, long long sd, void* stream) {
  int want_states = 1;
  while (want_states < N && want_states < 8) want_states *= 2;
  int want_lanes = 1;
  while (want_lanes * want_states < N) want_lanes *= 2;
  if (N < 1 || N > NMAX || B < 1 || D < 1 || L < 1 || B > 65535 || (dtype != 0 && dtype != 1) ||
      lanes != want_lanes || states != want_states || rows < 1 || B % rows != 0 || sa < 0 || sd < 0 ||
      nw != (D + NT / lanes - 1) / (NT / lanes) * WARPS || nch != (L + CT - 1) / CT)
    return static_cast<int>(cudaErrorInvalidValue);
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
  args.nw = nw;
  args.nch = nch;
  args.bf16 = dtype;
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
        case 1: err = launch_ps<1, 1>(args, B, st); break;
        case 2: err = launch_ps<1, 2>(args, B, st); break;
        case 4: err = launch_ps<1, 4>(args, B, st); break;
        default: err = launch_ps<1, 8>(args, B, st);
      }
      break;
    case 2: err = launch_ps<2, 8>(args, B, st); break;
    case 4: err = launch_ps<4, 8>(args, B, st); break;
    case 8: err = launch_ps<8, 8>(args, B, st); break;
    case 16: err = launch_ps<16, 8>(args, B, st); break;
    default: err = launch_ps<32, 8>(args, B, st);
  }
  if (err) return err;
  const int chips = B / rows;
  if ((err = launch_sum(args.pbc, static_cast<float*>(gbc), (long long)B * L, nw, 2LL * N, st))) return err;
  if ((err = launch_sum(args.pa, static_cast<float*>(ga), chips, rows, (long long)D * N, st))) return err;
  return launch_sum(args.pd, static_cast<float*>(gd), chips, rows, D, st);
}
