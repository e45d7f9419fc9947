// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py::selective_scan_pallas.
//
// What it computes, per batch row b and channel d, with h (N states) starting at zero:
//   h_t = exp(dt[b, t, d] * A[d, :]) * h_{t-1} + (dt[b, t, d] * u[b, t, d]) * B[b, t, :]
//   y[b, t, d] = <C[b, t, :], h_t> + D[d] * u[b, t, d]
// and h_last[b, d, :] = h_{L-1}. The recurrence runs in fp32 with the precise expf (not
// __expf); y is written in u's dtype, h_last in fp32.
//
// Design: the TPU kernel carries h in VMEM scratch from one L-chunk grid step to the next,
// relying on the grid running in order. Blocks on this card run in no order, so the whole L
// loop lives inside one block and nothing is carried or reduced across blocks. One thread owns
// one (batch, channel) pair and keeps its N <= 16 states and its row of A in registers. A block
// covers 128 neighbouring channels of one batch row. For each chunk of 32 time steps it stages
// B_t and C_t (shared by all its channels) and its own channels' u and dt in shared memory,
// issuing every load of the chunk before the first one is used, then runs the recurrence on the
// chunk. Loads and the y stores coalesce: neighbouring threads touch neighbouring channels.
// u, dt, B and C are read through their (batch, time) strides with a unit channel stride, so
// the B and C slices of the x_proj output need no copy. Ragged D is masked here: no padding.
//
// Bound on the card: each input is read once and y written once, so bytes bound it at short L
// and narrow D (4 x 128 x 8192 x 16 with bf16 u moves about 36 MB: about 11 us at 3.35 TB/s).
// Each (b, t, d, n) costs one expf on the special-function units, which can bound it instead at
// long L (1.07 G exps at 4 x 2048 x 8192 x 16). This first version takes neither bound head on:
// at 4 x 8192 channels the grid is 256 blocks of 128 threads, about two blocks (8 warps) on
// each of the 132 SMs, far below the 64 warps an SM can hold, so the latency of each time
// step's serial chain is exposed. Splitting the N states of a channel over several threads,
// or more channels per SM, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;    // channels (threads) per block
constexpr int CL = 32;     // time steps staged per chunk
constexpr int NMAX = 16;   // most states per channel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, t;  // the channel (or state) stride is 1
};

template <typename T>
__global__ void __launch_bounds__(NT)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm, const float* __restrict__ dskip,
                      T* __restrict__ y, float* __restrict__ h_last, int L, int D, int N,
                      Strides us, Strides dts, Strides bs, Strides cs) {
  __shared__ float u_s[CL][NT];
  __shared__ float dt_s[CL][NT];
  __shared__ float b_s[CL][NMAX];
  __shared__ float c_s[CL][NMAX];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int d = blockIdx.x * NT + tid;
  const bool ok = d < D;

  float av[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    av[n] = (ok && n < N) ? a[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dsk = ok ? dskip[d] : 0.f;

  const T* up = u + bi * us.b + d;
  const float* dtp = dt + bi * dts.b + d;
  const T* bp = bm + bi * bs.b;
  const T* cp = cm + bi * cs.b;
  T* yp = y + (long long)bi * L * D + d;

  for (int t0 = 0; t0 < L; t0 += CL) {
    const int cl = min(CL, L - t0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < cl * N; e += NT) {
      const int j = e / N, n = e % N;
      b_s[j][n] = to_f(bp[(long long)(t0 + j) * bs.t + n]);
      c_s[j][n] = to_f(cp[(long long)(t0 + j) * cs.t + n]);
    }
    for (int j = 0; j < cl; ++j) {
      u_s[j][tid] = ok ? to_f(up[(long long)(t0 + j) * us.t]) : 0.f;
      dt_s[j][tid] = ok ? dtp[(long long)(t0 + j) * dts.t] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < cl; ++j) {
      const float ut = u_s[j][tid], dtt = dt_s[j][tid];
      const float du = dtt * ut;
      float yt = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          h[n] = expf(dtt * av[n]) * h[n] + du * b_s[j][n];
          yt += h[n] * c_s[j][n];
        }
      }
      if (ok) yp[(long long)(t0 + j) * D] = from_f<T>(yt + dsk * ut);
    }
  }
  if (ok) {
    float* hp = h_last + ((long long)bi * D + d) * N;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) hp[n] = h[n];
  }
}

template <typename T>
void launch(const void* u, const float* dt, const float* a, const void* b, const void* c,
            const float* d, void* y, float* h_last, int B, int L, int D, int N, Strides us,
            Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  dim3 grid((D + NT - 1) / NT, B);
  selective_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(u), dt, a, static_cast<const T*>(b), static_cast<const T*>(c), d,
      static_cast<T*>(y), h_last, L, D, N, us, dts, bs, cs);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for u, B, C and y alike; dt, A, D and h_last are float32.
// u and dt (B, L, D), B and C (B, L, N) are addressed by (batch, time) strides with a unit last
// stride; A (D, N), D (D,), y (B, L, D) and h_last (B, D, N) are contiguous. 1 <= N <= 16.
// Returns cudaGetLastError() after the launch.
extern "C" int selective_scan(int dtype, const void* u, const void* dt, const void* a,
                              const void* b, const void* c, const void* d, void* y,
                              void* h_last, int B, int L, int D, int N,
                              long long usb, long long ust, long long dtsb, long long dtst,
                              long long bsb, long long bst, long long csb, long long cst,
                              void* stream) {
  if (N < 1 || N > NMAX || B < 1 || D < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides us{usb, ust}, dts{dtsb, dtst}, bs{bsb, bst}, cs{csb, cst};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(d);
  float* hf = static_cast<float*>(h_last);
  if (dtype == 0)
    launch<float>(u, dtf, af, b, c, df, y, hf, B, L, D, N, us, dts, bs, cs, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(u, dtf, af, b, c, df, y, hf, B, L, D, N, us, dts, bs, cs, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
