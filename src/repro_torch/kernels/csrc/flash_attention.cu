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
// Design: one block per (b * Hq + h, 64-row q tile). The block walks kv tiles of 64 keys that
// it stages in shared memory, and skips every tile that the causal and window masks exclude
// for all of its rows, so those tiles are never read. Each query row belongs to four
// neighbouring threads that split the head dimension (interleaved, so shared-memory reads hit
// distinct banks) and reduce their partial dot products with warp shuffles; scores, the running
// max and the running sum stay in fp32 registers. The kv head is h // (Hq / Hkv): K and V are
// never repeated per query head. q, k, v and o are taken through their batch/head/sequence
// strides, so the caller's (B, S, H, D) projections need no copy. Ragged edges are masked here:
// no padding of q or kv.
//
// Bound on the card: at prefill lengths the QK^T and PV products bound it by operations. This
// first version multiplies with SIMT FMAs, not tensor cores; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int TPR = 4;    // threads per query row
constexpr int BKV = 64;   // keys per staged kv tile
constexpr int NT = BQ * TPR;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;  // the last (head-dim) stride is 1
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
                       int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       int causal, int window, int q_offset) {
  constexpr int DP = D / TPR;  // head dims per thread
  __shared__ float k_s[BKV][D];
  __shared__ float v_s[BKV][D];

  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int row_abs = q_offset + qi;

  const T* qp = q + b * qs.b + h * qs.h + (long long)qi * qs.s;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_ok ? to_f(qp[i * TPR + part]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  // kv range any row of this block can keep
  const int lo = q_offset + q0;
  const int hi = q_offset + min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, lo - window + 1) : 0;

  for (int t0 = (kv_begin / BKV) * BKV; t0 < kv_end; t0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < BKV * D / NT; ++i) {
      const int e = tid + i * NT;
      const int j = e / D, d = e % D;
      const bool in = t0 + j < Skv;
      k_s[j][d] = in ? to_f(kp[(long long)(t0 + j) * ks.s + d]) : 0.f;
      v_s[j][d] = in ? to_f(vp[(long long)(t0 + j) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[BKV];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], k_s[j][i * TPR + part], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = t0 + j;
      const bool keep = row_ok && col < Skv && (!causal || col <= row_abs) &&
                        (window <= 0 || col > row_abs - window);
      s[j] = keep ? dot : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m_run, m_tile);
    if (m_new == -INFINITY) continue;  // this row has kept no key yet
    const float alpha = expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_new);
      l_run += p;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(p, v_s[j][i * TPR + part], acc[i]);
    }
    m_run = m_new;
  }

  if (row_ok) {
    T* op = o + b * os.b + h * os.h + (long long)qi * os.s;
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[i * TPR + part] = from_f<T>(acc[i] * inv);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
            int Skv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
            int window, int q_offset, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<T, 64><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window, q_offset);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and o alike. Layouts (B, H, S, D) addressed by
// (batch, head, sequence) strides with a unit head-dim stride; only D = 64 is built.
// window <= 0 means no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                               int B, int Hq, int Hkv, int Sq, int Skv, int D,
                               long long qsb, long long qsh, long long qss,
                               long long ksb, long long ksh, long long kss,
                               long long vsb, long long vsh, long long vss,
                               long long osb, long long osh, long long oss,
                               float scale, int causal, int window, int q_offset, void* stream) {
  if (D != 64 || Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  if (dtype == 0)
    launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window,
                  q_offset, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os, scale, causal, window,
                          q_offset, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
