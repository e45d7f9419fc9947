// Fault-masked GEMM for Hopper (sm_90a):  y[M, N] = x[M, K] @ (w[K, N] * ok[k % R, n % C]).
//
// Replaces the TPU kernel src/repro/kernels/masked_matmul/masked_matmul.py::masked_matmul_pallas.
//
// What it computes: the paper's FAP operator. Each block stages an x tile and a w tile in
// shared memory; the w tile is multiplied by the periodic healthy mask while it is staged, so
// no masked copy of w is ever written to device memory (the property the TPU kernel keeps in
// VMEM). The mask is read by modulo from the small (R, C) tensor, so no tile has to divide the
// array period and K = 576 with R = 256 needs no padding. Ragged M/N/K edges are masked here.
//
// w is read through its two strides: a row-major (K, N) weight and the transposed view
// embed.T of a tied unembedding (stride 1 along K) are both taken without a copy.
//
// Bound on the card: at decode (M = batch) the weights dominate and the kernel is bound by
// device-memory bytes; at prefill (M = batch x prompt) it is bound by operations. This first
// version accumulates in fp32 with SIMT FMAs (no tensor cores). The narrow GEMMs of the path
// have few output tiles (9 for a 576-wide one), so a block walking all of K in series is
// latency-bound on a few SMs: K is split across blocks until the grid fills the card, and the
// last slice of each tile sums the fp32 partials in a fixed order, so results do not change
// from run to run. Each block prefetches its next tile into registers while it multiplies the
// current one; small M takes a 16-row tile so decode does not waste 64-row tiles. wgmma and TMA
// are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
masked_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ ok, T* __restrict__ y, int M, int N, int K,
                     long long swk, long long swn, int R, int C, int tiles_per_split,
                     float* __restrict__ part, int* __restrict__ counters) {
  constexpr int TX = BN / TN;          // threads along N
  constexpr int NT = (BM / TM) * TX;   // threads per block
  constexpr int XL = BM * BK / NT;     // x elements each thread stages per tile
  constexpr int WL = BK * BN / NT;     // w elements each thread stages per tile
  static_assert(NT % BK == 0 && NT % BN == 0 && (BM * BK) % NT == 0, "tile/threads");

  // +1 column of padding: the transposed stores below hit distinct banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // Neighbouring threads walk w along its unit-stride axis, so loads coalesce either way.
  // Each thread keeps one coordinate of its staged w elements fixed and steps the other.
  const bool n_contig = (swn == 1);
  const int w_fix = n_contig ? tid % BN : tid % BK;   // nn (n_contig) or kk
  const int w_var = n_contig ? tid / BN : tid / BK;   // first kk (n_contig) or nn
  const int w_step = n_contig ? NT / BN : NT / BK;
  const int n_fix = n0 + w_fix;                       // n_contig: this thread's column
  const int n_fix_c = n_fix % C;

  float xr[XL], wr[WL];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // this block's slice of K: tiles [t_begin, t_begin + nt) of BK rows
  const int t_begin = blockIdx.z * tiles_per_split;
  const int nt = max(0, min((K + BK - 1) / BK - t_begin, tiles_per_split));
  for (int t = 0; t <= nt; ++t) {
    if (t > 0) {
      // stage tile t-1 (already in registers) into shared memory
#pragma unroll
      for (int i = 0; i < XL; ++i) {
        const int idx = tid + i * NT;
        xs[idx % BK][idx / BK] = xr[i];
      }
#pragma unroll
      for (int i = 0; i < WL; ++i) {
        if (n_contig)
          ws[w_var + i * w_step][w_fix] = wr[i];
        else
          ws[w_fix][w_var + i * w_step] = wr[i];
      }
      __syncthreads();
    }
    if (t < nt) {
      // global loads of tile t, in flight while tile t-1 is multiplied below
      const int k0 = (t_begin + t) * BK;
#pragma unroll
      for (int i = 0; i < XL; ++i) {
        const int idx = tid + i * NT;
        const int m = m0 + idx / BK, k = k0 + idx % BK;
        xr[i] = (m < M && k < K) ? to_f(x[(long long)m * K + k]) : 0.f;
      }
      if (n_contig) {
#pragma unroll
        for (int i = 0; i < WL; ++i) {
          const int k = k0 + w_var + i * w_step;
          wr[i] = (k < K && n_fix < N) ? to_f(w[k * swk + n_fix]) * ok[(k % R) * C + n_fix_c] : 0.f;
        }
      } else {
        const int k = k0 + w_fix;
        const float* ok_row = ok + (k % R) * C;
#pragma unroll
        for (int i = 0; i < WL; ++i) {
          const int n = n0 + w_var + i * w_step;
          wr[i] = (k < K && n < N) ? to_f(w[k + n * swn]) * ok_row[n % C] : 0.f;
        }
      }
    }
    if (t > 0) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * (BM / TM);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + j * TX;
        if (n < N) y[(long long)m * N + n] = from_f<T>(acc[i][j]);
      }
    }
    return;
  }

  // split K: every slice writes its fp32 partial tile; the last slice to finish sums all of
  // them in slice order (deterministic) and writes y
  float* my_part = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) my_part[(long long)m * N + n] = acc[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0)
    is_last = atomicAdd(&counters[blockIdx.y * gridDim.x + blockIdx.x], 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      float sum = 0.f;
      for (int z = 0; z < (int)gridDim.z; ++z) sum += __ldcg(part + ((long long)z * M + m) * N + n);
      y[(long long)m * N + n] = from_f<T>(sum);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w, const void* ok, void* y, int M, int N, int K,
           long long swk, long long swn, int R, int C, int splits, char* scratch,
           long long scratch_bytes, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const int ntiles = (K + BK - 1) / BK;
  const int per = (ntiles + splits - 1) / splits;
  // scratch: one int counter per output tile (16-byte aligned), then each slice's partial
  const long long counter_bytes = (4LL * grid.x * grid.y + 15) / 16 * 16;
  int* counters = reinterpret_cast<int*>(scratch);
  float* part = reinterpret_cast<float*>(scratch + counter_bytes);
  if (splits > 1) {
    if (scratch_bytes < counter_bytes + 4LL * splits * M * N)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemsetAsync(counters, 0, 4LL * grid.x * grid.y, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(ok),
      static_cast<T*>(y), M, N, K, swk, swn, R, C, per, part, counters);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* ok, void* y, int M, int N, int K,
             long long swk, long long swn, int R, int C, int splits, char* scratch,
             long long scratch_bytes, cudaStream_t s) {
  // tile shapes; kernels/masked_matmul/ops.py::_TILES mirrors them to size the scratch
  if (M <= 16)  // decode: one 16-row tile covers the batch
    return launch<T, 16, 64, 32, 2, 2>(x, w, ok, y, M, N, K, swk, swn, R, C, splits, scratch,
                                        scratch_bytes, s);
  return launch<T, 64, 64, 16, 4, 4>(x, w, ok, y, M, N, K, swk, swn, R, C, splits, scratch,
                                      scratch_bytes, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it); ok is float32 (R, C) contiguous;
// x is (M, K) contiguous, y is (M, N) contiguous, w is (K, N) with strides (swk, swn), one of
// them 1. splits > 1 cuts K into that many slices, one block each per output tile; it needs
// the caller's scratch: one int per output tile rounded up to 16 bytes, then
// splits * M * N floats. Returns the first CUDA error, or cudaGetLastError() after the launch.
extern "C" int masked_matmul(int dtype, const void* x, const void* w, const void* ok, void* y,
                             int M, int N, int K, long long swk, long long swn, int R, int C,
                             int splits, void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(x, w, ok, y, M, N, K, swk, swn, R, C, splits, sc, scratch_bytes, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, ok, y, M, N, K, swk, swn, R, C, splits, sc,
                                   scratch_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
