// Fault-masked GEMM for Hopper (sm_90a):  y[M, N] = x[M, K] @ (w[K, N] * ok[k % R, n % C]),
// for one chip or for a fleet of chips in one launch: y[c] = x[c] @ (w[c] * ok[c] tiled).
//
// Replaces the TPU kernel src/repro/kernels/masked_matmul/masked_matmul.py::masked_matmul_pallas.
//
// What it computes: the paper's FAP operator. The periodic healthy mask is applied to each weight
// on chip, after the weight is loaded and before it is multiplied, so no masked copy of w is ever
// written to device memory (the property the TPU kernel keeps in VMEM). The mask is taken modulo
// its period, so no tile has to divide it: K = 576 with R = 256 needs no padding. Ragged M/N/K
// edges are masked here. w is read through its two strides: a row-major (K, N) weight and the
// transposed view embed.T of a tied unembedding (stride 1 along K) are both taken in place.
//
// Three kernels; the caller's dtype and M pick one (kernels/masked_matmul/ops.py):
//
// - decode (bf16 x, M <= 16) is bound by the weight bytes. Every thread streams its weights with
//   16-byte loads (8 bf16 or 2 x 4 fp32), several rows in flight, and accumulates M x 8 outputs
//   in fp32 registers. Row-major w: a warp reads 256 neighbouring columns of 8 consecutive rows
//   at a time, with those rows of x; the block's 8 warps split its rows and are summed in shared
//   memory in a fixed order. embed.T: 8 lanes read one column's K run, 4 columns per warp, x from
//   shared memory, summed by shuffles. K is split across blocks to fill one wave of two blocks
//   per SM, and no more: a partial second wave would double the time.
// - mma (bf16 x, M > 16) is bound by operations: 128 x 128 output tiles on the tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 accumulators), k-depth 32, 8 warps of 64 x 32. x tiles come
//   through cp.async into a three-stage ring (or by plain loads where x rows are not 16-byte
//   aligned); w tiles come through registers, because every weight is masked (and an fp32 weight
//   rounded) before it reaches shared memory. x is fetched two k tiles ahead; bf16 w too, into
//   two register sets (fp32 w one tile ahead: a second set of fp32 registers would spill). The
//   grid walks groups of 8 row tiles across the column tiles, so blocks that run together share
//   their w tiles in L2. Both operands reach the tensor cores by ldmatrix (.trans for a
//   row-major w tile) from padded rows, free of bank conflicts.
// - v1 (float32 x and w) runs in fp32 on the SIMT cores, since tensor cores would round fp32 to
//   tf32, which misses the float32 tolerances. Two kernels, picked by M as the bf16 pair is:
//   - M <= 16: the decode kernels above, instantiated for fp32 x and w with no bf16 rounding of w
//     (the masked weight is w times its 0/1 bit, as the plain version multiplies). Bound by the
//     weight bytes: fp32 w in 16-byte loads, 8, 4 or 2 rows in flight at M <= 4, 8 or 16.
//   - M > 16: `tiled`, a register-tiled SIMT kernel bound by operations (67 TFLOP/s FP32).
//     128 x 128 output tiles (64 rows where M <= 64, 64 columns where 128-wide tiles would leave
//     a quarter of their columns empty), 256 threads, each accumulating an 8 x 8 (or 8 x 4, 4 x
//     8, 4 x 4) block. x and w are staged k-major in shared memory, so the inner loop reads each
//     thread's a and b fragments with float4 loads: one LDS.128 per 16 FMAs. The shared ring
//     holds two k tiles of 8: x tile t + 1 goes by cp.async while tile t is multiplied (4-byte
//     copies, which transpose x into its k-major rows and need no alignment beyond a float's;
//     zero-filled past the edge), w tile t + 1 through registers, since each weight is masked
//     before it reaches shared memory. One barrier per k tile. The grid walks groups of 8 row
//     tiles across the column tiles (as mma does), so co-resident blocks share w in L2.
//     Row-major w is read 16 bytes a thread along N; embed.T (k-contiguous) 16 bytes a thread
//     along K, two threads a column, so its loads coalesce too.
//   Both read the mask as bits and use the shared split-K counters, as the bf16 kernels do. v1
//   stays reachable for bf16 x and w by an explicit variant (the same templates), to be timed
//   beside the bf16 kernels.
//
// The bf16 kernels take w in bf16 or in fp32 (the master weights, read in place): each fp32 weight
// is rounded to bf16 in registers (__float2bfloat16_rn, bit for bit what w.to(torch.bfloat16)
// gives) before the mask and the product, so both launches give the same bits. Every kernel reads
// the mask as bits packed once per mask by the wrapper (8 KB for 256 x 256, L1-resident), 1 byte
// per 8 weights instead of 32 bytes of float mask. Where K is split, each slice writes an fp32
// partial and the last slice of each tile sums them in slice order, so results do not change from
// run to run.
//
// A chip axis (the counterpart of the TPU kernel under jax.vmap, whose batching rule adds the
// chip to the kernel's grid): every kernel takes `chips` stacks of x (chips, M, K), w (chip
// stride swc, 0 for a weight shared by every chip), the mask and y (chips, M, N), and folds the
// chip into grid.y. Each chip has its own split-K counters (the tile index counts chips x tiles)
// and its own slices of the scratch, and the plan cuts K for chips x tiles output tiles. One
// launch serves the whole fleet. The same axis carries an MoE layer's experts: w (E, K, N) under
// ONE mask, since every expert GEMM runs on the same chip; the mask's batch stride is then 0, so
// its bits are packed and read once for all experts. Both at once (a fleet's MoE layer): the
// batch axis is chips x E, and a mask group of E has grid entry i read mask i / E, so each chip's
// experts share that chip's bits, packed once a chip. Left for later work: wgmma and TMA (a warp-specialized producer ring) for the mma kernel,
// and a CUDA graph of the decode step, whose small GEMMs are launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// Shared pieces of the kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// The mask bits of 8 neighbouring entries c, c+1, ..., c+7 (each taken modulo ncol) of row r of a
// bit matrix that holds 8 entries per byte, `stride` bytes per row; r and c are already reduced.
// Bit j of the result belongs to entry c + j.
__device__ __forceinline__ uint32_t mask8(const uint8_t* __restrict__ bits, int stride, int ncol,
                                          int r, int c) {
  const uint8_t* row = bits + (long long)r * stride;
  if ((c & 7) == 0 && c + 8 <= ncol) return __ldg(row + (c >> 3));
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int cj = c + j;
    while (cj >= ncol) cj -= ncol;
    m |= ((__ldg(row + (cj >> 3)) >> (cj & 7)) & 1u) << j;
  }
  return m;
}

// The same for 4 entries c, ..., c+3 (one byte read where they share it); bit j is entry c + j.
__device__ __forceinline__ uint32_t mask4(const uint8_t* __restrict__ bits, int stride, int ncol,
                                          int r, int c) {
  const uint8_t* row = bits + (long long)r * stride;
  if ((c & 7) <= 4 && c + 4 <= ncol) return (__ldg(row + (c >> 3)) >> (c & 7)) & 0xFu;
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int cj = c + j;
    while (cj >= ncol) cj -= ncol;
    m |= ((__ldg(row + (cj >> 3)) >> (cj & 7)) & 1u) << j;
  }
  return m;
}

// Eight weights as loaded: one uint4 of bf16, or two uint4 of fp32.
template <typename WT> struct WRaw;
template <> struct WRaw<__nv_bfloat16> { uint4 v[1]; };
template <> struct WRaw<float> { uint4 v[2]; };

template <typename WT>
__device__ __forceinline__ void load_vec(WRaw<WT>& r, const WT* p) {  // 16-byte aligned
#pragma unroll
  for (int i = 0; i < (int)(sizeof(WRaw<WT>) / 16); ++i) r.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

template <typename WT>
__device__ __forceinline__ void load_scalar(WRaw<WT>& r, const WT* p, int count) {  // p[j], j < count
#pragma unroll
  for (int i = 0; i < (int)(sizeof(WRaw<WT>) / 16); ++i) r.v[i] = make_uint4(0, 0, 0, 0);
  WT* e = reinterpret_cast<WT*>(&r.v[0]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < count) e[j] = __ldg(p + j);
}

template <typename WT>
__device__ __forceinline__ void zero(WRaw<WT>& r) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(WRaw<WT>) / 16); ++i) r.v[i] = make_uint4(0, 0, 0, 0);
}

// bf16 pairs of the 8 weights, each rounded to bf16 (a no-op for bf16 w)
__device__ __forceinline__ void to_pairs(const WRaw<__nv_bfloat16>& r, uint32_t (&h)[4]) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(&r.v[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = in[i];
}
__device__ __forceinline__ void to_pairs(const WRaw<float>& r, uint32_t (&h)[4]) {
  const float* f = reinterpret_cast<const float*>(&r.v[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = bits_of(__floats2bfloat162_rn(f[2 * i], f[2 * i + 1]));
}

// The 8 weights as the GEMM multiplies them: rounded to bf16, times their 0/1 mask bits (a bf16
// product, exact: v * 1 = v, v * 0 = +-0), as 4 bf16x2 words.
template <typename WT>
__device__ __forceinline__ uint4 masked8(const WRaw<WT>& r, uint32_t m) {
  uint32_t h[4];
  to_pairs(r, h);
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = (m >> (2 * i)) & 3u;
    const uint32_t mp = (b & 1u) * 0x3F80u + (b >> 1) * 0x3F800000u;  // bf16 1.0 or 0.0, twice
    o[i] = bits_of(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&h[i]),
                           *reinterpret_cast<const __nv_bfloat162*>(&mp)));
  }
  return out;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// The 8 weights as a kernel with x of type XT multiplies them, in fp32 registers: with bf16 x
// rounded to bf16 and masked as above; with fp32 x (v1) the fp32 weights times their 0/1 bits,
// unrounded, as the plain version multiplies them (a NaN or inf weight under a 0 bit gives NaN).
template <typename XT, typename WT>
__device__ __forceinline__ void weights8(const WRaw<WT>& r, uint32_t m, float (&f)[8]) {
  if constexpr (std::is_same<XT, float>::value) {
    static_assert(std::is_same<WT, float>::value, "fp32 x takes fp32 w");
    const float* v = reinterpret_cast<const float*>(&r.v[0]);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = v[j] * static_cast<float>((m >> j) & 1u);
  } else {
    unpack8(masked8(r, m), f);
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Split K: every slice has stored its fp32 partial of the block's outputs (rows m0.., `rows`,
// columns n0.., `cols`) at part[(z * M + m) * N + n]. The last slice to finish sums the partials
// in slice order, so the result does not depend on which slice finished last, and writes y. The
// merge is a tail on one SM, bound by L2 latency, so its threads keep many loads in flight (float4
// loads where the columns allow). The tile's
// counter is left at 0 for the next launch, so the caller zeroes the counters once, not per
// launch. grid.y is the chip: `part` is the chip's own, and the counter index counts chips x
// tiles.
template <typename TY>
__device__ void merge_splits(const float* part, int* counters, TY* y, int M, int N, int m0,
                             int rows, int n0, int cols) {
  __shared__ int is_last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile], 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int Z = gridDim.z, T = blockDim.x;
  const long long zs = (long long)M * N;
  const int vw = (cols % 4 == 0 && n0 % 4 == 0 && N % 4 == 0) ? 4 : 1;  // outputs per load
  const int total = rows * cols / vw;
  // E outputs x ZB slices of loads in flight per thread: 4 x 4, or 1 x 16 where a thread has
  // one output (a decode tile's M x 256)
  auto run = [&](auto e_, auto zb_) {
    constexpr int E = decltype(e_)::value, ZB = decltype(zb_)::value;
    for (int base = threadIdx.x; base < total; base += E * T) {
      long long o[E];
      bool in[E];
      float4 sum[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = (base + e * T) * vw;
        const int m = m0 + i / cols, n = n0 + i % cols;
        in[e] = base + e * T < total && m < M && n < N;
        o[e] = in[e] ? (long long)m * N + n : 0;
        sum[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int z = 0; z < Z; z += ZB) {
        float4 v[E][ZB];
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int j = 0; j < ZB; ++j) {
            const bool ld = in[e] && z + j < Z;
            const float* p = part + o[e] + (z + j) * zs;
            v[e][j] = !ld ? make_float4(0.f, 0.f, 0.f, 0.f)
                    : vw == 4 ? __ldcg(reinterpret_cast<const float4*>(p))
                              : make_float4(__ldcg(p), 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int j = 0; j < ZB; ++j) {
            sum[e].x += v[e][j].x;
            sum[e].y += v[e][j].y;
            sum[e].z += v[e][j].z;
            sum[e].w += v[e][j].w;
          }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!in[e]) continue;
        if (vw == 4)
          store4(y + o[e], sum[e]);
        else
          y[o[e]] = from_f<TY>(sum[e].x);
      }
    }
  };
  if (total <= T)
    run(std::integral_constant<int, 1>{}, std::integral_constant<int, 16>{});
  else
    run(std::integral_constant<int, 4>{}, std::integral_constant<int, 4>{});
  if (threadIdx.x == 0) counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// decode: M <= 16, bound by the weight bytes
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_KQ = 64;           // K granule of the split plan
constexpr int DEC_MAX_SPLITS = 32;  // the last block of a tile merges every slice's partial serially
// rows of x the k-contiguous kernel stages in shared memory at a time: 16 KB of fp32, so a slice
// of up to 1024 rows (M <= 4) stages its x once
template <int MT> __host__ __device__ constexpr int dec_kc() { return 4096 / MT; }
// consecutive rows of row-major w a warp takes per step: with bf16 x 8 at M <= 4 (128 bytes of bf16
// a thread in flight, 256 of fp32), 4 above; with fp32 x (v1) 4 at every M (128 bytes of fp32 w
// in flight; U rows of fp32 x per m sit in registers too), so the rows a warp sums, and the bits
// of y, do not depend on M: a checksummed launch (M + 1 rows) repeats the payload's bits
template <typename XT, int MT> __host__ __device__ constexpr int dec_rows_u() {
  return std::is_same<XT, float>::value ? 4 : (MT > 4 ? 4 : 8);
}
// U values of x, loaded as one piece where aligned
template <int BYTES>
__device__ __forceinline__ void load_bytes(void* dst, const void* src) {
  if constexpr (BYTES == 32) {
    reinterpret_cast<uint4*>(dst)[0] = __ldg(reinterpret_cast<const uint4*>(src));
    reinterpret_cast<uint4*>(dst)[1] = __ldg(reinterpret_cast<const uint4*>(src) + 1);
  } else if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    static_assert(BYTES == 8, "x pieces of 8, 16 or 32 bytes");
    *reinterpret_cast<uint2*>(dst) = __ldg(reinterpret_cast<const uint2*>(src));
  }
}
constexpr int DEC_BN_ROWS = 256;  // columns per block, row-major w: 32 lanes x 8
constexpr int DEC_BN_COLS = 32;   // columns per block, k-contiguous w: 8 warps x 4

// Row-major w (K, N), unit stride along N. Each step, warp `warp` takes U consecutive rows of
// its slice (rows warp * U + 8U s, ...) and lane `lane` columns n0 .. n0 + 7 of them: a thread
// keeps U rows of w in flight (dec_rows_u), with the same U rows of x, loaded by every lane of
// the warp from one address. U is the same for both w dtypes under bf16 x, so both sum in the
// same order. No shared memory is staged before the loads; the 8 warps' sums meet in shared
// memory once, at the end. XT is x's and y's type: bf16, or fp32 for v1.
template <typename XT, typename WT, int MT>
__global__ void __launch_bounds__(DEC_THREADS, MT > 4 ? 1 : 2)
decode_rows_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                   const uint8_t* __restrict__ bits, XT* __restrict__ y, int M, int N,
                   int K, long long swk, long long swc, long long sbm, int mgroup, int R, int C, int cbytes,
                   int rows_per_split, int vec, int x_aligned, float* __restrict__ part,
                   int* __restrict__ counters) {
  constexpr int U = dec_rows_u<XT, MT>();  // consecutive rows per step
  const int chip = blockIdx.y;
  x += (long long)chip * M * K;
  w += chip * swc;
  bits += (long long)(chip / mgroup) * sbm;
  y += (long long)chip * M * N;
  part += (long long)chip * gridDim.z * M * N;
  __shared__ __align__(16) float red[MT * 8 * 32];  // [m][j][lane]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = blockIdx.x * DEC_BN_ROWS;
  const int n0 = nb + lane * 8;
  const int ncount = min(8, N - n0);  // <= 0: no column of this lane
  const bool vload = vec && ncount == 8;
  const bool xload = x_aligned && K % U == 0;  // U values of an x row in one load
  const int cmask = n0 % C;
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  if (ncount > 0) {
    int rr = (k_begin + warp * U) % R;  // mask row of row k0
    for (int k0 = k_begin + warp * U; k0 < k_end; k0 += 8 * U) {
      WRaw<WT> raw[U];
      uint32_t msk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // issue the loads of U rows before using any
        int ru = rr + u;
        if (ru >= R) ru %= R;
        if (k0 + u < k_end) {
          const WT* p = w + (long long)(k0 + u) * swk + n0;
          if (vload)
            load_vec(raw[u], p);
          else
            load_scalar(raw[u], p, ncount);
          msk[u] = mask8(bits, cbytes, C, ru, cmask);
        } else {
          zero(raw[u]);
          msk[u] = 0;
        }
      }
      struct alignas(16) XRow { XT v[U]; } xr[MT];  // x[m, k0 .. k0 + U)
      const int kc = min(U, k_end - k0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const XT* xp = x + (long long)m * K + k0;
        if (m < M && xload && kc == U) {
          load_bytes<U * (int)sizeof(XT)>(xr[m].v, xp);
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) xr[m].v[u] = m < M && u < kc ? xp[u] : from_f<XT>(0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= kc) break;
        float wf[8];
        weights8<XT>(raw[u], msk[u], wf);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xm = to_f(xr[m].v[u]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xm, wf[j], acc[m][j]);
        }
      }
      rr += 8 * U;
      if (rr >= R) rr %= R;
    }
  }

  // the 8 warps' partial sums, added in a fixed order: warp 7 first, then 6, ..., 0
  for (int src = 7; src >= 0; --src) {
    if (warp == src) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* r = red + (m * 8 + j) * 32 + lane;
          *r = (src == 7 ? 0.f : *r) + acc[m][j];
        }
    }
    __syncthreads();
  }
  const int n = nb + threadIdx.x;
  const float* mine = red + (threadIdx.x & 7) * 32 + (threadIdx.x >> 3);  // column nb + threadIdx.x
  if (gridDim.z == 1) {
    if (n < N)
      for (int m = 0; m < M; ++m) y[(long long)m * N + n] = from_f<XT>(mine[m * 8 * 32]);
    return;
  }
  float* my = part + (long long)blockIdx.z * M * N;
  if (n < N)
    for (int m = 0; m < M; ++m) my[(long long)m * N + n] = mine[m * 8 * 32];
  merge_splits(part, counters, y, M, N, 0, M, nb, DEC_BN_ROWS);
}

// k-contiguous w (the tied unembedding's embed.T), unit stride along K. Each group of 8 lanes
// takes one column and reads its K run 128 bytes at a time; a warp takes 4 columns. x is staged
// in shared memory as fp32 whatever its type (16 KB), DEC_KC rows of K at a time.
template <typename XT, typename WT, int MT>
__global__ void __launch_bounds__(DEC_THREADS, MT > 4 ? 1 : 2)
decode_cols_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                   const uint8_t* __restrict__ bits_t, XT* __restrict__ y, int M, int N,
                   int K, long long swn, long long swc, long long sbm, int mgroup, int R, int C, int rbytes,
                   int rows_per_split, int vec, float* __restrict__ part,
                   int* __restrict__ counters) {
  constexpr int U = MT > 4 ? 2 : 128 / (int)sizeof(WRaw<WT>);  // 128 bytes of w in flight at M <= 4
  const int chip = blockIdx.y;
  x += (long long)chip * M * K;
  w += chip * swc;
  bits_t += (long long)(chip / mgroup) * sbm;
  y += (long long)chip * M * N;
  part += (long long)chip * gridDim.z * M * N;
  constexpr int DEC_KC = dec_kc<MT>();
  __shared__ __align__(16) float xs[MT * DEC_KC];  // [m][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane & 7;
  const int nb = blockIdx.x * DEC_BN_COLS;
  const int n = nb + warp * 4 + (lane >> 3);
  const int cmask = n % C;  // the row of the transposed bit matrix
  const int k_begin = blockIdx.z * rows_per_split;
  const int k_end = min(K, k_begin + rows_per_split);

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += DEC_KC) {
    const int rows = min(DEC_KC, k_end - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * DEC_KC; i += DEC_THREADS) {
      const int m = i / DEC_KC, kk = i % DEC_KC;
      xs[i] = (m < M && kk < rows) ? to_f(x[(long long)m * K + kc + kk]) : 0.f;
    }
    __syncthreads();
    if (n >= N) continue;
    int rk = (kc + sub * 8) % R;  // mask column of k = kc + kk
    for (int kk = sub * 8; kk < rows; kk += 64 * U) {
      WRaw<WT> raw[U];
      uint32_t msk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + 64 * u;
        int ru = rk + 64 * u;
        if (ru >= R) ru %= R;
        if (k < rows) {
          const int cnt = min(8, rows - k);
          const WT* p = w + (long long)n * swn + kc + k;
          if (vec && cnt == 8)
            load_vec(raw[u], p);
          else
            load_scalar(raw[u], p, cnt);
          msk[u] = mask8(bits_t, rbytes, R, cmask, ru);
        } else {
          zero(raw[u]);
          msk[u] = 0;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + 64 * u;
        if (k >= rows) break;
        float wf[8];
        weights8<XT>(raw[u], msk[u], wf);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 a = *reinterpret_cast<const float4*>(xs + m * DEC_KC + k);
          const float4 b = *reinterpret_cast<const float4*>(xs + m * DEC_KC + k + 4);
          float s = acc[m];
          s = fmaf(a.x, wf[0], s); s = fmaf(a.y, wf[1], s); s = fmaf(a.z, wf[2], s); s = fmaf(a.w, wf[3], s);
          s = fmaf(b.x, wf[4], s); s = fmaf(b.y, wf[5], s); s = fmaf(b.z, wf[6], s); s = fmaf(b.w, wf[7], s);
          acc[m] = s;
        }
      }
      rk += 64 * U;
      if (rk >= R) rk %= R;
    }
  }
  // the 8 lanes of a column, summed by a fixed butterfly
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 1);
    acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 2);
    acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 4);
  }
  const bool writer = sub == 0 && n < N;
  if (gridDim.z == 1) {
    if (writer)
      for (int m = 0; m < M; ++m) y[(long long)m * N + n] = from_f<XT>(acc[m]);
    return;
  }
  if (writer) {
    float* my = part + (long long)blockIdx.z * M * N;
    for (int m = 0; m < M; ++m) my[(long long)m * N + n] = acc[m];
  }
  merge_splits(part, counters, y, M, N, 0, M, nb, DEC_BN_COLS);
}

// ---------------------------------------------------------------------------
// mma: M > 16, tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 128, MMA_BN = 128, MMA_BK = 32, MMA_THREADS = 256;
constexpr int MMA_CH = MMA_BM * MMA_BK / 8 / MMA_THREADS;  // 8-element chunks per thread per tile
constexpr int MMA_ALD = MMA_BK + 8;  // a row of an x tile [m][k] or a k-contiguous w tile [n][k]
constexpr int MMA_BLD = MMA_BN + 8;  // a row of a row-major w tile [k][n]
constexpr int MMA_A_STAGES = 3;      // x tiles: t (read), t + 1 (landed), t + 2 (in flight)
constexpr int MMA_GROUP_M = 8;       // row tiles per raster group
constexpr int MMA_MIN_TILES = 4;     // k tiles a slice holds at least, where K is split
constexpr int MMA_A_ELEMS = MMA_BM * MMA_ALD;
template <bool KCONTIG> __host__ __device__ constexpr int mma_b_elems() { return KCONTIG ? MMA_BN * MMA_ALD : MMA_BK * MMA_BLD; }
template <bool KCONTIG> __host__ __device__ constexpr int mma_smem_bytes() {
  return 2 * (MMA_A_STAGES * MMA_A_ELEMS + 2 * mma_b_elems<KCONTIG>());
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// one 4-byte element (zero-filled where src_bytes is 0); 4-byte copies go through L1 (.ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

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

// wstride: swk for row-major w, swn for k-contiguous w. bits is the (R, C) bit matrix for
// row-major w and the transposed (C, R) one for k-contiguous w, bstride bytes per row.
//
// Pipeline, per k tile t: x tile t + 2 goes by cp.async into a three-stage ring; w tile t + D
// goes into registers; the MMAs of tile t run; w tile t + 1 is masked, rounded and stored into
// the other of two shared-memory w stages. D = 2 for bf16 w (two register sets: a tile's loads
// have two tiles of MMAs to land), 1 for fp32 w, whose second set would spill. One barrier per
// k tile.
template <typename WT, bool KCONTIG>
__global__ void __launch_bounds__(MMA_THREADS, 2)
mma_kernel(const __nv_bfloat16* __restrict__ x, const WT* __restrict__ w,
           const uint8_t* __restrict__ bits, __nv_bfloat16* __restrict__ y, int M, int N, int K,
           long long wstride, long long swc, long long sbm, int mgroup, int R, int C, int bstride,
           int tiles_per_split, int x_async, int w_vec, float* __restrict__ part,
           int* __restrict__ counters) {
  constexpr int BT = mma_b_elems<KCONTIG>();
  const int chip = blockIdx.y;
  x += (long long)chip * M * K;
  w += chip * swc;
  bits += (long long)(chip / mgroup) * sbm;
  y += (long long)chip * M * N;
  part += (long long)chip * gridDim.z * M * N;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* const As = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [3][BM * ALD]
  __nv_bfloat16* const Bs = As + MMA_A_STAGES * MMA_A_ELEMS;             // [2][BT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, each 64 x 32 of the output tile
  // Grouped raster: blockIdx.x walks groups of MMA_GROUP_M row tiles, each group across all
  // column tiles with its row tiles fastest, so the blocks that run together share their w tiles
  // (read from device memory once, then from L2) and a few x row tiles.
  const int m_tiles = (M + MMA_BM - 1) / MMA_BM, n_tiles = (N + MMA_BN - 1) / MMA_BN;
  const int group = blockIdx.x / (MMA_GROUP_M * n_tiles), first_m = group * MMA_GROUP_M;
  const int group_m = min(m_tiles - first_m, MMA_GROUP_M);
  const int in_group = blockIdx.x % (MMA_GROUP_M * n_tiles);
  const int m0 = (first_m + in_group % group_m) * MMA_BM, n0 = in_group / group_m * MMA_BN;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int nt = max(0, min((K + MMA_BK - 1) / MMA_BK - t_begin, tiles_per_split));

  // This thread's MMA_CH 8-element chunks of each tile (KC = BK / 8 chunks per k run, NC = BN / 8
  // per row). x: chunk c is row c / KC, k (c % KC) * 8. Row-major w: k row c / NC, columns
  // (c % NC) * 8; k-contiguous w: column c / KC, k (c % KC) * 8.
  constexpr int KC = MMA_BK / 8, NC = MMA_BN / 8;
  int a_row[MMA_CH], a_k[MMA_CH], w_k[MMA_CH], w_n[MMA_CH], m_fix[MMA_CH], m_var[MMA_CH];
#pragma unroll
  for (int i = 0; i < MMA_CH; ++i) {
    const int c = tid + i * MMA_THREADS;
    a_row[i] = c / KC;
    a_k[i] = (c % KC) * 8;
    w_k[i] = KCONTIG ? (c % KC) * 8 : c / NC;
    w_n[i] = KCONTIG ? c / KC : (c % NC) * 8;
    m_fix[i] = (n0 + w_n[i]) % C;                // the mask column, fixed per thread
    m_var[i] = (t_begin * MMA_BK + w_k[i]) % R;  // the mask row of the next w tile loaded
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  constexpr int D = sizeof(WT) == 2 && MMA_CH == 2 ? 2 : 1;  // w prefetch distance in k tiles
  WRaw<WT> wraw[D][MMA_CH];  // [set][chunk]
  uint32_t wmask[D][MMA_CH];

  // x tile t into ring stage `stage`: by cp.async, or (rows not 16-byte aligned) by plain loads
  auto load_x = [&](int t, int stage) {
    const int k0 = t * MMA_BK;
#pragma unroll
    for (int i = 0; i < MMA_CH; ++i) {
      const int m = m0 + a_row[i], k = k0 + a_k[i];
      __nv_bfloat16* dst = As + stage * MMA_A_ELEMS + a_row[i] * MMA_ALD + a_k[i];
      if (x_async) {
        const bool in = m < M && k < K;
        cp_async16(dst, in ? x + (long long)m * K + k : x, in ? 16 : 0);
      } else {
        uint4 v = make_uint4(0, 0, 0, 0);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
        if (m < M) {
          const int cnt = min(8, K - k);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < cnt) e[j] = x[(long long)m * K + k + j];
        }
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
  };
  // w tile t into register set P, with its mask bits
  auto load_w = [&](int t, auto set) {
    constexpr int P = decltype(set)::value;
    const int k0 = t * MMA_BK;
#pragma unroll
    for (int i = 0; i < MMA_CH; ++i) {
      const int k = k0 + w_k[i], n = n0 + w_n[i];
      if (KCONTIG) {
        const int cnt = min(8, K - k);
        if (n < N && cnt > 0) {
          const WT* p = w + (long long)n * wstride + k;
          if (w_vec && cnt == 8) load_vec(wraw[P][i], p); else load_scalar(wraw[P][i], p, cnt);
        } else {
          zero(wraw[P][i]);
        }
        wmask[P][i] = mask8(bits, bstride, R, m_fix[i], m_var[i]);
      } else {
        const int cnt = min(8, N - n);
        if (k < K && cnt > 0) {
          const WT* p = w + (long long)k * wstride + n;
          if (w_vec && cnt == 8) load_vec(wraw[P][i], p); else load_scalar(wraw[P][i], p, cnt);
        } else {
          zero(wraw[P][i]);
        }
        wmask[P][i] = mask8(bits, bstride, C, m_var[i], m_fix[i]);
      }
      m_var[i] += MMA_BK;
      if (m_var[i] >= R) m_var[i] %= R;
    }
  };
  // register set P, masked and rounded, into w stage `stage`
  auto store_w = [&](auto set, int stage) {
    constexpr int P = decltype(set)::value;
#pragma unroll
    for (int i = 0; i < MMA_CH; ++i) {
      const int off = KCONTIG ? w_n[i] * MMA_ALD + w_k[i] : w_k[i] * MMA_BLD + w_n[i];
      *reinterpret_cast<uint4*>(Bs + stage * BT + off) = masked8(wraw[P][i], wmask[P][i]);
    }
  };
  auto compute = [&](int a_stage, int b_stage) {
    const __nv_bfloat16* as = As + a_stage * MMA_A_ELEMS;
    const __nv_bfloat16* bs = Bs + b_stage * BT;
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        if (KCONTIG)
          ldsm_x4(r, bs + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * MMA_ALD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(r, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * MMA_BLD + wn * 32 +
                           np * 16 + (lane >> 4) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        ldsm_x4(af, as + (wm * 64 + mi * 16 + (lane & 15)) * MMA_ALD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
      }
    }
  };
  // one k tile; P = t % D is the register set of w tiles t and t + D; w stages alternate
  using S0 = std::integral_constant<int, 0>;
  using S1 = std::integral_constant<int, D - 1>;  // set 1 with D = 2, set 0 with D = 1
  auto step = [&](int t, auto set) {
    constexpr int P = decltype(set)::value;
    cp_async_wait1();
    __syncthreads();  // x tile t landed, w tile t stored; every warp is done with tile t - 1
    if (t + 2 < nt) load_x(t_begin + t + 2, (t + 2) % MMA_A_STAGES);
    if (t + D < nt) load_w(t_begin + t + D, set);
    cp_async_commit();  // one group per step, empty or not
    compute(t % MMA_A_STAGES, t & 1);
    if (t + 1 < nt) store_w(std::integral_constant<int, (P + 1) % D>{}, (t + 1) & 1);
  };

  if (nt > 0) {
    load_x(t_begin, 0);
    load_w(t_begin, S0{});
  }
  cp_async_commit();
  if (nt > 1) {
    load_x(t_begin + 1, 1);
    if (D == 2) load_w(t_begin + 1, S1{});
  }
  cp_async_commit();
  if (nt > 0) store_w(S0{}, 0);
  for (int t = 0; t < nt; t += 2) {
    step(t, S0{});
    if (t + 1 < nt) step(t + 1, S1{});
  }

  // accumulator (mi, ni, e): row wm*64 + mi*16 + lane/4 (+8 for e >= 2), column wn*32 + ni*8 +
  // 2*(lane%4) + e%2
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (N & 1) == 0;
  const bool split = gridDim.z > 1;
  float* my = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
        const int n = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (m >= M || n >= N) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        const long long o = (long long)m * N + n;
        if (split) {
          if (pairs) {
            *reinterpret_cast<float2*>(my + o) = make_float2(v0, v1);
          } else {
            my[o] = v0;
            if (n + 1 < N) my[o + 1] = v1;
          }
        } else if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(y + o) = __floats2bfloat162_rn(v0, v1);
        } else {
          y[o] = __float2bfloat16(v0);
          if (n + 1 < N) y[o + 1] = __float2bfloat16(v1);
        }
      }
  if (split) merge_splits(part, counters, y, M, N, m0, MMA_BM, n0, MMA_BN);
}

// ---------------------------------------------------------------------------
// tiled: v1 at M > 16, register-tiled SIMT FP32
// ---------------------------------------------------------------------------

constexpr int TL_THREADS = 256;
constexpr int TL_BK = 8;              // k depth of a tile
constexpr int TL_MIN_BLOCKS = 2;      // blocks an SM holds: 128 registers a thread
constexpr int TL_GROUP_M = 8;     // row tiles per raster group
constexpr int TL_MIN_TILES = 8;   // k tiles (64 rows of K) a slice holds at least, where K is split

// v1's tile at M > 16: 64 rows where M <= 64, else 128; 96 columns where N is a multiple of 96
// but not of 128 (SmolLM's 576 and 192: no column tile half empty), else 64 where 128-wide
// tiles would leave a quarter or more of their columns empty, else 128.
// kernels/masked_matmul/ops.py::_v1_tiles mirrors it for the plan.
void tiled_shape(int M, int N, int* bm, int* bn) {
  *bm = M <= 64 ? 64 : 128;
  const int n128 = (N + 127) / 128 * 128;
  *bn = N % 96 == 0 && N % 128 != 0 ? 96 : 4 * (n128 - N) >= n128 ? 64 : 128;
}

// The BM x BN tile's threads each own TM x TN outputs (TM = BM / 16, TN = BN / 16): thread (tx,
// ty) = (tid % 16, tid / 16) rows ty * 4 + 64 i + (0..3) and columns tx * 4 + 64 j + (0..3), and
// at BN = 96 also 64 + 2 tx + (0, 1), so each k step reads its a and b fragments from the k-major
// tiles with float4 loads (one float2), a half-warp reading 2 and 16 distinct addresses, free of
// bank conflicts. (Warps of 2-D sub-tiles, fp32 x through registers, no fragment prefetch, k
// depths 4 and 16 and 8 x 16 outputs a thread measured no faster, tools/f32_kernels_probe.py.)
// x tile [k][m]: fp32 by cp.async, element i of a thread at k tid % BK, row tid / BK + (256 / BK)
// i (a warp reads whole 32-byte row runs; rows padded to BM + 4, so the transposing copies spread
// over the banks); bf16 through registers in 4-k chunks. w tile [k][n]: 4-element
// chunks, row-major at k row c / (BN / 4), columns (c % (BN / 4)) * 4; k-contiguous at column
// c / (BK / 4), k rows (c % (BK / 4)) * 4 .. + 3. bits is the (R, C) bit matrix for row-major w
// and the transposed (C, R) one for embed.T. WHOLE: every w chunk is whole and 16-byte aligned
// and its 4 mask bits sit in one byte (the launch checks), so the loop carries no scalar fallback
// (the generic instance's branches cost 6-7% of the time, tools/f32_kernels_probe.py).
template <typename T, int BM, int BN, bool WHOLE>
__global__ void __launch_bounds__(TL_THREADS, TL_MIN_BLOCKS)
tiled_kernel(const T* __restrict__ x, const T* __restrict__ w, const uint8_t* __restrict__ bits,
             T* __restrict__ y, int M, int N, int K, long long swk, long long swn, long long swc,
             long long sbm, int mgroup, int R, int C, int bstride, int splits, int split_tiles, int tiles_per_split,
             int w_vec, int x_vec, float* __restrict__ part, int* __restrict__ counters) {
  constexpr int BK = TL_BK, TM = BM / 16, TN = BN / 16;
  // a thread's columns: TN4 float4 runs, then (BN = 96) one float2 run at 64 + 2 (tid % 16)
  constexpr int TN4 = TN / 4, TN2 = TN % 4 / 2;
  static_assert(TN % 4 == 0 || TN == 6, "column runs of 4, or 4 + 2");
  constexpr int LDA = BM + 4, LDB = BN + 4;
  constexpr int XL = BM * BK / TL_THREADS;                             // x elements (cp.async)
  constexpr int XC = (BM * BK / 4 + TL_THREADS - 1) / TL_THREADS;      // x chunks (registers)
  constexpr int WC = (BK * BN / 4 + TL_THREADS - 1) / TL_THREADS;      // w chunks a thread
  __shared__ __align__(16) float As[2][BK][LDA];
  __shared__ __align__(16) float Bs[2][BK][LDB];
  const bool kcontig = swn != 1;
  const int chip = blockIdx.y;
  x += (long long)chip * M * K;
  w += chip * swc;
  bits += (long long)(chip / mgroup) * sbm;
  y += (long long)chip * M * N;
  part += (long long)chip * split_tiles * splits * BM * BN;
  const int tid = threadIdx.x;
  // this thread's first row and column; its float4 runs are 64 apart
  constexpr int RS = 64, CS = 64;
  const int row0 = (tid >> 4) * 4, col0 = (tid & 15) * 4, col2 = 64 * TN4 + (tid & 15) * 2;
  // The chip's tiles run whole but its last split_tiles, which are cut into `splits` K slices
  // each: block x of the first tiles - split_tiles is that tile, the rest slice x % splits of
  // the tile after them. The tiles walk a grouped raster, as in mma_kernel.
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int whole = m_tiles * n_tiles - split_tiles;
  int tile = blockIdx.x, z = 0, nz = 1;
  if (tile >= whole) {
    z = (tile - whole) % splits;
    tile = whole + (tile - whole) / splits;
    nz = splits;
  }
  const int group = tile / (TL_GROUP_M * n_tiles), first_m = group * TL_GROUP_M;
  const int group_m = min(m_tiles - first_m, TL_GROUP_M);
  const int in_group = tile % (TL_GROUP_M * n_tiles);
  const int m0 = (first_m + in_group % group_m) * BM, n0 = in_group / group_m * BN;
  const int t_begin = z * tiles_per_split, tiles_k = (K + BK - 1) / BK;
  const int nt = nz == 1 ? tiles_k : max(0, min(tiles_k - t_begin, tiles_per_split));

  int wk[WC], wn[WC], m_fix[WC], m_var[WC];
#pragma unroll
  for (int i = 0; i < WC; ++i) {
    const int c = tid + i * TL_THREADS;
    wk[i] = kcontig ? (c % (BK / 4)) * 4 : c / (BN / 4);
    wn[i] = kcontig ? c / (BK / 4) : (c % (BN / 4)) * 4;
    m_fix[i] = (n0 + wn[i]) % C;              // the mask column (row of bits_t), fixed
    m_var[i] = (t_begin * BK + wk[i]) % R;    // the mask row of the next w tile loaded
  }
  float wr[WC][4], xr[XC][4];
  uint32_t wmask[WC];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // 4 elements of a row of T at p (cnt of them valid), into fp32 registers
  auto load4 = [&](float (&r)[4], const T* p, int cnt, bool vec) {
    if (cnt == 4 && vec) {
      if constexpr (std::is_same<T, float>::value) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
        r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = j < cnt ? to_f(__ldg(p + j)) : 0.f;
    }
  };
  auto load_x = [&](int t, int stage) {
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < XC; ++i) {
        const int c = tid + i * TL_THREADS;
        if (c >= BM * BK / 4) break;
        const int row = c / (BK / 4), m = m0 + row, k = t * BK + (c % (BK / 4)) * 4;
        load4(xr[i], x + (long long)m * K + k, m < M ? max(0, min(4, K - k)) : 0, x_vec);
      }
    } else {
#pragma unroll
      for (int i = 0; i < XL; ++i) {
        const int kk = tid % BK, row = tid / BK + (TL_THREADS / BK) * i, m = m0 + row;
        const int k = t * BK + kk;
        const bool in = m < M && k < K;
        cp_async4(&As[stage][kk][row], in ? x + (long long)m * K + k : x, in ? 4 : 0);
      }
    }
  };
  auto store_x = [&](int stage) {
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < XC; ++i) {
        const int c = tid + i * TL_THREADS;
        if (c >= BM * BK / 4) break;
        const int row = c / (BK / 4), kq = (c % (BK / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) As[stage][kq + j][row] = xr[i][j];
      }
    }
  };
  auto load_w = [&](int t) {
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      if (tid + i * TL_THREADS >= BK * BN / 4) break;
      const int k = t * BK + wk[i], n = n0 + wn[i];
      const int cnt = max(0, min(4, kcontig ? K - k : N - n));
      const bool in = kcontig ? n < N : k < K;
      const T* p = kcontig ? w + (long long)n * swn + k : w + (long long)k * swk + n;
      const int r = kcontig ? m_fix[i] : m_var[i], c = kcontig ? m_var[i] : m_fix[i];
      if constexpr (WHOLE) {
        if (in && cnt == 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(p));
          wr[i][0] = v.x; wr[i][1] = v.y; wr[i][2] = v.z; wr[i][3] = v.w;
        } else {
          wr[i][0] = wr[i][1] = wr[i][2] = wr[i][3] = 0.f;
        }
        wmask[i] = (__ldg(bits + (long long)r * bstride + (c >> 3)) >> (c & 7)) & 0xFu;
      } else {
        load4(wr[i], p, in ? cnt : 0, w_vec);
        wmask[i] = mask4(bits, bstride, kcontig ? R : C, r, c);
      }
      m_var[i] += BK;
      if (m_var[i] >= R) m_var[i] %= R;
    }
  };
  // the registers' tile, masked (w times its 0/1 bit, as the plain version), into stage `stage`
  auto store_w = [&](int stage) {
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      if (tid + i * TL_THREADS >= BK * BN / 4) break;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = wr[i][j] * static_cast<float>((wmask[i] >> j) & 1u);
      if (kcontig) {
#pragma unroll
        for (int j = 0; j < 4; ++j) Bs[stage][wk[i] + j][wn[i]] = v[j];
      } else {
        *reinterpret_cast<float4*>(&Bs[stage][wk[i]][wn[i]]) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // this thread's a and b fragments of k step kk
  auto frag = [&](int stage, int kk, float (&a)[TM], float (&b)[TN]) {
#pragma unroll
    for (int i = 0; i < TM / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(&As[stage][kk][row0 + RS * i]);
      a[4 * i] = v.x; a[4 * i + 1] = v.y; a[4 * i + 2] = v.z; a[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < TN4; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(&Bs[stage][kk][col0 + CS * j]);
      b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
    }
    if constexpr (TN2 > 0) {
      const float2 v = *reinterpret_cast<const float2*>(&Bs[stage][kk][col2]);
      b[4 * TN4] = v.x; b[4 * TN4 + 1] = v.y;
    }
  };
  auto compute = [&](int stage) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      frag(stage, kk, a, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  // k tile t: its x copies and w stores were made during tile t - 1; the barrier makes them
  // visible and frees the other stage, into which tile t + 1 goes while t is multiplied
  if (nt > 0) {
    load_x(t_begin, 0);
    load_w(t_begin);
  }
  cp_async_commit();
  if (nt > 0) {
    store_x(0);
    store_w(0);
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait0();
    __syncthreads();
    if (t + 1 < nt) {
      load_x(t_begin + t + 1, (t + 1) & 1);
      load_w(t_begin + t + 1);
    }
    cp_async_commit();
    compute(t & 1);
    if (t + 1 < nt) {
      store_x((t + 1) & 1);
      store_w((t + 1) & 1);
    }
  }

  // a whole tile writes y; a slice writes its fp32 partial tile [BM][BN], and the last slice of
  // the tile to finish sums the partials in slice order (the same bits whichever finished last)
  // and writes y, leaving the tile's counter at 0 for the next launch
  // a run of w (4 or 2) outputs at (m, n): vector stores where N lets every run align
  float* const tile_part = part + (long long)(tile - whole) * splits * BM * BN;
  auto put = [&](int m, int n, float4 v, int w) {
    const long long o = (long long)m * N + n;
    if (N % w == 0) {
      if (w == 4) store4(y + o, v); else store2(y + o, make_float2(v.x, v.y));
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int c = 0; c < w && n + c < N; ++c) y[o + c] = from_f<T>(e[c]);
    }
  };
  auto part_at = [&](int q, int r, int c) { return tile_part + (long long)q * BM * BN + r * BN + c; };
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + RS * (i / 4) + i % 4;
    if (m0 + r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN4 + TN2; ++j) {
      const int c = j < TN4 ? col0 + CS * j : col2, w = j < TN4 ? 4 : 2;
      if (n0 + c >= N) continue;
      const float4 v = make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][min(4 * j + 2, TN - 1)],
                                   acc[i][min(4 * j + 3, TN - 1)]);  // a float2 run stores .x, .y
      if (nz == 1)
        put(m0 + r, n0 + c, v, w);
      else if (w == 4)
        store4(part_at(z, r, c), v);
      else
        store2(part_at(z, r, c), make_float2(v.x, v.y));
    }
  }
  if (nz == 1) return;
  __shared__ int is_last;
  const int ctr = chip * m_tiles * n_tiles + tile;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[ctr], 1) == nz - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + RS * (i / 4) + i % 4;
    if (m0 + r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN4 + TN2; ++j) {
      const int c = j < TN4 ? col0 + CS * j : col2, w = j < TN4 ? 4 : 2;
      if (n0 + c >= N) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < nz; ++q) {
        if (w == 4) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(part_at(q, r, c)));
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        } else {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(part_at(q, r, c)));
          sum.x += v.x; sum.y += v.y;
        }
      }
      put(m0 + r, n0 + c, sum, w);
    }
  }
  if (tid == 0) counters[ctr] = 0;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Scratch of a split launch: chips * splits * M * N floats of partials where K is split; the
// counters are the caller's, zero, one per output tile of every chip, and are left at zero.
int check_split(int chips, int splits, long long tiles_out, int M, int N, long long scratch_bytes,
                int counters_len) {
  if (splits == 1) return 0;
  if (scratch_bytes < 4LL * chips * splits * M * N || counters_len < chips * tiles_out)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// At most `want` slices of tiles_k k tiles, none of them empty.
int split_count(int tiles_k, int want) {
  want = std::min(want, tiles_k);
  if (want <= 1) return 1;
  const int per = (tiles_k + want - 1) / want;
  return (tiles_k + per - 1) / per;
}

// The bf16 kernels' plan: K slices and output tiles (per chip). Both keep the grid of chips x
// tiles x slices within one wave of two blocks per SM (a second, partial wave would double the
// time), so a fleet's launch splits K less than one chip's. decode cuts K into whole DEC_KQ-row
// granules, at most DEC_MAX_SPLITS slices; mma gives each slice at least MMA_MIN_TILES k tiles.
// v1's plan, the same rules for its decode and tiled kernels, is kernels/masked_matmul/ops.py::
// _split_plan; the launches below check its scratch and counters.
void plan(int variant, int chips, int M, int N, int K, bool kcontig, int sms, int* splits,
          int* tiles_out) {
  if (variant == 2) {
    const int bn = kcontig ? DEC_BN_COLS : DEC_BN_ROWS;
    *tiles_out = (N + bn - 1) / bn;
    *splits = split_count(std::max(1, (K + DEC_KQ - 1) / DEC_KQ),
                          std::min(DEC_MAX_SPLITS, std::max(1, 2 * sms / (chips * *tiles_out))));
  } else {
    *tiles_out = ((M + MMA_BM - 1) / MMA_BM) * ((N + MMA_BN - 1) / MMA_BN);
    const int tiles_k = std::max(1, (K + MMA_BK - 1) / MMA_BK);
    *splits = split_count(tiles_k, std::min(tiles_k / MMA_MIN_TILES, 2 * sms / (chips * *tiles_out)));
  }
}

// XT is x's and y's type (bf16, or fp32 for v1), WT w's
template <typename XT, typename WT>
int launch_decode(int chips, const void* x, const void* w, const uint8_t* bits, const uint8_t* bits_t,
                  void* y, int M, int N, int K, long long swk, long long swn, long long swc, int R,
                  int C, int mask_group, int splits, float* part, long long scratch_bytes,
                  int* counters, int counters_len, cudaStream_t s) {
  if (M > 16) return static_cast<int>(cudaErrorInvalidValue);
  const bool kcontig = swn != 1;
  const int bn = kcontig ? DEC_BN_COLS : DEC_BN_ROWS;
  const dim3 grid((N + bn - 1) / bn, chips, splits);
  const int tiles_k = (K + DEC_KQ - 1) / DEC_KQ;
  const int rows = (tiles_k + splits - 1) / splits * DEC_KQ;
  if (int err = check_split(chips, splits, grid.x, M, N, scratch_bytes, counters_len)) return err;
  const long long unit = 16 / sizeof(WT);
  const auto* xt = static_cast<const XT*>(x);
  const auto* wt = static_cast<const WT*>(w);
  auto* yt = static_cast<XT*>(y);
  // the instance by M: 4 and 16 rows, and 8 for fp32 x, whose rows of x take registers too
  constexpr bool f32 = std::is_same<XT, float>::value;
  const int mt = M <= 4 ? 4 : (f32 && M <= 8) ? 8 : 16;
  if (kcontig) {
    const int vec = aligned16(w) && swn % unit == 0 && swc % unit == 0;
    const int rbytes = (R + 7) / 8;
    auto go = [&](auto mt_) {
      constexpr int MT = decltype(mt_)::value;
      decode_cols_kernel<XT, WT, MT><<<grid, DEC_THREADS, 0, s>>>(
          xt, wt, bits_t, yt, M, N, K, swn, swc, (long long)(mask_group != 0) * C * rbytes,
          std::max(mask_group, 1), R, C, rbytes, rows,
          vec, part, counters);
    };
    if (mt == 4) go(std::integral_constant<int, 4>{});
    else if (f32 && mt == 8) go(std::integral_constant<int, f32 ? 8 : 16>{});
    else go(std::integral_constant<int, 16>{});
  } else {
    const int vec = aligned16(w) && swk % unit == 0 && swc % unit == 0;
    const int cbytes = (C + 7) / 8;
    // every chip's x rows 16-byte aligned
    const int xa = aligned16(x) && (chips == 1 || (long long)M * K * sizeof(XT) % 16 == 0);
    auto go = [&](auto mt_) {
      constexpr int MT = decltype(mt_)::value;
      decode_rows_kernel<XT, WT, MT><<<grid, DEC_THREADS, 0, s>>>(
          xt, wt, bits, yt, M, N, K, swk, swc, (long long)(mask_group != 0) * R * cbytes,
          std::max(mask_group, 1), R, C, cbytes, rows,
          vec, xa, part, counters);
    };
    if (mt == 4) go(std::integral_constant<int, 4>{});
    else if (f32 && mt == 8) go(std::integral_constant<int, f32 ? 8 : 16>{});
    else go(std::integral_constant<int, 16>{});
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int BN>
int launch_tiled_shape(int chips, const T* x, const T* w, const uint8_t* bits, const uint8_t* bits_t,
                       T* y, int M, int N, int K, long long swk, long long swn, long long swc, int R,
                       int C, int mask_group, int splits, int split_tiles, float* part,
                       long long scratch_bytes, int* counters, int counters_len, cudaStream_t s) {
  const bool kcontig = swn != 1;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (splits == 1) split_tiles = 0;
  if (split_tiles < 0 || split_tiles > tiles) return static_cast<int>(cudaErrorInvalidValue);
  // every chip's split tiles' partial tiles, and one counter per tile of every chip
  if (split_tiles > 0 && (scratch_bytes < 4LL * chips * split_tiles * splits * BM * BN ||
                          counters_len < (long long)chips * tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles - split_tiles + split_tiles * splits, chips);
  const int tiles_k = (K + TL_BK - 1) / TL_BK;
  const int per = (tiles_k + splits - 1) / splits;
  // a w chunk is 4 elements: one load where every chunk is aligned to its size
  const long long stride = kcontig ? swn : swk;
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T))) == 0 && stride % 4 == 0 &&
                    swc % 4 == 0;
  // fp32 w whose 4-element chunks are all whole (N, or K for embed.T, a multiple of 4) and
  // aligned, with a mask period whose 4-bit runs never straddle a byte or wrap
  const bool whole = std::is_same<T, float>::value && w_vec && (kcontig ? K % 4 == 0 && R % 4 == 0
                                                                        : N % 4 == 0 && C % 4 == 0);
  auto kern = whole ? tiled_kernel<T, BM, BN, std::is_same<T, float>::value>
                    : tiled_kernel<T, BM, BN, false>;
  const int bstride = kcontig ? (R + 7) / 8 : (C + 7) / 8;
  kern<<<grid, TL_THREADS, 0, s>>>(
      x, w, kcontig ? bits_t : bits, y, M, N, K, swk, swn, swc,
      (long long)(mask_group != 0) * (kcontig ? C : R) * bstride, std::max(mask_group, 1), R, C,
      bstride, splits, split_tiles, per,
      w_vec, aligned16(x) && K % 4 == 0, part, counters);
  return static_cast<int>(cudaGetLastError());
}

// v1 (x and w of one type T): the decode kernels at M <= 16, the tiled kernel above
template <typename T>
int launch_v1(int chips, const void* x, const void* w, const uint8_t* bits, const uint8_t* bits_t,
              void* y, int M, int N, int K, long long swk, long long swn, long long swc, int R, int C,
              int mask_group, int splits, int split_tiles, float* part, long long scratch_bytes,
              int* counters, int counters_len, cudaStream_t s) {
  if (M <= 16)
    return launch_decode<T, T>(chips, x, w, bits, bits_t, y, M, N, K, swk, swn, swc, R, C,
                               mask_group, splits, part, scratch_bytes, counters, counters_len, s);
  int bm, bn;
  tiled_shape(M, N, &bm, &bn);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  auto* yt = static_cast<T*>(y);
#define V1_TILED(BM_, BN_)                                                                         \
  if (bm == BM_ && bn == BN_)                                                                      \
    return launch_tiled_shape<T, BM_, BN_>(chips, xt, wt, bits, bits_t, yt, M, N, K, swk, swn, swc, \
                                           R, C, mask_group, splits, split_tiles, part,            \
                                           scratch_bytes, counters, counters_len, s);
  V1_TILED(128, 128)
  V1_TILED(128, 96)
  V1_TILED(128, 64)
  V1_TILED(64, 128)
  V1_TILED(64, 96)
  V1_TILED(64, 64)
#undef V1_TILED
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename WT, bool KCONTIG>
int launch_mma_layout(dim3 grid, const __nv_bfloat16* x, const WT* w, const uint8_t* bits,
                      __nv_bfloat16* y, int M, int N, int K, long long wstride, long long swc,
                      int mask_group, int R, int C, int bstride, int per, int x_async, int w_vec,
                      float* part, int* counters, cudaStream_t s) {
  constexpr int smem = mma_smem_bytes<KCONTIG>();
  // above 48 KB only after this attribute is set (on the current device)
  const cudaError_t err = cudaFuncSetAttribute(mma_kernel<WT, KCONTIG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_kernel<WT, KCONTIG><<<grid, MMA_THREADS, smem, s>>>(
      x, w, bits, y, M, N, K, wstride, swc, (long long)(mask_group != 0) * (KCONTIG ? C : R) * bstride,
      std::max(mask_group, 1), R, C,
      bstride, per, x_async, w_vec, part, counters);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int launch_mma(int chips, const void* x, const void* w, const uint8_t* bits, const uint8_t* bits_t,
               void* y, int M, int N, int K, long long swk, long long swn, long long swc, int R,
               int C, int mask_group, int splits, float* part, long long scratch_bytes, int* counters,
               int counters_len, cudaStream_t s) {
  const bool kcontig = swn != 1;
  const dim3 grid(((M + MMA_BM - 1) / MMA_BM) * ((N + MMA_BN - 1) / MMA_BN), chips, splits);
  const int tiles_k = (K + MMA_BK - 1) / MMA_BK;
  const int per = (tiles_k + splits - 1) / splits;
  if (int err = check_split(chips, splits, grid.x, M, N, scratch_bytes, counters_len))
    return err;
  const long long unit = 16 / sizeof(WT);
  const int x_async = aligned16(x) && K % 8 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wt = static_cast<const WT*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (kcontig)
    return launch_mma_layout<WT, true>(grid, xb, wt, bits_t, yb, M, N, K, swn, swc, mask_group, R, C, (R + 7) / 8,
                                       per, x_async, aligned16(w) && swn % unit == 0 && swc % unit == 0,
                                       part, counters, s);
  return launch_mma_layout<WT, false>(grid, xb, wt, bits, yb, M, N, K, swk, swc, mask_group, R, C, (C + 7) / 8,
                                      per, x_async, aligned16(w) && swk % unit == 0 && swc % unit == 0,
                                      part, counters, s);
}

}  // namespace

// The launch plan of a bf16 kernel (variant 2 = decode, 3 = mma) for `chips` stacks of x (M, K)
// and w (K, N), w k-contiguous (embed.T) or not, on a card of `sms` SMs: out[0] = K slices,
// out[1] = the scratch bytes a launch needs (every chip's slices' fp32 partials; 0 for one
// slice), out[2] = output tiles of all chips, the split-K counters it needs. The kernels' tiles
// and split rules live here alone.
extern "C" int masked_matmul_plan(int variant, int chips, int M, int N, int K, int kcontig, int sms,
                                  long long* out) {
  if ((variant != 2 && variant != 3) || chips < 1 || M < 1 || N < 1 || K < 1 || sms < 1 ||
      (variant == 2 && M > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int splits = 1, tiles_out = 1;
  plan(variant, chips, M, N, K, kcontig != 0, sms, &splits, &tiles_out);
  out[0] = splits;
  out[1] = splits == 1 ? 0 : 4LL * chips * splits * M * N;
  out[2] = (long long)chips * tiles_out;
  return 0;
}

// variant: 1 = v1 (x and w share the dtype xdtype), 2 = decode (M <= 16), 3 = mma; 2 and 3 take
// bf16 x and w in bf16 or float32. Dtypes: 0 = float32, 1 = bfloat16. `chips` >= 1 stacks run in
// one launch. The 0/1 mask comes as bits: bits packs each chip's (R, C) mask 8 entries per byte
// along C ((chips, R, ceil(C/8)) bytes), bits_t the same of each transposed mask ((chips, C,
// ceil(R/8)) bytes), for k-contiguous w. x is (chips, M, K) contiguous, y is (chips, M, N)
// contiguous in x's dtype, w[c] is (K, N) with strides (swk, swn), one of them 1, and chip c's
// starts swc elements after chip c - 1's (0: one w for every chip). mask_group g >= 1 gives each
// group of g consecutive chips its own mask, grid chip c reading mask c / g (bits holds chips / g
// of them): a group of 1 is a mask per chip, a group of E a fleet's chips x experts, each chip's
// E experts under that chip's one mask. mask_group 0 gives every batch entry the one mask bits
// holds (the MoE experts of one chip).
// splits > 1 cuts K into that many slices, one block each per output tile, and needs the
// caller's scratch, chips * splits * M * N floats (v1 at M > 16: only each chip's last
// split_tiles tiles are cut, and the scratch
// holds their chips * split_tiles * splits partial tiles), and `counters`, at least one zero int
// per output tile of every chip (counters_len of them), which the kernels leave at zero, so
// launches that share them must run one at a time: the wrapper keeps one buffer per stream.
// masked_matmul_plan gives the bf16 kernels' splits and sizes, ops.py::_split_plan v1's.
// Returns the first CUDA error, or cudaGetLastError() after the launch.
extern "C" int masked_matmul(int variant, int xdtype, int wdtype, int chips, const void* x,
                             const void* w, const void* bits, const void* bits_t, void* y, int M,
                             int N, int K, long long swk, long long swn, long long swc, int R, int C,
                             int mask_group, int splits, int split_tiles,
                             void* scratch, long long scratch_bytes, void* counters, int counters_len,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || chips < 1 || chips > 65535 || (swk != 1 && swn != 1) ||
      mask_group < 0 || (mask_group && chips % mask_group != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* b = static_cast<const uint8_t*>(bits);
  const auto* bt = static_cast<const uint8_t*>(bits_t);
  float* part = static_cast<float*>(scratch);
  int* cnt = static_cast<int*>(counters);
  const int g = mask_group;
  if (variant == 1) {
    if (xdtype != wdtype) return static_cast<int>(cudaErrorInvalidValue);
    if (xdtype == 0)
      return launch_v1<float>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R, C, g, splits,
                              split_tiles, part, scratch_bytes, cnt, counters_len, s);
    if (xdtype == 1)
      return launch_v1<__nv_bfloat16>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R, C, g, splits,
                                      split_tiles, part, scratch_bytes, cnt, counters_len, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (xdtype != 1 || (wdtype != 0 && wdtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 2)
    return wdtype == 1
               ? launch_decode<__nv_bfloat16, __nv_bfloat16>(chips, x, w, b, bt, y, M, N, K, swk, swn,
                                                             swc, R, C, g, splits, part, scratch_bytes,
                                                             cnt, counters_len, s)
               : launch_decode<__nv_bfloat16, float>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R,
                                                     C, g, splits, part, scratch_bytes, cnt,
                                                     counters_len, s);
  if (variant == 3)
    return wdtype == 1
               ? launch_mma<__nv_bfloat16>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R, C, g,
                                           splits, part, scratch_bytes, cnt, counters_len, s)
               : launch_mma<float>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R, C, g, splits,
                                   part, scratch_bytes, cnt, counters_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
