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
// - decode (bf16 x, M <= 16) is bound by the weight bytes. A block of 288 threads takes one column
//   tile (256 columns of row-major w, 32 of embed.T) over one K slice. Its producer warp's lane 0
//   keeps a shared-memory ring of stages (16 rows of the tile, or 128 k of each column: 16 KB of
//   fp32 w, or 8 KB of bf16, and x's bf16 rows; as many stages as fit 104 KB) filled by TMA, one
//   dense box of w and one of x a stage, each completing on the stage's mbarrier. The boxes are
//   large because the copy unit's cost is by request: 1-D bulk copies of 1 KB runs held one block
//   to 15 GB/s (PERF.md §6). The maps are cached on the host by pointer and shape, so a
//   weight's are encoded once, not per launch. Eight consumer warps read the raw weights from the
//   stage, round them to bf16, mask them and multiply them into M x 8 (row-major) or M (embed.T)
//   fp32 sums a thread; M picks an instance of 4, 8 or 16 rows, so M = 8 computes 8. Two blocks
//   an SM at M <= 8 hold about 200 KB in flight, far over the 25 KB that DRAM's latency (about
//   1 us) asks for at 3.35 TB/s over 132 SMs. K is split over a thread-block cluster of up to 16
//   blocks a tile (8 beyond 3 tiles), as many slices as two blocks an SM over ONE entry's tiles
//   ask for (never the chip or expert count, never M); the slices meet in distributed shared
//   memory, summed in rank order: no scratch, no counters, no fence. The grid is not persistent:
//   (tiles x slices, entries), one cluster a tile; where the entries' tiles pass one wave
//   (mixtral's 8 experts x 64 tiles x 4 slices = 2,048 blocks on 132 SMs at two an SM, 7.8
//   waves) the hardware starts each cluster as SMs free, so the last wave's empty share is under
//   a sixth of one wave's time. A w whose runs start off 16 bytes (hymba-1.5b's untied head,
//   32,001 fp32 columns; a bf16 w of N = 132), which TMA refuses, is copied run by run by 1-D
//   bulk copies (cp.async.bulk) from the 16-byte boundary below and read at each run's offset;
//   a granule past the operand's last byte is never read (its elements are loaded one by one).
//   An x TMA refuses (K = 100) is written by the producer's lanes. The wrapper names the routes
//   in last_loads.
// - mma (bf16 x, M > 16): wgmma with the masked weight as the register operand, fed by a TMA
//   ring. Each output tile is computed transposed, y^T = (w * mask)^T x^T: 128 weight columns,
//   split over two consumer warpgroups of 64 (wgmma's M), by 128 or 256 tokens (its N, so
//   M = 160 is one tile and each weight is read once). A producer warpgroup's first thread keeps
//   a ring of stages (an x tile of 64 k and the raw w tile, fp32 or bf16 as stored, both in TMA's
//   128-byte swizzle; as many as fit 200 KB) filled by cp.async.bulk.tensor, each completing on
//   the stage's mbarrier. A consumer thread reads its two columns' raw weights from the stage
//   (conflict-free LDS under the swizzle), rounds them to bf16, multiplies them by their 0/1 mask
//   bits and packs them straight into wgmma's A fragment: the masked weight never reaches shared
//   or device memory. x is wgmma's B from shared memory (K-major, the natural layout of x's
//   rows). Fragments of two k steps are prepared, then their wgmmas issued as one group; the next
//   group's are prepared while it runs (two register sets), and a stage is released once the
//   group after its last has been issued. Each thread's weight columns are fixed, so its mask
//   bits come as one 64-bit word a k tile per column from the transposed bit matrix (one load
//   where R is a multiple of 64, bit by bit otherwise), a tile ahead.
//   The grid is persistent, one block an SM: each walks work items (chip, tile, K slice) so one
//   item's epilogue overlaps the next one's loads. The tiles' traffic into shared memory binds
//   it (PERF.md, PR 31): 256-token tiles move the fewest bytes a product, so K is cut only where
//   the tiles leave half the card idle. An operand TMA refuses (a base or row stride not a
//   multiple of 16 bytes, as at K = 100) is copied by the producer warpgroup into the same
//   swizzled layout, fenced for the async proxy: the same kernel, named in the wrapper's
//   last_loads. TMA maps are encoded per launch (cuTensorMapEncodeTiled, found through the
//   runtime's driver entry point, so nothing but the runtime is linked).
// - v1 (float32 x and w) runs in fp32 on the SIMT cores, since tensor cores would round fp32 to
//   tf32, which misses the float32 tolerances. Two kernels, picked by M as the bf16 pair is:
//   - M <= 16: decode_rows_kernel and decode_cols_kernel, streaming kernels without a ring: every
//     thread streams its weights with 16-byte loads (2 x 4 fp32), several rows in flight, and
//     accumulates M x 8 outputs in fp32 registers; the block's 8 warps are summed in shared memory
//     in a fixed order, and K is split across blocks through fp32 partials to fill one wave of two
//     blocks per SM. Instantiated for fp32 x and w with no bf16 rounding of w (the masked weight
//     is w times its 0/1 bit, as the plain version multiplies): 8, 4 or 2 rows in flight at
//     M <= 4, 8 or 16. (An explicit v1 on bf16 x and w runs their bf16 instances.)
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
// is rounded to bf16 in registers (round to nearest even, bit for bit what w.to(torch.bfloat16)
// gives) before the mask and the product, so both launches give the same bits. Every kernel reads
// the mask as bits packed once per mask by the wrapper (8 KB for 256 x 256, L1-resident), 1 byte
// per 8 weights instead of 32 bytes of float mask (mma: the transposed bits, by weight column).
// Where mma or v1 split K, each slice writes an fp32 partial and the last slice of each tile sums
// them in slice order; decode sums its slices in its cluster in rank order. So results do not
// change from run to run.
//
// A chip axis (the counterpart of the TPU kernel under jax.vmap, whose batching rule adds the
// chip to the kernel's grid): every kernel takes `chips` stacks of x (chips, M, K), w (chip
// stride swc, 0 for a weight shared by every chip), the mask and y (chips, M, N), and folds the
// chip into grid.y. Each chip has its own split-K counters (the tile index counts chips x tiles)
// and its own slices of the scratch; the bf16 plans cut K as one chip's launch would, so a chip's
// rows of a batched launch have the bits of its own launch. One launch serves the whole fleet. The same axis carries an MoE layer's experts: w (E, K, N) under
// ONE mask, since every expert GEMM runs on the same chip; the mask's batch stride is then 0, so
// its bits are packed and read once for all experts. Both at once (a fleet's MoE layer): the
// batch axis is chips x E, and a mask group of E has grid entry i read mask i / E, so each chip's
// experts share that chip's bits, packed once a chip. The persistent mma kernel takes the axis
// into its work items in place of grid.y. A decode launch allocates nothing and touches no
// counter, so a CUDA graph of the decode step can capture it as it is. (TMA multicast of each w tile to a cluster of two blocks on
// neighbouring token tiles was built and ran slower: PERF.md, PR 31.)
#include <cuda.h>  // CUtensorMap and its enums; the driver's encoder is found at run time
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
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
// loads where the columns allow). The tile's counter (counters[ctr], one a tile of every chip) is
// left at 0 for the next launch, so the caller zeroes the counters once, not per launch. `part`
// is the chip's own. The T threads tid = 0 .. T - 1 take part, `sync` is their barrier and
// `is_last` a shared int of theirs.
template <typename TY, typename Sync>
__device__ void merge_partials(const float* part, int* counters, int ctr, int Z, TY* y, int M, int N,
                               int m0, int rows, int n0, int cols, int tid, int T, Sync sync,
                               int* is_last) {
  __threadfence();
  sync();
  if (tid == 0) *is_last = atomicAdd(&counters[ctr], 1) == Z - 1;
  sync();
  if (!*is_last) return;
  __threadfence();
  const long long zs = (long long)M * N;
  const int vw = (cols % 4 == 0 && n0 % 4 == 0 && N % 4 == 0) ? 4 : 1;  // outputs per load
  const int total = rows * cols / vw;
  // E outputs x ZB slices of loads in flight per thread: 4 x 4, or 1 x 16 where a thread has
  // one output (a decode tile's M x 256)
  auto run = [&](auto e_, auto zb_) {
    constexpr int E = decltype(e_)::value, ZB = decltype(zb_)::value;
    for (int base = tid; base < total; base += E * T) {
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
  if (tid == 0) counters[ctr] = 0;
}

// merge_partials for the decode kernels: the whole block takes part; grid.y is the chip, grid.z
// the slice, and the counter index counts chips x tiles.
template <typename TY>
__device__ void merge_splits(const float* part, int* counters, TY* y, int M, int N, int m0,
                             int rows, int n0, int cols) {
  __shared__ int is_last;
  merge_partials(part, counters, blockIdx.y * gridDim.x + blockIdx.x, gridDim.z, y, M, N, m0, rows, n0,
                 cols, threadIdx.x, blockDim.x, [] { __syncthreads(); }, &is_last);
}

// ---------------------------------------------------------------------------
// v1 at M <= 16: the streaming kernels, bound by the weight bytes (the bf16 decode kernel is below)
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_KQ = 64;           // K granule of the split plan
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
// mma: M > 16, tensor cores (wgmma with the masked weight in registers, a TMA-fed ring)
// ---------------------------------------------------------------------------

constexpr int MMA_BN = 128;          // weight columns (y's N) a block: two consumer warpgroups of 64
constexpr int MMA_BK = 64;           // k depth of a stage: 128 bytes of bf16 x, the swizzle's span
constexpr int MMA_CONSUMERS = 256;   // two warpgroups
constexpr int MMA_PRODUCERS = 128;   // and the producer warpgroup
constexpr int MMA_THREADS = MMA_CONSUMERS + MMA_PRODUCERS;
// registers a thread after setmaxnreg: the producers give theirs to the consumers' accumulators
// (128 x 56 + 256 x 224 <= 65,536)
constexpr int MMA_PRODUCER_REGS = 56, MMA_CONSUMER_REGS = 224;
constexpr int MMA_STEP_GROUP = 2;    // k steps of 16 a wgmma group: half a k tile
constexpr int MMA_MIN_TILES = 2;     // k tiles a slice holds at least, where K is split
constexpr int MMA_SPLIT_SHARE = 8;   // K is split only where one entry's tiles fill 1 / 8 of the SMs
constexpr int MMA_GROUP_M = 8;       // token tiles a raster group
constexpr int MMA_RING_BYTES = 200 * 1024;  // the ring's stages, at most
constexpr int MMA_MAX_STAGES = 6;

// A stage holds the x tile (TOK token rows of 64 k, 128 bytes each) and the raw w tile (64 k x
// 128 columns as stored: fp32 or bf16), both as TMA's 128-byte swizzle lays them out.
template <typename WT, int TOK> struct MmaShape {
  static constexpr int X_BYTES = TOK * MMA_BK * 2;
  static constexpr int W_BYTES = MMA_BK * MMA_BN * (int)sizeof(WT);
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES =
      MMA_RING_BYTES / STAGE < MMA_MAX_STAGES ? MMA_RING_BYTES / STAGE : MMA_MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + the slack that aligns the ring to 1 KB
  static constexpr int NR = TOK / 2;  // a consumer thread's fp32 accumulators: 64 x TOK over 128
};

struct MmaArgs {
  const __nv_bfloat16* x;  // (chips, M, K)
  const void* w;           // entry c at w + c * swc: (K, N) strides (wstride, 1), or (1, wstride)
  const uint8_t* bits_t;   // each mask transposed and packed: (masks, C, rbytes)
  __nv_bfloat16* y;        // (chips, M, N)
  float* part;             // chips x splits x M x N fp32 partials, where K is split
  int* counters;           // one a tile of every chip, zero, left zero
  long long wstride, swc, sbm;
  int chips, M, N, K, mgroup, R, C, rbytes, tiles_m, tiles_n, splits, per, x_copy, w_copy;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Wait for the phase of `parity` to complete. A ring that never completes (a fault in the kernel)
// traps after 10 s, so the launch fails with an error rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(a, parity))
    if (globaltimer() - t0 > 10000000000ull) __trap();
}
// a 3-d TMA load of one box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ bool aligned16_dev(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
// The producer warpgroup's own copy of one box, for an operand TMA refuses (a base or a stride
// that is not a multiple of 16 bytes): `rows` rows of 128 bytes, swizzled as TMA's SWIZZLE_128B
// writes them, element (r, i) = src[(o0 + r) * ostride + i0 + i], zero where o0 + r >= olim or
// i0 + i >= ilim. A whole 16-byte chunk is read in the widest pieces its address allows (one
// 16-byte load, two of 8, four of 4), a partial one element by element.
template <typename T>
__device__ __forceinline__ void copy_box(unsigned char* dst, const T* src, long long ostride, int o0, int olim,
                                         int i0, int ilim, int rows, int lane, int lanes) {
  constexpr int E = 16 / (int)sizeof(T);
#pragma unroll 4
  for (int c = lane; c < rows * 8; c += lanes) {
    const int r = c >> 3, q = c & 7;
    const int o = o0 + r, i = i0 + q * E;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (o < olim && i < ilim) {
      const T* p = src + (long long)o * ostride + i;
      const uintptr_t at = reinterpret_cast<uintptr_t>(p);
      if (i + E <= ilim && (at & 15) == 0) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
      } else if (i + E <= ilim && (at & 7) == 0) {
        const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p)), hi = __ldg(reinterpret_cast<const uint2*>(p) + 1);
        v = make_uint4(lo.x, lo.y, hi.x, hi.y);
      } else if (i + E <= ilim && (at & 3) == 0) {
        const unsigned* u = reinterpret_cast<const unsigned*>(p);
        v = make_uint4(__ldg(u), __ldg(u + 1), __ldg(u + 2), __ldg(u + 3));
      } else {
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int j = 0; j < E; ++j)
          if (i + j < ilim) e[j] = p[j];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((q ^ (r & 7)) << 4)) = v;
  }
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the wgmma sections
template <int NR> __device__ __forceinline__ void acc_fence(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The B operand: a K-major x tile, rows of 128 bytes with the 128-byte swizzle, 8-row groups
// 1024 bytes apart; `saddr` is the shared address of the 16 k at hand (the 1-KB aligned tile plus
// 32 bytes a k step).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma m64nTOKk16, A (the masked weights) from registers, B (x) from shared memory, fp32
// accumulators; D += A * B.
__device__ __forceinline__ void wgmma_rs_128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_rs_256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
template <int TOK> __device__ __forceinline__ void wgmma_rs(float (&d)[TOK / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (TOK == 128) wgmma_rs_128(d, a, desc);
  else wgmma_rs_256(d, a, desc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) { return bits_of(__floats2bfloat162_rn(lo, hi)); }

// A consumer thread's A fragment of k step s of the stage's raw w tile `ws`: rows g and g + 8 of
// its warp's 16 (g = lane / 4) are the weight columns nl and nl + 1, and its k are 2 t4, 2 t4 + 1,
// 2 t4 + 8 and 2 t4 + 9 (t4 = lane % 4) of the step's 16: a[2h + j] holds column nl + j at k pair
// 2 t4 + 8h. Each weight is rounded to bf16 (a no-op for bf16 w). `off` are the thread's offsets
// into the tile (mma_offsets), so every address below is an offset plus a constant.
template <typename WT, bool KCONTIG>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* ws, const int (&off)[2],
                                       int s, int t4) {
  if constexpr (!KCONTIG) {  // rows of k, (h, e) at row 16s + 8h + 2t4 + e
    if constexpr (sizeof(WT) == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v0 = *reinterpret_cast<const float2*>(ws + off[0] + (16 * s + 8 * h) * 128);
        const float2 v1 = *reinterpret_cast<const float2*>(ws + off[1] + (16 * s + 8 * h) * 128);
        a[2 * h] = pack_bf16(v0.x, v1.x);
        a[2 * h + 1] = pack_bf16(v0.y, v1.y);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(ws + off[0] + (16 * s + 8 * h) * 128);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(ws + off[1] + (16 * s + 8 * h) * 128);
        a[2 * h] = __byte_perm(u0, u1, 0x5410);
        a[2 * h + 1] = __byte_perm(u0, u1, 0x7632);
      }
    }
  } else {  // rows of n: off[j] is row nl + j's byte offset; its swizzle is the row's low 3 bits
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int sw = (off[j] >> 7) & 7;
        if constexpr (sizeof(WT) == 4) {  // box s / 2 of 32 k, 16-byte chunk 4 (s % 2) + 2h + t4 / 2
          const int q = 4 * (s & 1) + 2 * h + (t4 >> 1);
          const float2 v = *reinterpret_cast<const float2*>(ws + (s >> 1) * 16384 + off[j] + ((q ^ sw) << 4) +
                                                            8 * (t4 & 1));
          a[2 * h + j] = pack_bf16(v.x, v.y);
        } else {  // one box of 64 k, chunk 2s + h
          a[2 * h + j] = *reinterpret_cast<const uint32_t*>(ws + off[j] + (((2 * s + h) ^ sw) << 4) + 4 * t4);
        }
      }
  }
}

// The thread's offsets into a stage's w tile (see load_a). Row-major w: the tile is 128 / E boxes
// of 64 k rows x E columns (E = 128 bytes of WT), 8 KB each; the thread's columns nl, nl + 1 sit
// in box nl / E, 16-byte chunk q; off[e] is row 2t4 + e of it, swizzled. k-contiguous w: 64 / E
// boxes of 128 n rows x E k, 16 KB each; off[j] is row nl + j's byte offset in a box.
template <typename WT, bool KCONTIG>
__device__ __forceinline__ void mma_offsets(int (&off)[2], int nl, int t4) {
  if constexpr (!KCONTIG) {
    constexpr int E = 128 / (int)sizeof(WT);
    const int b = nl / E, nc = nl % E;
    const int q = nc * (int)sizeof(WT) / 16, within = nc * (int)sizeof(WT) % 16;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * t4 + e;  // < 8: its swizzle is r itself
      off[e] = b * 8192 + r * 128 + ((q ^ r) << 4) + within;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) off[j] = (nl + j) * 128;
  }
}

// 64 mask bits of one weight column c (its row of the transposed bit matrix, `row`), bit i for
// k = k0 + i, where kr = k0 % R. Where R is a multiple of 64, one aligned 8-byte load; any
// other R, bit by bit (only the 16 bits this thread reads: i = 16s + 8h + 2t4 + e).
__device__ __forceinline__ uint64_t mask_word(const uint8_t* row, bool aligned, int kr, int R, int t4) {
  if (aligned) return __ldg(reinterpret_cast<const unsigned long long*>(row + (kr >> 3)));
  uint64_t v = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 16 * s + 8 * h + 2 * t4 + e;
        const int r = (kr + i) % R;
        v |= (uint64_t)((__ldg(row + (r >> 3)) >> (r & 7)) & 1u) << i;
      }
  return v;
}

// The bf16 multipliers, 1.0 or 0.0, of mask bits p and p + 1 of u (the low half of the result for
// bit p): the bits are shifted to the sign bits of x's byte 0 and x2's byte 1, and prmt copies
// each sign across its half. p is a constant once the loops are unrolled.
__device__ __forceinline__ uint32_t mask_pair(uint32_t u, int p) {
  const uint32_t x = p <= 7 ? u << (7 - p) : u >> (p - 7);
  const uint32_t x2 = p <= 14 ? u << (14 - p) : u >> (p - 14);
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, 0xDD88;" : "=r"(m) : "r"(x), "r"(x2));
  return m & 0x3F803F80u;
}

// One launch computes y = x @ (w * mask) for every chip (or expert) as a persistent walk over
// work items (chip, output tile of TOK tokens x 128 weight columns, K slice). Warpgroups 0 and 1
// are the consumers, each computing y^T for 64 weight columns: wgmma m64nTOKk16 with the masked
// weights as A from registers and the x tile as B from shared memory. Warpgroup 2 is the
// producer: its first thread keeps the ring of STAGES stages filled by TMA, one stage a k tile of
// 64, and all of it copies an operand TMA refuses.
template <typename WT, bool KCONTIG, int TOK>
__global__ void __launch_bounds__(MMA_THREADS, 1)
mma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           const MmaArgs a) {
  using S = MmaShape<WT, TOK>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char mma_raw[];
  unsigned char* const ring =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(mma_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + MMA_PRODUCERS);  // producer 0's expect_tx, then every producer's arrival
      mbar_init(&empty[i], MMA_CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = a.tiles_m * a.tiles_n, tiles_k = (a.K + MMA_BK - 1) / MMA_BK;
  const int items = a.chips * tiles * a.splits;
  // Item order: chip, then output tile, then K slice (the slices of a tile run together). The
  // tiles walk groups of MMA_GROUP_M token tiles across the column tiles, token tiles fastest,
  // so blocks that run together share their w tiles in L2.
  auto locate = [&](int item, int& chip, int& tile, int& m0, int& n0, int& z, int& t0, int& nt) {
    chip = item / (tiles * a.splits);
    const int rem = item - chip * tiles * a.splits;
    tile = rem / a.splits;
    z = rem - tile * a.splits;
    const int group = tile / (MMA_GROUP_M * a.tiles_n), first_m = group * MMA_GROUP_M;
    const int group_m = min(a.tiles_m - first_m, MMA_GROUP_M);
    const int in_group = tile - group * MMA_GROUP_M * a.tiles_n;
    m0 = (first_m + in_group % group_m) * TOK;
    n0 = in_group / group_m * MMA_BN;
    t0 = z * a.per;
    nt = max(0, min(tiles_k - t0, a.per));
  };

  if (warp >= MMA_CONSUMERS / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(MMA_PRODUCER_REGS));
    constexpr int WE = 128 / (int)sizeof(WT);  // w elements a 128-byte box row
    const int p = tid - MMA_CONSUMERS;
    const uint32_t tx = (a.x_copy ? 0u : (uint32_t)S::X_BYTES) + (a.w_copy ? 0u : (uint32_t)S::W_BYTES);
    const WT* const w = static_cast<const WT*>(a.w);
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int chip, tile, m0, n0, z, t0, nt;
      locate(item, chip, tile, m0, n0, z, t0, nt);
      const int wc = a.swc != 0 ? chip : 0;  // the map's entry coordinate (a shared w has one entry)
      for (int t = 0; t < nt; ++t, ++it) {
        const int stage = it % STAGES;
        mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
        unsigned char* const xs = ring + stage * S::STAGE;
        unsigned char* const ws = xs + S::X_BYTES;
        const int k0 = (t0 + t) * MMA_BK;
        if (p == 0) {
          mbar_arrive_tx(&full[stage], tx);
          if (!a.x_copy) tma_load3(xs, &xmap, &full[stage], k0, m0, chip);
          if (!a.w_copy) {
            if (KCONTIG) {
#pragma unroll
              for (int b = 0; b < MMA_BK / WE; ++b) tma_load3(ws + b * 16384, &wmap, &full[stage], k0 + b * WE, n0, wc);
            } else {
#pragma unroll
              for (int b = 0; b < MMA_BN / WE; ++b) tma_load3(ws + b * 8192, &wmap, &full[stage], n0 + b * WE, k0, wc);
            }
          }
        }
        if (a.x_copy || a.w_copy) {  // the whole warpgroup copies what TMA does not take
          if (a.x_copy)
            copy_box(xs, a.x + (long long)chip * a.M * a.K, a.K, m0, a.M, k0, a.K, TOK, p, MMA_PRODUCERS);
          if (a.w_copy) {
            const WT* wp = w + chip * a.swc;
            if (KCONTIG) {
              for (int b = 0; b < MMA_BK / WE; ++b)
                copy_box(ws + b * 16384, wp, a.wstride, n0, a.N, k0 + b * WE, a.K, MMA_BN, p, MMA_PRODUCERS);
            } else {
              for (int b = 0; b < MMA_BN / WE; ++b)
                copy_box(ws + b * 8192, wp, a.wstride, k0, a.K, n0 + b * WE, a.N, MMA_BK, p, MMA_PRODUCERS);
            }
          }
          // generic-proxy writes, read by wgmma (the async proxy) once the barrier completes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_CONSUMER_REGS));

  // the consumers: warpgroup wg, warp wq of it, g = lane / 4, t4 = lane % 4
  const int wg = warp >> 2, wq = warp & 3, t4 = lane & 3;
  const int nl = 64 * wg + 16 * wq + 2 * (lane >> 2);  // the thread's columns nl, nl + 1 of the block's 128
  int off[2];
  mma_offsets<WT, KCONTIG>(off, nl, t4);
  const bool aligned = a.R % 64 == 0;
  float acc[S::NR];
  uint32_t af[2][MMA_STEP_GROUP][4];  // two sets of A fragments: one being read by wgmma, one being filled
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int chip, tile, m0, n0, z, t0, nt;
    locate(item, chip, tile, m0, n0, z, t0, nt);
    const uint8_t* const bits = a.bits_t + (long long)(chip / a.mgroup) * a.sbm;
    const uint8_t* rows[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) rows[j] = bits + (long long)((n0 + nl + j) % a.C) * a.rbytes;
#pragma unroll
    for (int i = 0; i < S::NR; ++i) acc[i] = 0.f;
    acc_fence(acc);
    int kr = (int)(((long long)t0 * MMA_BK) % a.R);
    uint64_t next[2];  // the next k tile's mask words, loaded a tile ahead
#pragma unroll
    for (int j = 0; j < 2; ++j) next[j] = mask_word(rows[j], aligned, kr, a.R, t4);
    // One k tile: MMA_STEP_GROUP steps' A fragments are prepared, then their wgmmas issued back to
    // back as one group; the groups alternate between two register sets, and waiting for all but
    // the newest group frees the other set (and, after a tile's first group, the stage before).
    for (int t = 0; t < nt; ++t) {
      constexpr int G = MMA_STEP_GROUP, GROUPS = 4 / G;
      static_assert(GROUPS % 2 == 0, "an even number of groups a tile: the sets alternate within it");
      const int stage = it % STAGES;
      uint32_t mw[2][2];  // [column][k half]: the column's 64 mask bits, shifted to this thread's k
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t v = next[j] >> (2 * t4);
        mw[j][0] = static_cast<uint32_t>(v);
        mw[j][1] = static_cast<uint32_t>(v >> 32);
      }
      kr += MMA_BK;
      if (kr >= a.R) kr %= a.R;
      if (t + 1 < nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) next[j] = mask_word(rows[j], aligned, kr, a.R, t4);
      }
      mbar_wait(&full[stage], (it / STAGES) & 1);
      const unsigned char* const ws = ring + stage * S::STAGE + S::X_BYTES;
      const uint32_t xaddr = smem_u32(ring + stage * S::STAGE);
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        uint32_t (&fs)[G][4] = af[gi & 1];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int s = gi * G + q;
          uint32_t (&f)[4] = fs[q];
          load_a<WT, KCONTIG>(f, ws, off, s, t4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t m = mask_pair(mw[j][s >> 1], 16 * (s & 1) + 8 * h);
              f[2 * h + j] = bits_of(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&f[2 * h + j]),
                                             *reinterpret_cast<const __nv_bfloat162*>(&m)));
            }
        }
        wg_fence();
#pragma unroll
        for (int q = 0; q < G; ++q) wgmma_rs<TOK>(acc, fs[q], b_desc(xaddr + 32 * (gi * G + q)));
        wg_commit();
        wg_wait<1>();
        if (gi == 0 && t > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      ++it;
    }
    wg_wait<0>();
    if (nt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    acc_fence(acc);

    // accumulator 4i + e: token 8i + 2t4 + (e & 1) of the tile, weight column nl + (e >> 1)
    const int n = n0 + nl;
    const bool pairs = (a.N & 1) == 0;
    const bool split = a.splits > 1;
    __nv_bfloat16* const y = a.y + (long long)chip * a.M * a.N;
    float* const part = a.part + (long long)chip * a.splits * a.M * a.N;
    if (n < a.N) {
#pragma unroll
      for (int i = 0; i < S::NR / 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * i + 2 * t4 + e;
          if (m >= a.M) continue;
          const float v0 = acc[4 * i + e], v1 = acc[4 * i + 2 + e];
          const long long o = (long long)m * a.N + n;
          if (split) {
            float* p = part + (long long)z * a.M * a.N + o;
            if (pairs) {
              *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
            } else {
              p[0] = v0;
              if (n + 1 < a.N) p[1] = v1;
            }
          } else if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(y + o) = __floats2bfloat162_rn(v0, v1);
          } else {
            y[o] = __float2bfloat16(v0);
            if (n + 1 < a.N) y[o + 1] = __float2bfloat16(v1);
          }
        }
    }
    if (split)
      merge_partials(part, a.counters, chip * tiles + tile, a.splits, y, a.M, a.N, m0, TOK, n0, MMA_BN, tid,
                     MMA_CONSUMERS, [] { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }, &is_last);
  }
}

// ---------------------------------------------------------------------------
// decode: bf16 x, M <= 16, bound by the weight bytes (a TMA ring, K split over a cluster)
// ---------------------------------------------------------------------------

constexpr int DEC_CONSUMERS = 256;             // eight consumer warps
constexpr int DEC_THREADS_BULK = DEC_CONSUMERS + 32;  // and one producer warp
constexpr int DEC_MAX_CLUSTER = 16;            // K slices of a tile, at most: a non-portable cluster
constexpr int DEC_WIDE_CLUSTER = 8;             // the most where an entry has more than DEC_NARROW_TILES tiles
constexpr int DEC_NARROW_TILES = 3;
constexpr int DEC_ROWS_KD = 16;                // k rows of a stage of row-major w: the K granule
constexpr int DEC_COLS_KD = 128;               // k of a stage of k-contiguous w: the K granule
constexpr int DEC_ROWS_WARP = DEC_ROWS_KD / 8;  // rows of a stage a consumer warp takes
constexpr int DEC_RING_BYTES = 104 * 1024;      // the ring's stages, at most: two blocks an SM at M <= 8
constexpr int DEC_MAX_STAGES = 12;

// A stage holds w's tile as stored (row-major: KD rows of the block's BN columns; k-contiguous:
// each of its BN columns' run of KD k) and x's KD k as bf16 [MT][KD]. By TMA, w lands as one dense
// box (rows RUN bytes apart) and x as another, rows of x past M zero. Where w's runs start off 16
// bytes (the "offset" route), each run is a 1-D bulk copy from the 16-byte boundary at or below
// its first byte into a slot of PITCH bytes. Where x's rows are not 16-byte multiples, the
// producer warp writes x itself. The stage's geometry is the same in elements for both w dtypes
// and both routes, so all four sum in the same order; bf16 takes about twice the stages.
template <typename WT, bool KCONTIG, int MT> struct DecShape {
  static constexpr int BN = KCONTIG ? DEC_BN_COLS : DEC_BN_ROWS;
  static constexpr int KD = KCONTIG ? DEC_COLS_KD : DEC_ROWS_KD;
  static constexpr int COPIES = KCONTIG ? BN : KD;
  static constexpr int RUN = (KCONTIG ? KD : BN) * (int)sizeof(WT);  // a run's bytes, the TMA box's rows
  static constexpr int PITCH = RUN + 16;
  static constexpr int W_BYTES = COPIES * PITCH;
  static constexpr int W_BOX = COPIES * RUN;
  static constexpr int X_BYTES = MT * KD * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STAGES = DEC_RING_BYTES / STAGE < DEC_MAX_STAGES ? DEC_RING_BYTES / STAGE : DEC_MAX_STAGES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = KCONTIG ? 0 : 8 * MT * BN * 4;  // the consumer warps' partials, over the ring
  static constexpr int BODY = RING > RED ? RING : RED;
  static constexpr int PART = MT * BN * 4;  // the block's partial, which its cluster reads
  static constexpr int BARS = 2 * DEC_MAX_STAGES * 8;  // the ring's full and empty barriers, first
  static constexpr int SMEM = BARS + 128 + BODY + PART;  // + the slack that aligns the ring to 128 bytes
  static_assert(2 * STAGES * 8 <= BARS && STAGE % 128 == 0 && W_BYTES % 128 == 0, "TMA's 128-byte boxes");
};

struct DecArgs {
  const __nv_bfloat16* x;    // (entries, M, K)
  const void* w;             // entry e at w + e * swc: (K, N) strides (wstride, 1), or (1, wstride)
  const unsigned char* wend;  // just past the last byte of w that any entry holds
  const uint8_t* bits;       // row-major w: each mask's bits along C; k-contiguous: along R (transposed)
  __nv_bfloat16* y;          // (entries, M, N)
  long long wstride, swc, sbm;
  int M, N, K, mgroup, R, C, bstride, splits, per, x_copy, w_offset;  // the routes: see launch_decode_bulk
};

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) into this block's
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 8 weights as the decode kernel multiplies them: each rounded to bf16, times its 0/1 mask bit
// as a bf16 product, widened to fp32; the values weights8 gives (bf16 x), with mask_pair's four
// instructions a pair for the multipliers.
template <typename WT>
__device__ __forceinline__ void masked_wide8(const WRaw<WT>& r, uint32_t m, float (&f)[8]) {
  uint32_t h[4];
  to_pairs(r, h);
  uint4 q;
  uint32_t* o = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t mp = mask_pair(m, 2 * p);
    o[p] = bits_of(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&h[p]), *reinterpret_cast<const __nv_bfloat162*>(&mp)));
  }
  unpack8(q, f);
}

// Eight weights of a stage at byte p, whose run starts `o` bytes into its 16-byte granule: 16-byte
// loads where the run is aligned, 4-byte ones where it lies on 4 bytes, else 2-byte ones (a bf16
// run on an odd element).
template <typename WT>
__device__ __forceinline__ void load_slot(WRaw<WT>& r, const unsigned char* p, int o) {
  constexpr int WORDS = (int)sizeof(WRaw<WT>) / 4;
  if (o == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) r.v[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if ((o & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(&r.v[0]);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) d[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
    unsigned short* d = reinterpret_cast<unsigned short*>(&r.v[0]);
#pragma unroll
    for (int i = 0; i < 2 * WORDS; ++i) d[i] = reinterpret_cast<const unsigned short*>(p)[i];
  }
}

// One launch computes y = x @ (w * mask) for every entry (chip or expert): grid (tiles x splits,
// entries), a cluster of `splits` blocks a column tile, block rank z the tile's K slice z. Warp 8
// is the producer: each stage, its lane 0 asks TMA for w's box and x's box (or, on the offset
// route, lane i bulk-copies run i; where x is not TMA's, the lanes write it), then the lanes arrive
// on the stage's full barrier. Warps 0-7 consume: row-major w, warp q takes rows 2q and 2q + 1 of
// each stage of 16, lane l its columns 8l .. 8l + 7; k-contiguous w, 8 lanes a column, lane s its
// k 8s .. 8s + 7 and 64 + 8s .. 64 + 8s + 7 of each stage of 128. Every thread sums its products
// in k order; the warps' partials of a row-major tile are added in warp order 0 .. 7, the 8 lanes
// of a k-contiguous column by a butterfly (xor 1, 2, 4). The slices' partials meet in distributed
// shared memory: block z sums the outputs of its run of columns (the z-th of `splits` runs of the
// tile) over the cluster's blocks in rank order and writes y. No scratch, no counters, no fence:
// a launch allocates nothing and can be captured as it is.
template <typename WT, bool KCONTIG, int MT>
__global__ void __launch_bounds__(DEC_THREADS_BULK, MT == 16 ? 1 : 2)
decode_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap, const DecArgs a) {
  using S = DecShape<WT, KCONTIG, MT>;
  constexpr int STAGES = S::STAGES, KD = S::KD, BN = S::BN;
  extern __shared__ __align__(128) unsigned char dec_smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(dec_smem);
  uint64_t* const empty = full + STAGES;
  unsigned char* const ring =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(dec_smem) + S::BARS + 127) & ~uintptr_t(127));
  float* const part = reinterpret_cast<float*>(ring + S::BODY);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int splits = a.splits;
  const int tile = blockIdx.x / splits, z = blockIdx.x - tile * splits;
  const int entry = blockIdx.y;
  const int n0 = tile * BN;
  const int k_begin = z * a.per, k_end = min(a.K, k_begin + a.per);
  const int nt = k_end > k_begin ? (k_end - k_begin + KD - 1) / KD : 0;
  const WT* const w = static_cast<const WT*>(a.w) + entry * a.swc;
  const int pitch = a.w_offset ? S::PITCH : S::RUN;  // a run's room in the stage
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + 32);  // lane 0's expect_tx, then every producer lane's arrival
      mbar_init(&empty[i], DEC_CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DEC_CONSUMERS / 32) {  // the producer warp
    const __nv_bfloat16* const x = a.x + (long long)entry * a.M * a.K;
    const uintptr_t wend = reinterpret_cast<uintptr_t>(a.wend);
    const int wc = a.swc != 0 ? entry : 0;  // w's map: a shared w has one entry
    for (int t = 0; t < nt; ++t) {
      const int st = t % STAGES;
      mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
      unsigned char* const ws = ring + st * S::STAGE;
      __nv_bfloat16* const xs = reinterpret_cast<__nv_bfloat16*>(ws + S::W_BYTES);
      const int k0 = k_begin + t * KD, kn = min(KD, k_end - k0);
      // the offset route: this lane's run of w, row k0 + lane of the tile's columns, or column
      // n0 + lane's run of K, from the 16-byte boundary below, but never a granule past the
      // operand's last byte
      const WT* src = nullptr;
      int count = 0;
      if (a.w_offset && !KCONTIG && lane < KD && lane < kn) {
        src = w + (long long)(k0 + lane) * a.wstride + n0;
        count = min(BN, a.N - n0);
      } else if (a.w_offset && KCONTIG && n0 + lane < a.N) {
        src = w + (long long)(n0 + lane) * a.wstride + k0;
        count = kn;
      }
      const uintptr_t at = reinterpret_cast<uintptr_t>(src), a0 = at & ~uintptr_t(15);
      const uintptr_t end = at + (uintptr_t)count * sizeof(WT);
      uintptr_t a1 = (end + 15) & ~uintptr_t(15);
      if (a1 > wend) a1 = wend & ~uintptr_t(15);
      const uint32_t bytes = count > 0 && a1 > a0 ? (uint32_t)(a1 - a0) : 0u;
      uint32_t total = bytes;
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) total += __shfl_xor_sync(0xffffffffu, total, d);
      if (lane == 0) {  // TMA's boxes count whole, their parts past the operand's edges zero-filled
        mbar_arrive_tx(&full[st], total + (a.w_offset ? 0u : (uint32_t)S::W_BOX) + (a.x_copy ? 0u : (uint32_t)S::X_BYTES));
        if (!a.w_offset) {
          if (KCONTIG)
            tma_load3(ws, &wmap, &full[st], k0, n0, wc);
          else
            tma_load3(ws, &wmap, &full[st], n0, k0, wc);
        }
        if (!a.x_copy) tma_load3(xs, &xmap, &full[st], k0, 0, entry);
      }
      __syncwarp();
      unsigned char* const slot = ws + lane * S::PITCH;
      if (bytes) bulk_copy(slot, reinterpret_cast<const void*>(a0), bytes, &full[st]);
      // the run's last elements in a granule that passes the operand's end: loaded one by one
      for (uintptr_t p = max(a0 + bytes, at); count > 0 && p < end; p += sizeof(WT))
        *reinterpret_cast<WT*>(slot + (p - a0)) = *reinterpret_cast<const WT*>(p);
      if (a.x_copy) {  // x's rows are not 16-byte multiples: the lanes write them, zero past the slice
        for (int e = lane; e < a.M * KD; e += 32) {
          const int m = e / KD, kk = e - m * KD;
          xs[m * KD + kk] = kk < kn ? x[(long long)m * a.K + k0 + kk] : __float2bfloat16(0.f);
        }
      }
      mbar_arrive(&full[st]);
    }
    if (splits > 1) {  // the consumers' two cluster barriers
      cooperative_groups::this_cluster().sync();
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
    }
    return;
  }

  const uint8_t* const bits = a.bits + (long long)(entry / a.mgroup) * a.sbm;
  __nv_bfloat16* const y = a.y + (long long)entry * a.M * a.N;
  if constexpr (!KCONTIG) {
    float acc[MT][8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
    const int cm = (n0 + lane * 8) % a.C;  // the mask column of the lane's first column
    const int i0 = DEC_ROWS_WARP * warp;
    int kr = (k_begin + i0) % a.R;  // the mask row of the warp's first row of the stage
    // row i of the stage (row k of w, mask row r), rounded, masked and widened: the lane's 8 weights
    auto row = [&](const unsigned char* ws, int i, int k, int r, float (&wf)[8]) {
      const int o = a.w_offset ? (int)(reinterpret_cast<uintptr_t>(w + (long long)k * a.wstride + n0) & 15) : 0;
      WRaw<WT> raw;
      load_slot(raw, ws + i * pitch + o + lane * 8 * (int)sizeof(WT), o);
      masked_wide8(raw, mask8(bits, a.bstride, a.C, r, cm), wf);
    };
    for (int t = 0; t < nt; ++t) {
      const int st = t % STAGES;
      mbar_wait(&full[st], (t / STAGES) & 1);
      const unsigned char* const ws = ring + st * S::STAGE;
      const __nv_bfloat16* const xs = reinterpret_cast<const __nv_bfloat16*>(ws + S::W_BYTES);
      const int k0 = k_begin + t * KD;
#pragma unroll
      for (int rr = 0; rr < DEC_ROWS_WARP; ++rr) {  // one row at a time: 8 weights and M sums live
        const int i = i0 + rr, k = k0 + i;
        if (k >= k_end) break;
        float wf[8];
        row(ws, i, k, kr + rr < a.R ? kr + rr : kr + rr - a.R, wf);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xk = __bfloat162float(xs[m * KD + i]);  // x[m][k], one address for the warp
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xk, wf[j], acc[m][j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      kr += KD;
      while (kr >= a.R) kr -= a.R;
    }
    // every stage is consumed (so every copy has landed): the ring holds the warps' partials
    asm volatile("bar.sync 1, %0;\n" ::"n"(DEC_CONSUMERS) : "memory");
    float* const red = reinterpret_cast<float*>(ring);  // [warp][m][BN]
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float* r = red + (warp * MT + m) * BN + lane * 8;
      reinterpret_cast<float4*>(r)[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      reinterpret_cast<float4*>(r)[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(DEC_CONSUMERS) : "memory");
    const int c = tid;  // the block's partial of column n0 + c: warps 0 .. 7 in order
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float s = red[m * BN + c];
#pragma unroll
      for (int q = 1; q < 8; ++q) s += red[(q * MT + m) * BN + c];
      part[m * BN + c] = s;
      if (splits == 1 && m < a.M && n0 + c < a.N) y[(long long)m * a.N + n0 + c] = __float2bfloat16(s);
    }
  } else {
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    const int col = tid >> 3, sub = tid & 7, n = n0 + col;
    const int cm = n % a.C;  // the row of the transposed bit matrix
    const int o = a.w_offset ? (int)(reinterpret_cast<uintptr_t>(w + (long long)n * a.wstride + k_begin) & 15) : 0;
    for (int t = 0; t < nt; ++t) {
      const int st = t % STAGES;
      mbar_wait(&full[st], (t / STAGES) & 1);
      const unsigned char* const ws = ring + st * S::STAGE;
      const __nv_bfloat16* const xs = reinterpret_cast<const __nv_bfloat16*>(ws + S::W_BYTES);
      const int k0 = k_begin + t * KD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 8 * sub + 64 * h, k = k0 + kk;
        if (k >= k_end) break;
        WRaw<WT> raw;
        load_slot(raw, ws + col * pitch + o + kk * (int)sizeof(WT), o);
        if (k + 8 > k_end) {  // past the slice's end: stale bytes of the slot, zeroed (not masked)
          WT* e = reinterpret_cast<WT*>(&raw.v[0]);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k + j >= k_end) e[j] = from_f<WT>(0.f);
        }
        float wf[8];
        masked_wide8(raw, mask8(bits, a.bstride, a.R, cm, k % a.R), wf);
#pragma unroll
        for (int m = 0; m < MT; ++m) {  // x[m][k .. k + 7]: zero past the slice's end, never stale
          float xv[8];
          unpack8(*reinterpret_cast<const uint4*>(xs + m * KD + kk), xv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m] = fmaf(xv[j], wf[j], acc[m]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 1);
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 2);
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 4);
    }
    if (sub == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        part[m * BN + col] = acc[m];
        if (splits == 1 && m < a.M && n < a.N) y[(long long)m * a.N + n] = __float2bfloat16(acc[m]);
      }
    }
  }
  if (splits == 1) return;
  // the slices' partials, summed in rank order through distributed shared memory: block z's
  // outputs (row m, a run of neighbouring columns c) spread over its threads, each output's peers
  // read at once, then added in rank order
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int share = (BN + splits - 1) / splits, c0 = z * share;  // the block's columns c0 .. c0 + cols
  const int cols = max(0, min(share, min(BN, a.N - n0) - c0));
  const float* peer[DEC_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < DEC_MAX_CLUSTER; ++q) peer[q] = q < splits ? cluster.map_shared_rank(part, q) : part;
  for (int o = tid; o < a.M * cols; o += DEC_CONSUMERS) {
    const int m = o / cols, c = c0 + (o - m * cols);
    float v[DEC_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < DEC_MAX_CLUSTER; ++q) v[q] = q < splits ? peer[q][m * BN + c] : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < DEC_MAX_CLUSTER; ++q)
      if (q < splits) s += v[q];
    y[(long long)m * a.N + n0 + c] = __float2bfloat16(s);
  }
  // no block leaves while a peer may still read its partial (nothing to publish: relaxed)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// tiled: v1 at M > 16, register-tiled SIMT FP32
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// one 4-byte element (zero-filled where src_bytes is 0); 4-byte copies go through L1 (.ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

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

// The mma kernel's token tile: 128 rows at M <= 128, 256 above (at M <= 256 one
// tile reads each weight once). A tile's traffic into shared memory, not its tensor work, sets
// its time (PERF.md, PR 31), and 256 tokens x 128 columns moves the fewest bytes a product; but
// where the chips' 256-row tiles would leave more than half the SMs idle, 128-row tiles fill them
// without cutting K. kernels/masked_matmul/ops.py::_mma_tokens mirrors it.
int mma_tokens(int chips, int M, int N, int sms) {
  if (M <= 128) return 128;
  if (M <= 256) return 256;
  const long long tiles = (long long)chips * ((M + 255) / 256) * ((N + MMA_BN - 1) / MMA_BN);
  return 2 * tiles < sms ? 128 : 256;
}

// The bf16 kernels' plan: K slices, output tiles (per chip) and the tile's rows. decode cuts K into
// whole stages (16 rows of row-major w, 128 k of embed.T), as many slices as two blocks an SM
// over one entry's column tiles ask for, at most a cluster of DEC_MAX_CLUSTER: the same slices at
// every M and every chip or expert count, so each entry's rows of a batched launch, and a
// checksummed launch's payload rows, have the bits of their own launch. mma
// runs one persistent block an SM: K is cut only where one entry's tiles fill at most 1 /
// MMA_SPLIT_SHARE of the SMs, each slice at least MMA_MIN_TILES k tiles, the same cut for every
// chip count. v1's plan, the same rules for its decode and tiled
// kernels, is kernels/masked_matmul/ops.py::_split_plan; the launches below check its scratch and
// counters.
void plan(int variant, int chips, int M, int N, int K, bool kcontig, int sms, int* splits,
          int* tiles_out, int* tokens) {
  if (variant == 2) {
    // one entry's column tiles alone set the slices (never the chip or expert count, nor M): two
    // blocks an SM's worth of them, each slice whole stages, at most a cluster of 16 for a narrow
    // weight (at most 3 tiles: one entry alone leaves the card idle) and of 8 otherwise (a batched
    // launch of wider entries passes one wave, and a wide cluster packs the GPCs worse)
    const int bn = kcontig ? DEC_BN_COLS : DEC_BN_ROWS, kd = kcontig ? DEC_COLS_KD : DEC_ROWS_KD;
    *tiles_out = (N + bn - 1) / bn;
    *tokens = M;
    const int cap = *tiles_out <= DEC_NARROW_TILES ? DEC_MAX_CLUSTER : DEC_WIDE_CLUSTER;
    *splits = split_count((K + kd - 1) / kd, std::min(cap, std::max(1, 2 * sms / *tiles_out)));
  } else {
    *tokens = mma_tokens(chips, M, N, sms);
    *tiles_out = ((M + *tokens - 1) / *tokens) * ((N + MMA_BN - 1) / MMA_BN);
    // K is cut as one entry's launch alone would cut it, so each chip's (or expert's) rows of a
    // batched launch have the bits of its own launch (the token tile changes no bit); and only
    // where that entry's tiles fill at most an eighth of the SMs, since a cut's partials cost
    // more than the idle SMs do above that, all the more in a batched launch
    const int tok1 = mma_tokens(1, M, N, sms);
    const int tiles1 = ((M + tok1 - 1) / tok1) * ((N + MMA_BN - 1) / MMA_BN);
    const int tiles_k = std::max(1, (K + MMA_BK - 1) / MMA_BK);
    *splits = MMA_SPLIT_SHARE * tiles1 > sms
                  ? 1
                  : split_count(tiles_k, std::min(tiles_k / MMA_MIN_TILES, sms / tiles1));
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

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the library links
// nothing but the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d map (d0 innermost, unit stride; d1 and d2 at s1 and s2 bytes) of boxes b0 x b1 x 1 with
// the 128-byte swizzle (mma) or none (decode: dense boxes); zero where a box passes the edge.
int encode_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base, unsigned long long d0,
               unsigned long long d1, unsigned long long d2, unsigned long long s1, unsigned long long s2,
               unsigned b0, unsigned b1, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = fn(map, dt, 3, const_cast<void*>(base), dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// What TMA takes: a 16-byte aligned base and strides that are multiples of 16 bytes, under 2^40
bool tma_stride(long long bytes) { return bytes > 0 && bytes % 16 == 0 && bytes < (1LL << 40); }

// A small cache of encoded maps, keyed by every argument the encoding reads: a weight's maps are
// encoded once, and an activation's again only where its address or shape is new, so a launch
// call does not pay for an encoding it made before. (A map holds an address and a layout only, so
// a hit stays right after the tensor that made it is freed.)
struct MapKey {
  const void* base;
  unsigned long long d0, d1, d2, s1, s2;
  unsigned b0, b1;
  int dt;
};

int cached_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base, unsigned long long d0,
               unsigned long long d1, unsigned long long d2, unsigned long long s1, unsigned long long s2,
               unsigned b0, unsigned b1) {
  struct Slot {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  static Slot slots[512];
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.d0 = d0;
  key.d1 = d1;
  key.d2 = d2;
  key.s1 = s1;
  key.s2 = s2;
  key.b0 = b0;
  key.b1 = b1;
  key.dt = static_cast<int>(dt);
  unsigned long long h = 1469598103934665603ULL;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof(key); ++i) h = (h ^ kb[i]) * 1099511628211ULL;
  Slot& slot = slots[h % 512];
  if (slot.used && memcmp(&slot.key, &key, sizeof(key)) == 0) {
    *map = slot.map;
    return 0;
  }
  if (int err = encode_map(map, dt, base, d0, d1, d2, s1, s2, b0, b1, CU_TENSOR_MAP_SWIZZLE_NONE)) return err;
  slot.key = key;
  slot.map = *map;
  slot.used = true;
  return 0;
}

template <typename WT, bool KC, int MT>
int launch_decode_mt(const CUtensorMap& xm, const CUtensorMap& wm, const DecArgs& a, int tiles, int entries,
                     cudaStream_t s) {
  using S = DecShape<WT, KC, MT>;
  auto kern = decode_kernel<WT, KC, MT>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64 || dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  // set once a device: above 48 KB only after this attribute, and clusters of more than 8 blocks
  // only after the non-portable one; a cluster of `splits` blocks that no GPC holds at this shared
  // memory never launches, so each slice count is checked once
  static bool ready[64];
  static signed char fits[64][DEC_MAX_CLUSTER + 1];
  if (!ready[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.splits, entries, 1);
  cfg.blockDim = dim3(DEC_THREADS_BULK, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  if (a.splits > 1 && fits[dev][a.splits] == 0) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    fits[dev][a.splits] = clusters > 0 ? 1 : -1;
  }
  if (a.splits > 1 && fits[dev][a.splits] < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, xm, wm, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The bf16 decode kernel (bf16 x, M <= 16, w in WT): the instance by M (4, 8 or 16 rows) and w's
// layout; `splits` K slices of whole stages, none empty, one cluster a column tile. loads: bit 0
// asks for x by the producer's own loads, bit 1 for w by 1-D bulk copies from the 16-byte boundary
// below each run (the offset route); the rest by TMA, which must then take the operand: a 16-byte
// aligned base, row strides of a multiple of 16 bytes, a stacked w's entries at least an entry
// apart (the wrapper picks by the same rule: ops.py::_decode_loads).
template <typename WT>
int launch_decode_bulk(int chips, const void* x, const void* w, const uint8_t* bits, const uint8_t* bits_t,
                       void* y, int M, int N, int K, long long swk, long long swn, long long swc, int R, int C,
                       int mask_group, int splits, int loads, cudaStream_t s) {
  if (M < 1 || M > 16 || splits < 1 || splits > DEC_MAX_CLUSTER || swc < 0 || (loads & ~3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kcontig = swn != 1;
  const int kd = kcontig ? DEC_COLS_KD : DEC_ROWS_KD, bn = kcontig ? DEC_BN_COLS : DEC_BN_ROWS;
  const int granules = (K + kd - 1) / kd;
  const int per = (granules + splits - 1) / splits;
  if ((long long)(splits - 1) * per >= granules) return static_cast<int>(cudaErrorInvalidValue);  // an empty slice
  DecArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.bits = kcontig ? bits_t : bits;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.wstride = kcontig ? swn : swk;
  a.swc = swc;
  a.bstride = kcontig ? (R + 7) / 8 : (C + 7) / 8;
  a.sbm = (long long)(mask_group != 0) * (kcontig ? C : R) * a.bstride;
  a.mgroup = std::max(mask_group, 1);
  a.M = M;
  a.N = N;
  a.K = K;
  a.R = R;
  a.C = C;
  a.splits = splits;
  a.per = per * kd;
  a.x_copy = loads & 1;
  a.w_offset = (loads >> 1) & 1;
  // the operand's last element: the last entry's last row (or column) end
  const long long last = (long long)(chips - 1) * swc + (kcontig ? (long long)(N - 1) * swn + K - 1
                                                                  : (long long)(K - 1) * swk + N - 1);
  a.wend = static_cast<const unsigned char*>(w) + (last + 1) * (long long)sizeof(WT);
  const int tiles = (N + bn - 1) / bn;
  const int mt = M <= 4 ? 4 : M <= 8 ? 8 : 16;
  alignas(64) CUtensorMap xm, wm;
  memset(&xm, 0, sizeof(xm));
  memset(&wm, 0, sizeof(wm));
  if (!a.x_copy) {  // boxes of kd k x mt rows of one entry's x; rows past M zero
    if (!aligned16(x) || !tma_stride(2LL * K)) return static_cast<int>(cudaErrorInvalidValue);
    if (int err = cached_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, chips, 2ULL * K, 2ULL * M * K, kd, mt))
      return err;
  }
  if (!a.w_offset) {  // boxes of kd rows x bn columns (row-major) or bn columns x kd k (embed.T)
    const long long sz = sizeof(WT);
    const long long extent = (kcontig ? (long long)N : (long long)K) * a.wstride * sz;
    const long long entry = swc != 0 ? swc * sz : extent;
    if (!aligned16(w) || !tma_stride(a.wstride * sz) || !tma_stride(entry) || entry < extent)
      return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMapDataType dt = sz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const unsigned long long entries = swc != 0 ? chips : 1;
    const int err = kcontig ? cached_map(&wm, dt, w, K, N, entries, a.wstride * sz, entry, kd, bn)
                            : cached_map(&wm, dt, w, N, K, entries, a.wstride * sz, entry, bn, kd);
    if (err) return err;
  }
#define DEC_GO(KC_, MT_) \
  if (kcontig == KC_ && mt == MT_) return launch_decode_mt<WT, KC_, MT_>(xm, wm, a, tiles, chips, s);
  DEC_GO(false, 4)
  DEC_GO(false, 8)
  DEC_GO(false, 16)
  DEC_GO(true, 4)
  DEC_GO(true, 8)
  DEC_GO(true, 16)
#undef DEC_GO
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename WT, bool KCONTIG, int TOK>
int launch_mma_tok(const CUtensorMap& xm, const CUtensorMap& wm, const MmaArgs& a, int blocks, cudaStream_t s) {
  constexpr int smem = MmaShape<WT, TOK>::SMEM;
  // above 48 KB only after this attribute is set (on the current device)
  const cudaError_t err =
      cudaFuncSetAttribute(mma_kernel<WT, KCONTIG, TOK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_kernel<WT, KCONTIG, TOK><<<blocks, MMA_THREADS, smem, s>>>(xm, wm, a);
  return static_cast<int>(cudaGetLastError());
}

// loads: bit 0 asks for x by the producer's copies, bit 1 for w; the rest by TMA, which must then
// take the operand: a 16-byte aligned base, row strides of a multiple of 16 bytes, and a stacked
// w's entries at least an entry apart (the wrapper picks by the same rule: ops.py::_mma_loads).
template <typename WT>
int launch_mma(int chips, const void* x, const void* w, const uint8_t* bits_t, void* y, int M, int N, int K,
               long long swk, long long swn, long long swc, int R, int C, int mask_group, int splits, int tokens,
               int blocks, int loads, float* part, long long scratch_bytes, int* counters, int counters_len,
               cudaStream_t s) {
  if ((tokens != 128 && tokens != 256) || blocks < 1 || (loads & ~3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kcontig = swn != 1;
  MmaArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.bits_t = bits_t;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.part = part;
  a.counters = counters;
  a.wstride = kcontig ? swn : swk;
  a.swc = swc;
  a.rbytes = (R + 7) / 8;
  a.sbm = (long long)(mask_group != 0) * C * a.rbytes;
  a.chips = chips;
  a.M = M;
  a.N = N;
  a.K = K;
  a.mgroup = std::max(mask_group, 1);
  a.R = R;
  a.C = C;
  a.tiles_m = (M + tokens - 1) / tokens;
  a.tiles_n = (N + MMA_BN - 1) / MMA_BN;
  const int tiles_k = (K + MMA_BK - 1) / MMA_BK;
  a.splits = splits;
  a.per = (tiles_k + splits - 1) / splits;
  a.x_copy = loads & 1;
  a.w_copy = (loads >> 1) & 1;
  if (int err = check_split(chips, splits, (long long)a.tiles_m * a.tiles_n, M, N, scratch_bytes, counters_len))
    return err;
  const long long sz = sizeof(WT);
  alignas(64) CUtensorMap xm, wm;
  memset(&xm, 0, sizeof(xm));
  memset(&wm, 0, sizeof(wm));
  if (!a.x_copy) {
    if (!aligned16(x) || !tma_stride(2LL * K)) return static_cast<int>(cudaErrorInvalidValue);
    if (int err = encode_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, chips, 2ULL * K, 2ULL * M * K,
                             MMA_BK, tokens))
      return err;
  }
  if (!a.w_copy) {
    // an entry's bytes: a stacked w's stride, at least one entry's extent; a shared w has one entry
    const long long extent = (kcontig ? (long long)N : (long long)K) * a.wstride * sz;
    const long long entry = swc != 0 ? swc * sz : extent;
    if (!aligned16(w) || !tma_stride(a.wstride * sz) || !tma_stride(entry) || entry < extent)
      return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMapDataType dt = sz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const unsigned we = 128 / sz;
    const unsigned long long entries = swc != 0 ? chips : 1;
    const int err = kcontig ? encode_map(&wm, dt, w, K, N, entries, a.wstride * sz, entry, we, MMA_BN)
                            : encode_map(&wm, dt, w, N, K, entries, a.wstride * sz, entry, we, MMA_BK);
    if (err) return err;
  }
#define MMA_GO(KC, T)                                                  \
  if (kcontig == KC && tokens == T) return launch_mma_tok<WT, KC, T>(xm, wm, a, blocks, s);
  MMA_GO(false, 128)
  MMA_GO(false, 256)
  MMA_GO(true, 128)
  MMA_GO(true, 256)
#undef MMA_GO
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The launch plan of a bf16 kernel (variant 2 = decode, 3 = mma) for `chips` stacks of x (M, K)
// and w (K, N), w k-contiguous (embed.T) or not, on a card of `sms` SMs: out[0] = K slices,
// out[1] = the scratch bytes a launch needs (every chip's slices' fp32 partials; 0 for one
// slice), out[2] = output tiles of all chips, the split-K counters it needs, out[3] = a tile's
// rows (mma: the token tile; decode: M). The kernels' tiles and split rules live here alone.
extern "C" int masked_matmul_plan(int variant, int chips, int M, int N, int K, int kcontig, int sms,
                                  long long* out) {
  if ((variant != 2 && variant != 3) || chips < 1 || M < 1 || N < 1 || K < 1 || sms < 1 ||
      (variant == 2 && M > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int splits = 1, tiles_out = 1, tokens = 0;
  plan(variant, chips, M, N, K, kcontig != 0, sms, &splits, &tiles_out, &tokens);
  out[0] = splits;
  out[1] = splits == 1 || variant == 2 ? 0 : 4LL * chips * splits * M * N;  // decode sums in its cluster
  out[2] = (long long)chips * tiles_out;
  out[3] = tokens;
  return 0;
}

// The bf16 decode kernel's instance for M rows (4, 8 or 16), w's dtype (0 = float32, 1 = bfloat16)
// and layout: out[0] = registers a thread, out[1] = local (spill) bytes a thread, out[2] = dynamic
// shared memory, out[3] = blocks an SM holds, out[4] = clusters of `splits` blocks the card holds at
// once (0 for splits 1).
extern "C" int masked_matmul_decode_info(int mt, int wdtype, int kcontig, int splits, long long* out) {
  auto info = [&](auto kern, int smem) -> int {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)  // clusters of more than 8, where the card takes them
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
    int blocks = 0, clusters = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, DEC_THREADS_BULK, smem);
    if (err == cudaSuccess && splits > 1) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = splits;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(splits * 64, 1, 1);
      cfg.blockDim = dim3(DEC_THREADS_BULK, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = fa.numRegs;
    out[1] = (long long)fa.localSizeBytes;
    out[2] = smem;
    out[3] = blocks;
    out[4] = clusters;
    return 0;
  };
#define DEC_INFO(WT_, KC_, MT_)                                                          \
  if ((wdtype == 0) == std::is_same<WT_, float>::value && (kcontig != 0) == KC_ && mt == MT_) \
    return info(decode_kernel<WT_, KC_, MT_>, DecShape<WT_, KC_, MT_>::SMEM);
  DEC_INFO(float, false, 4) DEC_INFO(float, false, 8) DEC_INFO(float, false, 16)
  DEC_INFO(float, true, 4) DEC_INFO(float, true, 8) DEC_INFO(float, true, 16)
  DEC_INFO(__nv_bfloat16, false, 4) DEC_INFO(__nv_bfloat16, false, 8) DEC_INFO(__nv_bfloat16, false, 16)
  DEC_INFO(__nv_bfloat16, true, 4) DEC_INFO(__nv_bfloat16, true, 8) DEC_INFO(__nv_bfloat16, true, 16)
#undef DEC_INFO
  return static_cast<int>(cudaErrorInvalidValue);
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
                             int mask_group, int splits, int split_tiles, int tokens, int blocks,
                             int loads, void* scratch, long long scratch_bytes, void* counters,
                             int counters_len, void* stream) {
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
  if (variant == 2)  // no scratch and no counters: the slices meet in the cluster's shared memory
    return wdtype == 1 ? launch_decode_bulk<__nv_bfloat16>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R, C, g,
                                                           splits, loads, s)
                       : launch_decode_bulk<float>(chips, x, w, b, bt, y, M, N, K, swk, swn, swc, R, C, g, splits,
                                                   loads, s);
  if (variant == 3)
    return wdtype == 1
               ? launch_mma<__nv_bfloat16>(chips, x, w, bt, y, M, N, K, swk, swn, swc, R, C, g, splits, tokens,
                                           blocks, loads, part, scratch_bytes, cnt, counters_len, s)
               : launch_mma<float>(chips, x, w, bt, y, M, N, K, swk, swn, swc, R, C, g, splits, tokens, blocks,
                                   loads, part, scratch_bytes, cnt, counters_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
