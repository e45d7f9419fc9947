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
//   running sum, accumulator), a zero sum treated as 1, and o cast to q's dtype. A sequence of
//   length 0 returns 0, as the TPU kernels do.
//
// Design: one block per (sequence, KV head) serves that head's whole query group, so each K/V
// tile is read once per group and not once per query head. The block walks the valid keys in
// tiles of bkv (a launch parameter, tuned by repro_torch.tune): it stages the tile's int8 K and V
// rows (16-byte loads) and their scales in shared memory; one thread per key converts the key
// once and computes its scores for every query head of the group; one warp per query head folds
// the tile into the online softmax; then every thread takes four head dims of one query head
// over a share of the tile's keys, in registers, and the shares are summed into the accumulator.
// int8 becomes fp32 by a byte permute and one add (exact), not by I2F, which Hopper runs at a
// quarter of the FMA rate: the first version converted each element once per query head and once
// per output, and those conversions set its time. Nothing but the output is written to device
// memory; the dequantized cache never exists there. Tiles past
// the valid length are never read: the dense kernel stops at len, and the paged kernel reads only
// the pages before ceil(len / page), so stale block-table entries past a sequence's length are
// never dereferenced.
//
// Bound on the card: bytes (the int8 cache and its scales, read once). With one block per
// (sequence, KV head) a small batch leaves most of the 132 SMs idle; splitting the keys over
// blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr long long SMEM_LIMIT = 232448;  // 227 KiB of dynamic shared memory per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// Byte offsets of the shared-memory regions. The Python wrappers compute the same total
// (kernels/decode_attention/ops.py::smem_bytes) and pass it; a launch whose total disagrees is
// refused, so the lint that checks it against the 227 KiB limit and the launch cannot drift.
struct Layout {
  long long q, acc, red, p, stats, ks, vs, k, v, total;
};

__host__ __device__ inline Layout layout(int bkv, int d, int g) {
  Layout L;
  long long o = 0;
  L.q = o;     o += a16(4LL * g * d);    // q * scale, fp32 (G, D)
  L.acc = o;   o += a16(4LL * g * d);    // the accumulator, fp32 (G, D)
  L.red = o;   o += a16(16LL * NT);      // one float4 per thread: PV's partial sums
  L.p = o;     o += a16(4LL * g * bkv);  // scores, then p * v_scale, fp32 (G, bkv)
  L.stats = o; o += a16(12LL * g);       // running max, running sum, rescale factor
  L.ks = o;    o += a16(4LL * bkv);      // the tile's K scales
  L.vs = o;    o += a16(4LL * bkv);      // the tile's V scales
  L.k = o;     o += a16(1LL * bkv * d);  // the tile's int8 K rows
  L.v = o;     o += a16(1LL * bkv * d);  // the tile's int8 V rows
  L.total = o;
  return L;
}

struct Dense {  // K/V (B, Hkv, S, D), scales (B, Hkv, S), all contiguous
  const int* len_ptr;
  int len_value, S;
  __device__ int length(int) const { return min(max(len_ptr ? len_ptr[0] : len_value, 0), S); }
  // row of token t of (b, h) in units of D-byte rows (and of scale entries)
  __device__ long long row(int b, int h, int Hkv, int t) const {
    return ((long long)b * Hkv + h) * S + t;
  }
};

struct Paged {  // pools (Hkv, P, page, D), scales (Hkv, P, page); tables (B, maxp); lens (B,)
  const int* tables;
  const int* lens;
  int maxp, page, P;
  __device__ int length(int b) const { return min(max(lens[b], 0), maxp * page); }
  __device__ long long row(int b, int h, int, int t) const {
    const int pid = tables[(long long)b * maxp + t / page];
    return ((long long)h * P + pid) * page + t % page;
  }
};

template <typename T, int D, typename Src>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ k, const float* __restrict__ ks,
              const int8_t* __restrict__ v, const float* __restrict__ vs, T* __restrict__ o,
              int Hkv, int G, int bkv, float scale, Src src) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(bkv, D, G);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float4* red_s = reinterpret_cast<float4*>(smem + L.red);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + L.v);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int len = src.length(b);
  const long long qo = ((long long)b * Hkv + h) * G * D;  // q and o are (B, Hq, D), contiguous

  for (int i = tid; i < G * D; i += NT) {
    q_s[i] = to_f(q[qo + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < G; i += NT) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  constexpr int CH = D / 16;  // 16-byte chunks per int8 row
  for (int t0 = 0; t0 < len; t0 += bkv) {
    const int n = min(bkv, len - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < n * CH; e += NT) {
      const int j = e / CH, c = e % CH;
      const long long r = src.row(b, h, Hkv, t0 + j);
      reinterpret_cast<int4*>(k_s + j * D)[c] = reinterpret_cast<const int4*>(k + r * D)[c];
      reinterpret_cast<int4*>(v_s + j * D)[c] = reinterpret_cast<const int4*>(v + r * D)[c];
    }
    for (int j = tid; j < n; j += NT) {
      const long long r = src.row(b, h, Hkv, t0 + j);
      ks_s[j] = ks[r];
      vs_s[j] = vs[r];
    }
    __syncthreads();

    // scores: one thread per key converts it once, for every query head of the group
    for (int j = tid; j < n; j += NT) {
      const int4* kr = reinterpret_cast<const int4*>(k_s + j * D);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int4 t = kr[c];
        const float4 k0 = i8x4_to_f32(t.x), k1 = i8x4_to_f32(t.y), k2 = i8x4_to_f32(t.z),
                     k3 = i8x4_to_f32(t.w);
        for (int g = 0; g < G; ++g) {
          const float4* qg = reinterpret_cast<const float4*>(q_s + g * D + 16 * c);
          const float part = dot4(qg[3], k3, dot4(qg[2], k2, dot4(qg[1], k1, dot4(qg[0], k0, 0.f))));
          p_s[g * bkv + j] = c ? p_s[g * bkv + j] + part : part;
        }
      }
      const float sk = ks_s[j];
      for (int g = 0; g < G; ++g) p_s[g * bkv + j] *= sk;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += NW) {
      float* pg = p_s + g * bkv;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(pg[j] - m_new);
        sum += p;
        pg[j] = p * vs_s[j];  // v's scale folded into the weight
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // accumulator: thread (split, item) sums p * v over keys split, split + nsplit, ... for
    // item = (query head, four head dims), in registers; the splits are then added in a fixed
    // order and folded into the rescaled accumulator
    constexpr int Q = D / 4;  // 32-bit words of int8 per V row
    const int items = G * Q;
    const int per = min(items, NT), nsplit = NT / per;
    for (int base = 0; base < items; base += per) {
      const int it = base + tid % per, split = tid / per;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (split < nsplit && it < items) {
        const int g = it / Q, w = it % Q;
        const float* pg = p_s + g * bkv;
        const int* vw = reinterpret_cast<const int*>(v_s) + w;
        for (int j = split; j < n; j += nsplit) {
          const float p = pg[j];
          const float4 vv = i8x4_to_f32(vw[j * Q]);
          a.x = fmaf(p, vv.x, a.x);
          a.y = fmaf(p, vv.y, a.y);
          a.z = fmaf(p, vv.z, a.z);
          a.w = fmaf(p, vv.w, a.w);
        }
      }
      red_s[tid] = a;
      __syncthreads();
      if (tid < per && base + tid < items) {
        float4 sum = red_s[tid];
        for (int sp = 1; sp < nsplit; ++sp) {
          const float4 r = red_s[sp * per + tid];
          sum.x += r.x;
          sum.y += r.y;
          sum.z += r.z;
          sum.w += r.w;
        }
        const int i4 = base + tid;
        const float alpha = alpha_s[i4 / Q];
        float4* acc4 = reinterpret_cast<float4*>(acc_s) + i4;
        float4 acc = *acc4;
        acc.x = fmaf(acc.x, alpha, sum.x);
        acc.y = fmaf(acc.y, alpha, sum.y);
        acc.z = fmaf(acc.z, alpha, sum.z);
        acc.w = fmaf(acc.w, alpha, sum.w);
        *acc4 = acc;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += NT) {
    const float l = l_s[i / D];
    o[qo + i] = from_f<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D, typename Src>
int launch_d(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* o,
             int B, int Hkv, int G, int bkv, float scale, long long smem, Src src,
             cudaStream_t stream) {
  auto kern = decode_kernel<T, D, Src>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B * Hkv, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs), static_cast<T*>(o), Hkv, G,
      bkv, scale, src);
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int launch(int dtype, int d, const void* q, const void* k, const void* ks, const void* v,
           const void* vs, void* o, int B, int Hkv, int G, int bkv, float scale, long long smem,
           Src src, cudaStream_t st) {
  if (Hkv <= 0 || G <= 0 || bkv <= 0 || B <= 0 || smem != layout(bkv, d, G).total ||
      smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
#define DA_CASE(TT, DD)                                                                     \
  return launch_d<TT, DD, Src>(q, k, ks, v, vs, o, B, Hkv, G, bkv, scale, smem, src, st)
  if (dtype == 0) {
    if (d == 32) DA_CASE(float, 32);
    if (d == 64) DA_CASE(float, 64);
    if (d == 128) DA_CASE(float, 128);
  } else if (dtype == 1) {
    if (d == 32) DA_CASE(__nv_bfloat16, 32);
    if (d == 64) DA_CASE(__nv_bfloat16, 64);
    if (d == 128) DA_CASE(__nv_bfloat16, 128);
  }
#undef DA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for q and o; d in {32, 64, 128}. q and o (B, Hkv * G, 1, D),
// k and v int8 (B, Hkv, S, D), scales f32 (B, Hkv, S), all contiguous. The valid length is
// len_ptr[0] (an int32 on the device) when len_ptr is not null, else len_value; it is clamped to
// [0, S]. smem must equal the layout's total. Returns cudaGetLastError() after the launch.
extern "C" int decode_attention(int dtype, int d, const void* q, const void* k, const void* ks,
                                const void* v, const void* vs, void* o, int B, int Hkv, int G,
                                int S, int bkv, const void* len_ptr, int len_value, float scale,
                                long long smem, void* stream) {
  const Dense src{static_cast<const int*>(len_ptr), len_value, S};
  return launch(dtype, d, q, k, ks, v, vs, o, B, Hkv, G, bkv, scale, smem, src,
                static_cast<cudaStream_t>(stream));
}

// The paged form: pools int8 (Hkv, P, page, D), scales f32 (Hkv, P, page), block tables int32
// (B, maxp), lengths int32 (B,), all contiguous and on the device. A sequence's length is
// clamped to [0, maxp * page]; only its first ceil(len / page) table entries are read. The tile
// is bkv tokens (whole pages: ops.py::paged_tile).
extern "C" int paged_decode_attention(int dtype, int d, const void* q, const void* k,
                                      const void* ks, const void* v, const void* vs, void* o,
                                      int B, int Hkv, int G, int P, int page, const void* tables,
                                      int maxp, const void* lens, int bkv, float scale,
                                      long long smem, void* stream) {
  if (page <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Paged src{static_cast<const int*>(tables), static_cast<const int*>(lens), maxp, page, P};
  return launch(dtype, d, q, k, ks, v, vs, o, B, Hkv, G, bkv, scale, smem, src,
                static_cast<cudaStream_t>(stream));
}
