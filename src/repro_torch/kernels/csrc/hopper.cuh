// Pieces the Hopper kernels share (csrc/masked_matmul.cu and csrc/flash_attention.cu): mbarriers,
// TMA loads, wgmma's fences, and on the host the encoding of TMA maps with a small cache.
// Everything sits in an anonymous namespace, so each kernel library keeps its own copy.
// kernels/common.py hashes this header with every source that includes it, so an edit here
// rebuilds them.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// Device: mbarriers, TMA, wgmma fences
// ---------------------------------------------------------------------------

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
// the same for a 4-d map
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, "
      "%6}], [%2];\n" ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
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

// ---------------------------------------------------------------------------
// Host: TMA maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query, so the library
// links nothing but the runtime
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

// What a map encodes: `rank` dims, dims[0] innermost with unit stride, dim i + 1 at strides[i]
// bytes; boxes of box[0] x ... x box[rank - 1]; zero where a box passes the edge. Made by
// map_spec, which zeroes the padding: the cache compares specs byte for byte.
struct MapSpec {
  const void* base;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
  int rank, dt, swizzle;
};

MapSpec map_spec(CUtensorMapDataType dt, int rank, const void* base, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  MapSpec s;
  memset(&s, 0, sizeof(s));
  s.base = base;
  s.rank = rank;
  s.dt = static_cast<int>(dt);
  s.swizzle = static_cast<int>(swizzle);
  for (int i = 0; i < rank; ++i) {
    s.dims[i] = dims[i];
    s.box[i] = box[i];
    if (i + 1 < rank) s.strides[i] = strides[i];
  }
  return s;
}

int encode_map(CUtensorMap* map, const MapSpec& s) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, static_cast<CUtensorMapDataType>(s.dt), s.rank, const_cast<void*>(s.base), s.dims,
                        s.strides, s.box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        static_cast<CUtensorMapSwizzle>(s.swizzle), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// What TMA takes: a 16-byte aligned base and strides that are multiples of 16 bytes, under 2^40
bool tma_stride(long long bytes) { return bytes > 0 && bytes % 16 == 0 && bytes < (1LL << 40); }

// A small cache of encoded maps, keyed by the whole spec: a weight's maps are encoded once, and
// an activation's again only where its address or shape is new, so a launch does not pay for an
// encoding it made before. (A map holds an address and a layout only, so a hit stays right after
// the tensor that made it is freed.)
int cached_map(CUtensorMap* map, const MapSpec& s) {
  struct Slot {
    MapSpec key;
    CUtensorMap map;
    bool used;
  };
  static Slot slots[512];
  unsigned long long h = 1469598103934665603ULL;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(&s);
  for (size_t i = 0; i < sizeof(s); ++i) h = (h ^ kb[i]) * 1099511628211ULL;
  Slot& slot = slots[h % 512];
  if (slot.used && memcmp(&slot.key, &s, sizeof(s)) == 0) {
    *map = slot.map;
    return 0;
  }
  if (int err = encode_map(map, s)) return err;
  slot.key = s;
  slot.map = *map;
  slot.used = true;
  return 0;
}

}  // namespace
