// Hopper (sm_90a) building blocks in inline PTX: tile copies by the
// Tensor Memory Accelerator (TMA), mbarriers, warpgroup products
// (wgmma) and register rebalancing (setmaxnreg), with the host-side
// encoding of a TMA tensor map.  Used by the bf16 forward of
// flash_fwd.cu; written, like flash_tc.cuh, without CUTLASS or CuTe, so
// a library is one plain nvcc of the repository's own sources.
//
// Shared tiles are bf16 in the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B):
// a tile is rows of 64 bf16 (128 bytes), and within every 8 rows (1024
// bytes) the 16-byte chunk c of row r lands at chunk c ^ (r % 8).  TMA
// writes that layout and wgmma reads it through a descriptor of the same
// swizzle; a tile starts on a 1024-byte boundary, so the pattern lines up.
// A row wider than 128 bytes (D = 128) is two such tiles side by side
// ("boxes"), each of all the rows and 64 columns.
//
// wgmma m64nNk16 (bf16 in, float32 accumulate), the warpgroup's 128
// threads, warp w = lane-group of rows 16w..16w+15, g = lane / 4, t =
// lane % 4:
//   D (64 x N):  d[4j + 0], d[4j + 1]  row 16w + g,     columns 8j + 2t, + 1
//                d[4j + 2], d[4j + 3]  row 16w + g + 8, the same columns
//   A in registers (64 x 16): a0 (16w + g, 2t..2t+1)  a1 (16w + g + 8, 2t..)
//                             a2 (16w + g, 2t+8..)     a3 (16w + g + 8, 2t+8..)
// so the accumulator chunks 2kk and 2kk + 1 of a product, packed to bf16
// pairs, are the A fragment of step kk of the next product as they are.
//
// Descriptors (64 bits): start address >> 4 in bits 0-13, the leading
// byte offset >> 4 in 16-29, the stride byte offset >> 4 in 32-45, the
// layout in 62-63 (1: 128-byte swizzle).
//   K-major operand (the depth contiguous: Q and K in Q.K^T): rows along
//   M or N, stride byte offset 1024 between groups of 8 rows; the leading
//   offset is unused; step kk of 16 starts 32 * kk bytes into the row.
//   MN-major operand (N contiguous: V in P.V, read through the transpose
//   bit): 8 rows of the depth (keys) at 128 bytes, stride byte offset
//   1024 between groups of 8 keys, leading byte offset between the
//   64-column boxes along N; step kk of 16 keys starts 2048 * kk bytes in.
#pragma once

// cuda.h for CUtensorMap and its enums only: the driver is reached at run
// time (encode_tiled)
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mxt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects ``bytes`` of copies to complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

// one box of a 4-d tensor map at coordinates (c0 innermost) into shared
// memory; completion is counted on ``bar`` in bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory out to a 4-d tensor map at coordinates (c0
// innermost), in this thread's bulk group; boxes past the tensor's edge
// are cut off
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory (it may be written)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later copies of the
// async proxy (TMA) that read them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_sw128(const void* tile,
                                               uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return uint64_t((smem_u32(tile) & 0x3FFFF) >> 4) |
         (uint64_t((lead_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t((stride_bytes >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching registers an asynchronous product
// still reads or writes: reads after the wait see the product's values,
// and the registers stay allocated until here
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define MXT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MXT_F16(d, i) \
  MXT_F4(d, i), MXT_F4(d, i + 4), MXT_F4(d, i + 8), MXT_F4(d, i + 12)
#define MXT_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
#define MXT_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128) = (-)A.B (+ d if acc): A and B K-major in shared memory,
// A negated if kNegA
template <bool kNegA>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXT_D64
      ", %64, %65, p, %67, 1, 0, 0;\n}\n"
      : MXT_F16(d, 0), MXT_F16(d, 16), MXT_F16(d, 32), MXT_F16(d, 48)
      : "l"(a), "l"(b), "r"(acc), "n"(kNegA ? -1 : 1));
}

// d (64 x 64) = A.B (+ d if acc): A in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MXT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MXT_F16(d, 0), MXT_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 128) = A.B (+ d if acc): A in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MXT_F16(d, 0), MXT_F16(d, 16), MXT_F16(d, 32), MXT_F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef MXT_D64
#undef MXT_D32
#undef MXT_F16
#undef MXT_F4

// ------------------------------------------------------- named barriers

// the ``count`` threads that name barrier ``id`` (1-15; 0 is
// __syncthreads') meet; arrive counts this warp without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------ setmaxnreg

// a whole warpgroup gives up registers down to R, or takes them up to R
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime,
// so the library links no -lcuda; null if the driver lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over one head's rows of a contiguous (B, T, H, D) bf16
// tensor, in place: dims {D, H, T, B}, boxes of 64 columns x ``rows``
// positions of one head, 128-byte swizzle; loads read rows past T as
// zeros, stores leave them out.  Host work only: no stream is touched, so
// it may run while a stream is being captured into a graph.
inline cudaError_t bthd_map(CUtensorMap* map, const void* base, int batch,
                            int seq, int heads, int head_dim, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(head_dim), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t row = cuuint64_t(head_dim) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace mxt
