// Tensor-core and async-copy helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), for Hopper (sm_90a).
//
// Float32-accurate products on the tensor cores ("3xTF32", CUTLASS's fast
// float32): each operand x is split into two TF32 values,
//   big = rna_tf32(x),  small = rna_tf32(x - big),
// and a product is summed as small_a*big_b + big_a*small_b + big_a*big_b
// (small terms first; small_a*small_b, about 2^-22 of the product, is
// dropped).  TF32 keeps 10 explicit mantissa bits, so big + small carries
// 21-22 bits of x: a dot product keeps float32's accuracy at three
// tensor-core passes, where a single TF32 pass keeps about three decimal
// digits.
//
// mma.sync.m16n8k8 (tf32 in, f32 accumulate) fragments, with g = lane / 4
// and t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// A product whose A operand is an accumulator (P.V, P^T.dO, dS^T.Q) takes
// its k index in a permuted order inside each 8-wide step: k = t stands for
// column 2t and k = t + 4 for column 2t + 1.  Then the accumulator
// fragment {c0, c2, c1, c3} is the A fragment as it is, with no shuffle,
// and the B operand reads rows 2t and 2t + 1 of the same step.
//
// bfloat16 takes one m16n8k16 product (bf16 in, f32 accumulate) per step;
// each register holds two bf16 of neighbouring k:
//   A (16 x 16):  a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t+8..)  a3 (g + 8, 2t+8..)
//   B (16 x 8):   b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..2t+9, n = g)
// so the accumulators of two neighbouring 8-column tiles, packed to bf16
// pairs, are an A fragment in the natural k order.
//
// `Mma<T>` gives the kernels one interface to both: the depth of a step,
// the row padding of shared tiles, A fragments from a tile or from
// accumulators, and d += a.B with B read from a tile stored along n
// (B[k][n] = tile[n][k], as K in Q.K^T) or along k (tile[k][n], as V in
// P.V).  Shared rows are padded so that both reads are free of bank
// conflicts: (D + 4) floats (4 mod 32 words) or (D + 8) bf16 (also 4 mod
// 32 words), rows 16-byte aligned for cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace mxt {

constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// the reference's casts of P and dS to an operand's dtype before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// min/max of vals[0..n) over one warp; every lane gets the result
__device__ __forceinline__ void warp_minmax(const int* vals, int n, int* mn,
                                            int* mx) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x % 32; i < n; i += 32) {
    lo = min(lo, vals[i]);
    hi = max(hi, vals[i]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  *mn = lo;
  *mx = hi;
}

// ------------------------------------------------------------ 3xTF32

// cvt.rna.tf32.f32: round to nearest, ties away from zero, on the 13 low
// mantissa bits (finite inputs), written as the two integer operations
// it amounts to
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = rna_tf32(x);
  return {big, rna_tf32(x - __uint_as_float(big))};
}

// d += a.b, one m16n8k8 TF32 product, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment, split
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  const float x[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(x[i]);
    f.big[i] = s.big;
    f.small[i] = s.small;
  }
  return f;
}

// d += a.b at float32 accuracy: three TF32 products, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  mma_tf32(d, a.small, s0.big, s1.big);
  mma_tf32(d, a.big, s0.small, s1.small);
  mma_tf32(d, a.big, s0.big, s1.big);
}

// ------------------------------------------------------------ bfloat16

// d += a.b, one m16n8k16 bf16 product, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even, as astype), lo in the low
// half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column from two rows, lo in the low half
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* lo,
                                            const __nv_bfloat16* hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// ------------------------------------------------------ one interface

template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int kK = 8;    // depth of one product step
  static constexpr int kPad = 4;  // padding of a shared row, elements
  using A = FragA;
  // rows r0 + g (and + 8), columns k0 + t (and + 4) of a tile, split
  __device__ static A load_a(const float* tile, int ld, int r0, int k0) {
    const float* p = tile + (r0 + ((threadIdx.x % 32) >> 2)) * ld + k0 +
                     (threadIdx.x & 3);
    return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
  }
  // the accumulator tile c[0] in the permuted k order (see the top)
  __device__ static A acc_a(const float (*c)[4]) {
    return split_a(c[0][0], c[0][2], c[0][1], c[0][3]);
  }
  __device__ static void mma_n(float (&d)[4], const A& a, const float* tile,
                               int ld, int n0, int k0) {
    const float* p = tile + (n0 + ((threadIdx.x % 32) >> 2)) * ld + k0 +
                     (threadIdx.x & 3);
    mma3(d, a, p[0], p[4]);
  }
  __device__ static void mma_k(float (&d)[4], const A& a, const float* tile,
                               int ld, int k0, int n0) {
    const float* p = tile + (k0 + 2 * (threadIdx.x & 3)) * ld + n0 +
                     ((threadIdx.x % 32) >> 2);
    mma3(d, a, p[0], p[ld]);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  struct A {
    uint32_t r[4];
  };
  __device__ static A load_a(const T* tile, int ld, int r0, int k0) {
    const T* p = tile + (r0 + ((threadIdx.x % 32) >> 2)) * ld + k0 +
                 2 * (threadIdx.x & 3);
    return {{ld_u32(p), ld_u32(p + 8 * ld), ld_u32(p + 8),
             ld_u32(p + 8 * ld + 8)}};
  }
  // the accumulator tiles c[0], c[1], rounded to bf16 (the reference's
  // astype before the product)
  __device__ static A acc_a(const float (*c)[4]) {
    return {{pack_bf16(c[0][0], c[0][1]), pack_bf16(c[0][2], c[0][3]),
             pack_bf16(c[1][0], c[1][1]), pack_bf16(c[1][2], c[1][3])}};
  }
  __device__ static void mma_n(float (&d)[4], const A& a, const T* tile,
                               int ld, int n0, int k0) {
    const T* p = tile + (n0 + ((threadIdx.x % 32) >> 2)) * ld + k0 +
                 2 * (threadIdx.x & 3);
    mma_bf16(d, a.r, ld_u32(p), ld_u32(p + 8));
  }
  __device__ static void mma_k(float (&d)[4], const A& a, const T* tile,
                               int ld, int k0, int n0) {
    const T* p = tile + (k0 + 2 * (threadIdx.x & 3)) * ld + n0 +
                 ((threadIdx.x % 32) >> 2);
    mma_bf16(d, a.r, ld_pair(p, p + ld), ld_pair(p + 8 * ld, p + 9 * ld));
  }
};

// two neighbouring outputs (columns 2t, 2t + 1 of a row) in T
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// ------------------------------------------------------------ cp.async

// 16 bytes global -> shared; zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + rows) of one head of a (B, T, H, D) tensor (``src`` at
// that head's element 0 of batch b, row stride ``rs``) into a shared tile
// with leading dimension ld; rows past n are zero.  All NTHR threads of
// the block take part.
template <int D, int NTHR, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld,
                                          const T* __restrict__ src,
                                          size_t rs, int r0, int n, int rows) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = D / kPer;     // chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += NTHR) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool ok = r < n;
    cp_async16(dst + r * ld + c, ok ? src + size_t(r0 + r) * rs + c : src, ok);
  }
}

// src[0 .. count) of a 4-byte array into shared; entries from n on zero
template <int NTHR, typename V>
__device__ __forceinline__ void load_vals(V* dst, const V* __restrict__ src,
                                          int n, int count) {
  for (int i = threadIdx.x; i < count; i += NTHR)
    cp_async4(dst + i, i < n ? src + i : src, i < n);
}

}  // namespace mxt
