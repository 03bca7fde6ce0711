// Forward flash attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces: mxnet_tpu/ops/flash.py `_fwd_kernel` (launched by `_fwd`), the
// Pallas TPU kernel on the prefill and training paths.  Same function:
// causal or full self-attention with an online softmax, an optional packed
// segment-id mask, skipping of key tiles above the diagonal and of tiles
// whose segment ranges cannot meet; rows with no valid key give O = 0 and
// lse = -1e30.  Outputs O in the input dtype and the per-row logsumexp in
// float32, laid out (B*H, T), for the backward.
//
// What bounds it on an H100: at prefill and training shapes (T >= 256,
// D = 64) the work is 4*D flops per attended (query, key) pair against
// 16*D input bytes per row, hundreds of operations per byte, so the bound
// is the tensor cores: 989 TFLOP/s for bf16, and for float32 (the main
// path) 495 / 3 = 165 TFLOP/s, since float32 accuracy takes three TF32
// products per product (3xTF32, flash_tc.cuh).
//
// bf16 at D = 64 and 128 (`flash_fwd_wgmma_kernel`, below) is bound by
// the tensor cores at 989 TFLOP/s and, at D = 64, nearly as much by the
// exponentials of the softmax (one a score, 16 a clock on an SM's
// special-function units, as many clocks as the products take).  Its
// design is Hopper's: a persistent kernel, one block an SM walking
// (batch*head, 128-query) items; one producer warp issues TMA copies (Q,
// then K, V and the tile's key segment ids through a ring of stages
// guarded by full and empty mbarriers) and two consumer warpgroups of 64
// query rows each run S = Q.K^T as a wgmma from shared memory, the online
// softmax in registers and O += P.V as a wgmma whose A operand is P in
// registers, V read through the transpose bit; O leaves by TMA store.
// The producer's warpgroup hands its registers to the consumers
// (setmaxnreg); the consumers take turns on the tensor cores, so one's
// softmax runs beside the other's products.
//
// Float32 (`flash_fwd_tc_kernel`, D = 64 and 128): one
// block of 4 warps per (batch*head, 64-query tile), each warp owning 16
// query rows; blocks walk query tiles longest first (causal tiles near the
// end of T start first).  Q is staged once (float32: split once into its
// two TF32 halves in shared memory).  K and V tiles of 64 keys are
// double-buffered by cp.async: tile k+1's copies are issued before tile k
// is computed, rows past T zero-filled.  S = Q.K^T is an mma.sync
// accumulator and never leaves registers: the row max and sum of the
// online softmax are quad shuffles, and P becomes the A fragment of P.V
// with no data movement (float32 by taking the keys of each 8-key step in
// a permuted order; flash_tc.cuh).  Shared rows are padded (D + 4
// floats) so that lanes read K along d and V along keys without bank
// conflicts, rows 16-byte aligned for cp.async.
//
// D = 256 keeps the first port's body (`flash_fwd_kernel`), chosen at
// compile time: float32 FMAs on the CUDA cores, four threads per query
// row, tiles staged in shared memory.  At D = 256 the O accumulator of 16
// rows alone takes 128 registers a lane, so the tensor-core design needs
// D split across a warp pair there; that is later work.
//
// Layout: q, k, v, o are (B, T, H, D) contiguous.  The reference flattens
// them to (B*H, T, D) with a transpose; here the kernel reads the original
// layout in place through its strides (row stride H*D), so the wrapper
// transposes nothing.
#include <atomic>
#include <cfloat>
#include <type_traits>

#include "flash_tc.cuh"
#include "hopper.cuh"

namespace {

using namespace mxt;

// ------------------------------------ tensor cores: float32 (3xTF32)

constexpr int kWarps = 4;
constexpr int kTC = 32 * kWarps;   // threads per block
constexpr int kBQt = 16 * kWarps;  // queries per block, 16 per warp
constexpr int kBKt = 64;           // keys per tile

template <typename T, int D>
constexpr size_t tc_smem_bytes() {
  // Q (float32: its big and small halves), then two stages of K and V,
  // then two stages of key segment ids
  constexpr size_t ld = D + Mma<T>::kPad;
  constexpr size_t q = (std::is_same<T, float>::value ? 2 : 1) * kBQt * ld;
  return (q + 4 * kBKt * ld) * sizeof(T) + 2 * kBKt * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTC)
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ qseg,
                        const int* __restrict__ kseg, T* __restrict__ o,
                        float* __restrict__ lse, int seq, int heads,
                        int causal, float scale) {
  using M = Mma<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = D + M::kPad;
  constexpr int NT = kBKt / 8;  // 8-key accumulator tiles per key tile
  constexpr int KS = M::kK;     // depth of one product step
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sQ = reinterpret_cast<T*>(tc_smem);  // Q as loaded (float32: small)
  T* sQb = sQ + kBQt * LD;                // float32: Q's big halves
  T* sKV = sQ + (kF32 ? 2 : 1) * kBQt * LD;  // stage s: K, V (2*kBKt x LD)
  int* sKseg = reinterpret_cast<int*>(sKV + 4 * kBKt * LD);  // 2 x kBKt

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = qt * kBQt;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const size_t rs = size_t(heads) * D;  // stride between positions
  const size_t base = size_t(b) * seq * rs + size_t(h) * D;
  const bool has_seg = qseg != nullptr;
  const int nq = min(kBQt, seq - q0);  // valid query rows in this tile

  int n_kt = (seq + kBKt - 1) / kBKt;
  if (causal) n_kt = min(n_kt, (q0 + kBQt + kBKt - 1) / kBKt);
  auto issue = [&](int kt) {
    T* st = sKV + (kt & 1) * 2 * kBKt * LD;
    const int k0 = kt * kBKt, nk = min(kBKt, seq - k0);
    load_rows<D, kTC>(st, LD, k + base, rs, k0, nk, kBKt);
    load_rows<D, kTC>(st + kBKt * LD, LD, v + base, rs, k0, nk, kBKt);
    if (has_seg)
      load_vals<kTC>(sKseg + (kt & 1) * kBKt, kseg + size_t(b) * seq + k0, nk,
                     kBKt);
  };

  load_rows<D, kTC>(sQ, LD, q + base, rs, q0, nq, kBQt);
  cp_async_commit();
  issue(0);
  cp_async_commit();

  // this thread's two query rows, their segment ids, the block's range
  const int r0 = 16 * warp + g;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  int qs[2] = {0, 0}, qmn = 0, qmx = 0;
  if (has_seg) {
    const int* qrow = qseg + size_t(b) * seq;
    for (int i = 0; i < 2; ++i) qs[i] = qi[i] < seq ? qrow[qi[i]] : INT_MIN;
    warp_minmax(qrow + q0, nq, &qmn, &qmx);
  }

  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kF32) {
    // split Q once per block, in place
    for (int i = threadIdx.x; i < kBQt * D; i += kTC) {
      const int at = (i / D) * LD + i % D;
      const Split s = split(sQ[at]);
      sQb[at] = __uint_as_float(s.big);
      sQ[at] = __uint_as_float(s.small);
    }
  }

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) issue(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and Q) visible to every warp
    const T* sK = sKV + (kt & 1) * 2 * kBKt * LD;
    const T* sV = sK + kBKt * LD;
    const int* ks = sKseg + (kt & 1) * kBKt;
    const int k0 = kt * kBKt;
    const int nk = min(kBKt, seq - k0);
    bool run = true;
    if (has_seg) {
      // segment-disjoint tile skip (flash.py `_run_pred`); every warp
      // reaches the same answer
      int mn, mx;
      warp_minmax(ks, nk, &mn, &mx);
      run = mn <= qmx && mx >= qmn;
    }
    if (run) {
      // S = Q.K^T: 16 rows x 64 keys per warp
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / KS; ++kk) {
        typename M::A a;
        if constexpr (kF32) {
          const int at = (16 * warp + g) * LD + 8 * kk + t;
          const int off[4] = {0, 8 * LD, 4, 8 * LD + 4};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a.big[i] = __float_as_uint(sQb[at + off[i]]);
            a.small[i] = __float_as_uint(sQ[at + off[i]]);
          }
        } else {
          a = M::load_a(sQ, LD, 16 * warp, KS * kk);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) M::mma_n(s[j], a, sK, LD, 8 * j, KS * kk);
      }
      // masks and the online softmax; s[j][2*r + e] is row r, key
      // 8j + 2t + e
      float mcur[2] = {kMask, kMask};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const int key = k0 + c;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bool keep = c < nk;
            if (causal) keep = keep && key <= qi[r];
            if (has_seg) keep = keep && qs[r] == ks[c];
            float& x = s[j][2 * r + e];
            x = keep ? x * scale : kMask;
            mcur[r] = fmaxf(mcur[r], x);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnext = fmaxf(m[r], quad_max(mcur[r]));
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // masked-safe exp (flash.py `p = where(s <= _MASK/2, 0, ...)`):
            // a row whose keys in this tile are all masked has mnext ==
            // kMask, and a bare exp(s - mnext) would count 1 per masked key
            float& x = s[j][2 * r + e];
            x = x <= kMask * 0.5f ? 0.f : expf(x - mnext);
            psum += x;
          }
        }
        corr[r] = expf(m[r] - mnext);
        l[r] = corr[r] * l[r] + quad_sum(psum);
        m[r] = mnext;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // O += P.V; P as the A fragment of KS/8 accumulator tiles, rounded
      // to V's dtype (the reference's p.astype(v.dtype)), the row sum l
      // taken before that rounding
#pragma unroll
      for (int j = 0; j < kBKt / KS; ++j) {
        const typename M::A a = M::acc_a(s + j * (KS / 8));
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          M::mma_k(acc[n], a, sV, LD, KS * j, 8 * n);
      }
    }
    __syncthreads();  // every warp is done with stage kt & 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= seq) continue;
    // rows with no matching key anywhere: zeros out and a finite lse of
    // kMask, so a backward recompute exp(s - lse) stays 0 (flash.py
    // `_finish`)
    const bool empty = l[r] <= 0.f;
    T* orow = o + base + size_t(qi[r]) * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + 8 * n, empty ? 0.f : acc[n][2 * r] / l[r],
             empty ? 0.f : acc[n][2 * r + 1] / l[r]);
    if (t == 0)
      lse[size_t(bh) * seq + qi[r]] = empty ? kMask : m[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* qseg, const int* kseg, void* o, float* lse,
                      int batch, int seq, int heads, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<T, D>();
  auto kern = flash_fwd_tc_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, (seq + kBQt - 1) / kBQt);
  kern<<<grid, kTC, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qseg, kseg, static_cast<T*>(o), lse, seq,
      heads, causal, scale);
  return cudaGetLastError();
}

// ------------------------- bfloat16 on Hopper: wgmma fed by TMA (D 64, 128)

namespace wg {

using bf16 = __nv_bfloat16;
using namespace mxt::hopper;

constexpr int kBQ = 128;        // queries per item, 64 per consumer warpgroup
constexpr int kBK = 128;        // keys per tile
constexpr int kBox = 64;        // columns of a TMA box: 128 bytes, the swizzle
constexpr int kRow = 2 * kBox;  // bytes of one box row
constexpr int kThreads = 384;   // the producer's warpgroup, then two consumers
constexpr int kConsumerWarps = 8;
// registers a thread: 128 x 40 + 256 x 232 = 64512 of the SM's 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers: 1 and 2 the consumers' turns, 3 and 4 each consumer's own
constexpr int kTurnBar = 1;
constexpr int kOwnBar = 3;

// Byte offsets into the block's dynamic shared memory (its base rounded
// up to 1024 bytes, which every tile keeps): the Q buffers, the K and V
// stages, O staged for its TMA store (in the same 128-byte swizzle), the
// stages' key segment ids and their {min, max}, then the barriers.  At D
// = 64 two Q buffers (the next item's Q comes in while this one's is
// read) and four stages: 176 KiB of tiles; at D = 128 one and two: 192.
template <int D>
struct Smem {
  static constexpr int kQStages = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr uint32_t kTileQ = kBQ * D * 2;
  static constexpr uint32_t kTileKV = kBK * D * 2;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQStages * kTileQ;
  static constexpr uint32_t v = k + kStages * kTileKV;
  static constexpr uint32_t out = v + kStages * kTileKV;
  static constexpr uint32_t kseg = out + kTileQ;
  static constexpr uint32_t krange = kseg + kStages * kBK * 4;
  // q_full[kQStages], q_empty[kQStages], full[kStages], empty[kStages]
  static constexpr uint32_t bars = krange + kStages * 8;
  static constexpr uint32_t bytes =
      bars + (2 * kQStages + 2 * kStages) * 8 + 1024;
};

// The work: (batch*head, 128-query tile) items, a head's tiles next to
// each other (the blocks that read its K and V run at once and find them
// in L2) and its longest tiles first.  The kernel is persistent: one
// block an SM, block k taking item k of each round of gridDim.x items,
// every other round in reverse (a snake), which evens out the causal
// tiles' unequal lengths.  The producer and the consumers walk the same
// items.
struct Item {
  int b, h, bh, q0, n_kt;
};

__device__ __forceinline__ bool item_of(int round, int n_qt, int n_items,
                                        int heads, int seq, bool causal,
                                        Item* it) {
  const int g = gridDim.x, k = blockIdx.x;
  const int idx = round * g + ((round & 1) ? g - 1 - k : k);
  if (idx >= n_items) return false;
  it->bh = idx / n_qt;
  it->b = it->bh / heads;
  it->h = it->bh % heads;
  it->q0 = (n_qt - 1 - idx % n_qt) * kBQ;
  it->n_kt = (seq + kBK - 1) / kBK;
  if (causal) it->n_kt = min(it->n_kt, (it->q0 + kBQ + kBK - 1) / kBK);
  return true;
}

// The producer warp: for each item, Q (once both consumer warpgroups are
// done with the last item that used its buffer), then for each key tile
// (after both have released its stage) the tile's segment ids and their
// range, written by the warp's lanes, and K and V by TMA, all counted on
// the stage's full barrier.  Rows past T arrive as zeros.  The stages and
// their phases run on across items.
template <int D>
__device__ __forceinline__ void produce(
    unsigned char* sm, const CUtensorMap& tq, const CUtensorMap& tk,
    const CUtensorMap& tv, const int* __restrict__ kseg, int seq, int heads,
    int n_qt, int n_items, bool causal) {
  using L = Smem<D>;
  constexpr int S = L::kStages, QS = L::kQStages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + QS;
  uint64_t* full = bars + 2 * QS;
  uint64_t* empty = bars + 2 * QS + S;
  int* sks = reinterpret_cast<int*>(sm + L::kseg);
  int* skr = reinterpret_cast<int*>(sm + L::krange);
  const int lane = threadIdx.x % 32;
  Item w;
  int it = 0;  // tiles loaded so far
  for (int round = 0;
       item_of(round, n_qt, n_items, heads, seq, causal, &w); ++round) {
    const int qb = round % QS;
    mbar_wait(&q_empty[qb], ((round / QS) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&q_full[qb], L::kTileQ);
#pragma unroll
      for (int i = 0; i < D / kBox; ++i)
        tma_load_4d(sm + L::q + qb * L::kTileQ + i * kBQ * kRow, &tq,
                    &q_full[qb], i * kBox, w.h, w.q0, w.b);
    }
    for (int kt = 0; kt < w.n_kt; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      const int k0 = kt * kBK;
      if (kseg != nullptr) {
        const int nk = min(kBK, seq - k0);
        const int* src = kseg + size_t(w.b) * seq + k0;
        int lo = INT_MAX, hi = INT_MIN;
        for (int i = lane; i < kBK; i += 32) {
          const int x = i < nk ? src[i] : 0;
          sks[s * kBK + i] = x;
          if (i < nk) {
            lo = min(lo, x);
            hi = max(hi, x);
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (lane == 0) {
          skr[2 * s] = lo;
          skr[2 * s + 1] = hi;
        }
        __syncwarp();  // the lanes' writes precede lane 0's arrival
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kTileKV);
#pragma unroll
        for (int i = 0; i < D / kBox; ++i) {
          const uint32_t at = s * L::kTileKV + i * kBK * kRow;
          tma_load_4d(sm + L::k + at, &tk, &full[s], i * kBox, w.h, k0, w.b);
          tma_load_4d(sm + L::v + at, &tv, &full[s], i * kBox, w.h, k0, w.b);
        }
      }
    }
  }
}

// 2^x on the special-function unit (ex2.approx: about 2 ulp, what the
// probabilities then lose in the bf16 rounding is 2^-9)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile's scores (S = Q.K^T, negated when the scale is) with the masked
// ones set to -inf, and each row's largest.  kMaskKeys: key k of column
// col survives for row r when k <= last[r] (the last key the row may
// see: its own position if causal, else T - 1) and, with kSeg, its
// segment id is the row's.  No branch: the conditions are fixed at
// compile time; the maxima are trees of four chains.
template <bool kMaskKeys, bool kSeg>
__device__ __forceinline__ void mask_max(float (&s)[kBK / 2], float (&mx)[2],
                                         int k0, const int (&last)[2],
                                         const int (&qs)[2],
                                         const int* __restrict__ ks) {
  const int t = threadIdx.x & 3;
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[r][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      int kseg = 0;
      if constexpr (kSeg) kseg = ks[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * j + 2 * r + e];
        if constexpr (kMaskKeys) {
          bool keep = k0 + col <= last[r];
          if constexpr (kSeg) keep = keep & (kseg == qs[r]);
          x = keep ? x : -INFINITY;
        }
        float& pm = part[r][(2 * j + e) % 4];
        pm = fmaxf(pm, x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]),
                  fmaxf(part[r][2], part[r][3]));
}

// O += P.V for one tile: kBK / 16 steps, A = P from registers, B = V
// MN-major (the leading byte offset steps between V's 64-column boxes)
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         uint32_t (&p)[kBK / 16][4],
                                         unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs_t(oacc, p[kk], desc_sw128(v + 16 * kk * kRow, kBK * kRow, 1024),
               1);
}

// S = (-)Q.K^T: D / 16 steps, K-major operands
template <int D, bool kNeg>
__device__ __forceinline__ void issue_s(float (&sacc)[kBK / 2],
                                        unsigned char* q,
                                        unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk / 4) * kBQ * kRow + 32 * (kk % 4);
    const uint32_t bt = (kk / 4) * kBK * kRow + 32 * (kk % 4);
    wgmma_ss<kNeg>(sacc, desc_sw128(q + at, 16, 1024),
                   desc_sw128(k + bt, 16, 1024), kk > 0);
  }
}

// One consumer warpgroup (c = 0, 1): of each item, query rows q0 + 64c ..
// + 63, each thread two of them (g and g + 8 of its warp's 16).  The
// softmax runs on the raw scores of S with the exponent exp2(x * sl2 -
// max * sl2), sl2 = |scale| * log2(e) (S is negated for a negative scale,
// so the max is always the max of scale * x; sl2 is at least FLT_MIN, so
// a masked score, -inf, gives 0 whatever the scale).
template <int D>
__device__ __forceinline__ void consume(
    unsigned char* sm, const CUtensorMap& to, const int* __restrict__ qseg,
    float* __restrict__ lse, int c, int seq, int heads, int n_qt,
    int n_items, bool causal, float scale, float sl2) {
  using L = Smem<D>;
  constexpr int S = L::kStages, QS = L::kQStages;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + QS;
  uint64_t* full = bars + 2 * QS;
  uint64_t* empty = bars + 2 * QS + S;
  const int* sks = reinterpret_cast<const int*>(sm + L::kseg);
  const int* skr = reinterpret_cast<const int*>(sm + L::krange);
  const int ct = threadIdx.x % 128;  // thread of this warpgroup
  const int warp = ct / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool has_seg = qseg != nullptr;
  const bool neg = scale < 0.f;
  const float lse_scale = neg ? -scale : scale;

  float sacc[kBK / 2];  // S: 64 rows x kBK keys
  float oacc[D / 2];    // O: 64 rows x D
  // P of the last tile computed, whose O += P.V is issued with the next
  // tile's S = Q.K^T, and that tile's stage (-1: none pending)
  uint32_t p[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.f;

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
  };
  // The two warpgroups take turns to issue their products (FA3's
  // ping-pong), so that one's softmax runs while the other's products
  // hold the tensor cores.  Each passes the turn once a tile, skipped
  // tiles too, so the turns alternate strictly over all items (a
  // warpgroup never passes twice before the other has taken the turn);
  // warpgroup 0 goes first and takes the last pass at the end.
  auto turn_wait = [&]() { bar_sync(kTurnBar + c, 256); };
  auto turn_pass = [&]() { bar_arrive(kTurnBar + 1 - c, 256); };
  if (c == 1) turn_pass();

  Item w;
  int it = 0;  // tiles consumed so far
  for (int round = 0;
       item_of(round, n_qt, n_items, heads, seq, causal, &w); ++round) {
    const int rw0 = w.q0 + 64 * c;      // this warpgroup's first row
    const int nq = min(64, seq - rw0);  // its rows before T (may be <= 0)
    const int row[2] = {rw0 + 16 * warp + g, rw0 + 16 * warp + g + 8};
    const int last[2] = {causal ? min(row[0], seq - 1) : seq - 1,
                         causal ? min(row[1], seq - 1) : seq - 1};
    int qs[2] = {0, 0}, qmn = INT_MAX, qmx = INT_MIN;
    if (has_seg) {
      const int* qrow = qseg + size_t(w.b) * seq;
      for (int r = 0; r < 2; ++r)
        qs[r] = row[r] < seq ? qrow[row[r]] : INT_MIN;
      // the same range in all four warps
      if (nq > 0) warp_minmax(qrow + rw0, nq, &qmn, &qmx);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    // the running max of the scores (-inf: no valid key yet), this
    // lane's part of the sums
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    int pend = -1;
    auto finish_pv = [&]() {  // the pending P.V alone, then its stage back
      reg_fence(oacc);
      wg_fence();
      issue_pv<D>(oacc, p, sm + L::v + pend * L::kTileKV);
      wg_commit();
      wg_wait<0>();
      reg_fence(oacc);
      reg_fence(p);
      release(pend);
      pend = -1;
    };
    const int qb = round % QS;
    mbar_wait(&q_full[qb], (round / QS) & 1);
    unsigned char* sq = sm + L::q + qb * L::kTileQ + 64 * c * kRow;

    for (int kt = 0; kt < w.n_kt; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const int k0 = kt * kBK;
      // the tile is skipped when no key of it can meet a row of this
      // warpgroup: above the diagonal, or (flash.py `_run_pred`) segment
      // ranges that cannot meet; uniform across the warpgroup.  A skip
      // first finishes the pending P.V, so the consumer never holds a
      // stage older than the previous tile's and the producer is never
      // stuck
      bool run = nq > 0 && !(causal && k0 > rw0 + 63);
      if (has_seg) run = run && skr[2 * s] <= qmx && skr[2 * s + 1] >= qmn;
      turn_wait();
      if (!run) {
        if (pend >= 0) finish_pv();
        turn_pass();
        release(s);
        continue;
      }
      // S, then the previous tile's O += P.V: the softmax below overlaps
      // the second product.  Each batch of products starts with a fence
      // of its registers
      reg_fence(sacc);
      wg_fence();
      if (neg)
        issue_s<D, true>(sacc, sq, sm + L::k + s * L::kTileKV);
      else
        issue_s<D, false>(sacc, sq, sm + L::k + s * L::kTileKV);
      wg_commit();
      // masks only where a key may be out of a row's reach: the diagonal
      // tile, the tile that crosses T, packed segments
      const bool edge =
          (causal && k0 + kBK - 1 > rw0) || k0 + kBK > seq || has_seg;
      // the online softmax: P = exp2(x * sl2 - mnext * sl2) in place as
      // one FFMA and one ex2, this lane's row sums, O's rescale.  Masked
      // scores are -inf and give 0, also in a row with no valid key yet
      // (its offset is 0): flash.py's masked-safe exp,
      // `p = where(s <= _MASK/2, 0, ...)`
      float corr[2];
      auto softmax = [&]() {
        float mcur[2];
        if (has_seg)
          mask_max<true, true>(sacc, mcur, k0, last, qs, sks + s * kBK);
        else if (edge)
          mask_max<true, false>(sacc, mcur, k0, last, qs, sks);
        else
          mask_max<false, false>(sacc, mcur, k0, last, qs, sks);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mnext = fmaxf(m[r], quad_max(mcur[r]));
          const float ms = mnext == -INFINITY ? 0.f : mnext * sl2;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sacc[4 * j + 2 * r + e];
              x = exp2_approx(fmaf(x, sl2, -ms));
              part[(2 * j + e) % 4] += x;
            }
          }
          corr[r] = m[r] == mnext ? 1.f : exp2_approx((m[r] - mnext) * sl2);
          l[r] = corr[r] * l[r] + ((part[0] + part[1]) + (part[2] + part[3]));
          m[r] = mnext;
        }
      };
      // one branch holds the whole step, each path its own waits: the
      // compiler then needs no wait of its own in a divergent path (which
      // would serialize every product of the kernel)
      if (pend >= 0) {
        reg_fence(oacc);
        wg_fence();
        issue_pv<D>(oacc, p, sm + L::v + pend * L::kTileKV);
        wg_commit();
        turn_pass();
        wg_wait<1>();  // S
        reg_fence(sacc);
        softmax();
        wg_wait<0>();  // the previous tile's P.V
        reg_fence(oacc);
        reg_fence(p);
        release(pend);
      } else {
        turn_pass();
        wg_wait<0>();
        reg_fence(sacc);
        softmax();
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= corr[0];
        oacc[4 * j + 1] *= corr[0];
        oacc[4 * j + 2] *= corr[1];
        oacc[4 * j + 3] *= corr[1];
      }
      // P rounded to bf16 (the reference's p.astype(v.dtype)) as the A
      // fragments of O += P.V, l summed before that rounding
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      pend = s;
    }
    // this warpgroup reads Q no more: the next item's may come in
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);
    if (pend >= 0) finish_pv();

    // O / l into shared memory (this warpgroup's 64 rows of each 64-column
    // box, in the TMA swizzle: 16-byte chunk ch of row r at ch ^ (r % 8),
    // which also keeps the writes free of bank conflicts), then one TMA
    // store a box, rows past T left out; lse (B*H, T) directly.  Rows with
    // no matching key anywhere give zeros and a finite lse of kMask, so a
    // backward recompute exp(s - lse) stays 0 (flash.py `_finish`)
    unsigned char* so = sm + L::out + 64 * c * kRow;
    if (ct == 0) bulk_wait_read();  // the last item's store has read them
    bar_sync(kOwnBar + c, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]);
      const bool none = lt <= 0.f;
      const float inv = none ? 0.f : 1.f / lt;
      const int lr = 16 * warp + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(
            so + (j / 8) * kBQ * kRow + lr * kRow +
            (((j % 8) ^ (lr % 8)) * 16) + 4 * t) =
            pack_bf16(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
      if (t == 0 && row[r] < seq)
        lse[size_t(w.bh) * seq + row[r]] =
            none ? kMask : m[r] * lse_scale + logf(lt);
    }
    fence_proxy_async();
    bar_sync(kOwnBar + c, 128);
    if (ct == 0 && nq > 0) {
#pragma unroll
      for (int i = 0; i < D / kBox; ++i)
        tma_store_4d(&to, so + i * kBQ * kRow, i * kBox, w.h, rw0, w.b);
      bulk_commit();
    }
  }
  if (ct == 0) bulk_wait();
  if (c == 0) turn_wait();
}

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const int* __restrict__ qseg,
                           const int* __restrict__ kseg,
                           float* __restrict__ lse, int seq, int heads,
                           int n_items, int causal, float scale) {
  using L = wg::Smem<D>;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm =
      wg_smem + ((1024 - (hopper::smem_u32(wg_smem) & 1023)) & 1023);
  const int n_qt = (seq + wg::kBQ - 1) / wg::kBQ;

  if (threadIdx.x == 0) {
    // full barriers take the producer's arrival, empty ones one from each
    // consumer warp
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::bars);
    constexpr int QS = L::kQStages, S = L::kStages;
    for (int i = 0; i < QS; ++i) {
      hopper::mbar_init(bars + i, 1);
      hopper::mbar_init(bars + QS + i, wg::kConsumerWarps);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(bars + 2 * QS + s, 1);
      hopper::mbar_init(bars + 2 * QS + S + s, wg::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // one branch per role to the end: setmaxnreg needs the roles apart
  const int role = threadIdx.x / 128;
  if (role == 0) {
    hopper::regs_dec<wg::kProducerRegs>();
    if (threadIdx.x < 32)
      wg::produce<D>(sm, tq, tk, tv, kseg, seq, heads, n_qt, n_items,
                     causal != 0);
  } else {
    hopper::regs_inc<wg::kConsumerRegs>();
    wg::consume<D>(sm, to, qseg, lse, role - 1, seq, heads, n_qt, n_items,
                   causal != 0, scale,
                   fmaxf(fabsf(scale) * 1.4426950408889634f, FLT_MIN));
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* qseg, const int* kseg, void* o,
                         float* lse, int batch, int seq, int heads,
                         int causal, float scale, cudaStream_t stream) {
  // Q, K, V and O; O is stored a warpgroup's 64 rows at a time
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, o};
  const int rows[4] = {wg::kBQ, wg::kBK, wg::kBK, wg::kBQ / 2};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = hopper::bthd_map(&maps[i], src[i], batch, seq,
                                             heads, D, rows[i]);
    if (err != cudaSuccess) return err;
  }
  // the device's SM count and the kernel's shared-memory limit, once a
  // device (host work on every call would be a few microseconds)
  static std::atomic<int> sm_count[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = wg::Smem<D>::bytes;
  auto kern = flash_fwd_wgmma_kernel<D>;
  int sms = sm_count[device].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sm_count[device].store(sms);
  }
  const int n_items = batch * heads * ((seq + wg::kBQ - 1) / wg::kBQ);
  kern<<<min(n_items, sms), wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], qseg, kseg, lse, seq, heads,
      n_items, causal, scale);
  return cudaGetLastError();
}

// ------------------------------------- D = 256: CUDA cores, either dtype

constexpr int kBQ = 64;        // queries per block
constexpr int kThreads = 256;  // threads per block
constexpr int kTPR = 4;        // threads per query row

template <int D, int BK>
constexpr size_t smem_bytes() {
  return (size_t(kBQ) * (D + 1) + 2 * size_t(BK) * (D + 1) +
          size_t(kBQ) * (BK + 1)) * sizeof(float) +
         (kBQ + BK + 4) * sizeof(int);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, T* __restrict__ o,
                     float* __restrict__ lse, int seq, int heads, int causal,
                     float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int DPT = D / kTPR;   // accumulator columns per thread
  constexpr int CPT = BK / kTPR;  // score columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x LD
  float* sK = sQ + kBQ * LD;    // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sP = sV + BK * LD;     // kBQ x LP
  int* sQseg = reinterpret_cast<int*>(sP + kBQ * LP);  // kBQ
  int* sKseg = sQseg + kBQ;                             // BK
  int* sFlag = sKseg + BK;  // [0] run this tile, [1] q-seg min, [2] max

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int lane = tid % kTPR;
  const size_t rs = size_t(heads) * D;  // stride between positions
  const size_t base = size_t(b) * seq * rs + size_t(h) * D;
  const bool has_seg = qseg != nullptr;
  const int nq = min(kBQ, seq - q0);  // valid query rows in this tile

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r * LD + c] = r < nq ? to_f(q[base + size_t(q0 + r) * rs + c]) : 0.f;
  }
  if (has_seg) {
    for (int i = tid; i < nq; i += kThreads)
      sQseg[i] = qseg[size_t(b) * seq + q0 + i];
  }
  __syncthreads();
  if (has_seg && tid < 32) {
    int mn, mx;
    warp_minmax(sQseg, nq, &mn, &mx);
    if (tid == 0) {
      sFlag[1] = mn;
      sFlag[2] = mx;
    }
  }

  float m = kMask, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  int n_kt = (seq + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ + BK - 1) / BK);
  const int qi = q0 + row;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, seq - k0);
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r < nk;
      const size_t off = base + size_t(k0 + r) * rs + c;
      sK[r * LD + c] = ok ? to_f(k[off]) : 0.f;
      sV[r * LD + c] = ok ? to_f(v[off]) : 0.f;
    }
    if (has_seg) {
      for (int i = tid; i < nk; i += kThreads)
        sKseg[i] = kseg[size_t(b) * seq + k0 + i];
    }
    __syncthreads();
    if (has_seg) {
      // segment-disjoint tile skip (flash.py `_run_pred`)
      if (tid < 32) {
        int mn, mx;
        warp_minmax(sKseg, nk, &mn, &mx);
        if (tid == 0) sFlag[0] = (mn <= sFlag[2]) && (mx >= sFlag[1]);
      }
      __syncthreads();
      if (!sFlag[0]) continue;  // uniform across the block
    }

    float s[CPT];
    float mcur = kMask;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = lane + kTPR * j;
      const int key = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += sQ[row * LD + d] * sK[c * LD + d];
      dot *= scale;
      bool keep = c < nk;
      if (causal) keep = keep && key <= qi;
      if (has_seg) keep = keep && row < nq && sQseg[row] == sKseg[c];
      s[j] = keep ? dot : kMask;
      mcur = fmaxf(mcur, s[j]);
    }
    mcur = quad_max(mcur);
    const float mnext = fmaxf(m, mcur);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = lane + kTPR * j;
      // masked-safe exp, as in the tensor-core kernel
      const float p = s[j] <= kMask * 0.5f ? 0.f : expf(s[j] - mnext);
      psum += p;
      sP[row * LP + c] = round_to<T>(p);  // p.astype(v.dtype)
    }
    psum = quad_sum(psum);
    const float corr = expf(m - mnext);
    l = corr * l + psum;
    m = mnext;
    __syncwarp();  // the row's four threads share one warp
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = lane + kTPR * j;
      float pv = 0.f;
#pragma unroll 16
      for (int c = 0; c < BK; ++c) pv += sP[row * LP + c] * sV[c * LD + d];
      acc[j] = acc[j] * corr + pv;
    }
  }

  if (row < nq) {
    const bool empty = l <= 0.f;
    const size_t ob = base + size_t(qi) * rs;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = lane + kTPR * j;
      o[ob + d] = from_f<T>(empty ? 0.f : acc[j] / l);
    }
    if (lane == 0) lse[size_t(bh) * seq + qi] = empty ? kMask : m + logf(l);
  }
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, void* o, float* lse,
                   int batch, int seq, int heads, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BK>();
  auto kern = flash_fwd_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + kBQ - 1) / kBQ, batch * heads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qseg, kseg, static_cast<T*>(o), lse, seq,
      heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 float32,
// 1 bfloat16.  qseg/kseg are (B, T) int32 or both null.  Each (dtype, head
// dim) has one kernel: at D = 64 and 128 float32 the mma.sync design and
// bf16 the wgmma one, at D = 256 the CUDA-core body.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const int* qseg, const int* kseg, void* o,
                             float* lse, int batch, int seq, int heads,
                             int head_dim, int causal, float scale, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0) {
    switch (head_dim) {
      case 64:
        return launch_tc<float, 64>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                    heads, causal, scale, st);
      case 128:
        return launch_tc<float, 128>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                     heads, causal, scale, st);
      case 256:
        return launch<float, 256, 32>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                      heads, causal, scale, st);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 64:
        return launch_wgmma<64>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                heads, causal, scale, st);
      case 128:
        return launch_wgmma<128>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                 heads, causal, scale, st);
      case 256:
        return launch<bf16, 256, 32>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                     heads, causal, scale, st);
    }
  }
  return cudaErrorInvalidValue;
}
