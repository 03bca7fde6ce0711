// Backward flash attention for Hopper (sm_90a): two kernels, dQ and dK/dV,
// each behind a plain C interface.
//
// Replaces: mxnet_tpu/ops/flash.py `_dq_kernel` and `_dkv_kernel` (both
// launched by `_bwd_impl`), the Pallas TPU kernels of the training
// backward.  Same function: the probabilities are recomputed from the
// forward's per-row logsumexp, P = exp(S - lse) (zero where S is masked),
// dP = dO.V^T, dS = P * (dP - delta) * scale; then dQ = dS.K (kernel 1)
// and dV = P^T.dO, dK = dS^T.Q (kernel 2).  Kernel 1 computes each row's
// delta in a first pass over the key tiles, delta = sum_j P dP / sum_j P
// from the very P and dP its second pass uses, and writes it for kernel 2.
// In exact arithmetic that is the reference's rowsum(dO * O); in float32 it
// keeps sum_j dS = 0 for each query, which a delta from the forward's O
// (its own 3xTF32 rounding apart from the backward's products) does not:
// where attention is peaked,
// dP - delta cancels, and that mismatch reached 1e-3 of q_proj's gradient
// in a 24-layer BERT-large on an H100 (the reference path: 5e-5 of float64).
// The first pass costs kernel 1 two more products per pair (S and dP
// again).  Causal and packed segment-id masks are the forward's; tiles
// above the diagonal and tiles whose segment ranges cannot meet are
// skipped.  A masked pair has P = 0 and skips its exp, which is the
// reference's masked-safe exp (`where(s <= _MASK/2, 0, exp(s - lse))`):
// a row with no valid key (lse = -1e30) gives dQ = 0 and adds nothing to
// dK/dV, and nothing becomes inf or NaN.
//
// Rounding follows the reference: dS is rounded to k's dtype before the dS.K
// product and to q's dtype before dS^T.Q, P to dO's dtype before P^T.dO; all
// sums are float32; outputs are in the input dtype.
//
// No atomics: kernel 1 runs one block per (batch*head, query tile) and loops
// over key tiles; kernel 2 one block per (batch*head, key tile) and loops
// over query tiles.  Each output element is summed by one thread in a fixed
// order, so gradients repeat bit for bit.  The TPU grid carried these sums
// across an "arbitrary" grid axis in scratch memory; here the loop inside
// the block takes its place.  Causal skip differs per kernel: kernel 1 stops
// its key loop at the diagonal, kernel 2 starts its query loop at the first
// query tile that reaches its key tile.
//
// What bounds it on an H100: per attended (query, key) pair kernel 1 does
// 3*D multiply-adds (S, dP, dQ: 6*D operations) and kernel 2 4*D (S, dP,
// dV, dK: 8*D), against 8*D input bytes per row, so at training shapes
// (T = 1024, D = 64) the bound is operations, by two orders of magnitude:
// the tensor cores, at 495 / 3 = 165 TFLOP/s for float32 through 3xTF32
// (flash_tc.cuh) and 989 TFLOP/s for bf16.  At D = 64 and 128 (both
// dtypes; the main path's is float32 D = 64) both kernels run every
// product there, as mma.sync accumulators that never leave registers:
// `flash_dq_tc_kernel` three per key tile, `flash_dkv_tc_kernel` four per
// query tile; their designs are described at the kernels.  Both keep the
// forward's shape (4 warps of 16 rows, the other side's tiles
// double-buffered by cp.async), so the work per staged byte is the
// forward's.  D = 256 (chosen at compile time, one kernel per case) keeps
// the first port's bodies, for register pressure: 16 rows of a D = 256
// accumulator take 128 registers a lane, kernel 2's two of them 256, so
// the tensor-core design needs D split across a warp pair there.  Those
// bodies run float32 FMAs on the CUDA cores with two shared-memory loads
// each, S, P and dS in shared memory (no T*T matrix in device memory),
// each staged tile read by all 256 threads of the block.
//
// Layout: q, k, v, dO are read and dQ, dK, dV written in (B, T, H, D) in
// place through the row stride H*D; lse and delta are (B*H, T) float32;
// segment ids (B, T) int32.
//
// Tiles of the CUDA-core bodies: the block owns BR rows (queries in kernel
// 1, keys in kernel 2) and loops over tiles of BC rows of the other side;
// TPR = 256 / BR threads share an owned row, each holding D / TPR
// accumulator columns in registers (two sets in kernel 2).  BR = BC = 32
// at D = 256, so the staged tiles (float32, one padding column so rows
// fall in distinct banks) take at most 141 KB of the 227 KB a block may
// use.
#include "flash_tc.cuh"

namespace {

using namespace mxt;

constexpr int kThreads = 256;

// Stage rows [r0, r0 + n) of one head of a (B, T, H, D) tensor as float32
// into dst (rows x (D + 1)); rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t base, size_t rs, int r0, int n,
                                      int rows) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r < n ? to_f(src[base + size_t(r0 + r) * rs + c])
                                 : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

template <int D, int BR, int BC>
constexpr size_t dq_smem() {
  return (2 * size_t(BR) * (D + 1) + 2 * size_t(BC) * (D + 1) +
          size_t(BR) * (BC + 1)) * sizeof(float) +
         (BR + BC + 4) * sizeof(int);
}

template <int D, int BR, int BC>
constexpr size_t dkv_smem() {
  return (2 * size_t(BR) * (D + 1) + 2 * size_t(BC) * (D + 1) +
          2 * size_t(BR) * (BC + 1) + 2 * size_t(BC)) * sizeof(float) +
         (BR + BC + 4) * sizeof(int);
}

// Kernel 1 (B2), the CUDA-core body (D = 256): dQ for BR queries of one
// (batch, head), looping over key tiles of BC.
template <typename T, int D, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta_out,
                    const int* __restrict__ qseg, const int* __restrict__ kseg,
                    T* __restrict__ dq, int seq, int heads, int causal,
                    float scale) {
  constexpr int TPR = kThreads / BR;  // threads per query row
  constexpr int LD = D + 1;
  constexpr int LS = BC + 1;
  constexpr int DPT = D / TPR;   // dQ columns per thread
  constexpr int CPT = BC / TPR;  // key columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // BR x LD
  float* sO = sQ + BR * LD;     // dO, BR x LD
  float* sK = sO + BR * LD;     // BC x LD
  float* sV = sK + BC * LD;     // BC x LD
  float* sS = sV + BC * LD;     // dS, BR x LS
  int* sQseg = reinterpret_cast<int*>(sS + BR * LS);  // BR
  int* sKseg = sQseg + BR;                             // BC
  int* sFlag = sKseg + BC;  // [0] run this tile, [1] q-seg min, [2] max

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const size_t rs = size_t(heads) * D;
  const size_t base = size_t(b) * seq * rs + size_t(h) * D;
  const bool has_seg = qseg != nullptr;
  const int nq = min(BR, seq - q0);

  stage<T, D>(sQ, q, base, rs, q0, nq, BR);
  stage<T, D>(sO, dout, base, rs, q0, nq, BR);
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

  const int qi = q0 + row;
  const bool live = row < nq;
  const float row_lse = live ? lse[size_t(bh) * seq + qi] : 0.f;
  float row_delta = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  int n_kt = (seq + BC - 1) / BC;
  if (causal) n_kt = min(n_kt, (q0 + BR + BC - 1) / BC);  // to the diagonal

  // pass 0 sums P and P.dP of this thread's pairs for the row's delta
  float psum = 0.f, pdp = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      // the row's TPR threads are adjacent lanes of one warp
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
        pdp += __shfl_xor_sync(0xffffffffu, pdp, o);
      }
      row_delta = psum > 0.f ? pdp / psum : 0.f;
      if (live && lane == 0) delta_out[size_t(bh) * seq + qi] = row_delta;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * BC;
      const int nk = min(BC, seq - k0);
      __syncthreads();  // the previous tile's sK/sV/sS reads are done
      stage<T, D>(sK, k, base, rs, k0, nk, BC);
      stage<T, D>(sV, v, base, rs, k0, nk, BC);
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

#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = lane + TPR * j;
        const int key = k0 + c;
        bool keep = live && c < nk;
        if (causal) keep = keep && key <= qi;
        if (has_seg) keep = keep && sQseg[row] == sKseg[c];
        float ds = 0.f;  // a masked pair has P = 0 (flash.py `p = where(...)`)
        if (keep) {
          const float s = dot<D>(sQ + row * LD, sK + c * LD) * scale;
          const float dp = dot<D>(sO + row * LD, sV + c * LD);
          const float p = expf(s - row_lse);
          psum += p;
          pdp += p * dp;
          ds = p * (dp - row_delta) * scale;
        }
        if (pass == 1) sS[row * LS + c] = round_to<T>(ds);  // ds.astype(k)
      }
      if (pass == 0) continue;
      __syncwarp();  // the row's threads share one warp
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = lane + TPR * j;
        float sum = 0.f;
#pragma unroll 16
        for (int c = 0; c < BC; ++c) sum += sS[row * LS + c] * sK[c * LD + d];
        acc[j] += sum;
      }
    }
  }

  if (live) {
    const size_t ob = base + size_t(qi) * rs;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[ob + lane + TPR * j] = from_f<T>(acc[j]);
  }
}

// Kernel 2 (B3): dK and dV for BR keys of one (batch, head), looping over
// query tiles of BC.
template <typename T, int D, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, int causal,
                     float scale) {
  constexpr int TPR = kThreads / BR;  // threads per key row
  constexpr int LD = D + 1;
  constexpr int LS = BC + 1;
  constexpr int DPT = D / TPR;   // dK and dV columns per thread
  constexpr int RPT = BC / TPR;  // query columns per thread
  extern __shared__ float smem[];
  float* sK = smem;             // BR x LD
  float* sV = sK + BR * LD;     // BR x LD
  float* sQ = sV + BR * LD;     // BC x LD
  float* sO = sQ + BC * LD;     // dO, BC x LD
  float* sP = sO + BC * LD;     // P^T, BR x LS
  float* sS = sP + BR * LS;     // dS^T, BR x LS
  float* sLse = sS + BR * LS;   // BC
  float* sDelta = sLse + BC;    // BC
  int* sKseg = reinterpret_cast<int*>(sDelta + BC);  // BR
  int* sQseg = sKseg + BR;                            // BC
  int* sFlag = sQseg + BC;  // [0] run this tile, [1] k-seg min, [2] max

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const size_t rs = size_t(heads) * D;
  const size_t base = size_t(b) * seq * rs + size_t(h) * D;
  const bool has_seg = qseg != nullptr;
  const int nk = min(BR, seq - k0);

  stage<T, D>(sK, k, base, rs, k0, nk, BR);
  stage<T, D>(sV, v, base, rs, k0, nk, BR);
  if (has_seg) {
    for (int i = tid; i < nk; i += kThreads)
      sKseg[i] = kseg[size_t(b) * seq + k0 + i];
  }
  __syncthreads();
  if (has_seg && tid < 32) {
    int mn, mx;
    warp_minmax(sKseg, nk, &mn, &mx);
    if (tid == 0) {
      sFlag[1] = mn;
      sFlag[2] = mx;
    }
  }

  const int key = k0 + row;
  const bool live = row < nk;
  float acc_k[DPT], acc_v[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc_k[j] = acc_v[j] = 0.f;

  const int n_qt = (seq + BC - 1) / BC;
  // causal: the first query tile holding a row >= k0
  const int qt0 = causal ? k0 / BC : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BC;
    const int nq = min(BC, seq - q0);
    __syncthreads();  // the previous tile's reads are done
    stage<T, D>(sQ, q, base, rs, q0, nq, BC);
    stage<T, D>(sO, dout, base, rs, q0, nq, BC);
    for (int i = tid; i < nq; i += kThreads) {
      sLse[i] = lse[size_t(bh) * seq + q0 + i];
      sDelta[i] = delta[size_t(bh) * seq + q0 + i];
      if (has_seg) sQseg[i] = qseg[size_t(b) * seq + q0 + i];
    }
    __syncthreads();
    if (has_seg) {
      if (tid < 32) {
        int mn, mx;
        warp_minmax(sQseg, nq, &mn, &mx);
        if (tid == 0) sFlag[0] = (mn <= sFlag[2]) && (mx >= sFlag[1]);
      }
      __syncthreads();
      if (!sFlag[0]) continue;  // uniform across the block
    }

#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = lane + TPR * j;
      bool keep = live && r < nq;
      if (causal) keep = keep && key <= q0 + r;
      if (has_seg) keep = keep && sQseg[r] == sKseg[row];
      float p = 0.f, ds = 0.f;  // a masked pair has P = 0
      if (keep) {
        const float s = dot<D>(sQ + r * LD, sK + row * LD) * scale;
        const float dp = dot<D>(sO + r * LD, sV + row * LD);
        p = expf(s - sLse[r]);
        ds = p * (dp - sDelta[r]) * scale;
      }
      sP[row * LS + r] = round_to<T>(p);   // p.astype(do.dtype)
      sS[row * LS + r] = round_to<T>(ds);  // ds.astype(q.dtype)
    }
    __syncwarp();  // the row's threads share one warp
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = lane + TPR * j;
      float sv = 0.f, sk = 0.f;
#pragma unroll 16
      for (int r = 0; r < BC; ++r) {
        sv += sP[row * LS + r] * sO[r * LD + d];
        sk += sS[row * LS + r] * sQ[r * LD + d];
      }
      acc_v[j] += sv;
      acc_k[j] += sk;
    }
  }

  if (live) {
    const size_t ob = base + size_t(key) * rs;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[ob + lane + TPR * j] = from_f<T>(acc_k[j]);
      dv[ob + lane + TPR * j] = from_f<T>(acc_v[j]);
    }
  }
}

// Kernel 2 (B3) at D = 64 and 128, float32 and bf16, on the tensor cores
// (Mma<T>, flash_tc.cuh): dK and dV for 64 keys of one (batch, head), 4
// warps of 16 keys each, looping over query tiles of BQ from the first that
// reaches the block's keys.  K and V are staged once; each query tile's Q,
// dO, lse, delta and segment ids are double-buffered by cp.async (tile
// i+1's copies are issued before tile i is computed).  Per query tile each
// warp runs four products, all mma.sync accumulators that stay in
// registers:
//   S^T = K.Q^T, P^T = exp(S^T * scale - lse) (masked pairs 0);
//   dP^T = V.dO^T, dS^T = P^T * (dP^T - delta) * scale;
//   dV += P^T.dO and dK += dS^T.Q, with P^T and dS^T as A fragments
//   (rounded to dO's / q's dtype on the way, as the reference's astype).
// Q and dO are each read in both orientations: as B[d][query] (S^T, dP^T)
// and as B[query][d] (dV, dK); the padded rows of flash_tc.cuh serve both
// without bank conflicts.  K and V A fragments are read from shared memory
// (float32: split) at each use: kept in registers beside the four
// accumulators they would not fit at D = 64.
constexpr int kWarps = 4;
constexpr int kTC = 32 * kWarps;    // threads per block
constexpr int kBKey = 16 * kWarps;  // keys per block

template <typename T, int D, int BQ>
struct DkvSmem {
  static constexpr int kLD = D + Mma<T>::kPad;
  static constexpr size_t kTile = size_t(BQ) * kLD * sizeof(T);
  // a stage: Q, dO (BQ x kLD), then lse, delta, q-seg (BQ each, 4 bytes)
  static constexpr size_t kStage = 2 * kTile + 3 * BQ * 4;
  static constexpr size_t kKV = size_t(2) * kBKey * kLD * sizeof(T);
  static constexpr size_t kBytes = kKV + 2 * kStage;
};

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kTC)
    flash_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, T* __restrict__ dk,
                        T* __restrict__ dv, int seq, int heads, int causal,
                        float scale) {
  using M = Mma<T>;
  using L = DkvSmem<T, D, BQ>;
  constexpr int LD = L::kLD;
  constexpr int NQ = BQ / 8;  // 8-query accumulator tiles per query tile
  constexpr int KS = M::kK;   // depth of one product step
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sK = reinterpret_cast<T*>(tc_smem);  // kBKey x LD
  T* sV = sK + kBKey * LD;                // kBKey x LD
  unsigned char* sStages = tc_smem + L::kKV;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.y * kBKey;  // the longest causal loops first
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const size_t rs = size_t(heads) * D;
  const size_t base = size_t(b) * seq * rs + size_t(h) * D;
  const bool has_seg = qseg != nullptr;
  const int nk = min(kBKey, seq - k0);

  const int n_qt = (seq + BQ - 1) / BQ;
  // causal: the first query tile holding a row >= k0
  const int qt0 = causal ? k0 / BQ : 0;
  auto stage = [&](int qt) { return sStages + ((qt - qt0) & 1) * L::kStage; };
  auto issue = [&](int qt) {
    unsigned char* st = stage(qt);
    const int q0 = qt * BQ, nq = min(BQ, seq - q0);
    load_rows<D, kTC>(reinterpret_cast<T*>(st), LD, q + base, rs, q0, nq, BQ);
    load_rows<D, kTC>(reinterpret_cast<T*>(st + L::kTile), LD, dout + base,
                      rs, q0, nq, BQ);
    float* rows = reinterpret_cast<float*>(st + 2 * L::kTile);
    load_vals<kTC>(rows, lse + size_t(bh) * seq + q0, nq, BQ);
    load_vals<kTC>(rows + BQ, delta + size_t(bh) * seq + q0, nq, BQ);
    if (has_seg)
      load_vals<kTC>(reinterpret_cast<int*>(rows + 2 * BQ),
                     qseg + size_t(b) * seq + q0, nq, BQ);
  };

  load_rows<D, kTC>(sK, LD, k + base, rs, k0, nk, kBKey);
  load_rows<D, kTC>(sV, LD, v + base, rs, k0, nk, kBKey);
  if (qt0 < n_qt) issue(qt0);
  cp_async_commit();

  // this thread's two keys, their segment ids, the block's range
  const int r0 = 16 * warp + g;
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  int ks[2] = {0, 0}, kmn = 0, kmx = 0;
  if (has_seg) {
    const int* krow = kseg + size_t(b) * seq;
    for (int i = 0; i < 2; ++i)
      ks[i] = key[i] < seq ? krow[key[i]] : INT_MIN;
    warp_minmax(krow + k0, nk, &kmn, &kmx);
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) issue(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile qt (and K, V) visible to every warp
    const T* sQ = reinterpret_cast<const T*>(stage(qt));
    const T* sO = sQ + BQ * LD;
    const float* sLse =
        reinterpret_cast<const float*>(stage(qt) + 2 * L::kTile);
    const float* sDelta = sLse + BQ;
    const int* sQseg = reinterpret_cast<const int*>(sDelta + BQ);
    const int q0 = qt * BQ;
    const int nq = min(BQ, seq - q0);
    bool run = true;
    if (has_seg) {
      // segment-disjoint tile skip; every warp reaches the same answer
      int mn, mx;
      warp_minmax(sQseg, nq, &mn, &mx);
      run = mn <= kmx && mx >= kmn;
    }
    if (run) {
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x BQ queries per warp
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / KS; ++kk) {
        const typename M::A ak = M::load_a(sK, LD, 16 * warp, KS * kk);
        const typename M::A av = M::load_a(sV, LD, 16 * warp, KS * kk);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          M::mma_n(s[j], ak, sQ, LD, 8 * j, KS * kk);
          M::mma_n(dp[j], av, sO, LD, 8 * j, KS * kk);
        }
      }
      // P^T and dS^T in place; s[j][2*r + e] is key r, query 8j + 2t + e.
      // A masked pair has P = 0 and skips its exp (the reference's
      // masked-safe exp); a row with no valid key has no kept pair.
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const int qi = q0 + c;
          const float row_lse = sLse[c], row_delta = sDelta[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bool keep = c < nq && key[r] < seq;
            if (causal) keep = keep && key[r] <= qi;
            if (has_seg) keep = keep && ks[r] == sQseg[c];
            const int i = 2 * r + e;
            const float p = keep ? expf(s[j][i] * scale - row_lse) : 0.f;
            dp[j][i] = p * (dp[j][i] - row_delta) * scale;
            s[j][i] = p;
          }
        }
      }
      // dV += P^T.dO and dK += dS^T.Q over this tile's queries
#pragma unroll
      for (int j = 0; j < BQ / KS; ++j) {
        const typename M::A ap = M::acc_a(s + j * (KS / 8));
        const typename M::A ad = M::acc_a(dp + j * (KS / 8));
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          M::mma_k(acc_v[n], ap, sO, LD, KS * j, 8 * n);
          M::mma_k(acc_k[n], ad, sQ, LD, KS * j, 8 * n);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= seq) continue;
    const size_t ob = base + size_t(key[r]) * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dk + ob + 8 * n, acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      store2(dv + ob + 8 * n, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

// Kernel 1 (B2) at D = 64 and 128, float32 and bf16, on the tensor cores
// (Mma<T>, flash_tc.cuh): dQ for 64 queries of one (batch, head), 4 warps
// of 16 queries each, looping over key tiles of BK up to the causal
// diagonal.  Q and dO are staged once (float32 as loaded: their A
// fragments are split at each use, which keeps the block at the forward's
// shared-memory size); each row's lse and delta sit in registers.  K, V
// and the key segment ids are double-buffered by cp.async (tile i+1's
// copies are issued before tile i is computed, rows past T zero-filled).
// Per key tile each warp runs three products, all mma.sync accumulators
// that stay in registers:
//   S = Q.K^T and dP = dO.V^T;
//   P = exp(S * scale - lse) (masked pairs 0, skipping their exp),
//   dS = P * (dP - delta) * scale;
//   dQ += dS.K, with dS as an A fragment (rounded to k's dtype on the way,
//   as the reference's astype) and K read along k.
template <typename T, int D, int BK>
struct DqSmem {
  static constexpr int kLD = D + Mma<T>::kPad;
  // Q and dO (kBKey x kLD), then two stages of K and V (BK x kLD each),
  // then two stages of key segment ids
  static constexpr size_t kQO = size_t(2) * kBKey * kLD * sizeof(T);
  static constexpr size_t kStage = size_t(2) * BK * kLD * sizeof(T);
  static constexpr size_t kBytes = kQO + 2 * kStage + 2 * BK * sizeof(int);
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kTC)
    flash_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta_out,
                       const int* __restrict__ qseg,
                       const int* __restrict__ kseg, T* __restrict__ dq,
                       int seq, int heads, int causal, float scale) {
  using M = Mma<T>;
  using L = DqSmem<T, D, BK>;
  constexpr int LD = L::kLD;
  constexpr int NT = BK / 8;  // 8-key accumulator tiles per key tile
  constexpr int KS = M::kK;   // depth of one product step
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* sQ = reinterpret_cast<T*>(tc_smem);  // kBKey x LD
  T* sO = sQ + kBKey * LD;                // dO, kBKey x LD
  T* sKV = sO + kBKey * LD;               // stage s: K, V (2*BK x LD)
  int* sKseg = reinterpret_cast<int*>(tc_smem + L::kQO + 2 * L::kStage);

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest loops first
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = qt * kBKey;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2, t = threadIdx.x & 3;
  const size_t rs = size_t(heads) * D;
  const size_t base = size_t(b) * seq * rs + size_t(h) * D;
  const bool has_seg = qseg != nullptr;
  const int nq = min(kBKey, seq - q0);

  int n_kt = (seq + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + kBKey + BK - 1) / BK);  // to the diagonal
  auto issue = [&](int kt) {
    T* st = sKV + (kt & 1) * 2 * BK * LD;
    const int k0 = kt * BK, nk = min(BK, seq - k0);
    load_rows<D, kTC>(st, LD, k + base, rs, k0, nk, BK);
    load_rows<D, kTC>(st + BK * LD, LD, v + base, rs, k0, nk, BK);
    if (has_seg)
      load_vals<kTC>(sKseg + (kt & 1) * BK, kseg + size_t(b) * seq + k0, nk,
                     BK);
  };

  load_rows<D, kTC>(sQ, LD, q + base, rs, q0, nq, kBKey);
  load_rows<D, kTC>(sO, LD, dout + base, rs, q0, nq, kBKey);
  cp_async_commit();
  issue(0);
  cp_async_commit();

  // this thread's two query rows: lse, delta, segment ids; the block's
  // segment range
  const int r0 = 16 * warp + g;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float row_lse[2], row_delta[2] = {0.f, 0.f};
  int qs[2] = {0, 0}, qmn = 0, qmx = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = qi[r] < seq;
    row_lse[r] = live ? lse[size_t(bh) * seq + qi[r]] : 0.f;
  }
  if (has_seg) {
    const int* qrow = qseg + size_t(b) * seq;
    for (int i = 0; i < 2; ++i) qs[i] = qi[i] < seq ? qrow[qi[i]] : INT_MIN;
    warp_minmax(qrow + q0, nq, &qmn, &qmx);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // pass 0 sums P and P.dP of this thread's pairs for the rows' deltas;
  // the four threads t of a row group hold disjoint key columns
  float psum[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], o);
          pdp[r] += __shfl_xor_sync(0xffffffffu, pdp[r], o);
        }
        row_delta[r] = psum[r] > 0.f ? pdp[r] / psum[r] : 0.f;
        if (t == 0 && qi[r] < seq)
          delta_out[size_t(bh) * seq + qi[r]] = row_delta[r];
      }
      issue(0);  // pass 0's last tile was read before its closing barrier
      cp_async_commit();
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt) issue(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile kt (and Q, dO) visible to every warp
      const T* sK = sKV + (kt & 1) * 2 * BK * LD;
      const T* sV = sK + BK * LD;
      const int* ks = sKseg + (kt & 1) * BK;
      const int k0 = kt * BK;
      const int nk = min(BK, seq - k0);
      bool run = true;
      if (has_seg) {
        // segment-disjoint tile skip (flash.py `_run_pred`); every warp
        // reaches the same answer
        int mn, mx;
        warp_minmax(ks, nk, &mn, &mx);
        run = mn <= qmx && mx >= qmn;
      }
      if (run) {
        // S = Q.K^T and dP = dO.V^T: 16 queries x BK keys per warp
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / KS; ++kk) {
          const typename M::A aq = M::load_a(sQ, LD, 16 * warp, KS * kk);
          const typename M::A ao = M::load_a(sO, LD, 16 * warp, KS * kk);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            M::mma_n(s[j], aq, sK, LD, 8 * j, KS * kk);
            M::mma_n(dp[j], ao, sV, LD, 8 * j, KS * kk);
          }
        }
        // dS in place of dP; s[j][2*r + e] is query row r, key 8j + 2t + e.
        // A masked pair has P = 0 and skips its exp (the reference's
        // masked-safe exp); a row with no valid key has no kept pair.
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
              const int i = 2 * r + e;
              const float p = keep ? expf(s[j][i] * scale - row_lse[r]) : 0.f;
              psum[r] += p;
              pdp[r] += p * dp[j][i];
              dp[j][i] = p * (dp[j][i] - row_delta[r]) * scale;
            }
          }
        }
        // dQ += dS.K over this tile's keys
        if (pass == 1) {
#pragma unroll
          for (int j = 0; j < BK / KS; ++j) {
            const typename M::A ad = M::acc_a(dp + j * (KS / 8));
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
              M::mma_k(acc[n], ad, sK, LD, KS * j, 8 * n);
          }
        }
      }
      __syncthreads();  // every warp is done with stage kt & 1
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= seq) continue;
    T* row = dq + base + size_t(qi[r]) * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(row + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float* lse;
  const float* delta;  // kernel 2 reads it
  float* delta_out;    // kernel 1 writes it
  const int *qseg, *kseg;
  void *d0, *d1;  // dQ (kernel 1); dK, dV (kernel 2)
  int batch, seq, heads, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int BR, int BC>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem<D, BR, BC>();
  auto kern = flash_dq_kernel<T, D, BR, BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.seq + BR - 1) / BR, a.batch * a.heads);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta_out, a.qseg, a.kseg, static_cast<T*>(a.d0), a.seq,
      a.heads, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, int BR, int BC>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem<D, BR, BC>();
  auto kern = flash_dkv_kernel<T, D, BR, BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.seq + BR - 1) / BR, a.batch * a.heads);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, static_cast<T*>(a.d0), static_cast<T*>(a.d1),
      a.seq, a.heads, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, int BQ>
cudaError_t launch_dkv_tc(const Args& a) {
  constexpr size_t smem = DkvSmem<T, D, BQ>::kBytes;
  auto kern = flash_dkv_tc_kernel<T, D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.batch * a.heads, (a.seq + kBKey - 1) / kBKey);
  kern<<<grid, kTC, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, static_cast<T*>(a.d0), static_cast<T*>(a.d1),
      a.seq, a.heads, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D, int BK>
cudaError_t launch_dq_tc(const Args& a) {
  constexpr size_t smem = DqSmem<T, D, BK>::kBytes;
  auto kern = flash_dq_tc_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.batch * a.heads, (a.seq + kBKey - 1) / kBKey);
  kern<<<grid, kTC, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta_out, a.qseg, a.kseg, static_cast<T*>(a.d0), a.seq,
      a.heads, a.causal, a.scale);
  return cudaGetLastError();
}

// one kernel per (dtype, head dim), as dispatch_dkv
template <typename T>
cudaError_t dispatch_dq(int d, const Args& a) {
  switch (d) {
    case 64:
      return launch_dq_tc<T, 64, 64>(a);
    case 128:
      return launch_dq_tc<T, 128, 64>(a);
    case 256:
      return launch_dq<T, 256, 32, 32>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// one kernel per (dtype, head dim): D = 64 and 128 the tensor-core design,
// D = 256 the CUDA-core body
template <typename T>
cudaError_t dispatch_dkv(int d, const Args& a) {
  switch (d) {
    case 64:
      return launch_dkv_tc<T, 64, 64>(a);
    case 128:
      return launch_dkv_tc<T, 128, 32>(a);
    case 256:
      return launch_dkv<T, 256, 32, 32>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == 0)
    return DKV ? dispatch_dkv<float>(head_dim, a)
               : dispatch_dq<float>(head_dim, a);
  if (dtype == 1)
    return DKV ? dispatch_dkv<__nv_bfloat16>(head_dim, a)
               : dispatch_dq<__nv_bfloat16>(head_dim, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  dtype: 0
// float32, 1 bfloat16.  qseg/kseg are (B, T) int32 or both null; lse and
// delta (B*H, T) float32: mxt_flash_dq writes each row's delta to
// delta_out and mxt_flash_dkv reads it.
extern "C" int mxt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            float* delta_out, const int* qseg,
                            const int* kseg, void* dq, int batch, int seq,
                            int heads, int head_dim, int causal, float scale,
                            int dtype, void* stream) {
  const Args a{q,     k,    v,    dout,    lse,   nullptr, delta_out,
               qseg,  kseg, dq,   nullptr, batch, seq,
               heads, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}

extern "C" int mxt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* qseg,
                             const int* kseg, void* dk, void* dv, int batch,
                             int seq, int heads, int head_dim, int causal,
                             float scale, int dtype, void* stream) {
  const Args a{q,     k,    v,    dout, lse,   delta, nullptr,
               qseg,  kseg, dk,   dv,   batch, seq,
               heads, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}
