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
// Design (`flash_fwd_tc_kernel`, D = 64 and 128, float32 and bf16): one
// block of 4 warps per (batch*head, 64-query tile), each warp owning 16
// query rows; blocks walk query tiles longest first (causal tiles near the
// end of T start first).  Q is staged once (float32: split once into its
// two TF32 halves in shared memory).  K and V tiles of 64 keys are
// double-buffered by cp.async: tile k+1's copies are issued before tile k
// is computed, rows past T zero-filled.  S = Q.K^T is an mma.sync
// accumulator and never leaves registers: the row max and sum of the
// online softmax are quad shuffles, and P becomes the A fragment of P.V
// with no data movement (float32 by taking the keys of each 8-key step in
// a permuted order, bf16 by packing neighbouring columns; flash_tc.cuh).
// Shared rows are padded (D + 4 floats, D + 8 bf16) so that lanes read K
// along d and V along keys without bank conflicts, rows 16-byte aligned
// for cp.async.
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
#include <type_traits>

#include "flash_tc.cuh"

namespace {

using namespace mxt;

// ---------------------- tensor cores: float32 (3xTF32) and bfloat16

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
// dim) has one kernel: D = 64 and 128 the tensor-core design, D = 256 the
// CUDA-core body.
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
        return launch_tc<bf16, 64>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                   heads, causal, scale, st);
      case 128:
        return launch_tc<bf16, 128>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                    heads, causal, scale, st);
      case 256:
        return launch<bf16, 256, 32>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                     heads, causal, scale, st);
    }
  }
  return cudaErrorInvalidValue;
}
