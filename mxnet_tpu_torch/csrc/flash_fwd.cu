// Forward flash attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces: mxnet_tpu/ops/flash.py `_fwd_kernel` (launched by `_fwd`), the
// Pallas TPU kernel on the prefill path.  Same function: causal or full
// self-attention with an online softmax, an optional packed segment-id
// mask, skipping of key tiles above the diagonal and of tiles whose
// segment ranges cannot meet; rows with no valid key give O = 0 and
// lse = -1e30.  Outputs O in the input dtype and the per-row logsumexp in
// float32, laid out (B*H, T), for the backward that comes later.
//
// What bounds it on an H100: at prefill shapes (T >= 256, D = 64) the
// work is 4*T*T*D/2 multiply-adds per head against 2*T*D*3 input bytes,
// hundreds of operations per byte, so the bound is the tensor cores.
// This first version is built to be right, not to reach that bound: the
// two products run as float32 FMAs on the CUDA cores, so it sits far
// below the tensor-core bound (PERF.md has the measured gap).  What the
// design does about the bound today: scores and probabilities never
// leave shared memory (no T*T matrix in device memory), each K/V tile is
// loaded once per 64-query block and shared by its 256 threads, and the
// causal loop stops at the diagonal, halving the work.  The next step is
// wgmma on bf16 tiles fed by TMA.
//
// Layout: q, k, v, o are (B, T, H, D) contiguous.  The reference flattens
// them to (B*H, T, D) with a transpose; here the kernel reads the
// original layout in place through its strides (row stride H*D), so the
// wrapper transposes nothing.
//
// Block shape: one block per (batch*head, 64-query tile), 256 threads,
// four threads per query row.  Tiles come from the card's limits (227 KB
// of shared memory per block, 255 registers per thread): the Q tile and
// one K and one V tile of BK rows are staged as float32 with one padding
// column (rows of a warp fall in distinct banks), BK = 64 for D <= 128
// and 32 for D = 256 (140 KB of shared memory at D = 256); each thread
// holds D/4 accumulator columns in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kMask = -1e30f;
constexpr int kBQ = 64;        // queries per block
constexpr int kThreads = 256;  // threads per block
constexpr int kTPR = 4;        // threads per query row

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
// The reference casts the probability tile to the value dtype before the
// P.V product (flash.py `p.astype(v_ref.dtype)`); do the same rounding.
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
      // masked-safe exp (flash.py `p = where(s <= _MASK/2, 0, ...)`): a
      // row whose keys in this tile are all masked has mnext == kMask,
      // and a bare exp(s - mnext) would count exp(0) = 1 per masked key
      const float p = s[j] <= kMask * 0.5f ? 0.f : expf(s[j] - mnext);
      psum += p;
      sP[row * LP + c] = round_to<T>(p);
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
    // rows with no matching key anywhere: zeros out and a finite lse of
    // kMask, so a backward recompute exp(s - lse) stays 0 (flash.py
    // `_finish`)
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

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const int* qseg, const int* kseg, void* o, float* lse,
                       int batch, int seq, int heads, int causal, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64, 64>(q, k, v, qseg, kseg, o, lse, batch, seq, heads,
                               causal, scale, stream);
    case 128:
      return launch<T, 128, 64>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                heads, causal, scale, stream);
    case 256:
      return launch<T, 256, 32>(q, k, v, qseg, kseg, o, lse, batch, seq,
                                heads, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 float32,
// 1 bfloat16.  qseg/kseg are (B, T) int32 or both null.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const int* qseg, const int* kseg, void* o,
                             float* lse, int batch, int seq, int heads,
                             int head_dim, int causal, float scale, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(head_dim, q, k, v, qseg, kseg, o, lse, batch,
                             seq, heads, causal, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, qseg, kseg, o, lse,
                                     batch, seq, heads, causal, scale, st);
  return cudaErrorInvalidValue;
}
