// Paged attention for Hopper (sm_90a), behind a plain C interface.
//
// Replaces: mxnet_tpu/ops/paged.py `_paged_kernel` (launched by
// `paged_attention`), the Pallas TPU kernel on every decode step and on
// chunk/offset prefill.  Same function: queries at absolute positions
// qpos attend the keys k <= qpos of their slot, read in place from a pool
// of fixed-size pages through the slot's page table, with an online
// softmax across pages; pages whose first key lies past the block's
// largest query position are skipped; int8 pages are dequantized by their
// (page, position, head) float32 scale as they are loaded; rows with no
// key give 0.
//
// What bounds it on an H100: at decode (Tq = 1) each key and value
// element read is used for one multiply-add per query, so the kernel
// moves far more bytes than it computes on: the bound is HBM bytes of the
// pages read (3.35 TB/s).  What the design does about that: it reads each
// live page exactly once per (slot, head), stops at the slot's last
// live page instead of walking the whole table, never materializes the
// gathered (B, P*ps, H, D) rows the gather arm builds, and reads int8
// pages as one byte per element with the dequantize fused into the load.
// It does not yet fill the card at small batch: one block per (slot,
// head) walks its pages in order, so B*H blocks (96 at 8 slots x 12
// heads) share 132 SMs.  Splitting the page walk across blocks with an
// lse merge is the next step.
//
// Layout: q and out are (B, Tq, H, D) contiguous; the pools are
// (N, ps, H, D) contiguous, so one head's page tile is ps rows strided by
// H*D, loaded with that stride; scales are (N, ps, H, 1) float32; the
// table is (B, P) int32 and holds valid page ids (the engine guarantees
// it; unassigned entries point at its never-written zero page).
//
// Block shape: one block per (slot, head, 16-query tile), 128 threads.
// Per page the block stages K and V as float32 in shared memory (one
// padding column), computes the (Tq_tile x ps) score tile, updates the
// per-row running max and sum, and folds P.V into a float32 accumulator
// in shared memory.  The block reads its own table entries, which takes
// the place of the reference's scalar prefetch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kMask = -1e30f;
constexpr int kTQ = 16;        // queries per block
constexpr int kThreads = 128;  // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int ps, int d) {
  return (size_t(kTQ) * (d + 1) + 2 * size_t(ps) * (d + 1) +
          size_t(kTQ) * (ps + 1) + size_t(kTQ) * d + 3 * kTQ) *
             sizeof(float) +
         (kTQ + 1) * sizeof(int);
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                 const PT* __restrict__ vp, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ table,
                 const int* __restrict__ qpos, QT* __restrict__ out, int tq,
                 int heads, int d, int ps, int npt, float scale) {
  const int LD = d + 1;
  const int LS = ps + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // kTQ x LD
  float* sK = sQ + kTQ * LD;        // ps x LD
  float* sV = sK + ps * LD;         // ps x LD
  float* sS = sV + ps * LD;         // kTQ x LS
  float* sAcc = sS + kTQ * LS;      // kTQ x d
  float* sM = sAcc + kTQ * d;       // kTQ
  float* sL = sM + kTQ;             // kTQ
  float* sCorr = sL + kTQ;          // kTQ
  int* sPos = reinterpret_cast<int*>(sCorr + kTQ);  // kTQ
  int* sQmax = sPos + kTQ;                           // 1

  const int s = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kTQ;
  const int nq = min(kTQ, tq - t0);
  const int tid = threadIdx.x;
  const bool quant = ks != nullptr;
  const size_t hd = size_t(heads) * d;

  for (int i = tid; i < nq * d; i += kThreads) {
    const int t = i / d, c = i % d;
    sQ[t * LD + c] = to_f(q[(size_t(s) * tq + t0 + t) * hd + size_t(h) * d + c]);
    sAcc[t * d + c] = 0.f;
  }
  for (int t = tid; t < nq; t += kThreads) {
    sPos[t] = qpos[size_t(s) * tq + t0 + t];
    sM[t] = kMask;
    sL[t] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = sPos[0];
    for (int t = 1; t < nq; ++t) mx = max(mx, sPos[t]);
    sQmax[0] = mx;
  }
  __syncthreads();
  // page-skip predicate (paged.py `j * ps <= qmax`): a page whose first
  // key is past every query position of this block is fully masked
  const int qmax = sQmax[0];
  const int n_pages = qmax < 0 ? 0 : min(npt, qmax / ps + 1);

  for (int j = 0; j < n_pages; ++j) {
    const size_t pid = size_t(table[size_t(s) * npt + j]);
    for (int i = tid; i < ps * d; i += kThreads) {
      const int p = i / d, c = i % d;
      const size_t row = pid * ps + p;
      const size_t off = row * hd + size_t(h) * d + c;
      float kf = to_f(kp[off]);
      float vf = to_f(vp[off]);
      if (quant) {
        // dequantize fused into the load (paged.py `kf * ks_ref[0]`)
        kf *= ks[row * heads + h];
        vf *= vs[row * heads + h];
      }
      sK[p * LD + c] = kf;
      sV[p * LD + c] = vf;
    }
    __syncthreads();
    for (int i = tid; i < nq * ps; i += kThreads) {
      const int t = i / ps, p = i % ps;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot += sQ[t * LD + c] * sK[p * LD + c];
      sS[t * LS + p] = (j * ps + p <= sPos[t]) ? dot * scale : kMask;
    }
    __syncthreads();
    for (int t = tid; t < nq; t += kThreads) {
      const float mprev = sM[t];
      float mcur = kMask;
      for (int p = 0; p < ps; ++p) mcur = fmaxf(mcur, sS[t * LS + p]);
      const float mnext = fmaxf(mprev, mcur);
      float sum = 0.f;
      for (int p = 0; p < ps; ++p) {
        const float x = sS[t * LS + p];
        // masked-safe exp (paged.py): a page fully beyond this row's
        // position has mnext == kMask, where a bare exp would add 1
        const float e = x <= kMask * 0.5f ? 0.f : expf(x - mnext);
        sS[t * LS + p] = e;
        sum += e;
      }
      const float corr = expf(mprev - mnext);
      sL[t] = corr * sL[t] + sum;
      sM[t] = mnext;
      sCorr[t] = corr;
    }
    __syncthreads();
    for (int i = tid; i < nq * d; i += kThreads) {
      const int t = i / d, c = i % d;
      float pv = 0.f;
      for (int p = 0; p < ps; ++p) pv += sS[t * LS + p] * sV[p * LD + c];
      sAcc[t * d + c] = sAcc[t * d + c] * sCorr[t] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * d; i += kThreads) {
    const int t = i / d, c = i % d;
    const float l = sL[t];
    // same empty-row rule as flash: zeros out, never inf or NaN
    out[(size_t(s) * tq + t0 + t) * hd + size_t(h) * d + c] =
        from_f<QT>(l <= 0.f ? 0.f : sAcc[t * d + c] / l);
  }
}

template <typename QT, typename PT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* qpos, void* out, int batch, int tq, int heads,
                   int d, int ps, int npt, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(ps, d);
  auto kern = paged_kernel<QT, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kTQ - 1) / kTQ, heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), ks, vs, table, qpos, static_cast<QT*>(out),
      tq, heads, d, ps, npt, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  q_dtype: 0
// float32, 1 bfloat16.  page_dtype: 0 float32, 1 bfloat16, 2 int8 (then
// ks/vs are the (N, ps, H, 1) float32 scales; otherwise both null).
// Float pages must have the query's dtype.
extern "C" int mxt_paged_attention(const void* q, const void* kp,
                                   const void* vp, const float* ks,
                                   const float* vs, const int* table,
                                   const int* qpos, void* out, int batch,
                                   int tq, int heads, int head_dim, int ps,
                                   int npt, int q_dtype, int page_dtype,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && page_dtype == 0)
    return launch<float, float>(q, kp, vp, nullptr, nullptr, table, qpos, out,
                                batch, tq, heads, head_dim, ps, npt, scale,
                                st);
  if (q_dtype == 1 && page_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, nullptr, nullptr, table, qpos, out, batch, tq, heads,
        head_dim, ps, npt, scale, st);
  if (q_dtype == 0 && page_dtype == 2)
    return launch<float, int8_t>(q, kp, vp, ks, vs, table, qpos, out, batch,
                                 tq, heads, head_dim, ps, npt, scale, st);
  if (q_dtype == 1 && page_dtype == 2)
    return launch<__nv_bfloat16, int8_t>(q, kp, vp, ks, vs, table, qpos, out,
                                         batch, tq, heads, head_dim, ps, npt,
                                         scale, st);
  return cudaErrorInvalidValue;
}
