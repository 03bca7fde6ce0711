// Paged attention for Hopper (sm_90a), behind a plain C interface: a split
// walk over the pages and a merge, launched back to back.
//
// Replaces: mxnet_tpu/ops/paged.py `_paged_kernel` (launched by
// `paged_attention`), the Pallas TPU kernel on every decode step and on
// chunk/offset prefill.  Same function: queries at absolute positions
// qpos attend the keys k <= qpos of their slot, read in place from a pool
// of fixed-size pages through the slot's page table, with an online
// softmax; nothing past the largest query position of a slot's query tile
// is read (the reference's page skip, `j * ps <= qmax`); int8 pages are
// dequantized by their (page, position, head) float32 scale as they are
// loaded; rows with no key give 0.
//
// What bounds it on an H100: at decode (Tq = 1) each key and value
// element read is used for one multiply-add per query, so the bound is the
// HBM bytes of the walked pages (3.35 TB/s).  The design is built to reach
// that whatever the batch, and so that no one slot's long walk (the
// engine's parked row at pos = Tmax walks every entry of its table) sets
// the time:
//   pass 1 (`paged_split_kernel`) cuts each slot's walk into splits of a
//   fixed run of pages (about 64 keys; the wrapper picks the count), one
//   warp per (slot, query tile, head, split), four heads of one split per
//   block, so a batch of 8 slots x 12 heads at ~500 keys runs ~700 warps
//   instead of 96 blocks.  Splits past the tile's last walked key exit at
//   once.  In a warp, lanes take 16-byte slices of a K or V row (float4,
//   8 bf16, or 16 int8 with the dequantize fused into the load) and the
//   warp takes 32 / (lanes per row) keys at a time: no lane is idle at
//   Tq = 1 and no step needs more than the warp (dot products reduce by
//   shuffles, every barrier is __syncwarp).  Each warp copies its rows by
//   cp.async in chunks of up to 16 keys into its own double buffer, the
//   next chunk in flight while this one is computed.  Each group of lanes
//   keeps its own online softmax; the warp folds its groups by shuffles
//   and writes the split's partial (m, l, acc[D]) in float32 to a scratch
//   buffer the wrapper allocates.
//   pass 2 (`paged_merge_kernel`), one warp per (slot, query, head), folds
//   the splits that start at or before the row's position (taken at most
//   at the table's last key), in split order:
//   m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l.  A
//   split with no live key carries m = -1e30 and l = 0 and adds nothing; a
//   row with l <= 0 gives 0, never inf or NaN.
// No atomics and fixed orders throughout, so the result repeats bit for
// bit.  The reduction order is not the reference's single pass: float32
// results differ from it by reassociation only.
//
// Layout: q and out are (B, Tq, H, D) contiguous; the pools are
// (N, ps, H, D) contiguous (16-byte aligned), so one head's row of a key
// is D elements at ((page * ps + position) * H + head) * D; scales are
// (N, ps, H, 1) float32; the table is (B, P) int32 and holds valid page ids
// (the engine guarantees it; unassigned entries point at its never-written
// zero page).  Each warp reads its own table entries, which takes the place
// of the reference's scalar prefetch.  Scratch: B*Tq*H*splits*(D + 2)
// float32.  D is 32, 64, 128 or 256: a row must split into a power of two
// of 16-byte slices, and the merge gives each lane D / 32 columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kMask = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // heads per block in pass 1, rows in pass 2
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkBytes = 4096;  // one tensor's rows in one chunk, at most

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

// 16 bytes of a page row in shared memory, as E floats
template <typename PT>
struct Slice;

template <>
struct Slice<float> {
  static constexpr int E = 4;
  __device__ static void get(const unsigned char* p, float (&x)[E]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Slice<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void get(const unsigned char* p, float (&x)[E]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of a float32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Slice<int8_t> {
  static constexpr int E = 16;
  __device__ static void get(const unsigned char* p, float (&x)[E]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j, sign-extended
        x[4 * i + j] = float(int(w[i] << (24 - 8 * j)) >> 24);
  }
};

// the shape of one warp's walk for head dim D and page type PT
template <int D, typename PT>
struct Walk {
  static constexpr int E = Slice<PT>::E;      // elements per 16-byte slice
  static constexpr int kSlices = D / E;       // slices per row
  static constexpr int GS = kSlices < 32 ? kSlices : 32;  // lanes per row
  static constexpr int SL = kSlices / GS;     // slices per lane
  static constexpr int G = 32 / GS;           // rows per warp step
  static constexpr int kRow = D * sizeof(PT);  // bytes per row
  static constexpr int KC = kChunkBytes / kRow < 16 ? kChunkBytes / kRow : 16;
  static constexpr int kPieces = 2 * KC * kSlices;  // 16-byte copies, K + V
  // a stage: KC rows of K, KC rows of V, KC scales of each
  static constexpr size_t kStage = 2 * size_t(KC) * kRow + 2 * KC * 4;
  static constexpr size_t kBytes = size_t(kWarps) * 2 * kStage;
  static_assert(KC % G == 0 && kPieces % 32 == 0 && KC <= 32, "walk shape");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Pass 1: one warp per (slot, query tile of QT, head, split).  Writes the
// split's partial softmax state of each query row of its tile.
template <typename QT_T, typename PT, int D, int QT>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const QT_T* __restrict__ q, const PT* __restrict__ kp,
                       const PT* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ qpos,
                       float* __restrict__ part, int tq, int heads, int ps,
                       int npt, int ns, float scale) {
  using W = Walk<D, PT>;
  constexpr int E = W::E, GS = W::GS, SL = W::SL, G = W::G, KC = W::KC;
  constexpr int NSTEP = KC / G;
  extern __shared__ __align__(16) unsigned char walk_smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.x;
  const int h = blockIdx.y * kWarps + warp;
  const int n_qt = (tq + QT - 1) / QT;
  const int s = blockIdx.z / n_qt;
  const int t0 = (blockIdx.z % n_qt) * QT;
  const bool quant = ks != nullptr;

  // the tile's query positions; rows past tq attend nothing
  int pos[QT];
  int qmax = -1;
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    pos[t] = t0 + t < tq ? qpos[size_t(s) * tq + t0 + t] : -1;
    qmax = max(qmax, pos[t]);
  }
  const int pps = (npt + ns - 1) / ns;  // pages per split
  const int kb = split * pps * ps;
  // the walk ends at the tile's last attended key (the page skip)
  const int kend = min(npt * ps, qmax + 1);
  if (kb >= kend || h >= heads) return;
  const int ke = min(kb + pps * ps, kend);

  const int grp = lane / GS, gl = lane % GS;
  float qv[QT][SL][E];
#pragma unroll
  for (int t = 0; t < QT; ++t)
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = (gl + sl * GS) * E + e;
        qv[t][sl][e] =
            t0 + t < tq
                ? to_f(q[((size_t(s) * tq + t0 + t) * heads + h) * D + c])
                : 0.f;
      }

  unsigned char* stages = walk_smem + size_t(warp) * 2 * W::kStage;
  const int* trow = table + size_t(s) * npt;
  auto issue = [&](int c0) {
    unsigned char* st = stages + ((c0 - kb) / KC & 1) * W::kStage;
    // lane r < KC finds row r's pool row; the copies fetch it by shuffle
    int my_row = 0;
    if (lane < KC && c0 + lane < ke) {
      const int key = c0 + lane;
      my_row = trow[key / ps] * ps + key % ps;
    }
#pragma unroll
    for (int i = 0; i < W::kPieces / 32; ++i) {
      const int p = lane + 32 * i;
      const int tensor = p / (KC * W::kSlices);  // 0: K, 1: V
      const int r = p % (KC * W::kSlices) / W::kSlices;
      const int c = p % W::kSlices;
      const int row = __shfl_sync(kFull, my_row, r);
      const bool ok = c0 + r < ke;
      const PT* src = (tensor ? vp : kp) + (size_t(row) * heads + h) * D +
                      c * E;
      cp_async16(st + (tensor * KC + r) * W::kRow + c * 16, src, ok);
    }
    if (quant) {
      const int r = lane % KC;
      const int row = __shfl_sync(kFull, my_row, r);
      if (lane < 2 * KC) {
        const bool ok = c0 + r < ke;
        const float* src = (lane < KC ? ks : vs) + size_t(row) * heads + h;
        cp_async4(st + 2 * KC * W::kRow + lane * 4, src, ok);
      }
    }
  };

  // this lane group's running state, per query row
  float m[QT], l[QT], acc[QT][SL][E];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    m[t] = kMask;
    l[t] = 0.f;
#pragma unroll
    for (int sl = 0; sl < SL; ++sl)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[t][sl][e] = 0.f;
  }

  issue(kb);
  cp_async_commit();
  for (int c0 = kb; c0 < ke; c0 += KC) {
    if (c0 + KC < ke) issue(c0 + KC);
    cp_async_commit();
    cp_async_wait1();
    __syncwarp();  // every lane's copies of this chunk are visible
    const unsigned char* st = stages + ((c0 - kb) / KC & 1) * W::kStage;
    const float* kscale = reinterpret_cast<const float*>(st + 2 * KC * W::kRow);
    const float* vscale = kscale + KC;

    // scores of this group's keys of the chunk: row r = step * G + grp
    float sc[QT][NSTEP];
#pragma unroll
    for (int step = 0; step < NSTEP; ++step) {
      const int r = step * G + grp;
      float dot[QT];
#pragma unroll
      for (int t = 0; t < QT; ++t) dot[t] = 0.f;
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        float x[E];
        Slice<PT>::get(st + r * W::kRow + (gl + sl * GS) * 16, x);
        if (quant) {
          const float f = kscale[r];
#pragma unroll
          for (int e = 0; e < E; ++e) x[e] *= f;  // fused dequantize
        }
#pragma unroll
        for (int t = 0; t < QT; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) dot[t] += qv[t][sl][e] * x[e];
      }
#pragma unroll
      for (int t = 0; t < QT; ++t) {
#pragma unroll
        for (int o = GS / 2; o > 0; o >>= 1)
          dot[t] += __shfl_xor_sync(kFull, dot[t], o);
        const int key = c0 + r;
        sc[t][step] = key < ke && key <= pos[t] ? dot[t] * scale : kMask;
      }
    }
    // online softmax over the chunk, one rescale per chunk
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      float mc = m[t];
#pragma unroll
      for (int step = 0; step < NSTEP; ++step) mc = fmaxf(mc, sc[t][step]);
      const float corr = expf(m[t] - mc);
      m[t] = mc;
      l[t] *= corr;
#pragma unroll
      for (int sl = 0; sl < SL; ++sl)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[t][sl][e] *= corr;
    }
#pragma unroll
    for (int step = 0; step < NSTEP; ++step) {
      const int r = step * G + grp;
      float p[QT];
#pragma unroll
      for (int t = 0; t < QT; ++t) {
        // masked-safe exp (paged.py): a chunk fully beyond this row's
        // position has m == kMask, where a bare exp would add 1
        p[t] = sc[t][step] <= kMask * 0.5f ? 0.f : expf(sc[t][step] - m[t]);
        l[t] += p[t];
      }
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        float x[E];
        Slice<PT>::get(st + (KC + r) * W::kRow + (gl + sl * GS) * 16, x);
        if (quant) {
          const float f = vscale[r];
#pragma unroll
          for (int e = 0; e < E; ++e) x[e] *= f;
        }
#pragma unroll
        for (int t = 0; t < QT; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[t][sl][e] += p[t] * x[e];
      }
    }
    __syncwarp();  // done with this stage before it is refilled
  }

  // fold the warp's G groups (butterfly: every group ends with the sum)
#pragma unroll
  for (int o = GS; o < 32; o <<= 1) {
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const float mo = __shfl_xor_sync(kFull, m[t], o);
      const float mn = fmaxf(m[t], mo);
      const float a = expf(m[t] - mn), b = expf(mo - mn);
      l[t] = l[t] * a + __shfl_xor_sync(kFull, l[t], o) * b;
#pragma unroll
      for (int sl = 0; sl < SL; ++sl)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[t][sl][e] =
              acc[t][sl][e] * a + __shfl_xor_sync(kFull, acc[t][sl][e], o) * b;
      m[t] = mn;
    }
  }

  if (grp == 0) {
    const size_t rows = size_t(gridDim.z / n_qt) * tq * heads;
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      if (t0 + t >= tq) continue;
      const size_t pi = ((size_t(s) * tq + t0 + t) * heads + h) * ns + split;
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        float* dst = part + pi * D + (gl + sl * GS) * E;
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(acc[t][sl][e], acc[t][sl][e + 1], acc[t][sl][e + 2],
                          acc[t][sl][e + 3]);
      }
      if (gl == 0) {
        float* ml = part + rows * ns * D + pi * 2;
        ml[0] = m[t];
        ml[1] = l[t];
      }
    }
  }
}

// Pass 2: one warp per (slot, query, head) row; folds the row's live
// splits in split order.
template <typename QT_T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_merge_kernel(const float* __restrict__ part,
                       const int* __restrict__ qpos, QT_T* __restrict__ out,
                       int rows, int heads, int ns, int split_keys,
                       int keys) {
  constexpr int NJ = D / 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int qp = qpos[row / heads];
  // splits starting at or before the row's position, clamped to the
  // table's last key (a parked row sits past it): pass 1 wrote each
  const int n = qp < 0 ? 0 : min(ns, min(qp, keys - 1) / split_keys + 1);
  const float* acc = part + size_t(row) * ns * D;
  const float* ml = part + size_t(rows) * ns * D + size_t(row) * ns * 2;
  float m = kMask;
  for (int i = 0; i < n; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, o[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    // a split with no live key has l = 0 and acc = 0 (and m = kMask)
    const float w = expf(ml[2 * i] - m);
    l += ml[2 * i + 1] * w;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j] += acc[size_t(i) * D + lane + 32 * j] * w;
  }
  // same empty-row rule as flash: zeros out, never inf or NaN
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    out[size_t(row) * D + lane + 32 * j] = from_f<QT_T>(l <= 0.f ? 0.f : o[j] / l);
}

struct Args {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *table, *qpos;
  void* out;
  float* scratch;
  int batch, tq, heads, ps, npt, ns;
  float scale;
  cudaStream_t stream;
};

template <typename QT_T, typename PT, int D, int QT>
cudaError_t launch_split(const Args& a) {
  constexpr size_t smem = Walk<D, PT>::kBytes;
  auto kern = paged_split_kernel<QT_T, PT, D, QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (a.tq + QT - 1) / QT;
  dim3 grid(a.ns, (a.heads + kWarps - 1) / kWarps, a.batch * n_qt);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const QT_T*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), a.ks, a.vs, a.table, a.qpos, a.scratch,
      a.tq, a.heads, a.ps, a.npt, a.ns, a.scale);
  return cudaGetLastError();
}

template <typename QT_T, typename PT, int D>
cudaError_t launch(const Args& a) {
  // decode takes one query per warp; chunks of up to 16 queries take 4
  const cudaError_t err = a.tq == 1 ? launch_split<QT_T, PT, D, 1>(a)
                                    : launch_split<QT_T, PT, D, 4>(a);
  if (err != cudaSuccess) return err;
  const int rows = a.batch * a.tq * a.heads;
  const int split_keys = (a.npt + a.ns - 1) / a.ns * a.ps;
  paged_merge_kernel<QT_T, D>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, a.stream>>>(
          a.scratch, a.qpos, static_cast<QT_T*>(a.out), rows, a.heads, a.ns,
          split_keys, a.npt * a.ps);
  return cudaGetLastError();
}

template <typename QT_T, typename PT>
cudaError_t dispatch(int d, const Args& a) {
  switch (d) {
    case 32:
      return launch<QT_T, PT, 32>(a);
    case 64:
      return launch<QT_T, PT, 64>(a);
    case 128:
      return launch<QT_T, PT, 128>(a);
    case 256:
      return launch<QT_T, PT, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  q_dtype: 0
// float32, 1 bfloat16.  page_dtype: 0 float32, 1 bfloat16, 2 int8 (then
// ks/vs are the (N, ps, H, 1) float32 scales; otherwise both null).
// Float pages must have the query's dtype.  scratch: batch * tq * heads *
// n_splits * (head_dim + 2) float32; each slot's table of npt pages is
// cut into n_splits runs of ceil(npt / n_splits) pages.
extern "C" int mxt_paged_attention(const void* q, const void* kp,
                                   const void* vp, const float* ks,
                                   const float* vs, const int* table,
                                   const int* qpos, void* out, float* scratch,
                                   int batch, int tq, int heads, int head_dim,
                                   int ps, int npt, int n_splits, int q_dtype,
                                   int page_dtype, float scale, void* stream) {
  if (n_splits < 1 || n_splits > npt) return cudaErrorInvalidValue;
  const Args a{q,     kp,      vp,    ks,  vs,  table,    qpos,
               out,   scratch, batch, tq,  heads, ps,     npt,
               n_splits, scale, static_cast<cudaStream_t>(stream)};
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && page_dtype == 0) return dispatch<float, float>(head_dim, a);
  if (q_dtype == 1 && page_dtype == 1) return dispatch<bf16, bf16>(head_dim, a);
  if (q_dtype == 0 && page_dtype == 2) return dispatch<float, int8_t>(head_dim, a);
  if (q_dtype == 1 && page_dtype == 2) return dispatch<bf16, int8_t>(head_dim, a);
  return cudaErrorInvalidValue;
}
