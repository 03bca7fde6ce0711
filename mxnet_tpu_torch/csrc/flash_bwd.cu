// Backward flash attention for Hopper (sm_90a), the training backward's
// calls behind a plain C interface: B2's single call (kernel 1 in its own
// mode, computing each row's delta) and B3 (kernel 2).  The kernels, their
// design and what bounds them are in `flash_bwd.cuh`.
//
// Replaces: mxnet_tpu/ops/flash.py `_dq_kernel` and `_dkv_kernel` (both
// launched by `_bwd_impl`).
#include "flash_bwd.cuh"

namespace {

using namespace mxt;

// one kernel per (dtype, head dim), as dispatch_dkv
template <bool DKV>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == 0)
    return DKV ? dispatch_dkv<float>(head_dim, a)
               : dispatch_dq_mode<float, kDqOwn>(head_dim, a);
  if (dtype == 1)
    return DKV ? dispatch_dkv<__nv_bfloat16>(head_dim, a)
               : dispatch_dq_mode<__nv_bfloat16, kDqOwn>(head_dim, a);
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
  const Args a{q,     k,       v,     dout,  lse,     nullptr,
               delta_out, nullptr, qseg,  kseg,  dq,      nullptr,
               batch, seq,     heads, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}

extern "C" int mxt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int* qseg,
                             const int* kseg, void* dk, void* dv, int batch,
                             int seq, int heads, int head_dim, int causal,
                             float scale, int dtype, void* stream) {
  const Args a{q,     k,       v,       dout, lse,   delta,
               nullptr, nullptr, qseg,  kseg, dk,    dv,
               batch, seq,     heads,   causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}
