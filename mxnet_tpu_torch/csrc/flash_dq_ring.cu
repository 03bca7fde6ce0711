// B2's ring modes for Hopper (sm_90a) behind a plain C interface: kernel 1
// of `flash_bwd.cuh` in its partial mode (pass 0 only: each row's sum P dP
// and sum P over one block of keys, undivided) and its given mode (pass 1
// only: dQ from a delta it is given).  Ring attention (`ops/ring.py`) adds
// the partial sums over the key blocks around the ring, divides once, and
// runs the given mode and B3 with that delta, so each row's delta is the
// single call's rule over the whole sequence.
//
// Replaces: mxnet_tpu/ops/flash.py `_dq_kernel` as ring attention runs it
// (mxnet_tpu/ops/ring.py `_block` under autodiff, one per key block).
// What bounds it and its design: `flash_bwd.cuh`; the partial mode costs
// two products a pair (S, dP), the given mode three (S, dP, dQ).
#include "flash_bwd.cuh"

namespace {

using namespace mxt;

template <typename T>
cudaError_t dispatch(int d, int mode, const Args& a) {
  switch (mode) {
    case kDqPartial:
      return dispatch_dq_mode<T, kDqPartial>(d, a);
    case kDqGiven:
      return dispatch_dq_mode<T, kDqGiven>(d, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mxt_flash_dq (flash_bwd.cu) in a ring mode (`DqMode`): kDqPartial writes
// sum_j P dP to delta_out and sum_j P to psum_out over this call's keys,
// and no dQ; kDqGiven reads each row's delta from delta_in and writes dQ.
// Returns the launch's cudaError_t (0 on success).
extern "C" int mxt_flash_dq_mode(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta_in, float* delta_out,
                                 float* psum_out, const int* qseg,
                                 const int* kseg, void* dq, int batch,
                                 int seq, int heads, int head_dim, int causal,
                                 float scale, int dtype, int mode,
                                 void* stream) {
  const Args a{q,     k,         v,        dout,  lse,     delta_in,
               delta_out, psum_out, qseg,  kseg,  dq,      nullptr,
               batch, seq,       heads,    causal, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(head_dim, mode, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(head_dim, mode, a);
  return cudaErrorInvalidValue;
}
