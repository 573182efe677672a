// K4: CTC shallow fusion + exact two-level top-k over log-probs computed
// beforehand, for the device prefix beam when the joint has no split form
// (the HAT joint; one call per encoder frame):
//
//   score = logaddexp(log_tw + logp[row], log_cw + ctc[row / n_rep])
//   top-k = topk_select.cuh (the selection of K2 and K5)
//
// Replaces: the JAX package's ops/topk_pallas.py, `_fused_topk_kernel` via
// `_fused_topk_rows` / `fused_top_k_vocab_pallas`.  Inputs in float32 or
// bfloat16 are fused in float32, as that wrapper upcasts before its kernel.
//
// Bound on the H100 at the flagship beam step (R = 32*8 rows, B = 32,
// V = 5002): it reads logp (R x V) and the B CTC rows once and writes
// R x k pairs, ~2.9 MB in bf16, so ~0.9 us at 3.35 TB/s; the arithmetic
// (one logaddexp per score) is far below the bytes.
//
// Design: the block selection K2 keeps for k > 32, without a product or a
// logsumexp.  One block per row reads the logp row and its CTC row (strided
// straight out of the (B, T, V) buffer, never repeated across the beam),
// fuses them into
// shared memory as f32 with the pad at -inf, and runs the shared selection.
// No scratch buffer and no second launch.  The selection's serial argmax
// rounds (2k block-wide reductions per row), not the bytes, bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "topk_select.cuh"

namespace {

using pafc::kChunk;
using pafc::kSelThreads;
using pafc::to_f32;

template <typename T>
__global__ void __launch_bounds__(kSelThreads)
    fused_topk_kernel(int V, int Vp, int n_rep, int k, const T* __restrict__ logp, int logp_ld,
                      const T* __restrict__ ctc, int ctc_ld, float log_tw, float log_cw,
                      float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float row[];  // Vp scores, then the chunk maxima / k*128 survivors
  __shared__ pafc::SelectShared sh;
  const int r = blockIdx.x;
  const T* lrow = logp + (long long)r * logp_ld;
  const T* crow = ctc + (long long)(r / n_rep) * ctc_ld;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads)
    row[n] = n < V ? pafc::logaddexp(log_tw + to_f32(lrow[n]), log_cw + to_f32(crow[n]))
                   : -INFINITY;
  __syncthreads();
  pafc::select_topk_row(row, V, Vp, k, vals + (long long)r * k, idx + (long long)r * k, sh);
}

template <typename T>
int launch(int R, int V, int n_rep, int k, const void* logp, int logp_ld, const void* ctc,
           int ctc_ld, float log_tw, float log_cw, float* vals, int* idx, cudaStream_t stream) {
  const int Vp = (V + kChunk - 1) / kChunk * kChunk;
  const size_t smem = pafc::select_smem_floats(Vp, k) * sizeof(float);
  int err = pafc::allow_smem(fused_topk_kernel<T>, smem);
  if (err) return err;
  fused_topk_kernel<T><<<R, kSelThreads, smem, stream>>>(V, Vp, n_rep, k, (const T*)logp,
                                                         logp_ld, (const T*)ctc, ctc_ld, log_tw,
                                                         log_cw, vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for logp (R rows of stride logp_ld) and
// ctc (R / n_rep rows of stride ctc_ld), both with V valid columns.  vals
// (R, k) f32 and idx (R, k) int32 are the outputs.
extern "C" int pafc_fused_topk(int dtype, int R, int V, int n_rep, int k, const void* logp,
                               int logp_ld, const void* ctc, int ctc_ld, float log_tw,
                               float log_cw, void* vals, void* idx, void* stream) {
  if (k < 1 || k > V || n_rep < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PAFC_ARGS                                                                             \
  R, V, n_rep, k, logp, logp_ld, ctc, ctc_ld, log_tw, log_cw, (float*)vals, (int*)idx, st
  if (dtype == 0) return launch<float>(PAFC_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(PAFC_ARGS);
#undef PAFC_ARGS
  return (int)cudaErrorInvalidValue;
}
