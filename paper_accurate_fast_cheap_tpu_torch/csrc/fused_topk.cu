// K4: CTC shallow fusion + exact two-level top-k over log-probs computed
// beforehand, for the device prefix beam when the joint has no split form
// (the HAT joint; one call per encoder frame):
//
//   score = logaddexp(log_tw + logp[row], log_cw + ctc[row / n_rep])
//   top-k = topk_filter.cuh (the selection of K5)
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
// Design: one block per row reads the logp row and its CTC row (strided
// straight out of the (B, T, V) buffer, never repeated across the beam),
// all of a warp's loads in flight at once, and selects by the threshold
// filter of K5: three block barriers a row, whatever k, where the first
// version ran 2k serial block-wide argmax rounds.  Its 20 logaddexps a
// thread (expf, log1pf) cost more than the loads, so the row holds
// max(a, b), a lower bound within 0.7 of the score, the group keys and
// tau come from those bounds, and only the columns whose bound may reach
// tau are scored exactly (a handful a row).  Rows whose scores fill fewer
// than k chunks run topk_select.cuh's two-level selection in the same
// launch.  What bounds it now is the latency of its phases, each a chain
// of dependent steps in 16 warps an SM (the loads, the warp sort's
// shuffles, tau's lifting, the exact scores' reloads and expf/log1pf,
// the compaction, the ranks), and the launch: not the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "topk_filter.cuh"

namespace {

using pafc::kChunk;
using pafc::kSelThreads;
using pafc::to_f32;

// score = logaddexp(a, b) = max(a, b) + log1pf(expf(-|a - b|)), whose
// second term lies in [0, ln 2]: max(a, b) is a lower bound within 0.7 of
// it, -inf exactly where the score is; NaN stands where a - b, and so the
// score, is NaN.
template <typename T>
struct FusedScore {
  static constexpr bool kBounded = true;
  static constexpr float kMargin = 0.7f;
  const T* lrow;
  const T* crow;
  float log_tw, log_cw;
  __device__ float operator()(int n) const {
    return pafc::logaddexp(log_tw + to_f32(__ldg(lrow + n)), log_cw + to_f32(__ldg(crow + n)));
  }
  __device__ float low(int n) const {
    const float a = log_tw + to_f32(__ldg(lrow + n)), b = log_cw + to_f32(__ldg(crow + n));
    const float m = fmaxf(a, b), d = a - b;
    return (m == -INFINITY) | (d == d) ? m : __int_as_float(0x7fffffff);
  }
};

template <typename T>
__global__ void __launch_bounds__(kSelThreads)
    fused_topk_kernel(int V, int Vp, int n_rep, int k, const T* __restrict__ logp, int logp_ld,
                      const T* __restrict__ ctc, int ctc_ld, float log_tw, float log_cw,
                      float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) float row[];  // Vp scores, then the selection's scratch
  __shared__ pafc::FilterShared sh;
  const int r = blockIdx.x;
  const FusedScore<T> score{logp + (long long)r * logp_ld, ctc + (long long)(r / n_rep) * ctc_ld,
                            log_tw, log_cw};
  pafc::filter_topk_row(score, row, V, Vp, k, vals + (long long)r * k, idx + (long long)r * k, sh);
}

template <typename T>
int launch(int R, int V, int n_rep, int k, const void* logp, int logp_ld, const void* ctc,
           int ctc_ld, float log_tw, float log_cw, float* vals, int* idx, cudaStream_t stream) {
  const int Vp = (V + kChunk - 1) / kChunk * kChunk;
  const size_t smem = pafc::filter_smem_floats(V, Vp, k) * sizeof(float);
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
