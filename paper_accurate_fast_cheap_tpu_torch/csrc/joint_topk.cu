// Fused transducer joint head + log-softmax + CTC shallow fusion + exact
// two-level top-k, for the device prefix beam (one call per encoder frame):
//
//   logits = x @ W^T + b                 (V padded to Vp = 128*G, pad = -inf)
//   logp   = logits - logsumexp(logits)
//   score  = logaddexp(log_tw + logp, log_cw + ctc[row / n_rep])
//   top-k  = 128-wide chunk maxima -> top-k chunks (ties: lowest chunk id)
//            -> top-k of the k*128 survivors (ties: lowest global index)
//
// Replaces: the JAX package's ops/topk_pallas.py,
// `_joint_topk_kernel` + `_select_phases` via `_joint_topk_rows` /
// `joint_top_k_vocab_pallas`.  Selection and tie rules are those of
// `decode/rnnt_search.py:top_k_vocab` (k masked-argmax rounds, lowest index
// on equal values), so indices agree with the plain version exactly where
// the scores do.
//
// Bound on the H100 at the flagship beam step (R = 32*8 rows, D = 640,
// V = 5002): W is 6.5 MB in bf16 and the product 1.68 GFLOP, so ~2 us per
// frame against the tensor-core rate, ~2 us against the memory rate.
//
// Design: two launches.  (1) a register-tiled FMA product (gemm_tile.cuh)
// writes the f32 logits, bias added and pad columns at -inf, into an (R, Vp)
// scratch buffer the wrapper allocates (5 MB: it stays in the 50 MB L2).
// (2) one block per row stages the row in shared memory, takes the
// logsumexp, fuses the CTC row and runs the selection shared with K4 and K5
// (topk_select.cuh: block-wide (value desc, index asc) argmax rounds).  The product runs on CUDA cores,
// far from the tensor-core bound; wgmma tiles and a single persistent launch
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"
#include "topk_select.cuh"

namespace {

using pafc::kChunk;
using pafc::kMaxK;
using pafc::kSelThreads;
using pafc::to_f32;

constexpr int GBM = 64, GBN = 128, GBK = 16, GTM = 8, GTN = 8;
constexpr int kGemmThreads = (GBM / GTM) * (GBN / GTN);

template <typename T>
struct RowLoad {  // rows of an (R, D) activation, zero past R
  const T* p;
  int ld, rows, r0;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    return r < rows ? to_f32(p[(long long)r * ld + k]) : 0.f;
  }
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    joint_logits_kernel(int R, int D, int V, int Vp, const T* __restrict__ x,
                        const T* __restrict__ w, const T* __restrict__ bias,
                        float* __restrict__ logits) {
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  float acc[GTM][GTN];
  pafc::zero_acc(acc);
  pafc::gemm_tile_nt<GBM, GBN, GBK, GTM, GTN>(D, RowLoad<T>{x, D, R, m0}, RowLoad<T>{w, D, V, n0},
                                              acc);
  constexpr int TX = GBN / GTN, TY = GBM / GTM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < GTM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= R) continue;
#pragma unroll
    for (int j = 0; j < GTN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= Vp) continue;
      logits[(long long)m * Vp + n] = n < V ? acc[i][j] + to_f32(bias[n]) : -INFINITY;
    }
  }
}

template <typename TC>
__global__ void __launch_bounds__(kSelThreads)
    fuse_select_kernel(int V, int Vp, int n_rep, int k, const float* __restrict__ logits,
                       const TC* __restrict__ ctc, int ctc_ld, float log_tw, float log_cw,
                       float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float row[];  // Vp scores, then the chunk maxima / k*128 survivors
  __shared__ pafc::SelectShared sh;
  const int r = blockIdx.x;
  const float* lrow = logits + (long long)r * Vp;
  const TC* crow = ctc + (long long)(r / n_rep) * ctc_ld;

  float m = -INFINITY;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) {
    const float l = lrow[n];
    row[n] = l;
    m = fmaxf(m, l);
  }
  m = pafc::block_reduce(m, true, sh);
  float s = 0.f;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) s += expf(row[n] - m);
  const float lse = m + logf(pafc::block_reduce(s, false, sh));
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) {
    const float c = n < V ? to_f32(crow[n]) : -INFINITY;
    row[n] = pafc::logaddexp(log_tw + (row[n] - lse), log_cw + c);
  }
  __syncthreads();

  pafc::select_topk_row(row, V, Vp, k, vals + (long long)r * k, idx + (long long)r * k, sh);
}

template <typename T>
int launch(int R, int D, int V, int n_rep, int k, const void* x, const void* w, const void* b,
           const void* ctc, int ctc_ld, float log_tw, float log_cw, float* logits, float* vals,
           int* idx, cudaStream_t stream) {
  const int Vp = (V + kChunk - 1) / kChunk * kChunk;
  const dim3 ggrid((Vp + GBN - 1) / GBN, (R + GBM - 1) / GBM);
  joint_logits_kernel<T><<<ggrid, kGemmThreads, 0, stream>>>(R, D, V, Vp, (const T*)x,
                                                             (const T*)w, (const T*)b, logits);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = pafc::select_smem_floats(Vp, k) * sizeof(float);
  err = pafc::allow_smem(fuse_select_kernel<T>, smem);
  if (err) return err;
  fuse_select_kernel<T><<<R, kSelThreads, smem, stream>>>(V, Vp, n_rep, k, logits,
                                                          (const T*)ctc, ctc_ld, log_tw, log_cw,
                                                          vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x, w (V, D), b (V) and ctc (B,
// ctc_ld) with ctc_ld >= V.  logits is an (R, Vp) f32 scratch; vals (R, k)
// f32 and idx (R, k) int32 are the outputs.
extern "C" int pafc_joint_topk(int dtype, int R, int D, int V, int n_rep, int k, const void* x,
                               const void* w, const void* b, const void* ctc, int ctc_ld,
                               float log_tw, float log_cw, void* logits, void* vals, void* idx,
                               void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PAFC_ARGS                                                                             \
  R, D, V, n_rep, k, x, w, b, ctc, ctc_ld, log_tw, log_cw, (float*)logits, (float*)vals,      \
      (int*)idx, st
  if (dtype == 0) return launch<float>(PAFC_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(PAFC_ARGS);
#undef PAFC_ARGS
  return (int)cudaErrorInvalidValue;
}
