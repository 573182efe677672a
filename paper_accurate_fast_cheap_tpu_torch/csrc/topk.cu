// K5: exact two-level top-k over a vocab-sized last axis, the one-launch
// form of `top_k_vocab` (the device beam's `xla` route selects with it
// from the fused scores):
//
//   top-k = topk_select.cuh (the selection of K4, and of K2 for k > 32)
//
// Replaces: the JAX package's ops/topk_pallas.py, `_topk_kernel` via
// `_topk_rows` / `top_k_vocab_pallas`.  Rows in float32 or bfloat16 are
// selected in float32 (the upcast is exact, so the order is the input's).
//
// Bound on the H100 at the flagship beam step (R = 32*8 rows, V = 5002):
// it reads R x V scores once and writes R x k pairs, ~5.1 MB in f32, so
// ~1.5 us at 3.35 TB/s; a comparison per score is far below the bytes.
//
// Design: one block per row stages the row in shared memory as f32 (pad at
// -inf) and runs the shared selection.  As K4, the selection's serial
// argmax rounds, not the bytes, bound it.
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
    topk_kernel(int V, int Vp, int k, const T* __restrict__ x, long long ld,
                float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float row[];  // Vp scores, then the chunk maxima / k*128 survivors
  __shared__ pafc::SelectShared sh;
  const int r = blockIdx.x;
  const T* xrow = x + (long long)r * ld;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) row[n] = n < V ? to_f32(xrow[n]) : -INFINITY;
  __syncthreads();
  pafc::select_topk_row(row, V, Vp, k, vals + (long long)r * k, idx + (long long)r * k, sh);
}

template <typename T>
int launch(int R, int V, int k, const void* x, long long ld, float* vals, int* idx,
           cudaStream_t stream) {
  const int Vp = (V + kChunk - 1) / kChunk * kChunk;
  const size_t smem = pafc::select_smem_floats(Vp, k) * sizeof(float);
  int err = pafc::allow_smem(topk_kernel<T>, smem);
  if (err) return err;
  topk_kernel<T><<<R, kSelThreads, smem, stream>>>(V, Vp, k, (const T*)x, ld, vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x (R rows of stride ld, V valid
// columns).  vals (R, k) f32 and idx (R, k) int32 are the outputs.
extern "C" int pafc_topk(int dtype, int R, int V, int k, const void* x, long long ld, void* vals,
                         void* idx, void* stream) {
  if (k < 1 || k > V) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(R, V, k, x, ld, (float*)vals, (int*)idx, st);
  if (dtype == 1) return launch<__nv_bfloat16>(R, V, k, x, ld, (float*)vals, (int*)idx, st);
  return (int)cudaErrorInvalidValue;
}
