// K5: exact two-level top-k over a vocab-sized last axis, the one-launch
// form of `top_k_vocab` (the device beam's `xla` route selects with it
// from the fused scores):
//
//   top-k = topk_filter.cuh (the selection of K4)
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
// -inf) and selects it by a threshold filter: three block barriers a row,
// whatever k, where the first version ran 2k serial block-wide argmax
// rounds (~70 barriers at k = 8).  Rows whose scores fill fewer than k
// chunks (k scores on the direct path) run the two-level selection of
// topk_select.cuh in the same launch, as its -inf rule needs.  What bounds
// it now is the latency of its phases, each a chain of dependent steps in
// 16 warps an SM (the row's loads, the warp sort's shuffles, tau's
// lifting, the compaction, the ranks), and the launch: not the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "topk_filter.cuh"

namespace {

using pafc::kChunk;
using pafc::kSelThreads;
using pafc::to_f32;

template <typename T>
struct RowScore {  // the row as it is, upcast
  static constexpr bool kBounded = false;
  const T* x;
  __device__ float operator()(int n) const { return to_f32(__ldg(x + n)); }
};

template <typename T>
__global__ void __launch_bounds__(kSelThreads)
    topk_kernel(int V, int Vp, int k, const T* __restrict__ x, long long ld,
                float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) float row[];  // Vp scores, then the selection's scratch
  __shared__ pafc::FilterShared sh;
  const int r = blockIdx.x;
  pafc::filter_topk_row(RowScore<T>{x + (long long)r * ld}, row, V, Vp, k,
                        vals + (long long)r * k, idx + (long long)r * k, sh);
}

template <typename T>
int launch(int R, int V, int k, const void* x, long long ld, float* vals, int* idx,
           cudaStream_t stream) {
  const int Vp = (V + kChunk - 1) / kChunk * kChunk;
  const size_t smem = pafc::filter_smem_floats(V, Vp, k) * sizeof(float);
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
