// K6: the fused position-wise feed-forward, y = act(x @ W1^T + b1) @ W2^T + b2
// per row, with the (R, H) hidden activation kept on chip.
//
// Replaces: the JAX package's ops/ffn_pallas.py, `_ffn_kernel` via
// `_ffn_rows` and `fused_ffn`.  Numerics follow it: the first product
// accumulates in f32, the bias and the activation (swish, relu, gelu in its
// tanh form, hardtanh) run in f32, the hidden is rounded to the weights'
// dtype before the second product, which accumulates in f32; y is written
// in x's dtype.  x, W1, b1, W2, b2 share one dtype (the wrapper casts the
// weights to x's, as the JAX wrapper does).  Weights are in nn.Linear
// layout: W1 (H, D), W2 (D, H).
//
// Bound on the H100 at the flagship FFN (R = 32 x 2248 rows, D = 512,
// H = 2048, bf16): 4 R D H = 302 GFLOP against 0.15 GB of x, y and weights,
// so the tensor-core rate bounds it (0.305 ms); at the training shape
// (R = 16 x 375, f32) the CUDA-core f32 rate does (0.37 ms).
//
// Design: one block owns BM rows and all D output columns.  Their f32 y
// accumulator (BM x D) lives in shared memory; the block walks H in slices
// of HS: h = act(x_tile @ W1[slice]^T + b1) is one register-tiled product
// (gemm_tile.cuh) whose epilogue applies the bias and activation and parks
// the rounded slice in shared memory, and y_tile += h @ W2[:, slice]^T is a
// run of products over D's column tiles whose results are added into the
// shared accumulator.  Only x is read and y written per row; the hidden
// never reaches global memory.  Plain FMA on the CUDA cores: a simple first
// version; wgmma/TMA tiles and x staged on chip are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using pafc::from_f32;
using pafc::round_to;
using pafc::to_f32;

constexpr int BM = 32;   // rows per block
constexpr int HS = 64;   // hidden units per slice
constexpr int BN = 64;   // output columns per tile of the second product
constexpr int BK = 16, TM = 2, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;
constexpr int kThreads = TX * TY;
static_assert(HS == BN, "both products use one tile shape");

// rows [r0, r0 + BM) of a (rows, ld) matrix starting at column c0, zero past
// ``rows`` (the K bound is applied by gemm_tile_nt)
template <typename T>
struct Rows {
  const T* p;
  int ld, rows, r0, c0;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    return r < rows ? to_f32(p[(long long)r * ld + c0 + k]) : 0.f;
  }
};

struct SharedRows {  // the hidden slice, (BM, HS) f32 in shared memory
  const float* p;
  __device__ float operator()(int m, int k) const { return p[m * HS + k]; }
};

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == 0) return v / (1.f + expf(-v));  // swish
  if (ACT == 1) return fmaxf(v, 0.f);         // relu
  if (ACT == 2) {                              // gelu, tanh approximation
    const float c = 0.7978845608028654f;       // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return fminf(fmaxf(v, -1.f), 1.f);           // hardtanh
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(int R, int D, int H, const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
               T* __restrict__ y) {
  extern __shared__ float smem[];
  float* ys = smem;            // (BM, D) f32 accumulator
  float* hs = smem + BM * D;   // (BM, HS) hidden slice
  const int m0 = blockIdx.x * BM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int i = threadIdx.x; i < BM * D; i += kThreads) ys[i] = 0.f;
  __syncthreads();

  for (int h0 = 0; h0 < H; h0 += HS) {
    float acc[TM][TN];
    pafc::zero_acc(acc);
    pafc::gemm_tile_nt<BM, HS, BK, TM, TN>(D, Rows<T>{x, D, R, m0, 0}, Rows<T>{w1, D, H, h0, 0},
                                           acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int hh = h0 + tx + j * TX;
        hs[(ty + i * TY) * HS + tx + j * TX] =
            hh < H ? round_to<T>(act<ACT>(acc[i][j] + to_f32(b1[hh]))) : 0.f;
      }
    __syncthreads();
    const int K2 = min(HS, H - h0);
    for (int n0 = 0; n0 < D; n0 += BN) {
      float acc2[TM][TN];
      pafc::zero_acc(acc2);
      pafc::gemm_tile_nt<BM, BN, BK, TM, TN>(K2, SharedRows{hs}, Rows<T>{w2, H, D, n0, h0}, acc2);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tx + j * TX;
          if (n < D) ys[(ty + i * TY) * D + n] += acc2[i][j];
        }
    }
    // gemm_tile_nt ends on a barrier after its last read of hs, so the next
    // slice's epilogue may overwrite it
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D; i += kThreads) {
    const int m = m0 + i / D, n = i % D;
    if (m < R) y[(long long)m * D + n] = from_f32<T>(ys[i] + to_f32(b2[n]));
  }
}

// 227 KB per block on the H100, less the two products' static tiles
// (gemm_tile_nt's As/Bs, 6 KB per instantiation)
constexpr size_t kMaxDynShared = 232448 - 2 * 6144;

template <typename T, int ACT>
int launch(int R, int D, int H, const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y, cudaStream_t stream) {
  const size_t smem = (size_t)BM * (D + HS) * sizeof(float);
  if (smem > kMaxDynShared) return (int)cudaErrorInvalidValue;
  auto kern = ffn_kernel<T, ACT>;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  kern<<<(R + BM - 1) / BM, kThreads, smem, stream>>>(R, D, H, (const T*)x, (const T*)w1,
                                                     (const T*)b1, (const T*)w2, (const T*)b2,
                                                     (T*)y);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int act, int R, int D, int H, const void* x, const void* w1, const void* b1,
             const void* w2, const void* b2, void* y, cudaStream_t st) {
  switch (act) {
    case 0: return launch<T, 0>(R, D, H, x, w1, b1, w2, b2, y, st);
    case 1: return launch<T, 1>(R, D, H, x, w1, b1, w2, b2, y, st);
    case 2: return launch<T, 2>(R, D, H, x, w1, b1, w2, b2, y, st);
    case 3: return launch<T, 3>(R, D, H, x, w1, b1, w2, b2, y, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x (R, D), W1 (H, D), b1 (H),
// W2 (D, H), b2 (D) and y (R, D); act: 0 swish, 1 relu, 2 gelu (tanh
// form), 3 hardtanh.  Returns cudaErrorInvalidValue when the (BM, D) f32
// accumulator does not fit a block's shared memory (D > 1656).
extern "C" int pafc_ffn(int dtype, int act, int R, int D, int H, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, void* stream) {
  if (R < 1 || D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(act, R, D, H, x, w1, b1, w2, b2, y, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(act, R, D, H, x, w1, b1, w2, b2, y, st);
  return (int)cudaErrorInvalidValue;
}
