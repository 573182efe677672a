// K7: the multi-buffer product, y = sum_i x @ W_i over `nbuf` weight buffers,
// accumulated in f32 and rounded to bf16 once at the end.
//
// Replaces: the JAX package's tools/repro_tpu_worker_crash.py, `pinned_call`
// (its Pallas body `kernel`): x (R, D) in 256-row tiles, every W_i (D, H)
// pinned whole in VMEM, `acc += dot(x, W_i)` in f32 per buffer, one bf16
// cast.  The VMEM pinning (`with_memory_space_constraint`,
// `vmem_limit_bytes`) is a TPU workaround and is not carried over: the
// weights stream through L2, which holds the tool's 10 MB whole.  As the
// TPU grid (R // 256 steps) does, the kernel covers R in whole 256-row
// tiles; the C entry refuses an R that is not a multiple of 256.
//
// Bound on the H100 at the tool's defaults (R 4096, D 512, 2 buffers of
// H 5120, bf16): 2 R D H nbuf = 42.9 GFLOP against 57 MB of x, W and y, so
// the bf16 tensor-core rate bounds it (0.0434 ms; the bytes take 0.0169 ms).
//
// Design: one block owns a BM x BN tile of y and keeps its f32 accumulator
// in registers across every buffer: for each buffer it runs the register-
// tiled product of gemm_tile.cuh over D (W_i is read N-contiguous through
// the loader functor), so the sum over buffers never leaves the chip and y
// is written once.  The weight pointers arrive as a by-value struct of at
// most kMaxBuffers entries (the wrapper never stacks the buffers, which
// would copy them).  Plain FMA on the CUDA cores (bf16 products are exact
// in f32): a simple first version, far from the tensor-core bound;
// wgmma/TMA tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using pafc::to_f32;

constexpr int kMaxBuffers = 8;
constexpr int kRowTile = 256;  // the TPU kernel's row block
constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
constexpr int TX = BN / TN, TY = BM / TM;
constexpr int kThreads = TX * TY;
static_assert(kRowTile % BM == 0, "row tiles split into whole blocks");

struct Weights {
  const __nv_bfloat16* p[kMaxBuffers];
};

struct XRows {  // x (R, D), rows [r0, r0 + BM); R % BM == 0
  const __nv_bfloat16* x;
  int D, r0;
  __device__ float operator()(int m, int k) const {
    return to_f32(x[(long long)(r0 + m) * D + k]);
  }
};

struct WCols {  // W (D, H) read as B(n, k) = W[k, c0 + n], zero past H
  const __nv_bfloat16* w;
  int H, c0;
  __device__ float operator()(int n, int k) const {
    const int c = c0 + n;
    return c < H ? to_f32(w[(long long)k * H + c]) : 0.f;
  }
};

__global__ void __launch_bounds__(kThreads)
    multi_product_kernel(int D, int H, int nbuf, const __nv_bfloat16* __restrict__ x,
                         Weights ws, __nv_bfloat16* __restrict__ y) {
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float acc[TM][TN];
  pafc::zero_acc(acc);
  for (int b = 0; b < nbuf; ++b)
    pafc::gemm_tile_nt<BM, BN, BK, TM, TN>(D, XRows{x, D, r0}, WCols{ws.p[b], H, c0}, acc);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + j * TX;
      if (c < H) y[(long long)(r0 + ty + i * TY) * H + c] = __float2bfloat16(acc[i][j]);
    }
}

}  // namespace

// x (R, D), ws[0..nbuf) each (D, H) and y (R, H), all bf16 and contiguous;
// ws is a host array of nbuf device pointers.  Returns cudaErrorInvalidValue
// for R % 256 != 0, nbuf outside [1, 8] or a non-positive size.
extern "C" int pafc_multi_product(int R, int D, int H, int nbuf, const void* x,
                                  const void* const* ws, void* y, void* stream) {
  if (R < 1 || D < 1 || H < 1 || R % kRowTile || nbuf < 1 || nbuf > kMaxBuffers)
    return (int)cudaErrorInvalidValue;
  Weights w{};
  for (int b = 0; b < nbuf; ++b) w.p[b] = (const __nv_bfloat16*)ws[b];
  const dim3 grid((H + BN - 1) / BN, R / BM);
  multi_product_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      D, H, nbuf, (const __nv_bfloat16*)x, w, (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}
