// Register-tiled "NT" matrix-product tile shared by the joint+top-k and the
// LSTM-step kernels: acc[m][n] += sum_k A(m, k) * B(n, k), both operands
// K-contiguous (the nn.Linear weight layout), f32 accumulation.
//
// A block of (BM / TM) * (BN / TN) threads computes one BM x BN output tile.
// Each thread owns rows ty + i * TY and columns tx + j * TX (interleaved, so a
// warp's shared-memory reads fall on consecutive addresses).  Operands reach
// the tile through loader functors that convert to float, apply bounds and
// any column remapping (the LSTM kernel groups the four gates of a unit), so
// the product is written once here.  Plain FMA on the CUDA cores with the
// next K slice prefetched into registers: a simple first version; wgmma/TMA
// tiles are later work.
#pragma once

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace pafc {

template <int TM, int TN>
__device__ __forceinline__ void zero_acc(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// Adds this block's BM x BN tile of A(m, k) B(n, k) over k < K into acc
// (callers zero it first; two calls sum two K ranges into one tile).
template <int BM, int BN, int BK, int TM, int TN, class ALoad, class BLoad>
__device__ __forceinline__ void gemm_tile_nt(int K, const ALoad& a_load, const BLoad& b_load,
                                             float (&acc)[TM][TN]) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  static_assert((BM * BK) % NT == 0 && (BN * BK) % NT == 0, "tile loads split evenly");
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BN * BK / NT;
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // The next K slice is loaded into registers while the current one is
  // multiplied out of shared memory: the loads of a slice are all in flight
  // together and their latency overlaps the FMAs (a load followed by its
  // shared-memory store, one at a time, exposes every load's latency).
  float ra[A_PER], rb[B_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int e = tid + i * NT;
    ra[i] = e % BK < K ? a_load(e / BK, e % BK) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int e = tid + i * NT;
    rb[i] = e % BK < K ? b_load(e / BK, e % BK) : 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      As[e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      Bs[e % BK][e / BK] = rb[i];
    }
    __syncthreads();
    const int k1 = k0 + BK;
    if (k1 < K) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int e = tid + i * NT;
        ra[i] = k1 + e % BK < K ? a_load(e / BK, k1 + e % BK) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int e = tid + i * NT;
        rb[i] = k1 + e % BK < K ? b_load(e / BK, k1 + e % BK) : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace pafc
