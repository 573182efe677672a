// WKV6 forward: the RWKV-6 linear recurrence, per (batch, head), head size N
//
//   y_t[i]    = sum_j r_t[j] * (u[j] * k_t[j] * v_t[i] + S_{t-1}[j][i])
//   S_t[j][i] = exp(-exp(min(w_t[j], log(160/18)))) * S_{t-1}[j][i] + k_t[j] * v_t[i]
//
// Replaces: the JAX package's ops/wkv6_pallas.py, `_kernel_v5` /
// `_v5_head` via `_wkv6_pallas_chunks` + `_wkv6_pallas_two_pass` (and the
// v1-v4, v6, v7 generations, which compute the same y).  The decay clamp is
// the one those kernels and `ops/wkv6.py:wkv6_chunked` apply.
//
// Bound on the H100: bytes.  Each call reads r, k, v, w (B, T, H, N) once and
// writes y once, ~5 x 73.7 MB in bf16 at the flagship window batch
// (B=32, T=2250, H=8, N=64): ~0.11 ms at 3.35 TB/s.  The arithmetic
// (~4 N^2 flops per step and head) is far below the tensor-core ridge.
//
// Design: one block per (b, h) with N threads; thread i keeps column i of S
// in registers and the block walks t in order (the reference CUDA stack's
// layout).  r_t, k_t and the decay are staged in double-buffered shared
// memory, so one barrier per step suffices, and step t+1's loads are issued
// before step t's arithmetic.  The walk is latency bound (T dependent steps
// per block, B*H blocks), far from the byte bound; the chunked two-pass form
// that parallelises over T is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using pafc::from_f32;
using pafc::to_f32;

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_fwd_kernel(int T_len, int H, const T* __restrict__ r,
                                                     const T* __restrict__ k, const T* __restrict__ v,
                                                     const T* __restrict__ w, const float* __restrict__ u,
                                                     const float* __restrict__ s0, T* __restrict__ y,
                                                     float* __restrict__ s_out, float w_clamp) {
  __shared__ float rs[2][N], ks[2][N], ds[2][N], us[N];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int i = threadIdx.x;
  const long long step = (long long)H * N;
  const long long base = (long long)b * T_len * step + (long long)h * N + i;

  float S[N];
  const long long sbase = (long long)bh * N * N;
#pragma unroll
  for (int j = 0; j < N; ++j) S[j] = s0 ? s0[sbase + (long long)j * N + i] : 0.f;
  us[i] = u[h * N + i];

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (T_len > 0) {
    rn = to_f32(r[base]);
    kn = to_f32(k[base]);
    vn = to_f32(v[base]);
    wn = to_f32(w[base]);
  }
  for (int t = 0; t < T_len; ++t) {
    const int buf = t & 1;
    rs[buf][i] = rn;
    ks[buf][i] = kn;
    ds[buf][i] = expf(-expf(fminf(wn, w_clamp)));
    const float vi = vn;
    const long long idx = base + (long long)t * step;
    if (t + 1 < T_len) {
      rn = to_f32(r[idx + step]);
      kn = to_f32(k[idx + step]);
      vn = to_f32(v[idx + step]);
      wn = to_f32(w[idx + step]);
    }
    __syncthreads();
    float ruk = 0.f, acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float rj = rs[buf][j], kj = ks[buf][j];
      ruk = fmaf(rj * us[j], kj, ruk);
      acc = fmaf(rj, S[j], acc);
      S[j] = fmaf(S[j], ds[buf][j], kj * vi);
    }
    y[idx] = from_f32<T>(fmaf(ruk, vi, acc));
  }
  if (s_out) {
#pragma unroll
    for (int j = 0; j < N; ++j) s_out[sbase + (long long)j * N + i] = S[j];
  }
}

template <typename T>
int launch(int B, int T_len, int H, int N, const void* r, const void* k, const void* v,
           const void* w, const float* u, const float* s0, void* y, float* s_out, float w_clamp,
           cudaStream_t stream) {
  const dim3 grid(B * H);
#define PAFC_WKV_CASE(NN)                                                                       \
  case NN:                                                                                      \
    wkv6_fwd_kernel<T, NN><<<grid, NN, 0, stream>>>(                                            \
        T_len, H, (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, (T*)y, s_out,      \
        w_clamp);                                                                               \
    break;
  switch (N) {
    PAFC_WKV_CASE(16)
    PAFC_WKV_CASE(32)
    PAFC_WKV_CASE(64)
    PAFC_WKV_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAFC_WKV_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y share it).  u is (H, N)
// float32; s0 (B, H, N, N) float32 or null; s_out likewise or null.
extern "C" int pafc_wkv6_fwd(int dtype, int B, int T_len, int H, int N, const void* r,
                             const void* k, const void* v, const void* w, const void* u,
                             const void* s0, void* y, void* s_out, float w_clamp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(B, T_len, H, N, r, k, v, w, (const float*)u, (const float*)s0, y,
                         (float*)s_out, w_clamp, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(B, T_len, H, N, r, k, v, w, (const float*)u, (const float*)s0,
                                 y, (float*)s_out, w_clamp, st);
  return (int)cudaErrorInvalidValue;
}
