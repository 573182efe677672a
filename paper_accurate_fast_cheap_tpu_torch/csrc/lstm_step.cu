// One autoregressive step of the stacked-LSTM transducer predictor: for each
// layer l, gates = [x | h_l] @ [W_ih; W_hh]^T + b_ih (gate order i, f, g, o,
// computed in f32), c' = sig(f) c + sig(i) tanh(g), h' = sig(o) tanh(c'),
// then out = h'_{L-1} @ W_proj^T + b_proj.
//
// Replaces: the JAX package's ops/lstm_pallas.py,
// `_lstm_step_kernel` via `lstm_predictor_step`.  Numerics follow it: the
// recurrent state is cast to the compute dtype before the product, biases
// ride in the compute dtype, the state is f32 (as the predictor's
// init_state makes it, also under bf16 weights) and the next layer's input
// is written in the compute dtype.
//
// Bound on the H100 at the flagship beam step (R = 256 rows, E = H = O =
// 640, L = 2): ~13.9 MB of bf16 weights per step and
// 2*256*(2*1280*2560 + 640*640) = 3.6 GFLOP, so ~4 us against the memory
// rate and ~4 us against the tensor-core rate.
//
// Design: per layer one register-tiled FMA product over the concatenated
// K = E + H axis (gemm_tile.cuh, as two K ranges summed into one tile:
// x against W_ih, then h against W_hh); each block owns 16 hidden units and all
// four of their gates, so the gate nonlinearity, the cell update and the
// casts are fused into the product's epilogue and the (R, 4H) gates never
// leave registers.  A last tiled product applies the projection.  CUDA-core
// FMA keeps it simple and far from the bound; wgmma tiles and weights held
// on chip across frames are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using pafc::from_f32;
using pafc::round_to;
using pafc::to_f32;

constexpr int kMaxLayers = 8;
constexpr int BM = 64, BK = 16, TM = 8;
constexpr int UNITS = 16;  // hidden units per block (x4 gates = 64 columns)
constexpr int kThreads = (BM / TM) * UNITS;

// Rows of an (rows, ld) matrix, zero past ``rows``, rounded through T (a
// no-op unless the state is f32 under bf16 weights: the TPU kernel casts
// the recurrent state to the compute dtype before its product).
template <typename T, typename TM_>
struct Rows {
  const TM_* p;
  int ld, rows, r0;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    return r < rows ? round_to<T>(to_f32(p[(long long)r * ld + k])) : 0.f;
  }
};

template <typename T>
struct GateRows {  // column n = gate (n / UNITS) of unit j0 + n % UNITS
  const T* w;
  int ld, H, j0;
  __device__ float operator()(int n, int k) const {
    const int j = j0 + n % UNITS;
    return j < H ? to_f32(w[((long long)(n / UNITS) * H + j) * ld + k]) : 0.f;
  }
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_layer_kernel(int R, int E, int H, const T* __restrict__ x, const float* __restrict__ h,
                      const float* __restrict__ c, const T* __restrict__ wih,
                      const T* __restrict__ whh, const T* __restrict__ bias, float* __restrict__ nh,
                      float* __restrict__ nc, T* __restrict__ xo) {
  const int j0 = blockIdx.x * UNITS, m0 = blockIdx.y * BM;
  float acc[TM][4];
  pafc::zero_acc(acc);
  pafc::gemm_tile_nt<BM, 4 * UNITS, BK, TM, 4>(E, Rows<T, T>{x, E, R, m0},
                                               GateRows<T>{wih, E, H, j0}, acc);
  pafc::gemm_tile_nt<BM, 4 * UNITS, BK, TM, 4>(H, Rows<T, float>{h, H, R, m0},
                                               GateRows<T>{whh, H, H, j0}, acc);
  constexpr int TY = BM / TM;
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  const int j = j0 + tx;
  if (j >= H) return;
  const float bi = round_to<T>(to_f32(bias[j])), bf = round_to<T>(to_f32(bias[H + j]));
  const float bg = round_to<T>(to_f32(bias[2 * H + j])), bo = round_to<T>(to_f32(bias[3 * H + j]));
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= R) continue;
    const long long o = (long long)m * H + j;
    const float ig = sigmoidf(acc[i][0] + bi), fg = sigmoidf(acc[i][1] + bf);
    const float gg = tanhf(acc[i][2] + bg), og = sigmoidf(acc[i][3] + bo);
    const float cn = fg * to_f32(c[o]) + ig * gg;
    const float hn = og * tanhf(cn);
    nh[o] = hn;
    nc[o] = cn;
    xo[o] = from_f32<T>(hn);
  }
}

constexpr int PBN = 64, PTN = 4;
constexpr int kProjThreads = (BM / TM) * (PBN / PTN);

template <typename T>
__global__ void __launch_bounds__(kProjThreads)
    proj_kernel(int R, int H, int O, const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ out) {
  const int n0 = blockIdx.x * PBN, m0 = blockIdx.y * BM;
  float acc[TM][PTN];
  pafc::zero_acc(acc);
  pafc::gemm_tile_nt<BM, PBN, BK, TM, PTN>(H, Rows<T, T>{x, H, R, m0}, Rows<T, T>{w, H, O, n0},
                                           acc);
  constexpr int TX = PBN / PTN, TY = BM / TM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= R) continue;
#pragma unroll
    for (int jj = 0; jj < PTN; ++jj) {
      const int n = n0 + tx + jj * TX;
      if (n < O) out[(long long)m * O + n] = from_f32<T>(acc[i][jj] + to_f32(b[n]));
    }
  }
}

template <typename T>
int launch(int L, int R, int E, int H, int O, const void* x, const void* hs, const void* cs,
           const void* const* wih, const void* const* whh, const void* const* bih,
           const void* wproj, const void* bproj, void* out, void* nhs, void* ncs, void* xbuf,
           cudaStream_t stream) {
  const long long RH = (long long)R * H;
  const dim3 grid((H + UNITS - 1) / UNITS, (R + BM - 1) / BM);
  const T* xin = (const T*)x;
  int ein = E;
  for (int l = 0; l < L; ++l) {
    T* xo = (T*)xbuf + l * RH;
    lstm_layer_kernel<T><<<grid, kThreads, 0, stream>>>(
        R, ein, H, xin, (const float*)hs + l * RH, (const float*)cs + l * RH, (const T*)wih[l],
        (const T*)whh[l], (const T*)bih[l], (float*)nhs + l * RH, (float*)ncs + l * RH, xo);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    xin = xo;
    ein = H;
  }
  const dim3 pgrid((O + PBN - 1) / PBN, (R + BM - 1) / BM);
  proj_kernel<T><<<pgrid, kProjThreads, 0, stream>>>(R, H, O, xin, (const T*)wproj,
                                                    (const T*)bproj, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x (R, E), the weights (nn.Linear
// layout: W_ih (4H, E|H), W_hh (4H, H), b (4H), W_proj (O, H), b_proj (O))
// and out (R, O); the state hs, cs, nhs, ncs (L, R, H) is float32.  xbuf is
// an (L, R, H) scratch in the compute dtype.
extern "C" int pafc_lstm_step(int dtype, int L, int R, int E, int H, int O, const void* x,
                              const void* hs, const void* cs, const void* const* wih,
                              const void* const* whh, const void* const* bih, const void* wproj,
                              const void* bproj, void* out, void* nhs, void* ncs, void* xbuf,
                              void* stream) {
  if (L < 1 || L > kMaxLayers) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PAFC_ARGS \
  L, R, E, H, O, x, hs, cs, wih, whh, bih, wproj, bproj, out, nhs, ncs, xbuf, st
  if (dtype == 0) return launch<float>(PAFC_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(PAFC_ARGS);
#undef PAFC_ARGS
  return (int)cudaErrorInvalidValue;
}
