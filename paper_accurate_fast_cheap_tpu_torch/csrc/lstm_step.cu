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
// bf16 (the decode's path): wgmma over TMA-fed tiles (sm90.cuh).  Three
// kinds of launch: (1) a cast of the f32 state h to bf16 for every layer
// (TMA cannot convert, and the beam reorders (hs, cs) between steps, so no
// earlier kernel can hold a bf16 copy); (2) per layer, a block of one
// warpgroup owns 64 rows and U = 16 hidden units: B is the four gate
// row-ranges g*H + j0 .. + 16 of W_ih, then of W_hh, in their nn.Linear
// layout (already K-major), loaded as four 16-row TMA boxes per 64-wide K
// chunk, so nothing is repacked on the host; A is x, then the bf16 h.  The
// K = E + H chunks stream through a 4-stage ring (ring_product) into one
// m64n64 accumulator, whose thread layout gives every thread all four
// gates of its (row, unit) cells: the nonlinearities, the cell update and
// the f32 h/c and bf16 next-input writes are the epilogue, and the (R, 4H)
// gates never leave registers.  Grid (H / 16, R / 64) = 160 blocks at the
// flagship step, 66 KB of shared memory each (three fit an SM).  (3) the
// projection, the same product with 64 output columns per block and a
// bias epilogue.  What bounds it: each block rereads its 64 rows of [x | h]
// and its 64 weight rows through L2 (~51 MB per layer at the flagship
// step), and every chunk waits out one wgmma latency.
//
// f32 (the card-vs-CPU reference only): per layer one register-tiled FMA
// product over the concatenated K = E + H axis (gemm_tile.cuh, as two K
// ranges summed into one tile); each block owns 16 hidden units and all
// four of their gates, so the epilogue is fused the same way; a last tiled
// product applies the projection.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"
#include "sm90.cuh"

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

// ---- bf16: wgmma over TMA tiles ------------------------------------------

namespace tc {

using namespace pafc::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 64, U = 16, BN = 4 * U, S = 4;
constexpr int kStage = BM * 128 + BN * 128;  // one 64-wide K chunk of A and B
constexpr size_t kSmem = ring_smem_bytes(S, kStage);
constexpr int kCastThreads = 256;

// hb = bf16(hs), n elements (n % 4 == 0)
__global__ void __launch_bounds__(kCastThreads)
    cast_state_kernel(long long n, const float4* __restrict__ hs, __nv_bfloat162* __restrict__ hb) {
  for (long long i = blockIdx.x * (long long)kCastThreads + threadIdx.x; i < n / 4;
       i += (long long)gridDim.x * kCastThreads) {
    const float4 v = hs[i];
    hb[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    hb[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// A chunk: 64 rows of A at column k; B chunk: four 16-row boxes at rows
// b_row0 + g * b_step, column k.  Chunks below n_a come from (amap0, bmap0),
// the rest from (amap1, bmap1), each counted from k = 0.
struct ChunkLoad {
  const CUtensorMap *amap0, *bmap0, *amap1, *bmap1;
  int n_a, m0, b_row0, b_step;
  __device__ void operator()(int c, uint8_t* st, uint64_t* bar) const {
    const bool first = c < n_a;
    const int k = (first ? c : c - n_a) * 64;
    mbar_arrive_expect_tx(bar, kStage);
    tma_load_2d(st, first ? amap0 : amap1, bar, k, m0);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      tma_load_2d(st + BM * 128 + g * U * 128, first ? bmap0 : bmap1, bar, k,
                  b_row0 + g * b_step);
  }
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// One layer: rows m0 .. + 64, units j0 .. + 16.  Accumulator column n is
// gate n / 16 of unit j0 + n % 16, so thread (warp w, lane l) holds, for
// rows w*16 + l/4 (+ 8) and units q*8 + (l%4)*2 (+ 1), q = 0, 1, all four
// gates: gate g at acc[(2g + q) * 4 + half * 2 + e].
__global__ void __launch_bounds__(128)
    lstm_layer_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap hmap,
                         const __grid_constant__ CUtensorMap wihmap,
                         const __grid_constant__ CUtensorMap whhmap, int R, int E, int H,
                         const bf16* __restrict__ bias, const float* __restrict__ c,
                         float* __restrict__ nh, float* __restrict__ nc, bf16* __restrict__ xo) {
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full;
  uint8_t* ring = ring_init(smem_raw, S, kStage, full);
  const int j0 = blockIdx.x * U, m0 = blockIdx.y * BM;
  const int n_x = (E + 63) / 64, n_h = (H + 63) / 64;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring_product<BN, S>(acc, ring, full, n_x + n_h, 1,
                      ChunkLoad{&xmap, &wihmap, &hmap, &whhmap, n_x, m0, j0, H});
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = j0 + q * 8 + (l % 4) * 2;
    if (j >= H) continue;
    float b[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + g * H + j));
      b[g][0] = bb.x;
      b[g][1] = bb.y;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + w * 16 + l / 4 + 8 * half;
      if (m >= R) continue;
      const long long o = (long long)m * H + j;
      const float2 cold = *reinterpret_cast<const float2*>(c + o);
      float hn[2], cn[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i0 = q * 4 + half * 2 + e;
        const float ig = sigmoid_f(acc[i0] + b[0][e]);
        const float fg = sigmoid_f(acc[i0 + 8] + b[1][e]);
        const float gg = tanhf(acc[i0 + 16] + b[2][e]);
        const float og = sigmoid_f(acc[i0 + 24] + b[3][e]);
        cn[e] = fg * (e ? cold.y : cold.x) + ig * gg;
        hn[e] = og * tanhf(cn[e]);
      }
      *reinterpret_cast<float2*>(nh + o) = make_float2(hn[0], hn[1]);
      *reinterpret_cast<float2*>(nc + o) = make_float2(cn[0], cn[1]);
      *reinterpret_cast<__nv_bfloat162*>(xo + o) = __floats2bfloat162_rn(hn[0], hn[1]);
    }
  }
}

// The projection: out rows m0 .. + 64, columns n0 .. + 64 = x @ W^T + b.
__global__ void __launch_bounds__(128)
    proj_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   int R, int H, int O, const bf16* __restrict__ bias, bf16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full;
  uint8_t* ring = ring_init(smem_raw, S, kStage, full);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_k = (H + 63) / 64;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring_product<BN, S>(acc, ring, full, n_k, 1,
                      ChunkLoad{&xmap, &wmap, &xmap, &wmap, n_k, m0, n0, U});
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int n = n0 + q * 8 + (l % 4) * 2;
    if (n >= O) continue;
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + w * 16 + l / 4 + 8 * half;
      if (m < R)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * O + n) =
            __floats2bfloat162_rn(acc[q * 4 + half * 2] + b.x, acc[q * 4 + half * 2 + 1] + b.y);
    }
  }
}

int launch(int L, int R, int E, int H, int O, const void* x, const void* hs, const void* cs,
           const void* const* wih, const void* const* whh, const void* const* bih,
           const void* wproj, const void* bproj, void* out, void* nhs, void* ncs, void* xbuf,
           void* hbuf, cudaStream_t stream) {
  const long long RH = (long long)R * H;
  const long long n = L * RH;
  const int cast_blocks = (int)((n / 4 + kCastThreads - 1) / kCastThreads < 1024
                                    ? (n / 4 + kCastThreads - 1) / kCastThreads
                                    : 1024);
  cast_state_kernel<<<cast_blocks, kCastThreads, 0, stream>>>(n, (const float4*)hs,
                                                              (__nv_bfloat162*)hbuf);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaFuncSetAttribute(lstm_layer_tc_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (!err)
    err = (int)cudaFuncSetAttribute(proj_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmem);
  if (err) return err;
  const bf16* xin = (const bf16*)x;
  int ein = E;
  const dim3 grid((H + U - 1) / U, (R + BM - 1) / BM);
  for (int l = 0; l < L; ++l) {
    bf16* xo = (bf16*)xbuf + l * RH;
    const bf16* hb = (const bf16*)hbuf + l * RH;
    CUtensorMap xmap, hmap, wihmap, whhmap;
    err = make_map_2d(&xmap, xin, R, ein, ein, BM, 64);
    if (!err) err = make_map_2d(&hmap, hb, R, H, H, BM, 64);
    if (!err) err = make_map_2d(&wihmap, wih[l], 4 * H, ein, ein, U, 64);
    if (!err) err = make_map_2d(&whhmap, whh[l], 4 * H, H, H, U, 64);
    if (err) return err;
    lstm_layer_tc_kernel<<<grid, 128, kSmem, stream>>>(
        xmap, hmap, wihmap, whhmap, R, ein, H, (const bf16*)bih[l], (const float*)cs + l * RH,
        (float*)nhs + l * RH, (float*)ncs + l * RH, xo);
    err = (int)cudaGetLastError();
    if (err) return err;
    xin = xo;
    ein = H;
  }
  CUtensorMap xmap, wmap;
  err = make_map_2d(&xmap, xin, R, H, H, BM, 64);
  if (!err) err = make_map_2d(&wmap, wproj, O, H, H, U, 64);
  if (err) return err;
  const dim3 pgrid((O + BN - 1) / BN, (R + BM - 1) / BM);
  proj_tc_kernel<<<pgrid, 128, kSmem, stream>>>(xmap, wmap, R, H, O, (const bf16*)bproj,
                                                (bf16*)out);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
// an (L, R, H) scratch in the compute dtype; hbuf, for bf16 only, an
// (L, R, H) bf16 scratch (the cast state).  bf16 needs E, H and O multiples
// of 8 and 16-byte-aligned pointers (TMA).
extern "C" int pafc_lstm_step(int dtype, int L, int R, int E, int H, int O, const void* x,
                              const void* hs, const void* cs, const void* const* wih,
                              const void* const* whh, const void* const* bih, const void* wproj,
                              const void* bproj, void* out, void* nhs, void* ncs, void* xbuf,
                              void* hbuf, void* stream) {
  if (L < 1 || L > kMaxLayers) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(L, R, E, H, O, x, hs, cs, wih, whh, bih, wproj, bproj, out, nhs, ncs,
                         xbuf, st);
  if (dtype == 1) {
    if (E % 8 || H % 8 || O % 8) return (int)cudaErrorInvalidValue;
    return tc::launch(L, R, E, H, O, x, hs, cs, wih, whh, bih, wproj, bproj, out, nhs, ncs, xbuf,
                      hbuf, st);
  }
  return (int)cudaErrorInvalidValue;
}
