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
// (B=32, T=2250, H=8, N=64): ~0.11 ms at 3.35 TB/s.  The arithmetic of the
// blocked form (~4.5 N^2 flops per step and head on the tensor cores, ~5
// exponentials per element) is far below the ridge.
//
// Algorithm: the blocked form of ops/wkv6.py:wkv6_chunked.  The block walks
// T in chunks of L steps (64; 32 for f32 at N = 128, where two f32 stages
// of 64 steps would not fit), and each chunk in inner blocks of 16 steps.
// With lw = -exp(min(w, clamp)), Bi the inclusive and Be the exclusive
// prefix of lw inside an inner block, m = Bi at its row 8 (the midpoint
// recentring: every factor below stays under e^80 because of the clamp),
// tot = Bi at its last row:
//   intra   A = (r e^(Be - m)) (k e^(m - Bi))^T, strictly lower, plus the
//           diagonal (r . u k) v in f32;
//   state   y += (r e^Be) S, with S the state before the inner block;
//   update  S = diag(e^tot) S + (k e^(tot - Bi))^T v.
// The plain version's between-block products (D . KV, then q2 . M) and its
// cross-chunk product (q_glob . S_chunk) are the same sum regrouped: here S
// is the running f32 state itself, updated after every inner block, which
// is cheapest when S never leaves the chip.
//
// Design: one block per (b, h) walking the chunks, S kept on chip (in
// registers) for the whole sequence.  At the flagship decode call this is
// 256 blocks of 8 warps, two per SM, and T / 16 = 141 dependent state
// updates per block (2250 dependent steps before).  The chunk-parallel two
// pass form of the JAX package would write and reread an f32 (N, N) summary
// per chunk (~150 MB at the decode shape, 40% of the call's bytes); the
// per-(b, h) walk writes none, and its dependent chain (an FMA and one
// tensor-core product per 16 steps) is short beside each chunk's
// independent work.  At the training shape (B16 x 374, 128 (b, h) pairs, 6
// chunks) it fills one wave.
//
// Per chunk: (1) cp.async stages the next chunk's r, k, v, w (zero past T)
// while this one computes (two stages); (2) every thread takes one channel
// j of one inner block (L / 16 x N threads): the 16-step prefix of lw, the
// four operand tiles (above; three exponentials an element) rounded to the
// product dtype into shared memory, e^tot, and the diagonal's r . u k,
// summed over channels by a shuffle reduce-scatter.  The prep's
// exponentials take the largest share of a chunk's time, so it gets every
// thread; (3) warp w < N / 16 owns the state's value channels i in
// [16 w, 16 w + 16) for every key channel j: S^T's rows, as m16n8
// accumulator tiles, so each 16-step update is a tensor-core product from
// zero added to e^tot * S in f32, and the same registers are the B operand
// of y = q2 S (an accumulator tile of S^T is a B fragment of S); each of
// these warps computes the intra product A (16 x 16), masks it in
// registers and feeds it back as the A operand of A v; y goes to shared
// memory, then (4) the
// block writes it with 16-byte stores.  Steps past T act as k = v = 0 with
// decay 1 (lw = 0), so the final state is exact.
//
// Products (mma_frag.cuh): bf16 operands with f32 accumulation (mma.sync
// m16n8k16), the rounding of the plain version's and JAX's cd = bf16.  f32:
// 3xTF32 on m16n8k8, each k8 half summed from zero and added to the running
// sum in IEEE f32, as K6 does: plain TF32 would miss the 1e-4 check.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma_frag.cuh"

namespace {

using namespace pafc::frag;
using pafc::from_f32;
using pafc::to_f32;

constexpr int SUB = 16;  // inner block

// ---- the diagonal's sum over channels ---------------------------------------
// p[0..15]: this lane's r . u k terms for the 16 steps of an inner block; the
// G lanes of a group hold G channels.  Reduce-scatter: each round halves the
// vector, keeping the half the lane's bit picks and adding the partner's
// copy of it.  Returns the group's sum for step (lane / (G / 16)) % 16.
template <int O, int H>
__device__ __forceinline__ void halve(float (&p)[16], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? p[i] : p[i + H];
    const float keep = up ? p[i + H] : p[i];
    p[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <int G>
__device__ __forceinline__ float reduce_scatter16(float (&p)[16], int lane) {
  static_assert(G == 16 || G == 32, "a group is 16 or 32 lanes");
  halve<G / 2, 8>(p, lane);
  halve<G / 4, 4>(p, lane);
  halve<G / 8, 2>(p, lane);
  halve<G / 16, 1>(p, lane);
  if (G == 32) p[0] += __shfl_xor_sync(0xffffffffu, p[0], 1);
  return p[0];
}

template <typename T>
__device__ __forceinline__ float ex(float x) {
  // bf16: the fast exponential (a few f32 ulps), below the operands' bf16
  // rounding; f32: the IEEE one
  if constexpr (kF32<T>) return expf(x);
  else return __expf(x);
}

// ---- the kernel -------------------------------------------------------------

template <typename T, int N>
struct Shape {
  static constexpr int L = (sizeof(T) == 4 && N == 128) ? 32 : 64;  // chunk
  static constexpr int NB = L / SUB;                  // inner blocks per chunk
  static constexpr int kThreads = NB * N;             // prep: one (channel, inner block) each
  static constexpr int kMmaWarps = N / 16;            // products: 16 value channels each
  static constexpr int LD = N + 16 / (int)sizeof(T);  // row pitch (elements): 16 bytes of pad
  static constexpr int kTile = L * LD;                // one (L, N) tile
  static constexpr int kCpr = N * (int)sizeof(T) / 16;  // 16-byte copies per row
  static constexpr int G = N >= 32 ? 32 : 16;         // lanes of one channel group
  static constexpr int NG = N >= 32 ? N / 32 : 1;     // channel groups per inner block
  // stages: 2 x (r, k, v, w); operands: QM, KM, Q2, K2; then f32 e^tot and
  // the diagonal's partial sums
  static constexpr size_t kSmem =
      (size_t)(8 + 4) * kTile * sizeof(T) + (size_t)(NB * N + NG * L) * sizeof(float);
  static_assert(kSmem <= 232448, "fits a block's shared memory");
  // two blocks an SM where their shared memory fits (bf16 at N <= 64):
  // one block's products (N / 16 warps, a latency-bound chain) then
  // overlap the other's prep (registers capped at 128 at N = 64)
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
};

template <typename T, int N>
__global__ void __launch_bounds__(Shape<T, N>::kThreads, Shape<T, N>::kMinBlocks)
    wkv6_fwd_kernel(int T_len, int H, const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ s_out, float w_clamp) {
  using Sh = Shape<T, N>;
  constexpr int L = Sh::L, NB = Sh::NB, LD = Sh::LD, kTile = Sh::kTile, kCpr = Sh::kCpr;
  constexpr int NT = Sh::kThreads, NG = Sh::NG, NJT = N / 8;
  extern __shared__ float4 smem4[];
  T* stage = reinterpret_cast<T*>(smem4);        // [2][4][L][LD]: r, k, v, w
  T* qm = stage + 8 * kTile;                     // r e^(Be - m)
  T* km = qm + kTile;                            // k e^(m - Bi)
  T* q2 = km + kTile;                            // r e^Be
  T* k2 = q2 + kTile;                            // k e^(tot - Bi)
  float* dtot = reinterpret_cast<float*>(k2 + kTile);  // [NB][N] e^tot
  float* rukp = dtot + NB * N;                          // [NG][L] r . u k partials

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const long long row_step = (long long)H * N;   // elements between two steps
  const long long base = (long long)b * T_len * row_step + (long long)h * N;
  const int n_chunks = (T_len + L - 1) / L;

  // chunk c's r, k, v, w into stage c & 1, zero past T
  auto issue = [&](int c) {
    T* st = stage + (c & 1) * 4 * kTile;
    const T* srcs[4] = {r, k, v, w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = tid; e < L * kCpr; e += NT) {
        const int s = e / kCpr, cc = e % kCpr, tt = c * L + s;
        const bool valid = tt < T_len;
        const T* src =
            srcs[q] + base + (long long)(valid ? tt : 0) * row_step + cc * (16 / sizeof(T));
        cp_async16(st + q * kTile + s * LD + cc * (16 / sizeof(T)), src, valid);
      }
    }
  };

  // S^T rows i0 .. i0 + 15 (value channels) x every key channel j, in the
  // first N / 16 warps: tile jt holds S[j = 8 jt + 2 t4 + e % 2][i = i0 + g
  // + 8 (e / 2)]
  const bool mma_warp = warp < Sh::kMmaWarps;
  const int i0 = warp * 16;
  float S[NJT][4];
#pragma unroll
  for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * jt + 2 * t4 + e % 2, i = i0 + g + 8 * (e / 2);
      S[jt][e] = s0 && mma_warp ? s0[((long long)bh * N + j) * N + i] : 0.f;
    }

  // prep: thread (j, ib) takes channel j of inner block ib
  const int j = tid % N, ib_prep = tid / N;
  const float uj = u[h * N + j];

  if (n_chunks > 0) issue(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) issue(c + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c's copies have landed
    __syncthreads();
    const T* rs = stage + (c & 1) * 4 * kTile;
    const T* ks = rs + kTile;
    const T* vs = ks + kTile;
    const T* ws = vs + kTile;

    // (2) the operand tiles, e^tot and the diagonal's partial sums
    {
      const int ib = ib_prep, row0 = ib * SUB;
      float lw[SUB], Bi[SUB], acc = 0.f;
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const bool valid = c * L + row0 + s < T_len;
        const float l = valid ? -ex<T>(fminf(to_f32(ws[(row0 + s) * LD + j]), w_clamp)) : 0.f;
        lw[s] = l;
        acc += l;
        Bi[s] = acc;
      }
      // three exponentials an element: e^Be = e^(Be - m) e^m and
      // e^(tot - Bi) = e^(tot - m) e^(m - Bi), every factor within e^+-80
      const float m = Bi[SUB / 2], tot = Bi[SUB - 1];
      const float em = ex<T>(m), etm = ex<T>(tot - m);
      dtot[ib * N + j] = ex<T>(tot);
      float p[SUB];
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const int o = (row0 + s) * LD + j;
        const float rv = to_f32(rs[o]), kv = to_f32(ks[o]);
        const float qf = ex<T>(Bi[s] - lw[s] - m), kf = ex<T>(m - Bi[s]);
        qm[o] = from_f32<T>(rv * qf);
        km[o] = from_f32<T>(kv * kf);
        q2[o] = from_f32<T>(rv * (qf * em));
        k2[o] = from_f32<T>(kv * (kf * etm));
        p[s] = rv * uj * kv;
      }
      const float sum = reduce_scatter16<Sh::G>(p, lane);
      constexpr int kStride = Sh::G / 16;
      if (lane % kStride == 0) {
        const int grp = N >= 32 ? j / 32 : 0;
        rukp[grp * L + row0 + (lane / kStride) % SUB] = sum;
      }
    }
    __syncthreads();

    // (3) warp w < N / 16: y[:, i0 .. i0 + 16) and S^T's rows i0 .. i0 +
    // 16, inner block by inner block (S carries from one to the next)
    T* ys = const_cast<T*>(rs);  // r's stage is free now: y's tile
    if (mma_warp) {
#pragma unroll 1  // unrolled, the loop needs more registers than two blocks an SM leave
      for (int ib = 0; ib < NB; ++ib) {
        const int row0 = ib * SUB;
        // intra: A = qm km^T (16 x 16), kept strictly below the diagonal
        float A[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const FragA<T> a = load_a(qm, LD, row0, 16 * kk);
          FragB<T> bb[2];
          load_b2(bb, km, LD, row0, 16 * kk);
          mma(A[0], a, bb[0]);
          mma(A[1], a, bb[1]);
        }
        float pv[8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = g + 8 * (e / 2), col = 8 * nt + 2 * t4 + e % 2;
            pv[4 * nt + e] = col < row ? A[nt][e] : 0.f;
          }
        float yacc[2][4] = {};
        {
          const FragA<T> pa = make_a<T>(pv);
          FragB<T> vb[2];
          load_b2_trans(vb, vs, LD, row0, i0);
          mma(yacc[0], pa, vb[0]);
          mma(yacc[1], pa, vb[1]);
        }
        // state: y += q2 S, S^T's accumulator tiles as S's B fragments
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const FragA<T> a = load_a(q2, LD, row0, 16 * kk);
#pragma unroll
          for (int nh = 0; nh < 2; ++nh) {
            const FragB<T> sb = make_b<T>(S[2 * kk][2 * nh], S[2 * kk][2 * nh + 1],
                                          S[2 * kk + 1][2 * nh], S[2 * kk + 1][2 * nh + 1]);
            mma(yacc[nh], a, sb);
          }
        }
        // update: S^T = S^T diag(e^tot) + v^T k2, the product from zero
        {
          const FragA<T> va = load_a_trans(vs, LD, row0, i0);
#pragma unroll
          for (int jt = 0; jt < NJT; jt += 2) {
            FragB<T> kb[2];
            load_b2_trans(kb, k2, LD, row0, 8 * jt);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma(d, va, kb[hh]);
              const float2 dt =
                  *reinterpret_cast<const float2*>(dtot + ib * N + 8 * (jt + hh) + 2 * t4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                S[jt + hh][e] = fmaf(S[jt + hh][e], e % 2 ? dt.y : dt.x, d[e]);
            }
          }
        }
        // the diagonal (r . u k) v in f32, then y into its tile
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = row0 + g + 8 * hr;
          float ruk = 0.f;
#pragma unroll
          for (int q = 0; q < NG; ++q) ruk += rukp[q * L + row];
#pragma unroll
          for (int nh = 0; nh < 2; ++nh) {
            const int col = i0 + 8 * nh + 2 * t4;
            const float v0 = to_f32(vs[row * LD + col]), v1 = to_f32(vs[row * LD + col + 1]);
            store2<T>(ys + row * LD + col, fmaf(ruk, v0, yacc[nh][2 * hr]),
                      fmaf(ruk, v1, yacc[nh][2 * hr + 1]));
          }
        }
      }
    }
    __syncthreads();

    // (4) y's tile to global memory, 16 bytes a thread
#pragma unroll
    for (int e = tid; e < L * kCpr; e += NT) {
      const int s = e / kCpr, cc = e % kCpr, tt = c * L + s;
      if (tt < T_len)
        *reinterpret_cast<float4*>(y + base + (long long)tt * row_step + cc * (16 / sizeof(T))) =
            *reinterpret_cast<const float4*>(ys + s * LD + cc * (16 / sizeof(T)));
    }
    __syncthreads();  // the stage is refilled by the next chunk's copies
  }

  if (s_out && mma_warp) {
#pragma unroll
    for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * jt + 2 * t4 + e % 2, i = i0 + g + 8 * (e / 2);
        s_out[((long long)bh * N + jj) * N + i] = S[jt][e];
      }
  }
}

template <typename T, int N>
int launch_n(int B, int T_len, int H, const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* s0, void* y, float* s_out, float w_clamp,
             cudaStream_t stream) {
  auto kern = wkv6_fwd_kernel<T, N>;
  constexpr size_t smem = Shape<T, N>::kSmem;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  kern<<<B * H, Shape<T, N>::kThreads, smem, stream>>>(
      T_len, H, (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, s0, (T*)y, s_out, w_clamp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int B, int T_len, int H, int N, const void* r, const void* k, const void* v,
           const void* w, const float* u, const float* s0, void* y, float* s_out, float w_clamp,
           cudaStream_t stream) {
  switch (N) {
    case 16: return launch_n<T, 16>(B, T_len, H, r, k, v, w, u, s0, y, s_out, w_clamp, stream);
    case 32: return launch_n<T, 32>(B, T_len, H, r, k, v, w, u, s0, y, s_out, w_clamp, stream);
    case 64: return launch_n<T, 64>(B, T_len, H, r, k, v, w, u, s0, y, s_out, w_clamp, stream);
    case 128: return launch_n<T, 128>(B, T_len, H, r, k, v, w, u, s0, y, s_out, w_clamp, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y share it, contiguous
// (B, T, H, N), 16-byte aligned).  u is (H, N) float32; s0 (B, H, N, N)
// float32 or null; s_out likewise or null.  N in 16, 32, 64, 128.
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
