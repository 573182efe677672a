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
// logsumexp, fuses the CTC row and runs the selection with block-wide
// (value desc, index asc) argmax rounds.  The product runs on CUDA cores,
// far from the tensor-core bound; wgmma tiles and a single persistent launch
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

using pafc::to_f32;

constexpr int kChunk = 128;
constexpr int kSelThreads = 256;
constexpr int kMaxK = 32;

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

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(-fabsf(a - b)));
}

// (value, index) pair order: larger value first, then lower index.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide best (value desc, index asc) over every thread's candidate.
__device__ void block_best(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  warp_best(v, i);
  if (lane == 0) {
    sv[wid] = v;
    si[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    v = lane < kSelThreads / 32 ? sv[lane] : -INFINITY;
    i = lane < kSelThreads / 32 ? si[lane] : 0x7fffffff;
    warp_best(v, i);
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

__device__ float block_reduce(float v, bool is_max, float* sv) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) sv[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < kSelThreads / 32 ? sv[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) sv[0] = v;
  }
  __syncthreads();
  v = sv[0];
  __syncthreads();
  return v;
}

// Masked-argmax rounds over cand[0, n): k picks, each the best (value desc,
// position asc); the pick is set to -inf.  On an all -inf remainder the
// lowest position wins again, as jnp.argmax does.
__device__ void argmax_rounds(float* cand, int n, int k, float* out_v, int* out_pos, float* sv,
                              int* si) {
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int p = threadIdx.x; p < n; p += kSelThreads)
      if (better(cand[p], p, bv, bi)) {
        bv = cand[p];
        bi = p;
      }
    block_best(bv, bi, sv, si);
    if (threadIdx.x == 0) {
      out_v[r] = bv;
      out_pos[r] = bi;
      cand[bi] = -INFINITY;
    }
    __syncthreads();
  }
}

template <typename TC>
__global__ void __launch_bounds__(kSelThreads)
    fuse_select_kernel(int V, int Vp, int n_rep, int k, const float* __restrict__ logits,
                       const TC* __restrict__ ctc, int ctc_ld, float log_tw, float log_cw,
                       float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ float row[];  // Vp scores, then the chunk maxima / k*128 survivors
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ float pick_v[kMaxK];
  __shared__ int pick_p[kMaxK];
  __shared__ int chunk_ids[kMaxK];
  const int r = blockIdx.x;
  const int G = Vp / kChunk;
  const float* lrow = logits + (long long)r * Vp;
  const TC* crow = ctc + (long long)(r / n_rep) * ctc_ld;

  float m = -INFINITY;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) {
    const float l = lrow[n];
    row[n] = l;
    m = fmaxf(m, l);
  }
  m = block_reduce(m, true, sv);
  float s = 0.f;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) s += expf(row[n] - m);
  const float lse = m + logf(block_reduce(s, false, sv));
  for (int n = threadIdx.x; n < Vp; n += kSelThreads) {
    const float c = n < V ? to_f32(crow[n]) : -INFINITY;
    row[n] = logaddexp(log_tw + (row[n] - lse), log_cw + c);
  }
  __syncthreads();

  const bool direct = V <= 8 * kChunk || k >= G;
  float* cand = row;
  int n_cand = V;
  if (!direct) {
    // phase 1: chunk maxima; phase 2: top-k chunks, lowest id on ties
    float* cmax = row + Vp;  // G floats, reused below for the survivors
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    for (int g = wid; g < G; g += kSelThreads / 32) {
      float cm = -INFINITY;
      for (int p = lane; p < kChunk; p += 32) cm = fmaxf(cm, row[g * kChunk + p]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
      if (lane == 0) cmax[g] = cm;
    }
    __syncthreads();
    argmax_rounds(cmax, G, k, pick_v, chunk_ids, sv, si);
    if (threadIdx.x == 0) {  // ascending chunk ids: position order == index order
      for (int a = 1; a < k; ++a)
        for (int c = a; c > 0 && chunk_ids[c - 1] > chunk_ids[c]; --c) {
          const int t = chunk_ids[c];
          chunk_ids[c] = chunk_ids[c - 1];
          chunk_ids[c - 1] = t;
        }
    }
    __syncthreads();
    // phase 3: gather the k chunks behind the scores
    cand = row + Vp;
    n_cand = k * kChunk;
    for (int p = threadIdx.x; p < n_cand; p += kSelThreads)
      cand[p] = row[chunk_ids[p / kChunk] * kChunk + p % kChunk];
    __syncthreads();
  }
  // phase 4: top-k of the candidates
  argmax_rounds(cand, n_cand, k, pick_v, pick_p, sv, si);
  if (threadIdx.x < k) {
    const int p = pick_p[threadIdx.x];
    vals[(long long)r * k + threadIdx.x] = pick_v[threadIdx.x];
    idx[(long long)r * k + threadIdx.x] =
        direct ? p : chunk_ids[p / kChunk] * kChunk + p % kChunk;
  }
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
  const int G = Vp / kChunk;
  const size_t smem = (size_t)(Vp + (G > k * kChunk ? G : k * kChunk)) * sizeof(float);
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(fuse_select_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
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
