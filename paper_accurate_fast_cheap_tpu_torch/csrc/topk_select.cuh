// Exact two-level vocab top-k over one row held in shared memory: K2's
// selection for k > 32 (joint_topk.cu), and that of the rows of K4 and K5
// with fewer than k finite chunks (topk_filter.cuh).  Port of the TPU
// kernels' common `_select_phases` (ops/topk_pallas.py in the JAX package)
// with the selection and tie rules of `decode/rnnt_search.py:top_k_vocab`:
//
//   phase 1  128-wide chunk maxima,
//   phase 2  the top-k chunks (ties: lowest chunk id), sorted ascending so
//            that position order among the survivors is index order,
//   phase 3  gather the k*128 survivors,
//   phase 4  top-k of the survivors (ties: lowest global index);
//
// or, when V <= 8*128 or k >= G, top-k of the whole row directly (the
// `direct` gate of `top_k_vocab`).  Each pick is a block-wide masked argmax
// round: (value desc, position asc); on an all -inf remainder the lowest
// position wins again, as jnp.argmax does.
//
// One block of kSelThreads threads per row.  The front ends stage the row
// (Vp = 128*G scores, pad at -inf) at the start of the dynamic shared
// memory, followed by select_smem_floats(Vp, k) - Vp floats of scratch:
// the chunk maxima or the k*128 survivors, then the k picks (value,
// position) and the k chunk ids.  So any 1 <= k <= V whose row and scratch
// fit the block's shared memory is served (every k <= 256 at V = 5002).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pafc {

constexpr int kChunk = 128;
constexpr int kSelThreads = 256;

struct SelectShared {  // the block reductions' per-warp partials
  float sv[32];
  int si[32];
};

// Floats between the row's start and the k picks: the row, then the chunk
// maxima (G) or the survivors (k*128).
__host__ __device__ inline size_t select_scratch_end(int Vp, int k) {
  const int G = Vp / kChunk;
  return (size_t)Vp + (size_t)(G > k * kChunk ? G : k * kChunk);
}

// Floats of dynamic shared memory one row's selection needs: the row, the
// scratch, and the picks (value, position) and chunk ids, k of each.
inline size_t select_smem_floats(int Vp, int k) {
  return select_scratch_end(Vp, k) + 3 * (size_t)k;
}

// log(exp(a) + exp(b)) with -inf + -inf = -inf (the CTC shallow fusion).
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
__device__ inline void block_best(float& v, int& i, SelectShared& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  warp_best(v, i);
  if (lane == 0) {
    sh.sv[wid] = v;
    sh.si[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    v = lane < kSelThreads / 32 ? sh.sv[lane] : -INFINITY;
    i = lane < kSelThreads / 32 ? sh.si[lane] : 0x7fffffff;
    warp_best(v, i);
    if (lane == 0) {
      sh.sv[0] = v;
      sh.si[0] = i;
    }
  }
  __syncthreads();
  v = sh.sv[0];
  i = sh.si[0];
  __syncthreads();
}

// Block-wide max (is_max) or sum of every thread's v.
__device__ inline float block_reduce(float v, bool is_max, SelectShared& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) sh.sv[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < kSelThreads / 32 ? sh.sv[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) sh.sv[0] = v;
  }
  __syncthreads();
  v = sh.sv[0];
  __syncthreads();
  return v;
}

// Masked-argmax rounds over cand[0, n): k picks, each the best (value desc,
// position asc); the pick is set to -inf.
__device__ inline void argmax_rounds(float* cand, int n, int k, float* out_v, int* out_pos,
                                     SelectShared& sh) {
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int p = threadIdx.x; p < n; p += kSelThreads)
      if (better(cand[p], p, bv, bi)) {
        bv = cand[p];
        bi = p;
      }
    block_best(bv, bi, sh);
    if (threadIdx.x == 0) {
      out_v[r] = bv;
      out_pos[r] = bi;
      cand[bi] = -INFINITY;
    }
    __syncthreads();
  }
}

// The top-k of row[0, V) (row[V, Vp) at -inf), written to vals[0, k) and
// idx[0, k).  Every thread of the block calls it after the barrier that
// publishes the staged row; the row and its scratch are overwritten.
__device__ inline void select_topk_row(float* row, int V, int Vp, int k, float* vals, int* idx,
                                       SelectShared& sh) {
  const int G = Vp / kChunk;
  const bool direct = V <= 8 * kChunk || k >= G;
  float* pick_v = row + select_scratch_end(Vp, k);
  int* pick_p = reinterpret_cast<int*>(pick_v + k);
  int* chunk_ids = pick_p + k;
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
    argmax_rounds(cmax, G, k, pick_v, chunk_ids, sh);
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
  argmax_rounds(cand, n_cand, k, pick_v, pick_p, sh);
  for (int i = threadIdx.x; i < k; i += kSelThreads) {
    const int p = pick_p[i];
    vals[i] = pick_v[i];
    idx[i] = direct ? p : chunk_ids[p / kChunk] * kChunk + p % kChunk;
  }
}

// Opt a selection kernel into more than 48 KB of dynamic shared memory.
template <class Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace pafc
