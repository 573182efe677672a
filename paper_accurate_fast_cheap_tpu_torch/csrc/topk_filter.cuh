// Exact vocab top-k of one row by a threshold filter, the selection of K4
// (fused_topk.cu) and K5 (topk.cu).  It returns what `select_topk_row`
// (topk_select.cuh, the port of the TPU kernels' two-level selection)
// returns, bit for bit, with three block barriers a row instead of 2k
// serial block-wide argmax rounds:
//
//   stage    every warp owns the 128-wide chunks w, w+8, ...: lane l reads
//            columns 32e + l (e < 4) of each, coalesced, all loads of a
//            batch in flight, and stores the scores as f32 in shared
//            memory (pad at -inf).  A thread's columns are its group; it
//            keeps the group's best score, whose key (below) is the
//            group's, and the warp counts the chunks that hold a score
//            (or, on the direct path, the scores);
//   tau      each warp sorts its 32 group keys (bitonic, by shuffles) and
//            lists its best Lp (a power of two >= min(k, 32)); barrier 1;
//            the listed key with exactly k-1 listed keys above it is tau,
//            the k-th best group key (binary lifting over the 8 sorted
//            lists at once); barrier 2.  At least k scores have a key >=
//            tau, so the top-k is among the scores whose key is >= tau: at
//            most the columns of k groups, k * filter_group(G) of them;
//   compact  each column is compared with tau's value and column; warp
//            ballots and one shared counter gather the candidates' keys;
//            barrier 3;
//   rank     each candidate counts the candidates above it; rank r < k is
//            pick r.
//
// A key orders (value desc, index asc) as one unsigned 64-bit integer: the
// value's bits made monotone (-0 taken as +0) above the inverted index.  A
// score is a value above -inf; NaN is none, so no pick takes it, as in the
// first version (the plain version's argmax would).
//
// A front end may stage a cheap lower bound instead of the score (K4: the
// larger logaddexp operand); then the group keys and tau come from the
// bounds, and only the columns that may reach tau are scored exactly.
//
// The two-level selection equals the exact top-k only while k chunks hold
// a score (the direct path, V <= 8*128 or k >= G: k scores); short of
// that it repeats chunk 0 or position 0 (jnp.argmax on an all -inf
// remainder).  Such a row is detected from the staged counts and runs
// `select_topk_row` on the staged row in the same launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "topk_select.cuh"

namespace pafc {

constexpr int kFilterWarps = kSelThreads / 32;
constexpr int kFilterBatch = 5;  // chunks a warp loads at once (40 chunks / 8 warps at V = 5002)

struct FilterShared {
  SelectShared sel;  // the degenerate rows' selection
  int finite[kFilterWarps];
  unsigned long long tau;
  int n_cand;
};

// Columns of one group: 4 of each chunk its warp owns.
__host__ __device__ inline int filter_group(int G) {
  return 4 * ((G + kFilterWarps - 1) / kFilterWarps);
}

// Floats of dynamic shared memory a row takes: the staged row, then the
// larger of the degenerate path's scratch and picks and the candidate keys
// (at most min(V, k * filter_group(G)), two floats each; the 8 sorted
// lists before them take 16 * Lp < 32k floats).
inline size_t filter_smem_floats(int V, int Vp, int k) {
  const size_t cap = (size_t)k * filter_group(Vp / kChunk);
  const size_t keys = 2 * (cap < (size_t)V ? cap : (size_t)V);
  const size_t sel = select_smem_floats(Vp, k) - Vp;
  return Vp + (sel > keys ? sel : keys);
}

// A score is a value above -inf (NaN is none: no pick takes it).  The
// per-column predicates below combine with & and |, not && and ||: a
// short circuit compiles to a branch and a convergence barrier a column.
__device__ __forceinline__ bool is_score(float v) { return v > -INFINITY; }

// (value desc, index asc) as one unsigned integer, -0 as +0; 0 is below
// every key.
__device__ __forceinline__ unsigned long long filter_key(float v, int n) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)~n;
}

// Column of this lane's slot s: chunk wid + 8 (s / 4), quarter s % 4.
__device__ __forceinline__ int slot_col(int s, int wid, int lane) {
  return (wid + kFilterWarps * (s >> 2)) * kChunk + 32 * (s & 3) + lane;
}

// What a front end stages for column n < V: its score, or with
// Score::kBounded a lower bound of it.
template <class Score>
__device__ __forceinline__ float staged(const Score& score, int n) {
  if constexpr (Score::kBounded) return score.low(n);
  else return score(n);
}

// For a front end that stages lower bounds (Score::kBounded): every
// score of this lane's columns exact in the row (a degenerate row, or an
// overflow of the candidates).
template <class Score>
__device__ inline void score_all(const Score& score, float* row, int V, int G) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int s = 0; s < filter_group(G); ++s) {
    const int n = slot_col(s, wid, lane);
    if (n < V && is_score(row[n])) row[n] = score(n);
  }
}

// The top-k of the row whose column n < V scores `score(n)`, written to
// vals[0, k) and idx[0, k).  Every thread of the block calls it; `row` is
// the dynamic shared memory (filter_smem_floats(V, Vp, k) floats).
//
// A front end with Score::kBounded stages `score.low(n)`: a cheaper lower
// bound, -inf (or NaN) exactly where the score is, with score(n) <=
// fl(low + Score::kMargin).  Its groups' keys and tau then come from the
// bounds: at least k columns score at least their bound's key >= tau, so
// the top-k is still among the scores whose key is >= tau, and only the
// columns whose bound may reach tau's value are scored exactly, by their
// own lane in the compaction (typically one column or none a lane).
// The candidates are no longer limited to k groups; should they overflow
// their space (never on random scores), every score is made exact and the
// selection runs again on the exact row.
template <class Score>
__device__ inline void filter_topk_row(const Score& score, float* row, int V, int Vp, int k,
                                       float* vals, int* idx, FilterShared& sh) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int G = Vp / kChunk;
  const bool direct = V <= 8 * kChunk || k >= G;
  if (threadIdx.x == 0) {
    sh.tau = 0;
    sh.n_cand = 0;
  }
  float best = -INFINITY;  // the group's best staged value and its (first) column
  int best_n = -1;
  int finite = 0;  // this lane's scores (direct) or its warp's chunks that hold one
  for (int c0 = wid; c0 < G; c0 += kFilterWarps * kFilterBatch) {
    float v[kFilterBatch][4];  // every load of the batch in flight at once
#pragma unroll
    for (int b = 0; b < kFilterBatch; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (c0 + b * kFilterWarps) * kChunk + 32 * e + lane;
        const float x = staged(score, n < V ? n : V - 1);  // no branch around the loads
        v[b][e] = n < V ? x : -INFINITY;
      }
    unsigned held = 0;  // bit b: this lane holds a score in the batch's chunk b
#pragma unroll
    for (int b = 0; b < kFilterBatch; ++b) {
      const int c = c0 + b * kFilterWarps;
      if (c >= G) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = c * kChunk + 32 * e + lane;
        row[n] = v[b][e];
        if (v[b][e] > best) {  // ascending columns: the first of equals stays
          best = v[b][e];
          best_n = n;
        }
        const bool fin = is_score(v[b][e]);
        held |= (unsigned)fin << b;
        finite += direct & fin;
      }
    }
    if (!direct) {
      const unsigned chunks = __reduce_or_sync(full, held);  // every lane takes part
      if (lane == 0) finite += __popc(chunks);
    }
  }
  finite = __reduce_add_sync(full, finite);
  if (lane == 0) sh.finite[wid] = finite;
  int Lp = 1;  // each warp lists its best Lp >= min(k, 32) keys
  while (Lp < k && Lp < 32) Lp <<= 1;
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(row + Vp);
  unsigned long long* cand = lists;  // after barrier 2
  const int cap = k * filter_group(G) < V ? k * filter_group(G) : V;
  for (int pass = 0;; ++pass) {
    // the warp's group keys, descending (bitonic sort across the lanes)
    unsigned long long key = best_n < 0 ? 0ull : filter_key(best, best_n);
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned long long other = __shfl_xor_sync(full, key, stride);
        const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
        key = keep_max ? (other > key ? other : key) : (other < key ? other : key);
      }
    if (lane < Lp) lists[wid * Lp + lane] = key;
    __syncthreads();  // 1: the row, the lists, the counts
    if (pass == 0) {
      int n_finite = 0;
#pragma unroll
      for (int w = 0; w < kFilterWarps; ++w) n_finite += sh.finite[w];
      if (n_finite < k) {  // the two-level rule repeats chunk 0 / position 0
        if constexpr (Score::kBounded) {
          score_all(score, row, V, G);
          __syncthreads();
        }
        select_topk_row(row, V, Vp, k, vals, idx, sh.sel);
        return;
      }
    }
    // tau: the listed key with k-1 listed keys above it, by binary lifting
    // over the 8 lists at once (its own list puts `lane` keys above it)
    if (threadIdx.x < kFilterWarps * Lp) {
      const unsigned long long mine = lists[threadIdx.x];
      int pos[kFilterWarps] = {};
      for (int step = Lp >> 1; step > 0; step >>= 1)
#pragma unroll
        for (int w = 0; w < kFilterWarps; ++w)
          pos[w] += lists[w * Lp + pos[w] + step - 1] > mine ? step : 0;
      int rank = 0;
#pragma unroll
      for (int w = 0; w < kFilterWarps; ++w) rank += pos[w] + (lists[w * Lp + pos[w]] > mine);
      if (mine != 0 && rank == k - 1) sh.tau = mine;  // none when fewer than k groups
    }
    __syncthreads();  // 2: tau; the lists are dead
    const unsigned long long tau = sh.tau;
    float tv = -INFINITY;  // tau's value and column (no tau: every score)
    const int tn = (int)~(unsigned)tau;
    if (tau != 0) {
      const unsigned u = (unsigned)(tau >> 32);
      tv = __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
    }
    // the candidates: this lane's in a mask (bit 4b + e of each batch), then
    // one shared counter bump per warp and a batch
    for (int c0 = wid; c0 < G; c0 += kFilterWarps * kFilterBatch) {
      float v[kFilterBatch][4];
#pragma unroll
      for (int b = 0; b < kFilterBatch; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = (c0 + b * kFilterWarps) * kChunk + 32 * e + lane;
          v[b][e] = n < V ? row[n] : -INFINITY;
        }
      unsigned take = 0, exact = 0;
#pragma unroll
      for (int b = 0; b < kFilterBatch; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = (c0 + b * kFilterWarps) * kChunk + 32 * e + lane;
          const float x = v[b][e];
          take |= (unsigned)(is_score(x) & ((x > tv) | ((x == tv) & (n <= tn)))) << (4 * b + e);
          if constexpr (Score::kBounded)  // a bound that may reach tau's value
            exact |= (unsigned)(is_score(x) & (x + Score::kMargin >= tv)) << (4 * b + e);
        }
      if constexpr (Score::kBounded)
        if (pass == 0)  // those columns decide on their exact scores
          for (unsigned m = exact; m; m &= m - 1) {
            const int j = __ffs(m) - 1;
            const int n = (c0 + (j >> 2) * kFilterWarps) * kChunk + 32 * (j & 3) + lane;
            const float x = score(n);
            row[n] = x;
            take = (take & ~(1u << j)) |
                   (unsigned)(is_score(x) & ((x > tv) | ((x == tv) & (n <= tn)))) << j;
          }
      int incl = __popc(take);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(full, incl, off);
        if (lane >= off) incl += o;
      }
      const int total = __shfl_sync(full, incl, 31);
      int base = 0;
      if (lane == 0 && total) base = atomicAdd(&sh.n_cand, total);
      base = __shfl_sync(full, base, 0) + incl - __popc(take);
      for (; take; take &= take - 1, ++base) {
        const int j = __ffs(take) - 1;
        const int n = (c0 + (j >> 2) * kFilterWarps) * kChunk + 32 * (j & 3) + lane;
        if (base < cap) cand[base] = filter_key(row[n], n);
      }
    }
    __syncthreads();  // 3: the candidates
    if constexpr (!Score::kBounded) {
      break;
    } else {
      if (sh.n_cand <= cap) break;
      // overflow: every score exact, the groups' best from the row, and
      // the selection again
      score_all(score, row, V, G);
      best = -INFINITY;
      best_n = -1;
      for (int s = 0; s < filter_group(G); ++s) {
        const int n = slot_col(s, wid, lane);
        if (n < V && row[n] > best) {
          best = row[n];
          best_n = n;
        }
      }
      __syncthreads();  // every thread has read the count
      if (threadIdx.x == 0) {
        sh.tau = 0;
        sh.n_cand = 0;
      }
    }
  }
  const int n_cand = sh.n_cand;
  for (int p = threadIdx.x; p < n_cand; p += kSelThreads) {
    const unsigned long long mine = cand[p];
    int rank = 0;
    for (int j = 0; j < n_cand && rank < k; j += 8)
#pragma unroll
      for (int q = 0; q < 8; ++q) rank += (j + q < n_cand ? cand[j + q] : 0ull) > mine;
    if (rank < k) {
      const int n = (int)~(unsigned)mine;
      vals[rank] = row[n];
      idx[rank] = n;
    }
  }
}

}  // namespace pafc
