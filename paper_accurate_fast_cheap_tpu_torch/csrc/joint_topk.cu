// Fused transducer joint head + log-softmax + CTC shallow fusion + exact
// top-k, for the device prefix beam (one call per encoder frame):
//
//   logits = x @ W^T + b                 (V padded to Vp = 128*G, pad = -inf)
//   logp   = logits - logsumexp(logits)
//   score  = logaddexp(log_tw + logp, log_cw + ctc[row / n_rep])
//   top-k  = the k best (value desc, lowest index on equal values)
//
// Replaces: the JAX package's ops/topk_pallas.py,
// `_joint_topk_kernel` + `_select_phases` via `_joint_topk_rows` /
// `joint_top_k_vocab_pallas`.  Selection and tie rules are those of
// `decode/rnnt_search.py:top_k_vocab`, so indices agree with the plain
// version exactly where the scores do.
//
// Bound on the H100 at the flagship beam step (R = 32*8 rows, D = 640,
// V = 5002): W is 6.5 MB in bf16 and the product 1.68 GFLOP, so ~2 us per
// frame against the tensor-core rate, ~2 us against the memory rate.
//
// Design: two launches.  (1) The product writes the f32 logits, bias added
// and pad columns at -inf, into an (R, Vp) scratch (5 MB: it stays in the
// 50 MB L2), and beside them, per row and 128-wide column tile, the tile's
// max and sum of exponentials, so the logsumexp needs no pass over the row.
// In bf16 (the decode's path) it is wgmma over TMA-fed tiles: a block of one
// warpgroup owns 64 rows and 128 columns, and x's and W's 64-wide K chunks
// stream through a 4-stage ring (sm90.cuh: ring_product); TMA fills W's
// rows past V with zeros, which the epilogue overwrites with -inf.  Grid
// (Vp / 128, R / 64) = 160 blocks at the flagship step, two per SM.  In f32
// (the card-vs-CPU reference) it is a register-tiled CUDA-core product
// (gemm_tile.cuh) with the same epilogue.  (2) The selection combines the
// row's partials into the logsumexp, then fuses and selects in one pass
// over the row.  For k <= 32 four warps own a row: each lane keeps its own
// best KMAX (value, index) pairs in registers, sorted, over every 128th
// column from its thread index (four loads in flight before it fuses
// them); k shuffle rounds merge a warp's 32 lists (the winner of a round is
// lane index % 32, which drops its head), and warp 0 merges the four
// warps' k picks the same way.  One block barrier, no shared row.  The
// result is the exact (value desc, index asc) top-k,
// which is top_k_vocab's two-level result whenever k chunks hold a finite
// score: here always, as a log-softmax of finite logits is finite.  For
// k > 32 one block owns a row, stages the fused scores in shared memory
// and runs the selection shared with K4 and K5 (topk_select.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"
#include "sm90.cuh"
#include "topk_select.cuh"

namespace {

using pafc::kChunk;
using pafc::kSelThreads;
using pafc::to_f32;

// ---- f32 product: CUDA cores ---------------------------------------------

constexpr int GBM = 64, GBN = kChunk, GBK = 16, GTM = 8, GTN = 8;
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

// s * exp(m - to), 0 for a part that saw only -inf (m = -inf)
__device__ __forceinline__ float rescale(float s, float m, float to) {
  return m == -INFINITY ? 0.f : s * expf(m - to);
}

// max and sum of exp(v - max) over the lanes of `width` (a power of two)
// that share a row; every lane holds its own part (m, s)
template <int width>
__device__ __forceinline__ float2 merge_max_sum(float m, float s) {
#pragma unroll
  for (int off = 1; off < width; off <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const float nm = fmaxf(m, om);
    s = rescale(s, m, nm) + rescale(os, om, nm);
    m = nm;
  }
  return make_float2(m, s);
}

__global__ void __launch_bounds__(kGemmThreads)
    joint_logits_kernel(int R, int D, int V, int Vp, const float* __restrict__ x,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        float* __restrict__ logits, float2* __restrict__ part) {
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM, G = gridDim.x;
  float acc[GTM][GTN];
  pafc::zero_acc(acc);
  pafc::gemm_tile_nt<GBM, GBN, GBK, GTM, GTN>(D, RowLoad<float>{x, D, R, m0},
                                              RowLoad<float>{w, D, V, n0}, acc);
  constexpr int TX = GBN / GTN, TY = GBM / GTM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < GTM; ++i) {
    const int m = m0 + ty + i * TY;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < GTN; ++j) {
      const int n = n0 + tx + j * TX;
      acc[i][j] = n < V ? acc[i][j] + bias[n] : -INFINITY;
      mx = fmaxf(mx, acc[i][j]);
    }
    float s = 0.f;  // exp(-inf - mx) = 0: pad columns add nothing
#pragma unroll
    for (int j = 0; j < GTN; ++j) s += expf(acc[i][j] - mx);
    if (mx == -INFINITY) s = 0.f;
    // the TX = 16 threads of a row are 16 consecutive lanes
    const float2 ms = merge_max_sum<TX>(mx, s);
    if (m >= R) continue;
#pragma unroll
    for (int j = 0; j < GTN; ++j) logits[(long long)m * Vp + n0 + tx + j * TX] = acc[i][j];
    if (tx == 0) part[(long long)m * G + blockIdx.x] = ms;
  }
}

// ---- bf16 product: wgmma over TMA tiles ------------------------------------

namespace tc {

using namespace pafc::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 64, BN = kChunk, S = 4;
constexpr int kStage = BM * 128 + BN * 128;
constexpr size_t kSmem = ring_smem_bytes(S, kStage);

struct ChunkLoad {
  const CUtensorMap *xmap, *wmap;
  int m0, n0;
  __device__ void operator()(int c, uint8_t* st, uint64_t* bar) const {
    mbar_arrive_expect_tx(bar, kStage);
    tma_load_2d(st, xmap, bar, c * 64, m0);
    tma_load_2d(st + BM * 128, wmap, bar, c * 64, n0);
  }
};

// Accumulator (m64n128): thread (warp w, lane l) holds rows w*16 + l/4 (+ 8)
// at columns q*8 + (l%4)*2 (+ 1), q < 16: acc[q*4 + half*2 + e].  The four
// lanes of a quad share a row.
__global__ void __launch_bounds__(128)
    joint_logits_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap, int R, int D, int V, int Vp,
                           const bf16* __restrict__ bias, float* __restrict__ logits,
                           float2* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full;
  uint8_t* ring = ring_init(smem_raw, S, kStage, full);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, G = gridDim.x;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  ring_product<BN, S>(acc, ring, full, (D + 63) / 64, 1, ChunkLoad{&xmap, &wmap, m0, n0});

  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int n = n0 + q * 8 + (l % 4) * 2;
    const float b0 = n < V ? __bfloat162float(bias[n]) : 0.f;
    const float b1 = n + 1 < V ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float& v0 = acc[q * 4 + half * 2];
      float& v1 = acc[q * 4 + half * 2 + 1];
      v0 = n < V ? v0 + b0 : -INFINITY;
      v1 = n + 1 < V ? v1 + b1 : -INFINITY;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + w * 16 + l / 4 + 8 * half;
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
      mx = fmaxf(mx, fmaxf(acc[q * 4 + half * 2], acc[q * 4 + half * 2 + 1]));
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
      s += expf(acc[q * 4 + half * 2] - mx) + expf(acc[q * 4 + half * 2 + 1] - mx);
    if (mx == -INFINITY) s = 0.f;
    const float2 ms = merge_max_sum<4>(mx, s);
    if (m >= R) continue;
    float* lrow = logits + (long long)m * Vp + n0 + (l % 4) * 2;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q)
      *reinterpret_cast<float2*>(lrow + q * 8) =
          make_float2(acc[q * 4 + half * 2], acc[q * 4 + half * 2 + 1]);
    if (l % 4 == 0) part[(long long)m * G + blockIdx.x] = ms;
  }
}

}  // namespace tc

// ---- selection -------------------------------------------------------------

// The fused score of a logit l and its CTC log-prob c, in a row whose
// logsumexp is lse.
__device__ __forceinline__ float fused_score(float l, float c, float lse, float log_tw,
                                             float log_cw) {
  return pafc::logaddexp(log_tw + (l - lse), log_cw + c);
}

// The row's logsumexp from its G tile partials, reduced over the 32 lanes
// of a warp (every lane gets it).
__device__ __forceinline__ float warp_lse(const float2* p, int G) {
  float m = -INFINITY;
  for (int t = threadIdx.x % 32; t < G; t += 32) m = fmaxf(m, p[t].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.f;
  for (int t = threadIdx.x % 32; t < G; t += 32) s += p[t].y * expf(p[t].x - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return m + logf(s);
}

constexpr int kRowWarps = 4;  // warps splitting one row's columns
constexpr int kUnroll = 4;    // columns a lane loads before it fuses them

// This lane's best KMAX (value, index) pairs, sorted (value desc, index
// asc); empty slots are (-inf, INT_MAX), below every real score.
template <int KMAX>
struct LaneList {
  float v[KMAX];
  int i[KMAX];
  __device__ void clear() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      v[j] = -INFINITY;
      i[j] = 0x7fffffff;
    }
  }
  // slot j takes slot j - 1's pair if (x, n) beats it, else (x, n) if that
  // beats slot j's own (old) pair
  __device__ void insert(float x, int n) {
    if (!pafc::better(x, n, v[KMAX - 1], i[KMAX - 1])) return;
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      if (pafc::better(x, n, v[j - 1], i[j - 1])) {
        v[j] = v[j - 1];
        i[j] = i[j - 1];
      } else if (pafc::better(x, n, v[j], i[j])) {
        v[j] = x;
        i[j] = n;
      }
    }
    if (pafc::better(x, n, v[0], i[0])) {
      v[0] = x;
      i[0] = n;
    }
  }
  // k rounds over the warp's 32 lists, each lane holding only indices
  // equal to its lane mod 32: the best head wins and its lane drops it.
  // Lane r returns the r-th pick.
  __device__ void merge(int k, float& out_v, int& out_i) {
    const int lane = threadIdx.x % 32;
    out_v = -INFINITY;
    out_i = 0x7fffffff;
    for (int round = 0; round < k; ++round) {
      float bv = v[0];
      int bi = i[0];
      pafc::warp_best(bv, bi);
      if (lane == (bi & 31)) {
#pragma unroll
        for (int j = 0; j + 1 < KMAX; ++j) {
          v[j] = v[j + 1];
          i[j] = i[j + 1];
        }
        v[KMAX - 1] = -INFINITY;
        i[KMAX - 1] = 0x7fffffff;
      }
      if (lane == round) {
        out_v = bv;
        out_i = bi;
      }
    }
  }
};

// k <= 32: one block of four warps per row.  Warp w scans the columns
// n = w*32 + lane + 128*i (so lane = n % 32 throughout) into per-lane
// lists, merges them into its own top-k, and warp 0 merges the four.
template <typename TC, int KMAX>
__global__ void __launch_bounds__(32 * kRowWarps)
    select_warp_kernel(int V, int Vp, int G, int n_rep, int k, const float* __restrict__ logits,
                       const float2* __restrict__ part, const TC* __restrict__ ctc, int ctc_ld,
                       float log_tw, float log_cw, float* __restrict__ vals,
                       int* __restrict__ idx) {
  __shared__ float cand_v[kRowWarps * 32];
  __shared__ int cand_i[kRowWarps * 32];
  const int r = blockIdx.x, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float lse = warp_lse(part + (long long)r * G, G);
  const float* lrow = logits + (long long)r * Vp;
  const TC* crow = ctc + (long long)(r / n_rep) * ctc_ld;
  LaneList<KMAX> list;
  list.clear();
  constexpr int kStride = 32 * kRowWarps;
  for (int n0 = threadIdx.x; n0 < V; n0 += kUnroll * kStride) {
    float l[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the loads first, all in flight
      const int n = n0 + u * kStride;
      l[u] = n < V ? lrow[n] : 0.f;
      c[u] = n < V ? to_f32(crow[n]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int n = n0 + u * kStride;
      if (n < V)
        list.insert(fused_score(l[u], c[u], lse, log_tw, log_cw), n);
    }
  }
  float ov;
  int oi;
  list.merge(k, ov, oi);
  if (lane < k) {
    cand_v[w * 32 + lane] = ov;
    cand_i[w * 32 + lane] = oi;
  }
  __syncthreads();
  if (w != 0) return;
  list.clear();
  for (int c = 0; c < kRowWarps * k; ++c) {
    const int p = (c / k) * 32 + c % k;
    if ((cand_i[p] & 31) == lane) list.insert(cand_v[p], cand_i[p]);
  }
  list.merge(k, ov, oi);
  if (lane < k) {
    vals[(long long)r * k + lane] = ov;
    idx[(long long)r * k + lane] = oi;
  }
}

template <typename TC>
__global__ void __launch_bounds__(kSelThreads)
    select_block_kernel(int V, int Vp, int G, int n_rep, int k, const float* __restrict__ logits,
                        const float2* __restrict__ part, const TC* __restrict__ ctc, int ctc_ld,
                        float log_tw, float log_cw, float* __restrict__ vals,
                        int* __restrict__ idx) {
  extern __shared__ float row[];  // Vp scores, then the selection's scratch
  __shared__ pafc::SelectShared sh;
  __shared__ float lse_sh;
  const int r = blockIdx.x;
  if (threadIdx.x < 32) {
    const float lse = warp_lse(part + (long long)r * G, G);
    if (threadIdx.x == 0) lse_sh = lse;
  }
  __syncthreads();
  const float lse = lse_sh;
  const float* lrow = logits + (long long)r * Vp;
  const TC* crow = ctc + (long long)(r / n_rep) * ctc_ld;
  for (int n = threadIdx.x; n < Vp; n += kSelThreads)
    row[n] = n < V ? fused_score(lrow[n], to_f32(crow[n]), lse, log_tw, log_cw) : -INFINITY;
  __syncthreads();
  pafc::select_topk_row(row, V, Vp, k, vals + (long long)r * k, idx + (long long)r * k, sh);
}

template <typename TC>
int run_select(int R, int V, int Vp, int n_rep, int k, const float* logits, const float2* part,
               const void* ctc, int ctc_ld, float log_tw, float log_cw, float* vals, int* idx,
               cudaStream_t stream) {
  const int G = Vp / kChunk;
  const TC* c = (const TC*)ctc;
  if (k <= 32) {
#define PAFC_SELECT(KMAX)                                                                    \
  select_warp_kernel<TC, KMAX><<<R, 32 * kRowWarps, 0, stream>>>(                            \
      V, Vp, G, n_rep, k, logits, part, c, ctc_ld, log_tw, log_cw, vals, idx)
    if (k <= 8) PAFC_SELECT(8);
    else if (k <= 16) PAFC_SELECT(16);
    else PAFC_SELECT(32);
#undef PAFC_SELECT
    return (int)cudaGetLastError();
  }
  const size_t smem = pafc::select_smem_floats(Vp, k) * sizeof(float);
  int err = pafc::allow_smem(select_block_kernel<TC>, smem);
  if (err) return err;
  select_block_kernel<TC><<<R, kSelThreads, smem, stream>>>(V, Vp, G, n_rep, k, logits, part, c,
                                                           ctc_ld, log_tw, log_cw, vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x (R, D), w (V, D), b (V) and ctc
// (B, ctc_ld) with ctc_ld >= V.  logits is an (R, Vp) f32 scratch and part
// an (R, Vp / 128) float2 scratch (tile max, tile sum of exponentials);
// vals (R, k) f32 and idx (R, k) int32 are the outputs.  bf16 needs D a
// multiple of 8 and 16-byte-aligned x and w (TMA).
extern "C" int pafc_joint_topk(int dtype, int R, int D, int V, int n_rep, int k, const void* x,
                               const void* w, const void* b, const void* ctc, int ctc_ld,
                               float log_tw, float log_cw, void* logits, void* part, void* vals,
                               void* idx, void* stream) {
  if (k < 1 || k > V || n_rep < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Vp = (V + kChunk - 1) / kChunk * kChunk;
  const dim3 grid(Vp / kChunk, (R + GBM - 1) / GBM);
  float* lg = (float*)logits;
  float2* pt = (float2*)part;
  if (dtype == 0) {
    joint_logits_kernel<<<grid, kGemmThreads, 0, st>>>(R, D, V, Vp, (const float*)x,
                                                       (const float*)w, (const float*)b, lg, pt);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    return run_select<float>(R, V, Vp, n_rep, k, lg, pt, ctc, ctc_ld, log_tw, log_cw,
                             (float*)vals, (int*)idx, st);
  }
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    CUtensorMap xmap, wmap;
    int err = pafc::sm90::make_map_2d(&xmap, x, R, D, D, tc::BM, 64);
    if (!err) err = pafc::sm90::make_map_2d(&wmap, w, V, D, D, tc::BN, 64);
    if (!err)
      err = (int)cudaFuncSetAttribute(tc::joint_logits_tc_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)tc::kSmem);
    if (err) return err;
    tc::joint_logits_tc_kernel<<<grid, 128, tc::kSmem, st>>>(
        xmap, wmap, R, D, V, Vp, (const __nv_bfloat16*)b, lg, pt);
    err = (int)cudaGetLastError();
    if (err) return err;
    return run_select<__nv_bfloat16>(R, V, Vp, n_rep, k, lg, pt, ctc, ctc_ld, log_tw, log_cw,
                                     (float*)vals, (int*)idx, st);
  }
  return (int)cudaErrorInvalidValue;
}
