// K6: the fused position-wise feed-forward, y = act(x @ W1^T + b1) @ W2^T + b2
// per row, with the (R, H) hidden activation kept on chip.
//
// Replaces: the JAX package's ops/ffn_pallas.py, `_ffn_kernel` via
// `_ffn_rows` and `fused_ffn`.  Numerics follow it: the first product
// accumulates in f32, the bias and the activation (swish, relu, gelu in its
// tanh form, hardtanh) run in f32, the hidden is rounded to the weights'
// dtype before the second product, which accumulates in f32; y is written
// in x's dtype.  x, W1, b1, W2, b2 share one dtype (the wrapper casts the
// weights to x's, as the JAX wrapper does).  Weights are in nn.Linear
// layout: W1 (H, D), W2 (D, H), so both products read K-major operands.
//
// Bound on the H100 at the flagship FFN (R = 32 x 2248 rows, D = 512,
// H = 2048, bf16): 4 R D H = 302 GFLOP against 0.15 GB of x, y and weights,
// so the tensor-core rate bounds it (0.305 ms); at the training shape
// (R = 16 x 374, f32) the CUDA-core f32 rate does (0.37 ms).
//
// In both kernels a block owns a band of rows and all D = 512 output
// columns, keeps its f32 y accumulator in registers and walks H in slices:
// h = act(x_band @ W1[slice]^T + b1[slice]) goes to a small shared tile,
// y_band += h @ W2[:, slice]^T.  The (R, H) hidden is never written to
// global memory: only x is read and y written per row.
//
// bf16 (ffn_tc_kernel: wgmma over TMA-fed tiles, sm90.cuh).  A block owns 64
// rows; TMA loads its x band (64 x 512, 64 KB) once.  One producer thread
// streams, per 64-wide H slice, four 32 KB tiles through a 4-stage ring
// with full/empty mbarriers: W1's 64 slice rows as two 256-wide K halves
// (stages 0, 1), W2's slice columns for y columns 0-255 and 256-511
// (stages 2, 3), in the order the consumers use them.  Two consumer
// warpgroups each own 256 of y's columns (128 accumulator registers a
// thread; one warpgroup would need 256).  Each computes half of the hidden
// slice (32 m64n32k16 over K = 512), adds the bias (prefetched a slice
// ahead), applies the activation with the fast intrinsics (the hidden is
// rounded to bf16 right after) and writes h into a 128-byte-swizzled
// shared tile, double-buffered; a named barrier joins the warpgroups, and
// each runs 4 m64n256k16 over the slice into its y columns.  The next
// slice's first product is issued ahead of this slice's second, so the
// activation overlaps the second product; the loop body has no branch (a
// branch there makes ptxas serialize every wgmma).  Rows past R load as
// zeros (TMA) and are not stored.  What bounds it: the first product is
// a chain of 32 dependent n32 wgmmas per warpgroup and slice (latency, not
// rate), and the ring holds one slice only (x, the ring and h fill the
// shared memory), so W loads are issued about one slice ahead.  Per block:
// 384 threads (setmaxnreg 232 / 40), 214,088 bytes of dynamic shared
// memory; ptxas (CUDA 12.9) caps the kernel at 168 registers a thread,
// spills 128 bytes and notes C7512 (wgmmas serialized for want of
// registers).  A second accumulator chain for the first product spills
// more at that cap, and lifting the cap (no launch bounds, or
// __maxnreg__) crashes ptxas 12.9 on this kernel.  A 2-block cluster that
// multicasts each weight tile halves the L2 traffic (every block rereads
// 4 MB of weights: ~4.5 GB at the decode shape) but ran slower: its
// refills wait on both blocks' releases, and the kernel is not bound by L2.
//
// f32 (ffn_f32_kernel: 3xTF32 on the tensor cores, mma.sync m16n8k8; plain
// TF32 would break the parity with ffn_plain).  Every operand v is split
// into two TF32 values, v = big + small, and each product is taken as
// small * big + big * small + big * big, which keeps f32 precision (the
// dropped small * small is ~2^-22 of the product).  The tensor core's f32
// accumulation truncates, and summed over K it misses ffn_plain by more
// than 1e-5 of the output scale, so it sums only one k8 step's 24 products
// from zero and the running sum takes IEEE adds.  A block of 8 warps owns
// 48 rows (ceil(5984 / 48) = 125 blocks fill the 132 SMs in one wave at
// the training shape); x's band is staged in shared memory once
// (cp.async, zero past R); the weights stream in 16-byte cp.async copies
// through a double-buffered stage: per 256-wide H slice, sixteen W1 chunks
// (256 rows x 32 k) then sixteen W2 chunks (512 rows x 16 k).  Rows are
// padded to 4 mod 32 floats, so each fragment load hits 32 banks.  Warp w
// owns 32 of the hidden slice's columns and 64 of y's, for all 48 rows
// (48 + 96 accumulator registers).  230,912 bytes of dynamic shared
// memory; ptxas: 255 registers, 4 bytes of spill for swish.  A
// register-blocked CUDA-core version (12 x 8 tiles) ran slower.
//
// Limits (the C entry returns cudaErrorInvalidValue otherwise, and
// ops/ffn.py raises a KernelError first): D = 512 and H a multiple of
// 256 (every model config of the repo has 512 / 2048); pointers 16-byte
// aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace pafc::sm90;

constexpr int kD = 512;     // the model width both kernels take
constexpr int kHStep = 256; // H must be a multiple of this

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == 0) return v / (1.f + expf(-v));  // swish
  if (ACT == 1) return fmaxf(v, 0.f);         // relu
  if (ACT == 2) {                              // gelu, tanh approximation
    const float c = 0.7978845608028654f;       // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return fminf(fmaxf(v, -1.f), 1.f);           // hardtanh
}

// The same activations with the fast intrinsics (__expf: ex2.approx, a few
// f32 ulps; __fdividef), for the bf16 kernel, whose hidden is rounded to
// bf16 (2^-8) right after: the IEEE expf / tanhf and division of act() cost
// as much as a product there.  tanh(u) = 1 - 2 / (1 + e^2u).
template <int ACT>
__device__ __forceinline__ float act_fast(float v) {
  if (ACT == 0) return __fdividef(v, 1.f + __expf(-v));
  if (ACT == 2) {
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (2.f - __fdividef(2.f, 1.f + __expf(2.f * u)));
  }
  return act<ACT>(v);
}

// ---- bf16: wgmma --------------------------------------------------------

namespace tc {

constexpr int BM = 64, HS = 64, kStages = 4;
constexpr int kThreads = 3 * 128;            // two consumer warpgroups, one producer
constexpr int kBox = 64 * 64 * 2;            // 8 KB: 64 rows x 64 k
constexpr int kXBytes = (kD / 64) * kBox;    // 64 KB: the block's x band
constexpr int kStage = 32768;                // one ring tile
constexpr int kHBytes = BM * HS * 2;         // 8 KB: one hidden slice
constexpr size_t kSmem =
    kXBytes + kStages * kStage + 2 * kHBytes + 1024 + (1 + 2 * kStages) * sizeof(uint64_t);
static_assert(kHStep % HS == 0, "H splits into whole slices");

// the slice's hidden columns wg * 32 .. + 32 over K = D: A is the x band
// (eight 64-wide boxes), B the two W1 ring tiles (stages 0 and 1, four
// 64-row boxes each; this warpgroup reads rows wg * 32 .. + 32 of each)
__device__ __forceinline__ void first_product(float (&hacc)[16], const uint8_t* xs,
                                              const uint8_t* ring, int wg) {
  const uint32_t xa = opaque_smem(xs), wa = opaque_smem(ring + wg * 4096);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t a = xa + (kk / 4) * kBox + (kk % 4) * 32;
    const uint32_t b = wa + (kk / 16) * kStage + ((kk % 16) / 4) * kBox + (kk % 4) * 32;
    wgmma_m64n32k16<0>(hacc, desc_kmajor(a), desc_kmajor(b), kk > 0);
  }
}

// y's columns wg * 256 .. + 256 += h (64 x 64, the slice) @ the W2 tile of
// those columns (ring stage 2 + wg)
__device__ __forceinline__ void second_product(float (&yacc)[128], const uint8_t* hb,
                                               const uint8_t* ring, int wg) {
  const uint32_t ha = opaque_smem(hb), wa = opaque_smem(ring + (2 + wg) * kStage);
  fence_regs(yacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
    wgmma_m64n256k16<0>(yacc, desc_kmajor(ha + kk * 32), desc_kmajor(wa + kk * 32), 1);
}

// the bias of this thread's hidden columns of the slice starting at col0
// (two adjacent columns in each of four 8-column groups): loaded a slice
// ahead, so the global load is off the path between a product and the
// named barrier
__device__ __forceinline__ void load_bias(__nv_bfloat162 (&bias)[4],
                                          const __nv_bfloat16* __restrict__ b1, int col0,
                                          int wg) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bias[g] = *reinterpret_cast<const __nv_bfloat162*>(b1 + col0 + wg * 32 + g * 8 +
                                                       (lane % 4) * 2);
}

// bias + activation on the f32 pre-activation, rounded to bf16, into the
// 64 x 64 hidden tile in the 128-byte swizzle wgmma reads as a K-major A
template <int ACT>
__device__ __forceinline__ void store_hidden(const float (&hacc)[16], uint8_t* hb,
                                             const __nv_bfloat162 (&bias)[4], int wg) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const int row = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int col = wg * 32 + (i / 4) * 8 + (lane % 4) * 2;
    const float2 b = __bfloat1622float2(bias[i / 4]);
    const float v0 = act_fast<ACT>(hacc[i] + b.x);
    const float v1 = act_fast<ACT>(hacc[i + 1] + b.y);
    const int off = row * 128 + (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
    *reinterpret_cast<__nv_bfloat162*>(hb + off) = __floats2bfloat162_rn(v0, v1);
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map, int R, int H,
                  const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ y) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = align_1024(smem_raw);
  uint8_t* ring = xs + kXBytes;
  uint8_t* hs = ring + kStages * kStage;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(hs + 2 * kHBytes);
  uint64_t* full = xfull + 1;
  uint64_t* empty = full + kStages;
  const int n_slices = H / HS;
  const int m0 = blockIdx.x * BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(xfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues the TMA
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      mbar_arrive_expect_tx(xfull, kXBytes);
      for (int k = 0; k < kD / 64; ++k) tma_load_2d(xs + k * kBox, &xmap, xfull, k * 64, m0);
      // stage s of slice j: 0, 1 = W1 rows j*HS.. (K halves), 2, 3 = W2
      // rows 0-255 / 256-511 at columns j*HS..; loaded in the consumers'
      // order: W1 of slice 0, then W1 of slice j + 1 before W2 of slice j
      for (int j = -1; j < n_slices; ++j) {
        for (int s = 0; s < kStages; ++s) {
          const int slice = s < 2 ? j + 1 : j;
          if (slice < 0 || slice >= n_slices) continue;
          mbar_wait(&empty[s], (slice & 1) ^ 1);
          uint8_t* dst = ring + s * kStage;
          mbar_arrive_expect_tx(&full[s], kStage);
          if (s < 2) {
            for (int q = 0; q < 4; ++q)
              tma_load_2d(dst + q * kBox, &w1map, &full[s], (s * 4 + q) * 64, slice * HS);
          } else {
            tma_load_2d(dst, &w2map, &full[s], slice * HS, (s - 2) * 256);
          }
        }
      }
    }
  } else {  // consumer warpgroups: y columns wg * 256 .. + 256
    setmaxnreg_inc<232>();
    float yacc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) yacc[i] = 0.f;
    float hacc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) hacc[i] = 0.f;
    __nv_bfloat162 bias[4];
    load_bias(bias, b1, 0, wg);
    mbar_wait(xfull, 0);
    mbar_wait(&full[0], 0);
    mbar_wait(&full[1], 0);
    fence_regs(hacc);
    wgmma_fence();
    first_product(hacc, xs, ring, wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hacc);
    mbar_arrive(&empty[0]);
    mbar_arrive(&empty[1]);
    store_hidden<ACT>(hacc, hs, bias, wg);
    fence_proxy_async();
    named_barrier(1, 2 * 128);
    // Slice j: the first product of slice j + 1 is issued ahead of the
    // second product of slice j, so its activation runs while the tensor
    // cores work on the second product.  The named barrier at the end
    // orders both warpgroups' writes of h(j + 1) before its reads, and
    // both warpgroups' reads of h(j) (their second products are waited
    // for) before its buffer is written again in slice j + 1.  The loop
    // body has no branch, so ptxas can count the wgmma groups in flight
    // (a branch there makes it serialize every wgmma); the last slice is
    // peeled.
    for (int j = 0; j + 1 < n_slices; ++j) {
      load_bias(bias, b1, (j + 1) * HS, wg);
      mbar_wait(&full[0], (j + 1) & 1);
      mbar_wait(&full[1], (j + 1) & 1);
      fence_regs(hacc);
      wgmma_fence();
      first_product(hacc, xs, ring, wg);
      wgmma_commit();
      // both warpgroups wait on (and release) both W2 tiles, so every
      // stage's empty barrier counts the same arrivals per phase
      mbar_wait(&full[2], j & 1);
      mbar_wait(&full[3], j & 1);
      second_product(yacc, hs + (j & 1) * kHBytes, ring, wg);
      wgmma_commit();
      wgmma_wait<1>();  // slice j + 1's first product is done
      fence_regs(hacc);
      mbar_arrive(&empty[0]);
      mbar_arrive(&empty[1]);
      store_hidden<ACT>(hacc, hs + ((j + 1) & 1) * kHBytes, bias, wg);
      fence_proxy_async();
      wgmma_wait<0>();  // slice j's second product is done
      fence_regs(yacc);
      mbar_arrive(&empty[2]);
      mbar_arrive(&empty[3]);
      named_barrier(1, 2 * 128);
    }
    const int last = n_slices - 1;
    mbar_wait(&full[2], last & 1);
    mbar_wait(&full[3], last & 1);
    second_product(yacc, hs + (last & 1) * kHBytes, ring, wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);

    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r = m0 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = wg * 256 + j * 8 + (lane % 4) * 2;
      const float bb0 = __bfloat162float(b2[c]), bb1 = __bfloat162float(b2[c + 1]);
      if (r < R)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)r * kD + c) =
            __floats2bfloat162_rn(yacc[4 * j] + bb0, yacc[4 * j + 1] + bb1);
      if (r + 8 < R)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)(r + 8) * kD + c) =
            __floats2bfloat162_rn(yacc[4 * j + 2] + bb0, yacc[4 * j + 3] + bb1);
    }
  }
}

}  // namespace tc

// ---- f32: 3xTF32 on the tensor cores ---------------------------------------

namespace f32 {

constexpr int BM = 48, HS = 256, kThreads = 256;
constexpr int K1 = 32, W1LD = K1 + 4;           // W1 chunk: HS rows x 32 k
constexpr int K2 = 16, W2LD = K2 + 4;           // W2 chunk: kD rows x 16 k
constexpr int kChunks1 = kD / K1, kChunks2 = HS / K2;
constexpr int kChunks = kChunks1 + kChunks2;    // per H slice
constexpr int kStageFloats = HS * W1LD > kD * W2LD ? HS * W1LD : kD * W2LD;
// every row padded to 4 mod 32 floats: the 32 lanes of a fragment load (row
// g, column t; g = lane / 4, t = lane % 4) fall on 32 distinct banks
constexpr int XLD = kD + 4, HLD = HS + 4;
constexpr size_t kSmem = (size_t)(BM * XLD + BM * HLD + 2 * kStageFloats) * sizeof(float);
constexpr int RT = BM / 16;        // m16 row tiles: every warp covers all rows
constexpr int NT1 = HS / 8 / 8;    // n8 tiles of the hidden slice per warp
constexpr int NT2 = kD / 8 / 8;    // n8 tiles of y per warp
static_assert(kHStep % HS == 0, "H splits into whole slices");
static_assert(kThreads == 8 * 32, "8 warps split the columns");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// chunk q of the block's weight stream into a stage
__device__ __forceinline__ void load_chunk(float* st, int q, const float* __restrict__ w1,
                                           const float* __restrict__ w2, int H) {
  const int j = q / kChunks, c = q % kChunks;
  if (c < kChunks1) {  // W1 rows j * HS .. + HS, k c * K1 .. + K1
#pragma unroll
    for (int e = threadIdx.x; e < HS * K1 / 4; e += kThreads) {
      const int row = e / (K1 / 4), c4 = e % (K1 / 4);
      cp_async16(st + row * W1LD + c4 * 4, w1 + (size_t)(j * HS + row) * kD + c * K1 + c4 * 4,
                 true);
    }
  } else {  // W2 rows 0 .. kD, k j * HS + (c - kChunks1) * K2 .. + K2
    const int k0 = j * HS + (c - kChunks1) * K2;
#pragma unroll
    for (int e = threadIdx.x; e < kD * K2 / 4; e += kThreads) {
      const int row = e / (K2 / 4), c4 = e % (K2 / 4);
      cp_async16(st + row * W2LD + c4 * 4, w2 + (size_t)row * H + k0 + c4 * 4, true);
    }
  }
}

// v = big + small, both TF32 (10-bit mantissas): big * big + big * small +
// small * big carries the product to ~2^-22 of |a b|, f32 precision
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[rt][nt] += A[rows rt*16.., k0..k0+8) B[cols n0 + nt*8.., same k]^T in
// 3xTF32.  A is row-major (lda floats a row), B row n holds column n of B^T
// (K-major, ldb floats a row): the m16n8k8 fragments read A(g, t), A(g+8, t),
// A(g, t+4), A(g+8, t+4) and B(n g, k t), B(n g, k t+4), g = lane / 4, t =
// lane % 4
template <int NT>
__device__ __forceinline__ void step(float (&acc)[RT][NT][4], const float* a, int lda,
                                     const float* b, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t ab[RT][4], as[RT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    const float* ar = a + (rt * 16 + g) * lda + t;
    split(ar[0], ab[rt][0], as[rt][0]);
    split(ar[8 * lda], ab[rt][1], as[rt][1]);
    split(ar[4], ab[rt][2], as[rt][2]);
    split(ar[8 * lda + 4], ab[rt][3], as[rt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t bb0, bb1, bs0, bs1;
    split(b[(nt * 8 + g) * ldb + t], bb0, bs0);
    split(b[(nt * 8 + g) * ldb + t + 4], bb1, bs1);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      // the tensor core's f32 accumulation truncates: it sums only this
      // k8 step's 24 products, from zero, and the running sum takes IEEE
      // adds (accumulating in the tensor core over K misses 1e-5 of scale)
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma(d, as[rt][0], as[rt][1], as[rt][2], as[rt][3], bb0, bb1);
      mma(d, ab[rt][0], ab[rt][1], ab[rt][2], ab[rt][3], bs0, bs1);
      mma(d, ab[rt][0], ab[rt][1], ab[rt][2], ab[rt][3], bb0, bb1);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rt][nt][i] += d[i];
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_f32_kernel(int R, int H, const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + BM * XLD;
  float* ws = hs + BM * HLD;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  for (int e = threadIdx.x; e < BM * kD / 4; e += kThreads) {
    const int row = e / (kD / 4), c4 = e % (kD / 4), r = m0 + row;
    cp_async16(xs + row * XLD + c4 * 4, x + (size_t)min(r, R - 1) * kD + c4 * 4, r < R);
  }
  const int n_chunks = (H / HS) * kChunks;
  load_chunk(ws, 0, w1, w2, H);
  cp_async_commit();

  // warp w: the hidden slice's columns w * 32 .. + 32 and y's columns
  // w * 64 .. + 64, every row of the block
  float yacc[RT][NT2][4], hacc[RT][NT1][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[rt][nt][i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[rt][nt][i] = 0.f;
  }

  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) {
      load_chunk(ws + ((q + 1) & 1) * kStageFloats, q + 1, w1, w2, H);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = ws + (q & 1) * kStageFloats;
    const int j = q / kChunks, c = q % kChunks;
    if (c < kChunks1) {  // hidden slice += x[:, chunk] @ W1 chunk^T
      if (c == 0) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) hacc[rt][nt][i] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K1; k += 8)
        step<NT1>(hacc, xs + c * K1 + k, XLD, st + warp * NT1 * 8 * W1LD + k, W1LD);
      if (c == kChunks1 - 1) {  // bias + activation into the hidden tile
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = rt * 16 + g + 8 * (i / 2);
              const int col = warp * NT1 * 8 + nt * 8 + 2 * t + i % 2;
              hs[row * HLD + col] = act<ACT>(hacc[rt][nt][i] + b1[j * HS + col]);
            }
      }
    } else {  // y += h[:, chunk] @ W2 chunk^T
#pragma unroll
      for (int k = 0; k < K2; k += 8)
        step<NT2>(yacc, hs + (c - kChunks1) * K2 + k, HLD, st + warp * NT2 * 8 * W2LD + k,
                  W2LD);
    }
    __syncthreads();
  }

#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + rt * 16 + g + 8 * half;
      if (r < R) {
#pragma unroll
        for (int nt = 0; nt < NT2; ++nt) {
          const int col = warp * NT2 * 8 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(y + (size_t)r * kD + col) =
              make_float2(yacc[rt][nt][2 * half] + b2[col], yacc[rt][nt][2 * half + 1] + b2[col + 1]);
        }
      }
    }
}

}  // namespace f32

template <int ACT>
int launch_tc(int R, int H, const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, void* y, cudaStream_t stream) {
  CUtensorMap xmap, w1map, w2map;
  int err = make_map_2d(&xmap, x, R, kD, kD, tc::BM, 64);
  if (!err) err = make_map_2d(&w1map, w1, H, kD, kD, tc::HS, 64);
  if (!err) err = make_map_2d(&w2map, w2, kD, H, H, 256, 64);
  if (err) return err;
  auto kern = tc::ffn_tc_kernel<ACT>;
  err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tc::kSmem);
  if (err) return err;
  kern<<<(R + tc::BM - 1) / tc::BM, tc::kThreads, tc::kSmem, stream>>>(
      xmap, w1map, w2map, R, H, (const __nv_bfloat16*)b1, (const __nv_bfloat16*)b2,
      (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch_f32(int R, int H, const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, cudaStream_t stream) {
  auto kern = f32::ffn_f32_kernel<ACT>;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)f32::kSmem);
  if (err) return err;
  kern<<<(R + f32::BM - 1) / f32::BM, f32::kThreads, f32::kSmem, stream>>>(
      R, H, (const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)y);
  return (int)cudaGetLastError();
}

template <int ACT>
int launch(int dtype, int R, int H, const void* x, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, cudaStream_t st) {
  if (dtype == 0) return launch_f32<ACT>(R, H, x, w1, b1, w2, b2, y, st);
  if (dtype == 1) return launch_tc<ACT>(R, H, x, w1, b1, w2, b2, y, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x (R, D), W1 (H, D), b1 (H),
// W2 (D, H), b2 (D) and y (R, D), all contiguous and 16-byte aligned; act:
// 0 swish, 1 relu, 2 gelu (tanh form), 3 hardtanh.  Returns
// cudaErrorInvalidValue unless D = 512 and H is a positive multiple of 128.
extern "C" int pafc_ffn(int dtype, int act, int R, int D, int H, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, void* stream) {
  if (R < 1 || D != kD || H < kHStep || H % kHStep) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (act) {
    case 0: return launch<0>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 1: return launch<1>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 2: return launch<2>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 3: return launch<3>(dtype, R, H, x, w1, b1, w2, b2, y, st);
  }
  return (int)cudaErrorInvalidValue;
}
