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
// In both kernels a block owns a band of rows and a group of y's columns
// (all D of them for D <= 512; two groups at D = 640, each group
// recomputing the whole hidden for its rows, so the first product is done
// twice there), keeps its f32 y accumulator in registers and walks H in slices:
// h = act(x_band @ W1[slice]^T + b1[slice]) goes to a small shared tile,
// y_band += h @ W2[:, slice]^T.  The (R, H) hidden is never written to
// global memory: only x is read and y written per row.
//
// bf16 (ffn_tc_kernel: wgmma over TMA-fed tiles, sm90.cuh).  A block owns 64
// rows; TMA loads its x band (64 x D, 64 KB at D = 512) once.  One producer
// thread streams, per 64-wide H slice, three tiles through a 3-stage ring
// with full/empty mbarriers: W1's 64 slice rows (stage 0, D / 64 boxes),
// W2's slice columns for each warpgroup's y columns (stages 1, 2), in the
// order the consumers use them.  Two consumer warpgroups each own 256 of
// the block's 512 y columns (128 accumulator registers a thread; one
// warpgroup would need 256); a D below 512 leaves the columns past D
// unstored (ptxas 12.9 crashes on this kernel with any second-product
// width but 256).  At D = 640 x's band, W1's rows and the W2 tiles exceed
// the shared memory, so one region takes W1 and then the W2 tiles of each
// slice in turn and the products wait for their loads (the serial form,
// two 512-column groups).  Each computes half of the hidden
// slice (D / 16 m64n32k16 over K = D), adds the bias (prefetched a slice
// ahead), applies the activation with the fast intrinsics (the hidden is
// rounded to bf16 right after) and writes h into a 128-byte-swizzled
// shared tile, double-buffered; a named barrier joins the warpgroups, and
// each runs 4 m64n256k16 over the slice into its y columns.  The next
// slice's first product is issued ahead of this slice's second, so the
// activation overlaps the second product; the loop body has no branch (a
// branch there makes ptxas serialize every wgmma).  Rows past R load as
// zeros (TMA) and are not stored.  What bounds it: the first product is
// a chain of 32 dependent n32 wgmmas per warpgroup and slice at D = 512
// (latency, not rate), and the ring holds one slice only (x, the ring and
// h fill the shared memory), so W loads are issued about one slice ahead.
// Per block: 384 threads (setmaxnreg 232 / 40), 214,072 bytes of dynamic
// shared memory at D = 512; ptxas (CUDA 12.9) caps the kernel at 168
// registers a thread,
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
// through a double-buffered stage: per H slice (256 wide, or 128 where H
// is an odd multiple of 128 or D = 640), D / 32 W1 chunks (slice rows x 32
// k) then the W2 chunks (the group's y rows x 16 k).  Rows are
// padded to 4 mod 32 floats, so each fragment load hits 32 banks.  Warp w
// owns an eighth of the hidden slice's columns and of the group's y
// columns, for all 48 rows (48 + 96 accumulator registers at D = 512).
// 230,912 bytes of dynamic shared memory at D = 512; ptxas: 255
// registers, 4 bytes of spill for swish.  A register-blocked CUDA-core
// version (12 x 8 tiles) ran slower.
//
// D > 640, both dtypes (ffn_stream_kernel: mma.sync over cp.async chunks,
// mma_frag.cuh; D a runtime argument).  x's band no longer stays resident:
// per 128-wide hidden slice the block streams x's 32-wide k chunks beside
// W1's (48 rows + 128 rows a chunk), then W2's chunks for its group of 512
// y columns (zeros past D), through two cp.async stages; each group
// recomputes the hidden, as the D = 640 form does.  8 warps: each owns 16
// of the slice's hidden columns and 64 of the group's y columns for all 48
// rows.  bf16 takes the fast activations, f32 3xTF32 with IEEE adds and the
// IEEE activations, as the kernels above.  A simple form: no config of the
// repo has D > 512.
//
// Limits (the C entry returns cudaErrorInvalidValue otherwise, and
// ops/ffn.py raises a KernelError first): D and H positive multiples of
// 128 (the JAX kernel's envelope); pointers 16-byte aligned.  D in 128 ..
// 640 takes the resident-band kernels above, any larger D the streaming
// form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"
#include "mma_frag.cuh"
#include "sm90.cuh"

namespace {

using namespace pafc::sm90;
namespace frag = pafc::frag;

constexpr int kStep = 128;   // D and H are multiples of this

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

constexpr int BM = 64, HS = 64, kStages = 3;
constexpr int kThreads = 3 * 128;            // two consumer warpgroups, one producer
constexpr int kBox = 64 * 64 * 2;            // 8 KB: 64 rows x 64 k
constexpr int kHBytes = BM * HS * 2;         // 8 KB: one hidden slice
static_assert(kStep % HS == 0, "H splits into whole slices");

// Each warpgroup owns NW = 256 of y's columns, a block a group of 512
// (ptxas 12.9 crashes on this kernel with any other second-product width,
// so a narrower D masks the columns past it).  KD = D is x's band and the
// first product's K.  Ring stage 0 holds the slice's W1 rows (KD / 64
// boxes), stages 1 and 2 the two warpgroups' W2 tiles (256 rows x 64 k).
// Past D = 512 those three and x's band overflow the shared memory: the
// serial form keeps one region, which takes W1 and the W2 tiles in turn.
constexpr int NW = 256;
template <int KD>
struct Shape {
  static constexpr bool kSerial = KD > 512;
  static constexpr int kGroups = (KD + 2 * NW - 1) / (2 * NW);  // y column groups
  static constexpr int kXBytes = KD * 128;   // the block's x band (64 KB at D = 512)
  static constexpr int kW1Bytes = KD * 128;  // one slice's W1 rows
  static constexpr int kW2Bytes = NW * 128;  // one warpgroup's W2 tile
  static constexpr int kW2Offset = kSerial ? 0 : kW1Bytes;  // W2 tiles in the ring
  static constexpr int kRingBytes =
      kSerial ? (kW1Bytes > 2 * kW2Bytes ? kW1Bytes : 2 * kW2Bytes) : kW1Bytes + 2 * kW2Bytes;
  static constexpr size_t kSmem =
      kXBytes + kRingBytes + 2 * kHBytes + 1024 + (1 + 2 * kStages) * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "fits a block's shared memory");
};

// the slice's hidden columns wg * 32 .. + 32 over K = D: A is the x band
// (KD / 64 boxes of 64 k), B the slice's W1 rows (ring stage 0, as many
// 64-row boxes; this warpgroup reads rows wg * 32 .. + 32 of each)
template <int KD>
__device__ __forceinline__ void first_product(float (&hacc)[16], const uint8_t* xs,
                                              const uint8_t* ring, int wg) {
  const uint32_t xa = opaque_smem(xs), wa = opaque_smem(ring + wg * 4096);
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t a = xa + (kk / 4) * kBox + (kk % 4) * 32;
    const uint32_t b = wa + (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_m64n32k16<0>(hacc, desc_kmajor(a), desc_kmajor(b), kk > 0);
  }
}

// this warpgroup's 256 columns of y += h (64 x 64, the slice) @ their W2
// tile (ring stage 1 + wg)
template <int KD>
__device__ __forceinline__ void second_product(float (&yacc)[128], const uint8_t* hb,
                                               const uint8_t* ring, int wg) {
  const uint32_t ha = opaque_smem(hb);
  const uint32_t wa = opaque_smem(ring + Shape<KD>::kW2Offset + wg * Shape<KD>::kW2Bytes);
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

template <int ACT, int KD>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map, int R, int H,
                  const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ y) {
  using Sh = Shape<KD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = align_1024(smem_raw);
  uint8_t* ring = xs + Sh::kXBytes;
  uint8_t* hs = ring + Sh::kRingBytes;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(hs + 2 * kHBytes);
  uint64_t* full = xfull + 1;
  uint64_t* empty = full + kStages;
  const int n_slices = H / HS;
  const int m0 = blockIdx.x * BM;
  const int y0 = Sh::kGroups > 1 ? blockIdx.y * 2 * NW : 0;  // this block's y columns
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
      mbar_arrive_expect_tx(xfull, Sh::kXBytes);
      for (int k = 0; k < KD / 64; ++k) tma_load_2d(xs + k * kBox, &xmap, xfull, k * 64, m0);
      if constexpr (Sh::kSerial) {
        // one region: W1 of slice j (use 2j), then both W2 tiles (2j + 1)
        for (int t = 0; t < 2 * n_slices; ++t) {
          const int slice = t / 2;
          mbar_wait(&empty[0], (t & 1) ^ 1);
          if (t % 2 == 0) {
            mbar_arrive_expect_tx(&full[0], Sh::kW1Bytes);
            for (int q = 0; q < KD / 64; ++q)
              tma_load_2d(ring + q * kBox, &w1map, &full[0], q * 64, slice * HS);
          } else {
            mbar_arrive_expect_tx(&full[0], 2 * Sh::kW2Bytes);
            for (int g = 0; g < 2; ++g)
              tma_load_2d(ring + g * Sh::kW2Bytes, &w2map, &full[0], slice * HS, y0 + g * NW);
          }
        }
      }
      // stage s of slice j: 0 = W1 rows j*HS.., 1, 2 = W2 rows y0 + (s-1)*NW
      // .. + NW at columns j*HS..; loaded in the consumers' order: W1 of
      // slice 0, then W1 of slice j + 1 before W2 of slice j
      for (int j = -1; j < n_slices && !Sh::kSerial; ++j) {
        for (int s = 0; s < kStages; ++s) {
          const int slice = s == 0 ? j + 1 : j;
          if (slice < 0 || slice >= n_slices) continue;
          mbar_wait(&empty[s], (slice & 1) ^ 1);
          if (s == 0) {
            mbar_arrive_expect_tx(&full[0], Sh::kW1Bytes);
            for (int q = 0; q < KD / 64; ++q)
              tma_load_2d(ring + q * kBox, &w1map, &full[0], q * 64, slice * HS);
          } else {
            mbar_arrive_expect_tx(&full[s], Sh::kW2Bytes);
            tma_load_2d(ring + Sh::kW1Bytes + (s - 1) * Sh::kW2Bytes, &w2map, &full[s],
                        slice * HS, y0 + (s - 1) * NW);
          }
        }
      }
    }
  } else {  // consumer warpgroups: y columns y0 + wg * NW .. + NW
    setmaxnreg_inc<232>();
    float yacc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) yacc[i] = 0.f;
    float hacc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) hacc[i] = 0.f;
    __nv_bfloat162 bias[4];
    load_bias(bias, b1, 0, wg);
    mbar_wait(xfull, 0);
    if constexpr (Sh::kSerial) {
      // slice by slice: W1's and W2's loads wait for the products before
      for (int j = 0; j < n_slices; ++j) {
        mbar_wait(&full[0], 0);
        fence_regs(hacc);
        wgmma_fence();
        first_product<KD>(hacc, xs, ring, wg);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(hacc);
        mbar_arrive(&empty[0]);
        store_hidden<ACT>(hacc, hs, bias, wg);
        fence_proxy_async();
        named_barrier(1, 2 * 128);
        if (j + 1 < n_slices) load_bias(bias, b1, (j + 1) * HS, wg);
        mbar_wait(&full[0], 1);
        second_product<KD>(yacc, hs, ring, wg);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(yacc);
        mbar_arrive(&empty[0]);
        named_barrier(1, 2 * 128);  // h is read by both before its next write
      }
    } else {
      mbar_wait(&full[0], 0);
      fence_regs(hacc);
      wgmma_fence();
      first_product<KD>(hacc, xs, ring, wg);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hacc);
      mbar_arrive(&empty[0]);
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
        fence_regs(hacc);
        wgmma_fence();
        first_product<KD>(hacc, xs, ring, wg);
        wgmma_commit();
        // both warpgroups wait on (and release) both W2 tiles, so every
        // stage's empty barrier counts the same arrivals per phase
        mbar_wait(&full[1], j & 1);
        mbar_wait(&full[2], j & 1);
        second_product<KD>(yacc, hs + (j & 1) * kHBytes, ring, wg);
        wgmma_commit();
        wgmma_wait<1>();  // slice j + 1's first product is done
        fence_regs(hacc);
        mbar_arrive(&empty[0]);
        store_hidden<ACT>(hacc, hs + ((j + 1) & 1) * kHBytes, bias, wg);
        fence_proxy_async();
        wgmma_wait<0>();  // slice j's second product is done
        fence_regs(yacc);
        mbar_arrive(&empty[1]);
        mbar_arrive(&empty[2]);
        named_barrier(1, 2 * 128);
      }
      const int last = n_slices - 1;
      mbar_wait(&full[1], last & 1);
      mbar_wait(&full[2], last & 1);
      second_product<KD>(yacc, hs + (last & 1) * kHBytes, ring, wg);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yacc);
    }

    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r = m0 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = y0 + wg * NW + j * 8 + (lane % 4) * 2;
      if (KD % (2 * NW) && c >= KD) continue;  // the masked columns past D
      const float bb0 = __bfloat162float(b2[c]), bb1 = __bfloat162float(b2[c + 1]);
      if (r < R)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)r * KD + c) =
            __floats2bfloat162_rn(yacc[4 * j] + bb0, yacc[4 * j + 1] + bb1);
      if (r + 8 < R)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)(r + 8) * KD + c) =
            __floats2bfloat162_rn(yacc[4 * j + 2] + bb0, yacc[4 * j + 3] + bb1);
    }
  }
}

}  // namespace tc

// ---- f32: 3xTF32 on the tensor cores ---------------------------------------

namespace f32 {

constexpr int BM = 48, kThreads = 256;
constexpr int K1 = 32, W1LD = K1 + 4;           // W1 chunk: HS rows x 32 k
constexpr int K2 = 16, W2LD = K2 + 4;           // W2 chunk: NY rows x 16 k
constexpr int RT = BM / 16;        // m16 row tiles: every warp covers all rows
static_assert(kThreads == 8 * 32, "8 warps split the columns");

// The widths of one instance: KD = D; a block owns NY of y's columns; the
// hidden is walked in slices of HS (256, or 128 where H is an odd multiple
// of 128 or D = 640).
template <int KD, int NY, int HS>
struct Shape {
  static constexpr int kChunks1 = KD / K1, kChunks2 = HS / K2;
  static constexpr int kChunks = kChunks1 + kChunks2;  // per H slice
  static constexpr int kStageFloats = HS * W1LD > NY * W2LD ? HS * W1LD : NY * W2LD;
  // every row padded to 4 mod 32 floats: the 32 lanes of a fragment load
  // (row g, column t; g = lane / 4, t = lane % 4) fall on 32 distinct banks
  static constexpr int XLD = KD + 4, HLD = HS + 4;
  static constexpr size_t kSmem = (size_t)(BM * XLD + BM * HLD + 2 * kStageFloats) * sizeof(float);
  static constexpr int NT1 = HS / 8 / 8;  // n8 tiles of the hidden slice per warp
  static constexpr int NT2 = NY / 8 / 8;  // n8 tiles of y per warp
  static_assert(kSmem <= 232448, "fits a block's shared memory");
  static_assert(NY % 64 == 0 && HS % 64 == 0, "8 warps split the columns");
};

// chunk q of the block's weight stream into a stage
template <int KD, int NY, int HS>
__device__ __forceinline__ void load_chunk(float* st, int q, const float* __restrict__ w1,
                                           const float* __restrict__ w2, int H, int y0) {
  using Sh = Shape<KD, NY, HS>;
  const int j = q / Sh::kChunks, c = q % Sh::kChunks;
  if (c < Sh::kChunks1) {  // W1 rows j * HS .. + HS, k c * K1 .. + K1
#pragma unroll
    for (int e = threadIdx.x; e < HS * K1 / 4; e += kThreads) {
      const int row = e / (K1 / 4), c4 = e % (K1 / 4);
      frag::cp_async16(st + row * W1LD + c4 * 4, w1 + (size_t)(j * HS + row) * KD + c * K1 + c4 * 4,
                 true);
    }
  } else {  // W2 rows y0 .. y0 + NY, k j * HS + (c - kChunks1) * K2 .. + K2
    const int k0 = j * HS + (c - Sh::kChunks1) * K2;
#pragma unroll
    for (int e = threadIdx.x; e < NY * K2 / 4; e += kThreads) {
      const int row = e / (K2 / 4), c4 = e % (K2 / 4);
      frag::cp_async16(st + row * W2LD + c4 * 4, w2 + (size_t)(y0 + row) * H + k0 + c4 * 4, true);
    }
  }
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
    frag::split_tf32(ar[0], ab[rt][0], as[rt][0]);
    frag::split_tf32(ar[8 * lda], ab[rt][1], as[rt][1]);
    frag::split_tf32(ar[4], ab[rt][2], as[rt][2]);
    frag::split_tf32(ar[8 * lda + 4], ab[rt][3], as[rt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t bb0, bb1, bs0, bs1;
    frag::split_tf32(b[(nt * 8 + g) * ldb + t], bb0, bs0);
    frag::split_tf32(b[(nt * 8 + g) * ldb + t + 4], bb1, bs1);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      // the tensor core's f32 accumulation truncates: it sums only this
      // k8 step's 24 products, from zero, and the running sum takes IEEE
      // adds (accumulating in the tensor core over K misses 1e-5 of scale)
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      frag::mma_tf32(d, as[rt][0], as[rt][1], as[rt][2], as[rt][3], bb0, bb1);
      frag::mma_tf32(d, ab[rt][0], ab[rt][1], ab[rt][2], ab[rt][3], bs0, bs1);
      frag::mma_tf32(d, ab[rt][0], ab[rt][1], ab[rt][2], ab[rt][3], bb0, bb1);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rt][nt][i] += d[i];
    }
  }
}

template <int ACT, int KD, int NY, int HS>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_f32_kernel(int R, int H, const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ y) {
  using Sh = Shape<KD, NY, HS>;
  constexpr int XLD = Sh::XLD, HLD = Sh::HLD, NT1 = Sh::NT1, NT2 = Sh::NT2;
  constexpr int kChunks1 = Sh::kChunks1, kStageFloats = Sh::kStageFloats;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* hs = xs + BM * XLD;
  float* ws = hs + BM * HLD;
  const int m0 = blockIdx.x * BM;
  const int y0 = KD > NY ? blockIdx.y * NY : 0;  // this block's group of y's columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  for (int e = threadIdx.x; e < BM * KD / 4; e += kThreads) {
    const int row = e / (KD / 4), c4 = e % (KD / 4), r = m0 + row;
    frag::cp_async16(xs + row * XLD + c4 * 4, x + (size_t)min(r, R - 1) * KD + c4 * 4, r < R);
  }
  const int n_chunks = H / HS * Sh::kChunks;
  load_chunk<KD, NY, HS>(ws, 0, w1, w2, H, y0);
  frag::cp_async_commit();

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
      load_chunk<KD, NY, HS>(ws + ((q + 1) & 1) * kStageFloats, q + 1, w1, w2, H, y0);
      frag::cp_async_commit();
      frag::cp_async_wait<1>();
    } else {
      frag::cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = ws + (q & 1) * kStageFloats;
    const int j = q / Sh::kChunks, c = q % Sh::kChunks;
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
          const int col = y0 + warp * NT2 * 8 + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(y + (size_t)r * KD + col) =
              make_float2(yacc[rt][nt][2 * half] + b2[col], yacc[rt][nt][2 * half + 1] + b2[col + 1]);
        }
      }
    }
}

}  // namespace f32

// ---- D > 640: x streamed beside W1 (both dtypes, mma.sync) --------------------

namespace wide {

constexpr int BM = 48, RT = BM / 16;  // a block's rows: three m16 tiles
constexpr int HS = 128;               // hidden slice
constexpr int NY = 512;               // a block's group of y columns
constexpr int KC = 32;                // k of one streamed chunk
constexpr int kThreads = 256;         // 8 warps: 16 hidden and 64 y columns each

template <typename T>
struct Shape {
  static constexpr int PAD = 16 / (int)sizeof(T);  // 16 bytes: ldmatrix rows on distinct banks
  static constexpr int LDK = KC + PAD;             // a chunk's row pitch (elements)
  static constexpr int LDH = HS + PAD;             // the hidden tile's
  static constexpr int kStage = NY * LDK > (BM + HS) * LDK ? NY * LDK : (BM + HS) * LDK;
  static constexpr int kCpr = KC * (int)sizeof(T) / 16;  // 16-byte copies per chunk row
  static constexpr size_t kSmem = (size_t)(2 * kStage + BM * LDH) * sizeof(T);
  static_assert(kSmem <= 232448, "fits a block's shared memory");
};

// Chunk q of the block's stream into a stage.  Per hidden slice j, D / KC
// chunks of the first product (x rows m0.. beside W1 rows j * HS.., k
// c * KC..; x rows past R load as zeros), then HS / KC chunks of W2 (rows
// y0.. of the group, zero past D; k j * HS + c' * KC..).
template <typename T>
__device__ __forceinline__ void load_chunk(T* st, int q, int R, int D, int H, int m0, int y0,
                                           const T* __restrict__ x, const T* __restrict__ w1,
                                           const T* __restrict__ w2) {
  using Sh = Shape<T>;
  constexpr int LDK = Sh::LDK, kCpr = Sh::kCpr, EPC = 16 / (int)sizeof(T);
  const int nc1 = D / KC, nc = nc1 + HS / KC;
  const int j = q / nc, c = q % nc;
  if (c < nc1) {
    for (int e = threadIdx.x; e < (BM + HS) * kCpr; e += kThreads) {
      const int row = e / kCpr, cc = e % kCpr;
      const T* src;
      bool valid = true;
      if (row < BM) {
        valid = m0 + row < R;
        src = x + (size_t)(valid ? m0 + row : 0) * D + c * KC + cc * EPC;
      } else {
        src = w1 + (size_t)(j * HS + row - BM) * D + c * KC + cc * EPC;
      }
      frag::cp_async16(st + row * LDK + cc * EPC, src, valid);
    }
  } else {
    const int k0 = j * HS + (c - nc1) * KC;
    for (int e = threadIdx.x; e < NY * kCpr; e += kThreads) {
      const int row = e / kCpr, cc = e % kCpr;
      const bool valid = y0 + row < D;
      frag::cp_async16(st + row * LDK + cc * EPC,
                       w2 + (size_t)(valid ? y0 + row : 0) * H + k0 + cc * EPC, valid);
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_stream_kernel(int R, int D, int H, const T* __restrict__ x, const T* __restrict__ w1,
                      const T* __restrict__ b1, const T* __restrict__ w2,
                      const T* __restrict__ b2, T* __restrict__ y) {
  using Sh = Shape<T>;
  using frag::FragA;
  using frag::FragB;
  constexpr int LDK = Sh::LDK, LDH = Sh::LDH, kStage = Sh::kStage;
  extern __shared__ float4 smem4[];
  T* stages = reinterpret_cast<T*>(smem4);
  T* hs = stages + 2 * kStage;
  const int m0 = blockIdx.x * BM, y0 = blockIdx.y * NY;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int nc1 = D / KC, nc = nc1 + HS / KC, n_chunks = H / HS * nc;

  // warp w: the slice's hidden columns w * 16 .. + 16 and the group's y
  // columns w * 64 .. + 64, every row of the block
  float hacc[RT][2][4], yacc[RT][8][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) yacc[rt][nt][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) hacc[rt][nt][e] = 0.f;
    }

  load_chunk<T>(stages, 0, R, D, H, m0, y0, x, w1, w2);
  frag::cp_async_commit();
  for (int q = 0; q < n_chunks; ++q) {
    if (q + 1 < n_chunks) {
      load_chunk<T>(stages + ((q + 1) & 1) * kStage, q + 1, R, D, H, m0, y0, x, w1, w2);
      frag::cp_async_commit();
      frag::cp_async_wait<1>();
    } else {
      frag::cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = stages + (q & 1) * kStage;
    const int j = q / nc, c = q % nc;
    if (c < nc1) {  // hidden slice += x[:, chunk] W1[slice, chunk]^T
      if (c == 0) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) hacc[rt][nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        FragB<T> b[2];
        frag::load_b2(b, st + BM * LDK, LDK, warp * 16, 16 * kk);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const FragA<T> a = frag::load_a(st, LDK, 16 * rt, 16 * kk);
          frag::mma(hacc[rt][0], a, b[0]);
          frag::mma(hacc[rt][1], a, b[1]);
        }
      }
      if (c == nc1 - 1) {  // bias + activation, rounded to T, into the hidden tile
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = 16 * rt + g + 8 * hr, col = warp * 16 + 8 * nt + 2 * t;
              const float v0 = hacc[rt][nt][2 * hr] + pafc::to_f32(b1[j * HS + col]);
              const float v1 = hacc[rt][nt][2 * hr + 1] + pafc::to_f32(b1[j * HS + col + 1]);
              if constexpr (frag::kF32<T>)
                frag::store2<T>(hs + row * LDH + col, act<ACT>(v0), act<ACT>(v1));
              else
                frag::store2<T>(hs + row * LDH + col, act_fast<ACT>(v0), act_fast<ACT>(v1));
            }
      }
    } else {  // y += h[:, chunk] W2[group, chunk]^T
      const int k0 = (c - nc1) * KC;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        FragA<T> a[RT];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) a[rt] = frag::load_a(hs, LDH, 16 * rt, k0 + 16 * kk);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          FragB<T> b[2];
          frag::load_b2(b, st, LDK, warp * 64 + 16 * p, 16 * kk);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            frag::mma(yacc[rt][2 * p], a[rt], b[0]);
            frag::mma(yacc[rt][2 * p + 1], a[rt], b[1]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + 16 * rt + g + 8 * hr;
      if (row >= R) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = y0 + warp * 64 + 8 * nt + 2 * t;
        if (col >= D) continue;
        frag::store2<T>(y + (size_t)row * D + col,
                        yacc[rt][nt][2 * hr] + pafc::to_f32(b2[col]),
                        yacc[rt][nt][2 * hr + 1] + pafc::to_f32(b2[col + 1]));
      }
    }
}

}  // namespace wide

template <typename T, int ACT>
int launch_stream(int R, int D, int H, const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* y, cudaStream_t stream) {
  auto kern = wide::ffn_stream_kernel<T, ACT>;
  constexpr size_t smem = wide::Shape<T>::kSmem;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  const dim3 grid((R + wide::BM - 1) / wide::BM, (D + wide::NY - 1) / wide::NY);
  kern<<<grid, wide::kThreads, smem, stream>>>(R, D, H, (const T*)x, (const T*)w1,
                                                 (const T*)b1, (const T*)w2, (const T*)b2,
                                                 (T*)y);
  return (int)cudaGetLastError();
}

template <int ACT, int KD>
int launch_tc(int R, int H, const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, void* y, cudaStream_t stream) {
  CUtensorMap xmap, w1map, w2map;
  int err = make_map_2d(&xmap, x, R, KD, KD, tc::BM, 64);
  if (!err) err = make_map_2d(&w1map, w1, H, KD, KD, tc::HS, 64);
  if (!err) err = make_map_2d(&w2map, w2, KD, H, H, tc::NW, 64);
  if (err) return err;
  auto kern = tc::ffn_tc_kernel<ACT, KD>;
  constexpr size_t smem = tc::Shape<KD>::kSmem;
  err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid((R + tc::BM - 1) / tc::BM, tc::Shape<KD>::kGroups);
  kern<<<grid, tc::kThreads, smem, stream>>>(xmap, w1map, w2map, R, H, (const __nv_bfloat16*)b1,
                                            (const __nv_bfloat16*)b2, (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}

template <int ACT, int KD, int NY, int HS>
int launch_f32(int R, int H, const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* y, cudaStream_t stream) {
  auto kern = f32::ffn_f32_kernel<ACT, KD, NY, HS>;
  constexpr size_t smem = f32::Shape<KD, NY, HS>::kSmem;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err) return err;
  const dim3 grid((R + f32::BM - 1) / f32::BM, KD / NY);
  kern<<<grid, f32::kThreads, smem, stream>>>(R, H, (const float*)x, (const float*)w1,
                                              (const float*)b1, (const float*)w2,
                                              (const float*)b2, (float*)y);
  return (int)cudaGetLastError();
}

// The instance for D.  bf16: blocks of 512 y columns (masked past D; two
// groups at D = 640, each recomputing the whole hidden for its rows).
// f32: D <= 512, one block owns all of y's columns and walks H in 256-wide
// slices, or 128-wide where H is an odd multiple of 128; D = 640, y's
// columns in two groups of 320 and 128-wide slices, or x's band and the
// weight stages would not fit the shared memory.
template <int ACT, int KD>
int launch_d(int dtype, int R, int H, const void* x, const void* w1, const void* b1,
             const void* w2, const void* b2, void* y, cudaStream_t st) {
  if (dtype == 1) return launch_tc<ACT, KD>(R, H, x, w1, b1, w2, b2, y, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if constexpr (KD > 512) {
    return launch_f32<ACT, KD, KD / 2, 128>(R, H, x, w1, b1, w2, b2, y, st);
  } else {
    if (H % 256) return launch_f32<ACT, KD, KD, 128>(R, H, x, w1, b1, w2, b2, y, st);
    return launch_f32<ACT, KD, KD, 256>(R, H, x, w1, b1, w2, b2, y, st);
  }
}

template <int ACT>
int launch(int dtype, int R, int D, int H, const void* x, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, cudaStream_t st) {
  switch (D) {
    case 128: return launch_d<ACT, 128>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 256: return launch_d<ACT, 256>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 384: return launch_d<ACT, 384>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 512: return launch_d<ACT, 512>(dtype, R, H, x, w1, b1, w2, b2, y, st);
    case 640: return launch_d<ACT, 640>(dtype, R, H, x, w1, b1, w2, b2, y, st);
  }
  // past 640: the streaming form, D a runtime argument
  if (dtype == 0) return launch_stream<float, ACT>(R, D, H, x, w1, b1, w2, b2, y, st);
  if (dtype == 1) return launch_stream<__nv_bfloat16, ACT>(R, D, H, x, w1, b1, w2, b2, y, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for x (R, D), W1 (H, D), b1 (H),
// W2 (D, H), b2 (D) and y (R, D), all contiguous and 16-byte aligned; act:
// 0 swish, 1 relu, 2 gelu (tanh form), 3 hardtanh.  Returns
// cudaErrorInvalidValue unless D and H are positive multiples of 128.
extern "C" int pafc_ffn(int dtype, int act, int R, int D, int H, const void* x, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, void* stream) {
  if (R < 1 || D < kStep || D % kStep || H < kStep || H % kStep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (act) {
    case 0: return launch<0>(dtype, R, D, H, x, w1, b1, w2, b2, y, st);
    case 1: return launch<1>(dtype, R, D, H, x, w1, b1, w2, b2, y, st);
    case 2: return launch<2>(dtype, R, D, H, x, w1, b1, w2, b2, y, st);
    case 3: return launch<3>(dtype, R, D, H, x, w1, b1, w2, b2, y, st);
  }
  return (int)cudaErrorInvalidValue;
}
