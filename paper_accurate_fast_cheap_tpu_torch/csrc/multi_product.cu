// K7: the multi-buffer product, y = sum_b x @ W_b over `nbuf` weight buffers,
// accumulated in f32 and rounded to bf16 once at the end.
//
// Replaces: the JAX package's tools/repro_tpu_worker_crash.py, `pinned_call`
// (its Pallas body `kernel`): x (R, D) in 256-row tiles, every W_b (D, H)
// pinned whole in VMEM, `acc += dot(x, W_b)` in f32 per buffer, one bf16
// cast.  The VMEM pinning (`with_memory_space_constraint`,
// `vmem_limit_bytes`) is a TPU workaround and is not carried over: the
// weights stream through L2, which holds the tool's 10 MB whole.  As the
// TPU grid (R // 256 steps) does, the kernel covers R in whole 256-row
// tiles; the C entry refuses an R that is not a multiple of 256.
//
// Bound on the H100 at the tool's defaults (R 4096, D 512, 2 buffers of
// H 5120, bf16): 2 R D H nbuf = 42.9 GFLOP against 57 MB of x, W and y, so
// the bf16 tensor-core rate bounds it (0.0434 ms; the bytes take 0.0169 ms).
//
// Design (Hopper, sm90.cuh): a persistent block per SM walks 128 x 256
// tiles of y; for each it runs one long K loop over (buffer, 64-wide k
// tile), so the sum over buffers stays in the f32 wgmma accumulators and y
// is written once.  One producer thread issues TMA loads into a 4-stage
// ring of x tiles (128 x 64, K-major) and W tiles (64 k rows x 256 columns
// as four 64-column boxes; W_b is (D, H) with H contiguous, so B is
// MN-major and wgmma reads it through its transpose bit: nothing is copied
// or stacked), with full/empty mbarriers, and runs on into the next tile
// while the consumers store this one; one tensor map per buffer (at most
// kMaxBuffers) travels as a __grid_constant__ kernel parameter.  Two
// consumer warpgroups each run m64n256k16 on their 64 rows, one group kept
// in flight so a stage is released while the next one multiplies.  TMA
// zero-fills a ragged H edge (and a D that is not a multiple of 64); the
// store masks the columns.  What bounds it, most likely: at the defaults
// each tile streams 768 KB (16 stages of 48 KB; x is read once per buffer)
// from L2 for 67 MFLOP of products, and both consumer warpgroups store
// the tile's y at once while the producer can run only four stages ahead.
// Per block: 384 threads (setmaxnreg: 232 registers for the consumers, 40
// for the producer), 197,696 bytes of dynamic shared memory (the ring, 1
// KB of alignment slack and the barriers); ptxas (CUDA 12.9): 168
// registers, no spills.
//
// Limits (the C entry returns cudaErrorInvalidValue otherwise, and
// ops/multi_product.py raises first): R a multiple of 256, 1 <= nbuf <= 8,
// D and H multiples of 8 (TMA's 16-byte row strides), every pointer
// 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace pafc::sm90;

constexpr int kMaxBuffers = 8;
constexpr int kRowTile = 256;  // the TPU kernel's row block
constexpr int BM = 128, BN = 256, BK = 64, kStages = 4;
constexpr int kConsumers = 2;  // warpgroups, 64 rows each
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kATile = BM * BK * 2;         // 16 KB of x
constexpr int kBBox = BK * 64 * 2;          // 8 KB: 64 k rows x 64 columns
constexpr int kBTile = kBBox * (BN / 64);   // 32 KB of W
constexpr int kStageBytes = kATile + kBTile;
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 1024 + 2 * kStages * sizeof(uint64_t);
static_assert(kRowTile % BM == 0, "row tiles split into whole blocks");

struct WeightMaps {
  CUtensorMap m[kMaxBuffers];
};

// Persistent: block b walks output tiles b, b + gridDim.x, ...; tile t is
// row tile t % m_tiles of column band t / m_tiles.  The producer runs
// straight on into the next tile's loads while the consumers store this
// tile, so one tile's epilogue overlaps the next one's first loads.
__global__ void __launch_bounds__(kThreads, 1)
    multi_product_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ WeightMaps wmaps, int R, int D, int H,
                         int nbuf, __nv_bfloat16* __restrict__ y) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int k_tiles = (D + BK - 1) / BK;
  const int n_iter = nbuf * k_tiles;  // ring stages per output tile
  const int m_tiles = R / BM, tiles = m_tiles * ((H + BN - 1) / BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup: one thread issues the TMA
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int it = 0;  // stages filled so far, across tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
        for (int i = 0; i < n_iter; ++i, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* a = smem + s * kStageBytes;
          uint8_t* b = a + kATile;
          const int buf = i / k_tiles, k0 = (i % k_tiles) * BK;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_2d(a, &xmap, &full[s], k0, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b + j * kBBox, &wmaps.m[buf], &full[s], n0 + 64 * j, k0);
        }
      }
    }
  } else {  // consumer warpgroups: rows m0 + wg * 64 .. + 64 of each tile
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;  // stages consumed so far, across tiles
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
      for (int i = 0; i < n_iter; ++i, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a = smem_u32(smem + s * kStageBytes + wg * (64 * BK * 2));
        const uint32_t b = smem_u32(smem + s * kStageBytes + kATile);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n256k16<1>(acc, desc_kmajor(a + kk * 32),
                              desc_sw128(b + kk * 16 * 128, kBBox, 1024), i > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (i > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % kStages]);

      const long long r = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + j * 8 + (lane % 4) * 2;
        if (c < H) {
          *reinterpret_cast<__nv_bfloat162*>(y + r * H + c) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(y + (r + 8) * H + c) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

}  // namespace

// x (R, D), ws[0..nbuf) each (D, H) and y (R, H), all bf16, contiguous and
// 16-byte aligned; ws is a host array of nbuf device pointers.  Returns
// cudaErrorInvalidValue for a shape outside the limits above.
extern "C" int pafc_multi_product(int R, int D, int H, int nbuf, const void* x,
                                  const void* const* ws, void* y, void* stream) {
  if (R < 1 || D < 1 || H < 1 || R % kRowTile || D % 8 || H % 8 || nbuf < 1 ||
      nbuf > kMaxBuffers)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  WeightMaps wmaps;
  int err = make_map_2d(&xmap, x, R, D, D, BM, BK);
  for (int b = 0; b < nbuf && !err; ++b) err = make_map_2d(&wmaps.m[b], ws[b], D, H, H, BK, 64);
  for (int b = nbuf; b < kMaxBuffers; ++b) wmaps.m[b] = wmaps.m[0];
  if (err) return err;
  err = (int)cudaFuncSetAttribute(multi_product_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err) return err;
  static int sms = 0;  // one persistent block per SM
  if (sms == 0) {
    int dev = 0;
    err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
  }
  const int tiles = (R / BM) * ((H + BN - 1) / BN);
  multi_product_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, (cudaStream_t)stream>>>(
      xmap, wmaps, R, D, H, nbuf, (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}
