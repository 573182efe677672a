// Hopper (sm_90a) building blocks shared by K2 (joint_topk.cu), K3
// (lstm_step.cu), K6 (ffn.cu) and K7 (multi_product.cu): mbarriers, TMA 2-D
// tile loads into 128-byte-swizzled shared memory, wgmma shared-memory
// descriptors (K-major, and MN-major B through the instruction's transpose
// bit), the bf16 -> f32 m64nNk16 wgmma forms the kernels issue, and the
// one-warpgroup ring product K2 and K3 share.  Inline PTX only, so a source
// builds in seconds.
//
// Tensor maps come from the driver's cuTensorMapEncodeTiled.  The nvcc line
// of ops/cuda_lib.py links no libcuda, so make_map_2d looks the entry up
// once with dlopen("libcuda.so.1") / dlsym, which every machine with the
// driver has (cudaGetDriverEntryPoint changed its signature across CUDA
// releases).  A map travels to the kernel by value as a
// __grid_constant__ const CUtensorMap parameter.  TMA needs a 16-byte-
// aligned base and row stride: bf16 rows a multiple of 8 elements, f32 of 4.
//
// Layouts.  A TMA box of R rows x 64 bf16 (128 bytes) lands as R rows of
// 128 bytes, the 16-byte chunks of row r XORed with r % 8 (SWIZZLE_128B);
// eight rows make one 1024-byte swizzle atom, so every tile starts on a
// 1024-byte boundary.  K-major operand (rows = M or N, K contiguous):
// SBO = 1024 bytes (the next 8 rows), LBO unused; the k16 step inside the
// 64-wide row moves the start address by 32 bytes.  MN-major B (rows = K,
// N contiguous, boxes of 64 columns stored one after another): LBO = the
// byte distance between two 64-column boxes, SBO = 1024 bytes (the next 8
// k rows); the k16 step moves the start by 16 rows = 2048 bytes.
//
// Accumulator layout of m64nN (f32): thread t of the warpgroup, warp w =
// t / 32, lane l = t % 32, holds d[i] at row w * 16 + l / 4 + 8 * ((i / 2) % 2)
// and column (i / 4) * 8 + (l % 4) * 2 + i % 2.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <mutex>

namespace pafc {
namespace sm90 {

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? (EncodeTiledFn)dlsym(lib, "cuTensorMapEncodeTiled") : (EncodeTiledFn) nullptr;
  }();
  return fn;
}

// A map over a row-major bf16 (rows, cols) matrix with `ld` elements between
// rows, read in boxes of box_rows x box_cols (box_cols * 2 <= 128 bytes),
// 128-byte swizzled; elements past the matrix's edge load as zeros.
// Returns 0, or cudaErrorInvalidValue when the driver refuses the map.
// A map depends on nothing but these arguments, so the last 64 are kept and
// served again: a caller that passes the same weights every call (the
// decode's per-frame kernels) pays the encode once.
inline int make_map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                       uint64_t ld, uint32_t box_rows, uint32_t box_cols) {
  struct Entry {
    const void* base;
    uint64_t rows, cols, ld;
    uint32_t box_rows, box_cols;
    CUtensorMap map;
  };
  constexpr int kKept = 64;
  static std::mutex mu;
  static Entry kept[kKept];
  static int n_kept = 0, next = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_kept; ++i) {
      const Entry& e = kept[i];
      if (e.base == base && e.rows == rows && e.cols == cols && e.ld == ld &&
          e.box_rows == box_rows && e.box_cols == box_cols) {
        *map = e.map;
        return 0;
      }
    }
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectInitFailed;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  kept[next] = Entry{base, rows, cols, ld, box_rows, box_cols, *map};
  next = (next + 1) % kKept;
  if (n_kept < kKept) ++n_kept;
  return 0;
}

// ---- device: shared memory, barriers, TMA ---------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p in shared memory
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call after the inits, before the block-wide barrier
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so parity 1 passes at once).  A wait that outlasts ~2^34
// clocks (seconds) traps: a pipeline fault fails the launch loudly instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long t0 = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > (1ll << 34)) __trap();
  }
}

// TMA: the box at element coordinates (c0 = column, c1 = row) of `map`
// into shared memory at dst, completing `bytes` on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma operands); then a barrier between the threads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- device: wgmma --------------------------------------------------------

// A shared-memory address the compiler treats as new at this point: a
// loop that builds its wgmma descriptors from it cannot have them hoisted
// out and held in registers (64 descriptors are 128 registers).
__device__ __forceinline__ uint32_t opaque_smem(const void* p) {
  uint32_t a = smem_u32(p);
  asm volatile("" : "+r"(a));
  return a;
}

// descriptor of a 128-byte-swizzled operand tile at shared address `addr`
// (see the note above)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // layout type 1: 128-byte swizzle
  return d;
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Ties accumulator registers to this point of the program, so the compiler
// neither reads them before a wgmma_wait nor moves writes past an issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 32, f32, 16 registers a thread) += A (64 x 16) B (16 x 32),
// A and B bf16 in shared memory; TB = 1 reads B MN-major (the transpose bit).
template <int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 64, f32, 32 registers a thread) += A (64 x 16) B (16 x 64),
// A and B bf16 in shared memory; TB = 1 reads B MN-major (the transpose bit).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 128, f32, 64 registers a thread) += A (64 x 16) B (16 x 128),
// A and B bf16 in shared memory; TB = 1 reads B MN-major (the transpose bit).
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 256, f32, 128 registers a thread) += A (64 x 16) B (16 x 256),
// A and B bf16 in shared memory; TB = 1 reads B MN-major (the transpose bit).
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// The K-major m64nNk16 form for a width N fixed at compile time.
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                          int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "a width with a wgmma form above");
  if constexpr (N == 32) wgmma_m64n32k16<0>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16<0>(d, da, db, scale_d);
  else if constexpr (N == 128) wgmma_m64n128k16<0>(d, da, db, scale_d);
  else wgmma_m64n256k16<0>(d, da, db, scale_d);
}

// The ring of ring_product in dynamic shared memory: S stages of
// stage_bytes from smem's first 1024-byte boundary, then their S full
// barriers (returned in full), initialised by thread 0 and published to the
// block.  Takes ring_smem_bytes(S, stage_bytes) of dynamic shared memory.
constexpr size_t ring_smem_bytes(int S, int stage_bytes) {
  return (size_t)S * stage_bytes + 1024 + S * sizeof(uint64_t);
}

__device__ __forceinline__ uint8_t* ring_init(uint8_t* smem, int S, int stage_bytes,
                                              uint64_t*& full) {
  uint8_t* ring = align_1024(smem);
  full = reinterpret_cast<uint64_t*>(ring + S * stage_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  return ring;
}

// One warpgroup's C (64 x N) += A B^T over n_chunks chunks of 64 k, through
// a ring of S shared-memory stages.  A stage holds A's 64 rows and B's N
// rows of one chunk, K-major and 128-byte swizzled (64 x 128 bytes, then
// N x 128 bytes; the ring starts on a 1024-byte boundary).  Thread 0 of the
// warpgroup is its own producer: load(chunk, stage, bar) announces the
// stage's bytes on bar and issues the TMA copies, S chunks ahead.  The
// warpgroup waits for a chunk's wgmmas and meets at the named barrier
// bar_id before the stage is refilled, so no producer warp and no empty
// barriers are needed; the cost is one wgmma latency per chunk, hidden by
// the other blocks on the SM.  full holds S barriers initialised to 1.
template <int N, int S, class Load>
__device__ __forceinline__ void ring_product(float (&acc)[N / 2], uint8_t* ring, uint64_t* full,
                                             int n_chunks, int bar_id, const Load& load) {
  constexpr int kA = 64 * 128, kStage = kA + N * 128;
  static_assert(kStage % 1024 == 0, "stages on swizzle-atom boundaries");
  const bool leader = threadIdx.x % 128 == 0;
  if (leader)
    for (int c = 0; c < S && c < n_chunks; ++c) load(c, ring + c * kStage, &full[c]);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S;
    mbar_wait(&full[s], (c / S) & 1);
    const uint32_t a = opaque_smem(ring + s * kStage), b = a + kA;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_k16<N>(acc, desc_kmajor(a + kk * 32), desc_kmajor(b + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    named_barrier(bar_id, 128);
    if (leader && c + S < n_chunks) load(c + S, ring + s * kStage, &full[s]);
  }
}

}  // namespace sm90
}  // namespace pafc
