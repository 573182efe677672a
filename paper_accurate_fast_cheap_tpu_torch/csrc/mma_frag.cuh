// Warp-level tensor-core products (mma.sync) over shared-memory tiles, one
// fragment layout for both dtypes, shared by K1 (wkv6_fwd.cu) and K6's
// streaming form (ffn.cu, D > 640).  Inline PTX only.
//
// A logical k16 step.  A (16 x 16): lane (g = lane / 4, t = lane % 4) holds,
// in this order, A[g][2t], A[g][2t+1], A[g+8][2t], A[g+8][2t+1], A[g][2t+8],
// A[g][2t+9], A[g+8][2t+8], A[g+8][2t+9].  B (16 x 8): B[2t][g], B[2t+1][g],
// B[2t+8][g], B[2t+9][g].  C (16 x 8, f32): C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1].  bf16 packs each consecutive pair into one
// register (the lower index in the low half): the m16n8k16 operands,
// loaded with ldmatrix (.trans for a tile stored the other way round).
// f32 keeps the values and takes the step as 3xTF32 on two m16n8k8 halves:
// each operand split into two TF32 values (big + small; the dropped
// small x small term is ~2^-22 of the product), lane t's k = 2t, 2t + 1
// (and + 8) fed as the m16n8k8 columns t, t + 4, an order a sum does not
// see.  The tensor core's f32 accumulation truncates, so each k8 half is
// summed from zero and added to the running sum in IEEE f32 (K6's f32
// kernel does the same): plain TF32, or accumulating in the tensor core
// over K, misses a 1e-5 check of an f32 product.
//
// An accumulator tile is itself a B fragment of the transposed product:
// for C = X^T (rows n, columns k), C's n8 tiles 2q and 2q + 1 give
// B[k = 16q + .][n = g (+ 8)] through make_b (K1's state), and two n8 tiles
// of C give an A fragment through make_a (K1's intra block).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pafc {
namespace frag {

struct A16 { uint32_t x[4]; };
struct B16 { uint32_t x[2]; };
struct A32 { float x[8]; };
struct B32 { float x[4]; };

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
template <typename T>
using FragA = std::conditional_t<kF32<T>, A32, A16>;
template <typename T>
using FragB = std::conditional_t<kF32<T>, B32, B16>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of eight f32 values in the layout's order
template <typename T>
__device__ __forceinline__ FragA<T> make_a(const float (&v)[8]) {
  FragA<T> f;
  if constexpr (kF32<T>) {
#pragma unroll
    for (int e = 0; e < 8; ++e) f.x[e] = v[e];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f.x[e] = pack_bf16(v[2 * e], v[2 * e + 1]);
  }
  return f;
}

// the B fragment B[2t][g], B[2t+1][g], B[2t+8][g], B[2t+9][g]
template <typename T>
__device__ __forceinline__ FragB<T> make_b(float a, float b, float c, float d) {
  FragB<T> f;
  if constexpr (kF32<T>) {
    f.x[0] = a, f.x[1] = b, f.x[2] = c, f.x[3] = d;
  } else {
    f.x[0] = pack_bf16(a, b), f.x[1] = pack_bf16(c, d);
  }
  return f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Tiles are row-major with a pitch of `ld` elements; a bf16 row pitch that
// is 16 bytes past a multiple of 128 puts ldmatrix's eight rows on distinct
// banks.

// A[m][k] = tile[(r0 + m) * ld + c0 + k]
template <typename T>
__device__ __forceinline__ FragA<T> load_a(const T* tile, int ld, int r0, int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  FragA<T> f;
  if constexpr (kF32<T>) {
    const float* p = tile + (r0 + g) * ld + c0 + 2 * t;
    f.x[0] = p[0], f.x[1] = p[1], f.x[2] = p[8 * ld], f.x[3] = p[8 * ld + 1];
    f.x[4] = p[8], f.x[5] = p[9], f.x[6] = p[8 * ld + 8], f.x[7] = p[8 * ld + 9];
  } else {
    ldsm_x4(f.x, tile + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8);
  }
  return f;
}

// A[m][k] = tile[(k0 + k) * ld + m0 + m]
template <typename T>
__device__ __forceinline__ FragA<T> load_a_trans(const T* tile, int ld, int k0, int m0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  FragA<T> f;
  if constexpr (kF32<T>) {
    const float* p = tile + (k0 + 2 * t) * ld + m0 + g;
    f.x[0] = p[0], f.x[1] = p[ld], f.x[2] = p[8], f.x[3] = p[ld + 8];
    f.x[4] = p[8 * ld], f.x[5] = p[9 * ld], f.x[6] = p[8 * ld + 8], f.x[7] = p[9 * ld + 8];
  } else {
    const int q = lane / 8, r = lane % 8;
    ldsm_x4_t(f.x, tile + (k0 + r + 8 * (q / 2)) * ld + m0 + 8 * (q % 2));
  }
  return f;
}

// two n8 tiles, h = 0, 1: B_h[k][n] = tile[(n0 + 8 h + n) * ld + k0 + k]
template <typename T>
__device__ __forceinline__ void load_b2(FragB<T> (&b)[2], const T* tile, int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (kF32<T>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = tile + (n0 + 8 * h + g) * ld + k0 + 2 * t;
      b[h].x[0] = p[0], b[h].x[1] = p[1], b[h].x[2] = p[8], b[h].x[3] = p[9];
    }
  } else {
    const int q = lane / 8, r = lane % 8;
    uint32_t x[4];
    ldsm_x4(x, tile + (n0 + r + 8 * (q / 2)) * ld + k0 + 8 * (q % 2));
    b[0].x[0] = x[0], b[0].x[1] = x[1], b[1].x[0] = x[2], b[1].x[1] = x[3];
  }
}

// two n8 tiles, h = 0, 1: B_h[k][n] = tile[(k0 + k) * ld + n0 + 8 h + n]
template <typename T>
__device__ __forceinline__ void load_b2_trans(FragB<T> (&b)[2], const T* tile, int ld, int k0,
                                              int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (kF32<T>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = tile + (k0 + 2 * t) * ld + n0 + 8 * h + g;
      b[h].x[0] = p[0], b[h].x[1] = p[ld], b[h].x[2] = p[8 * ld], b[h].x[3] = p[9 * ld];
    }
  } else {
    const int q = lane / 8, r = lane % 8;
    uint32_t x[4];
    ldsm_x4_t(x, tile + (k0 + r + 8 * (q % 2)) * ld + n0 + 8 * (q / 2));
    b[0].x[0] = x[0], b[0].x[1] = x[1], b[1].x[0] = x[2], b[1].x[1] = x[3];
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// v = big + small, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// acc += A B over one k16 step: bf16 accumulates in the tensor core
__device__ __forceinline__ void mma(float (&acc)[4], const A16& a, const B16& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
}

// f32: 3xTF32, each k8 half from zero, then IEEE adds
__device__ __forceinline__ void mma(float (&acc)[4], const A32& a, const B32& b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t ab[4], as[4], bb[2], bs[2];
    split_tf32(a.x[4 * h + 0], ab[0], as[0]);  // A[g][k]:         m16n8k8 a0
    split_tf32(a.x[4 * h + 2], ab[1], as[1]);  // A[g + 8][k]:     a1
    split_tf32(a.x[4 * h + 1], ab[2], as[2]);  // A[g][k + 1]:     a2
    split_tf32(a.x[4 * h + 3], ab[3], as[3]);  // A[g + 8][k + 1]: a3
    split_tf32(b.x[2 * h + 0], bb[0], bs[0]);
    split_tf32(b.x[2 * h + 1], bb[1], bs[1]);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(d, as[0], as[1], as[2], as[3], bb[0], bb[1]);
    mma_tf32(d, ab[0], ab[1], ab[2], ab[3], bs[0], bs[1]);
    mma_tf32(d, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[e];
  }
}

// two adjacent f32 values into a T tile
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (kF32<T>) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes global -> shared, zeros when !valid (src must still be mapped)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace frag
}  // namespace pafc
