// rope_tile.cuh: the pieces that the long-sequence bodies of rope_attention
// (rope_attention.cuh) and rope_attention_bwd (rope_attention_bwd.cuh) share:
// ldmatrix fragment loads, the fp16 mma.sync, and the staging of one head
// row (16-byte global reads, RoPE, fp16 scaled by a power of two or bf16,
// zero pad lanes). blocked_attention_bwd.cuh takes its fp16 mma, packing
// and scale rule from here too.
//
// Staged rows are row-major [row][d] with a row stride of RS = DP + 8
// elements (attention_tile.cuh's Dims): 8 consecutive rows start 16 bytes
// apart modulo 128, so an ldmatrix phase (8 rows of 16 bytes) reads 32
// distinct banks. The head dim D pads to DP (24 -> 32) with zero lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace rope_tile {

typedef __nv_bfloat16 bf16;
typedef __half f16;
using attn_tile::Dims;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: four (x4) or two (x2) 8 x 8 b16 matrices; lane l gives the row
// address l of them (matrix l / 8). Thread t receives element (t / 4,
// 2 (t % 4) .. + 1) of matrix i in r[i], or with .trans (2 (t % 4) .. + 1,
// t / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), fp16 in, f32 accumulators
__device__ __forceinline__ void mma16816_f16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_h2(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// the A fragments (16 rows from row0, KC chunks of 16 lanes) of a staged tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const void* tile, int row0) {
  constexpr int RS = Dims<D>::RS;
  const int lane = threadIdx.x & 31;
  const uint16_t* p = static_cast<const uint16_t*>(tile) + (row0 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < Dims<D>::KC; ++kc) ldsm_x4(a[kc], p + kc * 16);
}

// the B fragments of a product over d: rows r0 .. r0 + 7 of a staged tile
// are the 8 columns; b[kc] = {b0, b1} of 16-deep chunk kc
template <int D>
__device__ __forceinline__ void load_b_d(uint32_t (*b)[2], const void* tile, int r0) {
  constexpr int RS = Dims<D>::RS, KC = Dims<D>::KC;
  const int lane = threadIdx.x & 31;
  const uint16_t* p = static_cast<const uint16_t*>(tile) + (r0 + (lane & 7)) * RS + (lane >> 3) * 8;
#pragma unroll
  for (int kc = 0; kc + 1 < KC; kc += 2) {
    uint32_t r[4];
    ldsm_x4(r, p + kc * 16);
    b[kc][0] = r[0];
    b[kc][1] = r[1];
    b[kc + 1][0] = r[2];
    b[kc + 1][1] = r[3];
  }
  if constexpr (KC % 2) {
    uint32_t r[2];
    ldsm_x2(r, static_cast<const uint16_t*>(tile) + (r0 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8 +
                   (KC - 1) * 16);
    b[KC - 1][0] = r[0];
    b[KC - 1][1] = r[1];
  }
}

// the B fragments of a product over rows: rows r0 .. r0 + 15 of a staged
// tile are the 16-deep chunk, its D lanes the columns; b[db] = {b0, b1} of
// 8-lane block db (D / 8 blocks)
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (*b)[2], const void* tile, int r0) {
  constexpr int RS = Dims<D>::RS, OB = D / 8;
  const int lane = threadIdx.x & 31;
  const uint16_t* p = static_cast<const uint16_t*>(tile) + (r0 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int db = 0; db + 1 < OB; db += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, p + db * 8);
    b[db][0] = r[0];
    b[db][1] = r[1];
    b[db + 1][0] = r[2];
    b[db + 1][1] = r[3];
  }
  if constexpr (OB % 2) {
    uint32_t r[2];
    ldsm_x2_t(r, static_cast<const uint16_t*>(tile) + (r0 + (lane & 15)) * RS + (OB - 1) * 8);
    b[OB - 1][0] = r[0];
    b[OB - 1][1] = r[1];
  }
}

// the D lanes of one bf16 head row (16-byte aligned) as f32
template <int D>
__device__ __forceinline__ void load_row(float* x, const bf16* src) {
#pragma unroll
  for (int v = 0; v < D / 8; ++v) {
    const uint4 u = reinterpret_cast<const uint4*>(src)[v];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf2(w[e]);
      x[8 * v + 2 * e] = f.x;
      x[8 * v + 2 * e + 1] = f.y;
    }
  }
}

// the same from a row that may not be 16-byte aligned (the bias key / value)
template <int D>
__device__ __forceinline__ void load_row_scalar(float* x, const bf16* src) {
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = __bfloat162float(src[d]);
}

// RoPE (rotate-half) at a table row: the tables' two halves are equal, so
// the first D / 2 entries of cos and sin serve both
template <int D>
__device__ __forceinline__ void rope(float* x, const float* cs, const float* sn) {
  constexpr int HALF = D / 2;
  float c[HALF], s[HALF];
#pragma unroll
  for (int d = 0; d < HALF; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(cs + d);
    const float4 b = *reinterpret_cast<const float4*>(sn + d);
    c[d] = a.x; c[d + 1] = a.y; c[d + 2] = a.z; c[d + 3] = a.w;
    s[d] = b.x; s[d + 1] = b.y; s[d + 2] = b.z; s[d + 3] = b.w;
  }
#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    const float v0 = x[d], v1 = x[d + HALF];
    x[d] = v0 * c[d] - v1 * s[d];
    x[d + HALF] = v1 * c[d] + v0 * s[d];
  }
}

// its transpose: g * cos + rot^T(g * sin), rot^T(a, b) = (b, -a)
template <int D>
__device__ __forceinline__ void rope_t(float* g, const float* cs, const float* sn) {
  constexpr int HALF = D / 2;
#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    const float g0 = g[d], g1 = g[d + HALF];
    g[d] = g0 * cs[d] + g1 * sn[d];
    g[d + HALF] = g1 * cs[d] - g0 * sn[d];
  }
}

template <int D>
__device__ __forceinline__ float row_max(const float* x) {
  float m = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) m = fmaxf(m, fabsf(x[d]));
  return m;
}

// one staged row of DP lanes (16-byte aligned): x times `mul` (a power of
// two) in fp16 (F16) or x in bf16, zeros in the pad lanes
template <int D, bool F16>
__device__ __forceinline__ void store_row(void* dst, const float* x, float mul = 1.f) {
  constexpr int DP = Dims<D>::DP;
#pragma unroll
  for (int v = 0; v < DP / 8; ++v) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (8 * v < D) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = x[8 * v + 2 * e], hi = x[8 * v + 2 * e + 1];
        w[e] = F16 ? pack_h2(lo * mul, hi * mul) : attn_tile::pack2(lo, hi);
      }
    }
    static_cast<uint4*>(dst)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// D lanes of f32 as bf16 16-byte vectors into a global row (16-byte aligned)
template <int D>
__device__ __forceinline__ void store_global(bf16* dst, const float* x) {
#pragma unroll
  for (int v = 0; v < D / 8; ++v)
    reinterpret_cast<uint4*>(dst)[v] =
        make_uint4(attn_tile::pack2(x[8 * v], x[8 * v + 1]), attn_tile::pack2(x[8 * v + 2], x[8 * v + 3]),
                   attn_tile::pack2(x[8 * v + 4], x[8 * v + 5]), attn_tile::pack2(x[8 * v + 6], x[8 * v + 7]));
}

// the scale exponent s of fp16-staged values whose largest magnitude is m:
// 0 inside [2^-6, 2^15) (and for m = 0), else the s with m * 2^s in
// [2^14, 2^15) (blocked_attention_bwd.cuh uses it too)
__device__ __forceinline__ int scale_exponent(float m) {
  int e = 0;
  if (m > 0.f) frexpf(m, &e);  // m in [2^(e-1), 2^e)
  return (m > 0.f && (e > 15 || e < -5)) ? 15 - e : 0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the largest of the 4 warps' values at red[0..3] (after a barrier)
__device__ __forceinline__ float max4(const float* red) {
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

}  // namespace rope_tile
