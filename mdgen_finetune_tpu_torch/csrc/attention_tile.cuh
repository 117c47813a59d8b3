// attention_tile.cuh: the mma.sync and packing helpers and constants that
// the attention kernels share (the m16n8k16 bf16 product, bf16 pair
// packing, the masked logit, log2 constants) and the head-dim padding of
// the rope_attention bodies (Dims).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_tile {

typedef __nv_bfloat16 bf16;

constexpr float MASKED = -1e9f;  // a masked key's logit (the JAX package's _NEG_INF)
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Dims {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int RS = DP + 8;              // row stride (bf16) of a row-major tile
  static constexpr int KC = DP / 16;             // 16-deep chunks of a product over D
  static constexpr int DB = DP / 8;              // 8-lane blocks of a (16, D) product
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace attn_tile
