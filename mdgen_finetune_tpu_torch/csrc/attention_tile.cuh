// attention_tile.cuh: the tile pieces of fused_attention.cu (the long-key
// forward); the other kernels take its mma.sync and packing helpers and
// constants.
//
// A block of 4 warps owns a tile of 64 query rows; each warp keeps its 16
// rows as mma.sync m16n8k16 A fragments in registers. The other operand streams through shared memory in tiles of 64
// rows, row-major [row][d] for products over the head dim and transposed
// [d][row] for products over the rows. The head dim D is padded with zero
// lanes to DP, a multiple of the mma depth 16 (24 -> 32). Products take bf16
// in and keep f32 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_tile {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;         // rows of every tile: 4 warps x 16
constexpr int THREADS = 128;
constexpr int NB = ROWS / 8;     // 8-column blocks of a (16, 64) product
constexpr int TS = ROWS + 8;     // row stride (bf16) of a transposed tile
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

// Rows i0 .. i0 + 63 of an (n, D) bf16 matrix into `dst` ([row][d], stride
// RS) and / or `dst_t` ([d][row], stride TS). Rows past n and pad lanes are
// written as zeros.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, bf16* dst_t, const bf16* src, int i0, int n) {
  constexpr int DP = Dims<D>::DP, RS = Dims<D>::RS;
  for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
    const int r = e / DP, d = e % DP, i = i0 + r;
    bf16 val = __float2bfloat16(0.f);
    if (d < D && i < n) val = src[(long long)i * D + d];
    if (dst != nullptr) dst[r * RS + d] = val;
    if (dst_t != nullptr) dst_t[d * TS + r] = val;
  }
}

// the A fragments of rows row0 .. row0 + 15 of a row-major tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const bf16* tile, int row0) {
  constexpr int RS = Dims<D>::RS;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bf16* lo = tile + (row0 + gid) * RS + tig * 2;
  const bf16* hi = lo + 8 * RS;
#pragma unroll
  for (int kc = 0; kc < Dims<D>::KC; ++kc) {
    a[kc][0] = ld32(lo + kc * 16);
    a[kc][1] = ld32(hi + kc * 16);
    a[kc][2] = ld32(lo + kc * 16 + 8);
    a[kc][3] = ld32(hi + kc * 16 + 8);
  }
}

// s (16 x 64) = A (16 x D) . tile^T: column c of s is row c of the row-major tile
template <int D>
__device__ __forceinline__ void product_d(float (*s)[4], uint32_t (*a)[4], const bf16* tile) {
  constexpr int RS = Dims<D>::RS;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    const bf16* br = tile + (nb * 8 + gid) * RS + tig * 2;
#pragma unroll
    for (int kc = 0; kc < Dims<D>::KC; ++kc)
      mma16816(s[nb], a[kc], ld32(br + kc * 16), ld32(br + kc * 16 + 8));
  }
}

// acc (16 x D) += bf16(p) (16 x 64) . X (64 x D), X given transposed
// ([d][row]); p in the accumulator layout of product_d, which is reused as
// the A fragments (columns 2j*8.. and (2j+1)*8.. form 16-deep chunk j)
template <int D>
__device__ __forceinline__ void product_rows(float (*acc)[4], float (*p)[4], const bf16* tile_t) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < ROWS / 16; ++j) {
    const uint32_t pa[4] = {pack2(p[2 * j][0], p[2 * j][1]), pack2(p[2 * j][2], p[2 * j][3]),
                            pack2(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack2(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int db = 0; db < Dims<D>::DB; ++db) {
      const bf16* vr = tile_t + (db * 8 + gid) * TS + j * 16 + tig * 2;
      mma16816(acc[db], pa, ld32(vr), ld32(vr + 8));
    }
  }
}

// a key's class: 1 attendable, 0 masked, -1 past the last key
__device__ __forceinline__ float key_class(const float* key_valid, int n, int M) {
  return n < M ? (key_valid[n] > 0.f ? 1.f : 0.f) : -1.f;
}

// a logit in base-2 units (q.k times `scale`); masked keys MASKED, keys
// past the end -inf (they take no part in the softmax)
__device__ __forceinline__ float logit2(float s, float cls, float scale) {
  return cls > 0.f ? s * scale : (cls == 0.f ? MASKED : -INFINITY);
}

// write rows row0 + gid and row0 + gid + 8 of a (16, D) accumulator, times
// inv[0] / inv[1], as bf16 into rows of `dst` (n, D); rows past n are skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, float (*acc)[4], int row0, int n,
                                           const float* inv) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + gid + 8 * i;
    if (r >= n) continue;
#pragma unroll
    for (int db = 0; db < Dims<D>::DB; ++db) {
      const int d = db * 8 + tig * 2;
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + (long long)r * D + d) =
            pack2(acc[db][2 * i] * inv[i], acc[db][2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace attn_tile
