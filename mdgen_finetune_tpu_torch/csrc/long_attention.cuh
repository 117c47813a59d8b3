// long_attention.cuh: the pieces that the long-key attention kernels share,
// tiled_attention.cu (the frame core's forward) and fused_attention_bwd.cu
// (the attention backward at long T).
//
// Both kernels have one shape. A block of 8 warps owns a chunk of 16-row
// tiles of one attention row (sequence and head): query tiles in the
// forward and the dq pass, key tiles in the dK / dV pass. The rows of the
// other side (keys and values, or queries and dO) are resident in shared
// memory: the block stages them once, and every warp walks all of them for
// each of its tiles, with no barrier in the walk. Where they do not fit the
// block's share of an SM (two blocks per SM), they come in windows, and the
// block takes one round of tiles so that every window is staged once per
// block. ops/long_attention.py computes the schedule (tiles per block,
// window rows) and the launchers size their shared memory from the window.
//
// Staged rows are row-major [row][d] with blocked_attention_bwd.cuh's row
// stride (Geo<D>::RS: D lanes, an odd number of 16-byte units, so that an
// ldmatrix phase reads 32 distinct banks; no pad of D = 24 to 32). Products
// run on mma.sync with f32 accumulators: over d as D / 16 chunks of 16 and,
// at D = 24, an m16n8k8 tail (prod_d); over rows with B fragments from
// ldmatrix.trans of the row-major tile (load_b_rows), so no tile is ever
// copied transposed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "blocked_attention_bwd.cuh"

namespace longattn {

typedef __nv_bfloat16 bf16;
using attn_tile::mma16816;
using attn_tile::pack2;
using blockedbwd::AFrag;
using blockedbwd::Geo;
using blockedbwd::load_b_rows;
using rope_tile::smem_u32;

using attn_tile::LN2;
using attn_tile::LOG2E;
using attn_tile::MASKED;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// resident blocks per SM that the launch bounds ask for: two, but one at
// D = 64, whose accumulators would spill at two
template <int D>
struct Occ {
  static constexpr int MIN_BLOCKS = D <= 32 ? 2 : 1;
};

// 2^x on the SFU, subnormal results flushed to zero: every p that the
// kernels form is a term of a sum that holds 1 (natural) or 1e-30 (base
// 2), so a flushed p below 2^-126 moves no result
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the A fragments of rows r0 .. r0 + 15 of a row-major (n, D) bf16 matrix
// in device memory, read directly (each row once per tile); rows past n
// are zero
template <int D>
__device__ __forceinline__ void load_a_global(AFrag<D>& f, const bf16* src, int r0, int n) {
  const int lane = threadIdx.x & 31, ra = r0 + (lane >> 2), rb = ra + 8, c = (lane & 3) * 2;
  auto ld = [&](int r, int col) -> uint32_t {
    return r < n ? *reinterpret_cast<const uint32_t*>(src + (long long)r * D + col) : 0u;
  };
#pragma unroll
  for (int kc = 0; kc < Geo<D>::K16; ++kc) {
    f.a[kc][0] = ld(ra, kc * 16 + c);
    f.a[kc][1] = ld(rb, kc * 16 + c);
    f.a[kc][2] = ld(ra, kc * 16 + 8 + c);
    f.a[kc][3] = ld(rb, kc * 16 + 8 + c);
  }
  if constexpr (Geo<D>::TAIL) {
    f.t[0] = ld(ra, Geo<D>::K16 * 16 + c);
    f.t[1] = ld(rb, Geo<D>::K16 * 16 + c);
  }
}

// the B fragments of a product over d: rows r0 .. r0 + 7 of a staged tile
// (their D lanes the reduction), as blockedbwd::product_d loads them
template <int D>
__device__ __forceinline__ void load_b_d(uint32_t* b, const void* tile, int r0) {
  constexpr int RS = Geo<D>::RS, OB = Geo<D>::OB;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m0 = 0; m0 < OB; m0 += 4) {
    const int m = m0 + min(lane >> 3, OB - 1 - m0);  // lanes past the end repeat the last
    uint32_t r[4];
    rope_tile::ldsm_x4(r, static_cast<const uint16_t*>(tile) + (r0 + (lane & 7)) * RS + m * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m0 + i < OB) b[m0 + i] = r[i];
  }
}

// c = a (16x16, row) * b (16x8, col) from zero accumulators (no registers
// to clear), bf16 in, f32 out
__device__ __forceinline__ void mma16816_zero(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c (16 x 8) = A (16 x D) . B (those 8 rows), bf16 in, f32 out
template <int D>
__device__ __forceinline__ void mma_d(float* c, const AFrag<D>& a, const uint32_t* b) {
  mma16816_zero(c, a.a[0], b[0], b[1]);
#pragma unroll
  for (int kc = 1; kc < Geo<D>::K16; ++kc) mma16816(c, a.a[kc], b[2 * kc], b[2 * kc + 1]);
  if constexpr (Geo<D>::TAIL) blockedbwd::mma1688_bf16(c, a.t, b[Geo<D>::OB - 1]);
}

// c (16 x 8) = A (16 x D) . rows r0 .. r0 + 7 of a staged tile
template <int D>
__device__ __forceinline__ void prod_d(float* c, const AFrag<D>& a, const void* tile, int r0) {
  uint32_t b[Geo<D>::OB];
  load_b_d<D>(b, tile, r0);
  mma_d<D>(c, a, b);
}

// 16 bytes from device to shared memory without the registers; zeros where
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// rows r0 .. r0 + rows - 1 of a row-major (n, D) bf16 matrix into dst
// (rows of RS) with cp.async; rows past n, and rows where zero(row) holds,
// are zeros. The caller waits (cp_async_wait_all) and syncs.
template <int D, class Zero>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src, int r0, int rows, int n,
                                            Zero zero) {
  constexpr int RS = Geo<D>::RS, U = D / 8;  // 16-byte units of a row
  for (int e = threadIdx.x; e < rows * U; e += THREADS) {
    const int r = e / U, u = e % U, g = r0 + r;
    const bool ok = g < n && !zero(g);
    cp_async16(dst + r * RS + u * 8, src + (long long)(ok ? g : 0) * D + u * 8, ok);
  }
}

// the schedule of a block: tiles [t0, t1) of its row, `rounds` rounds of
// `per_warp` tiles per warp, `nwin` windows of `win` resident rows out of `np`
struct Sched {
  int t0, t1, rounds, nwin;
  __device__ Sched(int chunk_index, int chunk, int tiles, int np, int win, int per_warp = 1) {
    t0 = chunk_index * chunk;
    t1 = min(tiles, t0 + chunk);
    rounds = (t1 - t0 + WARPS * per_warp - 1) / (WARPS * per_warp);
    nwin = (np + win - 1) / win;
  }
};

// ---------------------------------------------------------------------------
// the forward's key walk (tiled_attention.cu, fused_attention.cu)
// ---------------------------------------------------------------------------

constexpr int TQ = 2;  // 16-query tiles that a warp walks the keys with at once

// the block's shared memory at a window of `win` keys: k and v rows, the
// keys' additive masks, and each warp's TQ x 16 query rows
template <int D>
struct FwdLayout {
  size_t ks, vs, kb, qw, total;
  __host__ __device__ explicit FwdLayout(int win) {
    constexpr int RS = Geo<D>::RS;
    size_t o = 0;
    ks = o; o += (size_t)win * RS * 2;
    vs = o; o += (size_t)win * RS * 2;
    kb = o; o += (size_t)win * 4;
    qw = o; o += (size_t)WARPS * TQ * 16 * RS * 2;
    total = o;
  }
};

// keys k0 .. k0 + 8 NBK - 1 of the resident window against this warp's TQ
// query tiles (each B fragment loaded once for all of them): o (f32,
// 16 x D per tile) += p . v, l += the rows' p sums (this thread's
// columns), m the natural mode's running row maxima (base-2 units). A
// key's logit in base-2 units is q.k * km + Kb[key] (capped at 100 in base
// 2): km carries log2(e) in the natural mode, Kb the additive mask.
template <int D, bool NATURAL, int NBK>
__device__ __forceinline__ void step(float (*o)[Geo<D>::OB][4], float (*l)[2], float (*m)[2],
                                     const AFrag<D>* qa, const bf16* Ks, const bf16* Vs,
                                     const float* Kb, float km, int k0) {
  constexpr int OB = Geo<D>::OB;
  const int tig = threadIdx.x & 3;
  float s[TQ][NBK][4];
#pragma unroll
  for (int nb = 0; nb < NBK; ++nb) {
    uint32_t b[OB];
    load_b_d<D>(b, Ks, k0 + nb * 8);
    const float2 kb = *reinterpret_cast<const float2*>(Kb + k0 + nb * 8 + tig * 2);
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      float* c = s[t][nb];
      mma_d<D>(c, qa[t], b);
      c[0] = fmaf(c[0], km, kb.x);
      c[1] = fmaf(c[1], km, kb.y);
      c[2] = fmaf(c[2], km, kb.x);
      c[3] = fmaf(c[3], km, kb.y);
      if constexpr (!NATURAL) {
        c[0] = fminf(c[0], 100.f);
        c[1] = fminf(c[1], 100.f);
        c[2] = fminf(c[2], 100.f);
        c[3] = fminf(c[3], 100.f);
      }
    }
  }
  if constexpr (NATURAL) {
    // the step's row maxima (the four threads of a row hold disjoint keys)
    float mx[TQ][2];
    bool rose = false;
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      mx[t][0] = mx[t][1] = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) {
        mx[t][0] = fmaxf(mx[t][0], fmaxf(s[t][nb][0], s[t][nb][1]));
        mx[t][1] = fmaxf(mx[t][1], fmaxf(s[t][nb][2], s[t][nb][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[t][i] = fmaxf(mx[t][i], __shfl_xor_sync(0xffffffffu, mx[t][i], 1));
        mx[t][i] = fmaxf(m[t][i], fmaxf(mx[t][i], __shfl_xor_sync(0xffffffffu, mx[t][i], 2)));
        rose |= mx[t][i] > m[t][i];
      }
    }
    if (__any_sync(0xffffffffu, rose)) {
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        // 0 at the first step (m = -inf); 1 for a row whose max held
        const float a[2] = {ex2(m[t][0] - mx[t][0]), ex2(m[t][1] - mx[t][1])};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m[t][i] = mx[t][i];
          l[t][i] *= a[i];
        }
#pragma unroll
        for (int db = 0; db < OB; ++db) {
          o[t][db][0] *= a[0];
          o[t][db][1] *= a[0];
          o[t][db][2] *= a[1];
          o[t][db][3] *= a[1];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) {
        s[t][nb][0] -= m[t][0];
        s[t][nb][1] -= m[t][0];
        s[t][nb][2] -= m[t][1];
        s[t][nb][3] -= m[t][1];
      }
  }
  uint32_t pa[TQ][NBK / 2][4];
#pragma unroll
  for (int t = 0; t < TQ; ++t)
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb) {
      const float p0 = ex2(s[t][nb][0]), p1 = ex2(s[t][nb][1]);
      const float p2 = ex2(s[t][nb][2]), p3 = ex2(s[t][nb][3]);
      l[t][0] += p0 + p1;
      l[t][1] += p2 + p3;
      pa[t][nb / 2][(nb % 2) * 2] = pack2(p0, p1);
      pa[t][nb / 2][(nb % 2) * 2 + 1] = pack2(p2, p3);
    }
#pragma unroll
  for (int j = 0; j < NBK / 2; ++j) {
    uint32_t b[OB][2];
    load_b_rows<D>(b, Vs, k0 + j * 16);
#pragma unroll
    for (int t = 0; t < TQ; ++t)
#pragma unroll
      for (int db = 0; db < OB; ++db) mma16816(o[t][db], pa[t][j], b[db][0], b[db][1]);
  }
}

// the launch resources of `kernel` with `smem` bytes of dynamic shared
// memory: info[0] registers per thread, [1] local (spill) bytes per
// thread, [2] the shared memory, [3] resident blocks per SM
template <class K>
int resources(K kernel, size_t smem, long long* info) {
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (long long)fa.localSizeBytes;
  info[2] = (long long)smem;
  info[3] = per_sm;
  return 0;
}

}  // namespace longattn
